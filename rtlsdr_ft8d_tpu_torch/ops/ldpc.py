"""Batched LDPC(174, 91) sum-product belief propagation and CRC-14.

Port of rtlsdr_ft8d_tpu/ops/ldpc.py (bp_decode_xla, the plain version
here; crc_check) and ops/ldpc_pallas.py (the kernel, csrc/ldpc.cu). Both
run the XLA formulation's schedule with a fixed iteration count and
best-so-far tracking; the Tanner graph is indexed through the edge maps
of ops/tables.py instead of one-hot selection GEMMs. The plain version
spells out the kernel's operation order, so on one device the two agree
bit for bit.
"""

import torch

from rtlsdr_ft8d_tpu.protocol.constants import (FT8_LDPC_K, FT8_LDPC_M,
                                                FT8_LDPC_N)

from . import build
from .tables import NUM_EDGES

KERNEL = build.Kernel(
    "bp", "ft8_bp_decode", [build.P] * 6 + [build.I] * 2,
    source="rtlsdr_ft8d_tpu_torch/csrc/ldpc.cu",
    replaces="rtlsdr_ft8d_tpu/ops/ldpc_pallas.py:169")


def _fast_tanh(x):
    """ft8_lib's rational tanh (rtlsdr_ft8d_tpu/ops/ldpc.py:65-72)."""
    x = torch.clamp(x, -4.97, 4.97)
    x2 = x * x
    return x * (945.0 + x2 * (105.0 + x2)) \
        / (945.0 + x2 * (420.0 + 15.0 * x2))


def _fast_atanh(x):
    """ft8_lib's rational atanh (rtlsdr_ft8d_tpu/ops/ldpc.py:75-80)."""
    x2 = x * x
    return x * (945.0 + x2 * (-735.0 + x2 * 64.0)) \
        / (945.0 + x2 * (-1050.0 + x2 * 225.0))


def bp_decode_plain(llr, edge_var, edge_slot, slot_edge, max_iters=20,
                    return_posterior=False):
    """(..., 174) LLRs (positive = bit 1) -> (hard (..., 174) int8,
    errors (...,) int32[, posterior (..., 174) float32])."""
    batch_shape = llr.shape[:-1]
    l = llr.reshape(-1, FT8_LDPC_N).to(torch.float32)
    N = l.shape[0]
    var = edge_var.to(torch.int64)
    valid = var >= 0
    var = var.clamp(min=0)
    slot = edge_slot.to(torch.int64).clamp(min=0)
    tov = torch.zeros((N, FT8_LDPC_N * 3), dtype=torch.float32,
                      device=l.device)
    best_err = torch.full((N,), FT8_LDPC_M, dtype=torch.int32,
                          device=l.device)
    best_hard = torch.zeros((N, FT8_LDPC_N), dtype=torch.int8,
                            device=l.device)

    def posterior(tov):
        t3 = tov.view(N, FT8_LDPC_N, 3)
        return l + ((t3[..., 0] + t3[..., 1]) + t3[..., 2])

    for _ in range(max_iters):
        post = posterior(tov)
        hard = post > 0
        ones = (hard[:, var] & valid).view(N, FT8_LDPC_M, 7).sum(-1)
        errors = (ones % 2).sum(-1).to(torch.int32)
        errors = torch.where(hard.any(-1), errors, FT8_LDPC_M)
        better = errors < best_err
        best_err = torch.where(better, errors, best_err)
        best_hard = torch.where(better[:, None], hard.to(torch.int8),
                                best_hard)

        diff = post[:, var] - tov[:, slot]                  # (N, 581)
        toc = torch.where(valid, _fast_tanh(-0.5 * diff), 1.0)
        toc7 = toc.view(N, FT8_LDPC_M, 7)
        fwd = [torch.ones_like(toc7[..., 0])]
        bwd = [torch.ones_like(toc7[..., 0])]
        for j in range(6):
            fwd.append(fwd[-1] * toc7[..., j])
            bwd.append(bwd[-1] * toc7[..., 6 - j])
        excl = torch.stack([fwd[j] * bwd[6 - j] for j in range(7)],
                           dim=-1).view(N, NUM_EDGES)
        val = torch.clamp(excl[:, slot_edge], -0.999999, 0.999999)
        tov = -2.0 * _fast_atanh(val)

    hard_out = best_hard.reshape(batch_shape + (FT8_LDPC_N,))
    err_out = best_err.reshape(batch_shape)
    if return_posterior:
        return hard_out, err_out, \
            posterior(tov).reshape(batch_shape + (FT8_LDPC_N,))
    return hard_out, err_out


def bp_decode_cuda(llr, edge_var, edge_slot, slot_edge, max_iters=20,
                   return_posterior=False):
    """The kernel: one warp per codeword, any leading batch shape."""
    dev = llr.device
    batch_shape = llr.shape[:-1]
    l = llr.reshape(-1, FT8_LDPC_N).to(torch.float32).contiguous()
    N = l.shape[0]
    hard = torch.empty((N, FT8_LDPC_N), dtype=torch.int8, device=dev)
    errors = torch.empty((N,), dtype=torch.int32, device=dev)
    post = (torch.empty((N, FT8_LDPC_N), dtype=torch.float32, device=dev)
            if return_posterior else None)
    if N:
        KERNEL(dev, build.check(l, torch.float32, device=dev),
               build.check(edge_var, torch.int32, (NUM_EDGES,), dev),
               build.check(edge_slot, torch.int32, (NUM_EDGES,), dev),
               build.check(hard, torch.int8), build.check(errors, torch.int32),
               None if post is None else build.check(post, torch.float32),
               N, max_iters)
    out = (hard.reshape(batch_shape + (FT8_LDPC_N,)),
           errors.reshape(batch_shape))
    if return_posterior:
        return out + (post.reshape(batch_shape + (FT8_LDPC_N,)),)
    return out


def bp_decode(llr, edge_var, edge_slot, slot_edge, max_iters=20,
              return_posterior=False):
    fn = bp_decode_cuda if build.on_cuda(llr) else bp_decode_plain
    return fn(llr, edge_var, edge_slot, slot_edge, max_iters,
              return_posterior)


def crc_check(hard: torch.Tensor, crc_mat: torch.Tensor) -> torch.Tensor:
    """CRC-14 check on (..., >= 91) hard bits; True = CRC ok. The GF(2)
    product is a float32 matmul of 0/1 values, exact for counts <= 77
    (integer matmul does not run on CUDA)."""
    payload = hard[..., :77].to(torch.float32)
    expect = torch.remainder(torch.matmul(payload, crc_mat.to(torch.float32)),
                             2.0)
    got = hard[..., 77:FT8_LDPC_K].to(torch.float32)
    return (expect == got).all(-1)
