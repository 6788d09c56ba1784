"""Quantized waterfall spectrogram (windowed DFT -> uint8).

Port of rtlsdr_ft8d_tpu/ops/waterfall.py (waterfall_xla, the plain
version here) and ops/waterfall_pallas.py (the kernel, csrc/waterfall.cu):
92 symbol blocks x 2 half-symbol time offsets, a 1024-point DFT of the
sine-windowed I/Q at bins 0..511, log power in dB quantized to
`clip(trunc(2 db + 240), 0, 255)`. Layout [block][time_sub][freq_sub][bin]
as a (..., 92, 2, 2, 256) uint8 tensor.
"""

import torch

from rtlsdr_ft8d_tpu.protocol.constants import (FREQ_OSR, NFFT, NUM_BIN,
                                                NUM_BLOCKS, SUB_BLOCK_SIZE,
                                                TIME_OSR)

from . import build

NUM_FRAMES = NUM_BLOCKS * TIME_OSR                  # 184
NUM_SEGMENTS = NFFT // SUB_BLOCK_SIZE               # 4
NUM_BLOCKS_RAW = NUM_FRAMES + NUM_SEGMENTS - 1      # 187
USED_SAMPLES = NUM_BLOCKS_RAW * SUB_BLOCK_SIZE      # 47872

KERNEL = build.Kernel(
    "waterfall", "ft8_waterfall", [build.P] * 6 + [build.I] * 2,
    source="rtlsdr_ft8d_tpu_torch/csrc/waterfall.cu",
    replaces="rtlsdr_ft8d_tpu/ops/waterfall_pallas.py:108")


def _frames(x: torch.Tensor) -> torch.Tensor:
    """(..., 48000) -> (..., 184, 1024) overlapped frames: frame t is the
    256-sample blocks t..t+3 of a (187, 256) reshape
    (rtlsdr_ft8d_tpu/ops/waterfall.py:48-53)."""
    bl = x[..., :USED_SAMPLES].reshape(
        x.shape[:-1] + (NUM_BLOCKS_RAW, SUB_BLOCK_SIZE))
    return torch.cat([bl[..., j:j + NUM_FRAMES, :]
                      for j in range(NUM_SEGMENTS)], dim=-1)


def _require_full_f32_matmul():
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "the waterfall DFT must run in full float32: "
            "torch.backends.cuda.matmul.allow_tf32 is on or the float32 "
            "matmul precision is not 'highest'")


def waterfall_plain(i_samples, q_samples, cos, sin, cos_minus_sin):
    """Plain PyTorch waterfall: three float32 matmuls in Karatsuba form
    (P1 = I@C, P2 = Q@S, P3 = (I+Q)@(C-S); re = P1 + P2,
    im = P3 - P1 + P2), as the JAX default formulation."""
    if i_samples.is_cuda:
        _require_full_f32_matmul()
    i_f = _frames(i_samples)
    q_f = _frames(q_samples)
    p1 = torch.matmul(i_f, cos)
    p2 = torch.matmul(q_f, sin)
    p3 = torch.matmul(i_f + q_f, cos_minus_sin)
    re = p1 + p2
    im = p3 - p1 + p2
    mag2 = re * re + im * im
    db = 10.0 * torch.log10(1e-12 + mag2 * (4.0 / (NFFT * NFFT)))
    scaled = torch.trunc(2.0 * db + 240.0)
    q = torch.clamp(scaled, 0.0, 255.0).to(torch.uint8)
    # frame t -> (block t // 2, time_sub t % 2); bin k -> (k // 2, k % 2)
    q = q.reshape(q.shape[:-2] + (NUM_BLOCKS, TIME_OSR, NUM_BIN, FREQ_OSR))
    return q.transpose(-1, -2).contiguous()


def waterfall_cuda(i_samples, q_samples, cos, sin, cos_minus_sin):
    """The kernel: (..., n >= 47872) float32 I/Q on one CUDA device."""
    dev = i_samples.device
    batch_shape = i_samples.shape[:-1]
    n = i_samples.shape[-1]
    if n < USED_SAMPLES or q_samples.shape != i_samples.shape:
        raise ValueError(f"expected matching (..., >= {USED_SAMPLES}) I/Q, "
                         f"got {tuple(i_samples.shape)} and "
                         f"{tuple(q_samples.shape)}")
    i2 = i_samples.reshape(-1, n).contiguous()
    q2 = q_samples.reshape(-1, n).contiguous()
    B = i2.shape[0]
    out = torch.empty((B, NUM_BLOCKS, TIME_OSR, FREQ_OSR, NUM_BIN),
                      dtype=torch.uint8, device=dev)
    if B:
        basis = (NFFT, NUM_BIN * FREQ_OSR)
        KERNEL(dev, build.check(i2, torch.float32, device=dev),
               build.check(q2, torch.float32, device=dev),
               build.check(cos, torch.float32, basis, dev),
               build.check(sin, torch.float32, basis, dev),
               build.check(cos_minus_sin, torch.float32, basis, dev),
               build.check(out, torch.uint8), B, n)
    return out.reshape(batch_shape + out.shape[1:])


def waterfall(i_samples, q_samples, cos, sin, cos_minus_sin):
    """(..., 48000) float32 I/Q -> (..., 92, 2, 2, 256) uint8: the kernel
    on a CUDA tensor, the plain version on a CPU tensor."""
    fn = waterfall_cuda if build.on_cuda(i_samples) else waterfall_plain
    return fn(i_samples, q_samples, cos, sin, cos_minus_sin)
