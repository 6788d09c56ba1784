"""Noncoherent 8-FSK tone magnitudes, bit LLRs and SNR estimates.

Port of rtlsdr_ft8d_tpu/ops/llr.py (the plain versions here) and
ops/llr_pallas.py (the kernel, csrc/llr.cu, which also fuses
_llrs_from_mags). For each flat candidate the 58 data symbols contribute
8 Gray-mapped tone magnitudes and 3 max-log bit LLRs; the 174-vector is
scaled to variance 24 (ft8_lib's normalization).

Out-of-window symbols read as 0 and are masked by `valid`; time and
frequency offsets are clipped to [-12, 23] and [0, 248] as in the Pallas
wrapper (llr_pallas.py:105-106) — find_sync never yields others.
"""

import numpy as np
import torch

from rtlsdr_ft8d_tpu.protocol.constants import (FT8_LDPC_N, FT8_ND,
                                                GRAY_MAP, NUM_BIN,
                                                NUM_BLOCKS)

from . import build

# data symbol k sits at channel symbol k + 7 (k < 29) or k + 14
DATA_SYM = np.array([k + (7 if k < 29 else 14) for k in range(FT8_ND)],
                    dtype=np.int64)
# bit b of the Gray-decoded value j, MSB first (rtlsdr_ft8d_tpu/ops/llr.py:27)
BIT_SET = np.array([[(j >> (2 - b)) & 1 for j in range(8)]
                    for b in range(3)], dtype=bool)         # (3, 8)
CAND_KEYS = ("time_sub", "freq_sub", "time_offset", "freq_offset")

KERNEL = build.Kernel(
    "llr", "ft8_tone_llrs", [build.P] * 8 + [build.I],
    source="rtlsdr_ft8d_tpu_torch/csrc/llr.cu",
    replaces="rtlsdr_ft8d_tpu/ops/llr_pallas.py:123")


def _llrs_from_mags(s2: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Max-log bit LLRs + variance normalization
    (rtlsdr_ft8d_tpu/ops/llr.py:31-50). s2: (..., 58, 8); valid: (..., 58)."""
    set_mask = torch.as_tensor(BIT_SET, device=s2.device)
    s2e = s2[..., None, :]                                   # (..., 58, 1, 8)
    neg = torch.tensor(-1e30, dtype=s2.dtype, device=s2.device)
    max_set = torch.where(set_mask, s2e, neg).amax(-1)
    max_clr = torch.where(set_mask, neg, s2e).amax(-1)
    logl = torch.where(valid[..., None], max_set - max_clr, 0.0)
    log174 = logl.reshape(s2.shape[:-2] + (FT8_LDPC_N,))
    s = log174.sum(-1, keepdim=True)
    s2sum = (log174 * log174).sum(-1, keepdim=True)
    inv_n = 1.0 / FT8_LDPC_N
    var = (s2sum - s * s * inv_n) * inv_n
    # a true division: Python's `24.0 / tensor` is reciprocal() * 24.0
    norm = torch.sqrt(torch.full_like(var, 24.0) / torch.clamp(var, 1e-12))
    return log174 * norm


def _operands(cand_flat: dict, chan_idx: torch.Tensor):
    ts, fs = cand_flat["time_sub"], cand_flat["freq_sub"]
    to = torch.clamp(cand_flat["time_offset"], -12, 23)
    fo = torch.clamp(cand_flat["freq_offset"], 0, NUM_BIN - 8)
    return chan_idx, ts, fs, to, fo


def _symbol_blocks(to: torch.Tensor):
    """(N, 58) waterfall block of each data symbol, and whether it lies
    inside the window."""
    blocks = to.to(torch.int64)[:, None] + torch.as_tensor(DATA_SYM,
                                                          device=to.device)
    return blocks, (blocks >= 0) & (blocks < NUM_BLOCKS)


def tone_llrs_plain(wf, cand_flat, chan_idx):
    """(s2 (N, 58, 8) f32, valid (N, 58) bool, llr (N, 174) f32) by
    direct indexing of the flattened waterfall."""
    chan, ts, fs, to, fo = (x.to(torch.int64)
                            for x in _operands(cand_flat, chan_idx))
    dev = wf.device
    blocks, valid = _symbol_blocks(to)
    base = ((((chan[:, None] * NUM_BLOCKS + blocks.clamp(0, NUM_BLOCKS - 1))
              * 2 + ts[:, None]) * 2 + fs[:, None]) * NUM_BIN
            + fo[:, None])
    gray = torch.as_tensor(GRAY_MAP.astype(np.int64), device=dev)
    s2 = wf.reshape(-1)[base[..., None] + gray].to(torch.float32)
    s2 = torch.where(valid[..., None], s2, 0.0)
    return s2, valid, _llrs_from_mags(s2, valid)


def tone_llrs_cuda(wf, cand_flat, chan_idx):
    """The kernel: the same three outputs, for a waterfall on CUDA."""
    dev = wf.device
    ops = [x.to(torch.int32).contiguous()
           for x in _operands(cand_flat, chan_idx)]
    n = ops[0].shape[0]
    s2 = torch.empty((n, FT8_ND, 8), dtype=torch.float32, device=dev)
    llr = torch.empty((n, FT8_LDPC_N), dtype=torch.float32, device=dev)
    if n:
        wf_c = wf.contiguous()
        if wf_c.shape[1:] != (NUM_BLOCKS, 2, 2, NUM_BIN):
            raise ValueError(f"expected a (B, 92, 2, 2, 256) waterfall, got "
                             f"{tuple(wf_c.shape)}")
        KERNEL(dev, build.check(wf_c, torch.uint8, device=dev),
               *(build.check(x, torch.int32, (n,), dev) for x in ops),
               build.check(s2, torch.float32), build.check(llr, torch.float32),
               n)
    return s2, _symbol_blocks(ops[3])[1], llr


def tone_llrs(wf, cand_flat, chan_idx):
    fn = tone_llrs_cuda if build.on_cuda(wf) else tone_llrs_plain
    return fn(wf, cand_flat, chan_idx)


def tone_mags_flat(wf, cand_flat, chan_idx):
    """(s2 (N, 58, 8) f32, valid (N, 58)) for a flat selection
    (rtlsdr_ft8d_tpu/ops/llr.py:82-115)."""
    s2, valid, _ = tone_llrs(wf, cand_flat, chan_idx)
    return s2, valid


def flatten_grid(cand: dict):
    """(B, K) candidate grid -> flat (B*K,) dict + channel indices."""
    B, K = cand["time_sub"].shape
    flat = {k: cand[k].reshape(-1) for k in CAND_KEYS}
    chan = torch.arange(B, device=cand["time_sub"].device).repeat_interleave(K)
    return flat, chan, B, K


def extract_llrs_flat(wf, cand_flat, chan_idx) -> torch.Tensor:
    """(N, 174) normalized LLRs of a flat cross-channel selection."""
    return tone_llrs(wf, cand_flat, chan_idx)[2]


def extract_llrs(wf, cand) -> torch.Tensor:
    """(B, K, 174) normalized LLRs of a find_sync candidate grid."""
    flat, chan, B, K = flatten_grid(cand)
    return extract_llrs_flat(wf, flat, chan).reshape(B, K, FT8_LDPC_N)


def estimate_snr_flat(wf, cand_flat, chan_idx) -> torch.Tensor:
    """(N,) SNR estimates in dB re 2500 Hz
    (rtlsdr_ft8d_tpu/ops/llr.py:155-172): mean strongest-tone level over
    valid symbols against the channel's trimmed-mean noise floor."""
    s2, valid = tone_mags_flat(wf, cand_flat, chan_idx)
    peak = s2.amax(-1)
    nvalid = torch.clamp(valid.sum(-1), min=1)
    sig_half_db = torch.where(valid, peak, 0.0).sum(-1) / nvalid
    wf_f = wf.reshape(wf.shape[0], -1).to(torch.float32)
    m1 = wf_f.mean(-1, keepdim=True)
    below = (wf_f <= m1).to(torch.float32)
    noise_half_db = ((wf_f * below).sum(-1)
                     / torch.clamp(below.sum(-1), min=1.0) + 9.9)
    return 0.5 * (sig_half_db - noise_half_db[chan_idx]) - 26.0


def estimate_snr(wf, cand) -> torch.Tensor:
    """(B, K) SNR estimates of a candidate grid."""
    flat, chan, B, K = flatten_grid(cand)
    return estimate_snr_flat(wf, flat, chan).reshape(B, K)
