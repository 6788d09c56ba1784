"""Signal subtraction for multi-pass decoding.

Port of rtlsdr_ft8d_tpu/ops/subtract.py (subtract_signals, no Pallas
kernel there). Each decoded signal is rebuilt from its 79 tones and
subtracted from the window, after three refinements of the candidate's
half-symbol / half-bin parameters:
  1. coarse timing: +-1 half-symbol start variants, max energy wins;
  2. fractional delay: a two-stage sample-shift search (step 16, then
     step 2) maximizing the consecutive-symbol gain coherence
     |sum g_n conj(g_{n-1})|, which a constant frequency error cannot
     move;
  3. frequency: the phase slope of consecutive per-symbol gains on the
     aligned windows;
then one global complex gain per message. argmax keeps the first
maximum, as jnp.argmax does; `.at[].add` becomes `index_add_`.

The work runs on the flat list of decoded (channel, message) pairs, in
(channel, message) order with the channels ascending, and in two stages:
`refine_pairs` (steps 1-3 and the gain: a PairFit a pair) and
`reconstruct` (the residual). `subtract_pairs` composes them: pairs on a
card launch the kernel csrc/subtract.cu, once a stage
(`refine_pairs_cuda`, `reconstruct_cuda`), which keeps the plain
arithmetic as PyTorch runs it on the card; pairs on the CPU take the
plain versions, whose arithmetic is the padded (B, M) function's, pair
by pair.
"""

import math
from typing import NamedTuple

import torch

from ..protocol.constants import (BLOCK_SIZE, FT8_NN, SIGNAL_SAMPLE_RATE,
                                  TONE_SPACING_HZ)
from . import build

KERNEL = build.Kernel(
    "subtract", "ft8_subtract", [build.I] + [build.P] * 11 + [build.I] * 2,
    source="rtlsdr_ft8d_tpu_torch/csrc/subtract.cu",
    replaces="no Pallas kernel: rtlsdr_ft8d_tpu/ops/subtract.py:"
             "subtract_signals is plain jnp")

WINDOW = 15 * SIGNAL_SAMPLE_RATE
SYMBOL_S = BLOCK_SIZE / SIGNAL_SAMPLE_RATE     # 0.16 s


class PairFit(NamedTuple):
    """refine_pairs' result, a row a pair. choice: (P, 2) integers, the
    chosen start in half symbols and the sample shift; fit: (P, 3)
    float32, the frequency error in Hz and the global complex gain
    (g_r, g_i); phase0: (P, 79) float32, the per-symbol start phases at
    f + f_err."""
    choice: torch.Tensor
    fit: torch.Tensor
    phase0: torch.Tensor


def _symbol_windows(start_half_blocks, sample_offset=None):
    """(...) half-symbol starts (+ optional (...) sample shift) ->
    clipped sample indices (..., 79, 512) and their in-window mask."""
    dev = start_half_blocks.device
    sym = torch.arange(FT8_NN, device=dev)
    start = start_half_blocks[..., None] * (BLOCK_SIZE // 2) \
        + sym * BLOCK_SIZE                                    # (..., 79)
    if sample_offset is not None:
        start = start + sample_offset[..., None]
    idx = start[..., None] + torch.arange(BLOCK_SIZE, device=dev)
    in_range = (idx >= 0) & (idx < WINDOW)
    return idx.clamp(0, WINDOW - 1), in_range


def _freqs(tones, base_freq_bin2):
    """(P, 79) per-symbol tone frequencies in Hz."""
    return (base_freq_bin2[..., None].to(torch.float32) * 0.5
            + tones.to(torch.float32)) * TONE_SPACING_HZ


def _phase0(f_hz):
    """Phase-continuous per-symbol start phases (exclusive cumsum of the
    per-symbol phase increments)."""
    inc = (2.0 * math.pi * BLOCK_SIZE / SIGNAL_SAMPLE_RATE) * f_hz
    return torch.cumsum(inc, dim=-1) - inc


def _angles(f_hz, phase0):
    n = torch.arange(BLOCK_SIZE, dtype=torch.float32, device=f_hz.device)
    return phase0[..., None] \
        + (2.0 * math.pi / SIGNAL_SAMPLE_RATE) * f_hz[..., None] * n


def _gains(i_s, q_s, rows, f_hz, idx_c, in_range):
    """Per-symbol complex gains (P, 79) and captured energy (P,) of the
    pairs whose channels are `rows`."""
    xi = i_s[rows[:, None, None], idx_c]
    xq = q_s[rows[:, None, None], idx_c]
    ang = _angles(f_hz, _phase0(f_hz))
    c, s = torch.cos(ang), torch.sin(ang)
    mask = in_range.to(torch.float32)
    gr = torch.sum((xi * c + xq * s) * mask, dim=-1) / BLOCK_SIZE
    gi = torch.sum((xq * c - xi * s) * mask, dim=-1) / BLOCK_SIZE
    energy = torch.sum(gr * gr + gi * gi, dim=-1)
    return gr, gi, energy


def _coherence_search(i_s, q_s, rows, f_hz, start, base_shift, offsets):
    """The shift among base_shift + offsets with the largest
    consecutive-symbol gain coherence, per pair."""
    cohs = []
    for dt in offsets:
        idx_s, inr_s = _symbol_windows(start, base_shift + dt)
        g_r, g_i, _ = _gains(i_s, q_s, rows, f_hz, idx_s, inr_s)
        sv = inr_s.any(dim=-1).to(torch.float32)
        pr = g_r[..., 1:] * g_r[..., :-1] + g_i[..., 1:] * g_i[..., :-1]
        pi_ = g_i[..., 1:] * g_r[..., :-1] - g_r[..., 1:] * g_i[..., :-1]
        svv = sv[..., 1:] * sv[..., :-1]
        cohs.append(torch.sum(pr * svv, dim=-1) ** 2
                    + torch.sum(pi_ * svv, dim=-1) ** 2)       # (P,)
    k = torch.argmax(torch.stack(cohs, dim=-1), dim=-1)
    offs = torch.tensor(offsets, dtype=base_shift.dtype,
                        device=base_shift.device)
    return base_shift + offs[k]


def refine_pairs(i_s, q_s, chan, tones, base_freq_bin2, start_half_blocks):
    """The plain refinement of P pairs: i_s, q_s (B, 48000) float32; chan
    (P,) channel index; tones (P, 79) tone indices; base_freq_bin2 (P,)
    tone-0 frequency in half bins; start_half_blocks (P,) start in half
    symbols. All on one device. Returns a PairFit (int64 choice)."""
    rows = chan.to(torch.int64)
    start = start_half_blocks.to(torch.int64)
    f_hz = _freqs(tones, base_freq_bin2)

    # 1. timing: the start variant with the most energy
    energies = []
    for dv in (-1, 0, 1):
        idx_c, in_range = _symbol_windows(start + dv)
        energies.append(_gains(i_s, q_s, rows, f_hz, idx_c, in_range)[2])
    best_v = torch.argmax(torch.stack(energies, dim=-1), dim=-1)
    start_best = start + (best_v - 1)

    # 2. fractional delay, before the CFO estimate
    zero = torch.zeros_like(start_best)
    shift = _coherence_search(i_s, q_s, rows, f_hz, start_best, zero,
                              list(range(-128, 129, 16)))
    shift = _coherence_search(i_s, q_s, rows, f_hz, start_best, shift,
                              list(range(-8, 9, 2)))
    idx_c, in_range = _symbol_windows(start_best, shift)

    # 3. frequency from the gain phase slope on the aligned windows
    gr, gi, _ = _gains(i_s, q_s, rows, f_hz, idx_c, in_range)
    dot_r = torch.sum(gr[..., 1:] * gr[..., :-1]
                      + gi[..., 1:] * gi[..., :-1], dim=-1)
    dot_i = torch.sum(gi[..., 1:] * gr[..., :-1]
                      - gr[..., 1:] * gi[..., :-1], dim=-1)
    f_err = torch.atan2(dot_i, dot_r) / (2.0 * math.pi * SYMBOL_S)
    f_hz2 = f_hz + f_err[..., None]
    gr, gi, _ = _gains(i_s, q_s, rows, f_hz2, idx_c, in_range)
    sym_valid = in_range.any(dim=-1).to(torch.float32)

    # 4. one global complex gain per pair at the refined (f, dt)
    denom = torch.clamp(torch.sum(sym_valid, dim=-1), min=1.0)
    g_r = torch.sum(gr * sym_valid, dim=-1) / denom
    g_i = torch.sum(gi * sym_valid, dim=-1) / denom
    return PairFit(torch.stack([start_best, shift], dim=-1),
                   torch.stack([f_err, g_r, g_i], dim=-1), _phase0(f_hz2))


def reconstruct(i_s, q_s, chan, tones, base_freq_bin2, fit: PairFit):
    """The plain residual: i_s, q_s minus every pair's signal rebuilt at
    its PairFit, summed in pair order. Returns a new (i, q) pair."""
    rows = chan.to(torch.int64)
    f_hz2 = _freqs(tones, base_freq_bin2) + fit.fit[:, 0, None]
    idx_c, in_range = _symbol_windows(fit.choice[:, 0].to(torch.int64),
                                      fit.choice[:, 1].to(torch.int64))
    ang = _angles(f_hz2, fit.phase0)
    c, s = torch.cos(ang), torch.sin(ang)
    g_r = fit.fit[:, 1, None, None]
    g_i = fit.fit[:, 2, None, None]
    rec_i = g_r * c - g_i * s
    rec_q = g_r * s + g_i * c
    w = in_range.to(torch.float32)

    B = i_s.shape[0]
    flat_idx = (idx_c + rows[:, None, None] * WINDOW).reshape(-1)
    acc_i = torch.zeros(B * WINDOW, dtype=torch.float32, device=i_s.device)
    acc_q = torch.zeros_like(acc_i)
    acc_i.index_add_(0, flat_idx, (rec_i * w).reshape(-1))
    acc_q.index_add_(0, flat_idx, (rec_q * w).reshape(-1))
    return (i_s - acc_i.reshape(B, WINDOW),
            q_s - acc_q.reshape(B, WINDOW))


def _operands(i_s, q_s, chan, tones, base_freq_bin2):
    """The operands both launches read, checked: the samples as
    contiguous float32 (B, 48000) and the pairs' int32 fields."""
    dev = i_s.device
    B, P = i_s.shape[0], chan.shape[0]
    x = [t.contiguous() for t in (i_s, q_s)]
    for t in x:
        build.check(t, torch.float32, (B, WINDOW), dev)
    ints = [t.to(dev, torch.int32).contiguous()
            for t in (chan, tones, base_freq_bin2)]
    for t, shape in zip(ints, ((P,), (P, FT8_NN), (P,))):
        build.check(t, torch.int32, shape, dev)
    return x + ints


def refine_pairs_cuda(i_s, q_s, chan, tones, base_freq_bin2,
                      start_half_blocks):
    """The kernel's refinement launch, one block a pair: refine_pairs'
    PairFit (int32 choice) on the samples' card."""
    dev = i_s.device
    P = chan.shape[0]
    ops = _operands(i_s, q_s, chan, tones, base_freq_bin2)
    st = start_half_blocks.to(dev, torch.int32).contiguous()
    build.check(st, torch.int32, (P,), dev)
    out = PairFit(torch.empty((P, 2), dtype=torch.int32, device=dev),
                  torch.empty((P, 3), dtype=torch.float32, device=dev),
                  torch.empty((P, FT8_NN), dtype=torch.float32, device=dev))
    if P:
        KERNEL(dev, 0, *(t.data_ptr() for t in ops + [st] + list(out)),
               None, None, P, i_s.shape[0])
    return out


def _check_ascending(chan):
    """The residual launch finds a channel's pairs by binary search, so
    their channels must ascend; host-built operands are checked here,
    since pairs out of order would be skipped without a word."""
    if chan.device.type == "cpu" and bool((chan[1:] < chan[:-1]).any()):
        raise ValueError("the pairs' channels must ascend: (channel, "
                         "message) order")


def reconstruct_cuda(i_s, q_s, chan, tones, base_freq_bin2, fit: PairFit):
    """The kernel's residual launch, one thread a (channel, sample):
    reconstruct's residual on the samples' card. The pairs' channels
    must ascend, as they do in (channel, message) order: a ValueError
    where chan is on the host, unchecked where it is on the card."""
    _check_ascending(chan)
    dev = i_s.device
    B, P = i_s.shape[0], chan.shape[0]
    ops = _operands(i_s, q_s, chan, tones, base_freq_bin2)
    params = [fit.choice.to(dev, torch.int32).contiguous(),
              fit.fit.to(dev, torch.float32).contiguous(),
              fit.phase0.to(dev, torch.float32).contiguous()]
    for t, shape in zip(params, ((P, 2), (P, 3), (P, FT8_NN))):
        build.check(t, t.dtype, shape, dev)
    if not P:
        return i_s.clone(), q_s.clone()
    out = [torch.empty((B, WINDOW), dtype=torch.float32, device=dev)
           for _ in range(2)]
    KERNEL(dev, 1, *(t.data_ptr() for t in ops), None,
           *(t.data_ptr() for t in params + out), P, B)
    return tuple(out)


def subtract_pairs(i_s, q_s, chan, tones, base_freq_bin2, start_half_blocks):
    """Subtract P decoded signals, given as pairs in (channel, message)
    order (chan (P,) ascending; tones (P, 79); base_freq_bin2,
    start_half_blocks (P,)), from the windows i_s, q_s (B, 48000)
    float32. Samples on a card launch the kernel twice (refine, residual)
    or raise (a ValueError for host channels out of order); samples on
    the CPU take refine_pairs and reconstruct, in any order.
    Returns the residual (i, q), a new pair."""
    if build.on_cuda(i_s):
        fit = refine_pairs_cuda(i_s, q_s, chan, tones, base_freq_bin2,
                                start_half_blocks)
        return reconstruct_cuda(i_s, q_s, chan, tones, base_freq_bin2, fit)
    fit = refine_pairs(i_s, q_s, chan, tones, base_freq_bin2,
                       start_half_blocks)
    return reconstruct(i_s, q_s, chan, tones, base_freq_bin2, fit)


def subtract_signals(i_s, q_s, tones, base_freq_bin2, start_half_blocks,
                     valid):
    """Subtract reconstructed FT8 signals from baseband windows, in the
    JAX package's padded layout.

    i_s, q_s: (B, 48000) float32; tones: (B, M, 79) tone indices;
    base_freq_bin2: (B, M) tone-0 frequency in half bins; start_half_blocks:
    (B, M) start in half symbols; valid: (B, M) bool. All on one device.
    The valid slots become pairs in (channel, message) order for
    subtract_pairs. Returns the residual (i, q), (B, 48000) float32.
    """
    chan, m = torch.nonzero(valid, as_tuple=True)
    return subtract_pairs(i_s, q_s, chan, tones[chan, m],
                          base_freq_bin2[chan, m], start_half_blocks[chan, m])
