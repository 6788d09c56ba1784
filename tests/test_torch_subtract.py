"""The port's signal subtraction and multipass decode against the JAX
package.

subtract_signals gets the same window and the same decoded-signal
parameters (from the JAX package's own first pass) on both sides. The
residuals agree within 5e-3 absolute, 1% of the strong signal's 0.5
amplitude; the difference found is 3.4e-3. Its source is the float32
phase accumulator: a cumsum of per-symbol phase steps reaches 1.4e5 rad,
where one float32 ulp is 0.016 rad, and XLA and PyTorch sum in different
orders (each is as far from a float64 sum as the other). The decode
lists of passes=2 and 3 must equal JAX's (text, frequency, time and
score equal, SNR within 0.5 dB), and the WindowStats counters must be
equal.

The pair split (refine_pairs + reconstruct over the flat list of
decoded (channel, message) pairs) is held to the padded (B, 16) function
it replaced, kept below as `_padded_subtract`, within 1e-6 of the
residual: on the masked and clean scenes and on a batch of 4 channels
(one with no pair, one with 16 and a 17th left out by MAX_SUBTRACT, one
with bursts clipped at either end of the window).
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtlsdr_ft8d_tpu import pipeline as jpipe
from rtlsdr_ft8d_tpu.host.io import read_iq
from rtlsdr_ft8d_tpu.host.synth import synthesize_message
from rtlsdr_ft8d_tpu.ops.subtract import subtract_signals as jax_subtract
from rtlsdr_ft8d_tpu.protocol.constants import K_LDPC_ITERS, K_MAX_CANDIDATES
from rtlsdr_ft8d_tpu.protocol.encode import codeword_to_tones, ldpc_encode
from rtlsdr_ft8d_tpu_torch import pipeline
from rtlsdr_ft8d_tpu_torch.host.log import StageTimer
from rtlsdr_ft8d_tpu_torch.host.synth import synthesize_tones
from rtlsdr_ft8d_tpu_torch.ops import build
from rtlsdr_ft8d_tpu_torch.ops.subtract import (PairFit, reconstruct,
                                                reconstruct_cuda,
                                                refine_pairs,
                                                subtract_pairs,
                                                subtract_signals)
from rtlsdr_ft8d_tpu_torch.pipeline import WindowDecoder, decode_window
from rtlsdr_ft8d_tpu_torch.protocol.crc import add_crc
from rtlsdr_ft8d_tpu_torch.protocol.pack import pack77

from .torch_cpu import few_torch_threads  # noqa: F401

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
STRONG, WEAK = "CQ K1JT FN20", "K1ABC W9XYZ EN37"


def _masked():
    """tests/test_multipass.py:9-17: a strong signal on top of a 23 dB
    weaker one at overlapping tones."""
    rng = np.random.default_rng(7)
    strong = synthesize_message(STRONG, f0_hz=500.0, amplitude=0.5,
                                noise_sigma=0.0)
    weak = synthesize_message(WEAK, f0_hz=506.25, amplitude=0.035,
                              noise_sigma=0.0)
    noise = 0.004 * (rng.standard_normal(48000)
                     + 1j * rng.standard_normal(48000))
    return (strong + weak + noise).astype(np.complex64)


def _clean():
    """tests/test_multipass.py:30-32."""
    return synthesize_message(STRONG, f0_hz=700.0, amplitude=0.5,
                              noise_sigma=0.1, rng=np.random.default_rng(9))


SCENES = {"masked": _masked, "clean": _clean}


@pytest.fixture(scope="module")
def decoder():
    return WindowDecoder()


@pytest.fixture(scope="module")
def jax_multipass():
    return {(name, p): jpipe.decode_window(make(), passes=p)
            for name, make in SCENES.items() for p in (2, 3)}


def _assert_same(mine, ref):
    assert [d.text for d in mine] == [d.text for d in ref]
    for a, b in zip(mine, ref):
        assert (a.freq_hz, a.time_sec, a.score) == \
            (b.freq_hz, b.time_sec, b.score), a.text
        assert abs(a.snr_db - b.snr_db) <= 0.5, (a.text, a.snr_db, b.snr_db)


def test_subtract_signals_matches_jax():
    iq = _masked()
    i_s = np.real(iq)[None].astype(np.float32)
    q_s = np.imag(iq)[None].astype(np.float32)
    res, sub, _ = jpipe._decode_pass(i_s, q_s, None, K_MAX_CANDIDATES,
                                     K_LDPC_ITERS)
    assert [d.text for d in res[0]] == [STRONG]
    M = 16
    tones = np.zeros((1, M, 79), np.int32)
    fbin2 = np.zeros((1, M), np.int32)
    start2 = np.zeros((1, M), np.int32)
    valid = np.zeros((1, M), bool)
    for m, (bits, fb2, st2) in enumerate(sub[0]):
        tones[0, m] = codeword_to_tones(ldpc_encode(bits))
        fbin2[0, m], start2[0, m], valid[0, m] = fb2, st2, True
    ri, rq = jax_subtract(*(jnp.asarray(a) for a in
                            (i_s, q_s, tones, fbin2, start2, valid)), M)
    gi, gq = subtract_signals(*(torch.from_numpy(a) for a in
                                (i_s, q_s, tones, fbin2, start2, valid)))
    for got, ref, orig in ((gi, ri, i_s), (gq, rq, q_s)):
        got, ref = got.numpy(), np.asarray(ref)
        np.testing.assert_allclose(got, ref, rtol=0, atol=5e-3)
        # the strong signal is gone: the residual is the weak one + noise
        assert np.sqrt(np.mean(got ** 2)) < 0.1 * np.sqrt(np.mean(orig ** 2))


def test_second_pass_finds_masked_signal(decoder):
    iq = _masked()
    one = {d.text for d in decode_window(iq, decoder=decoder)}
    two = {d.text for d in decode_window(iq, passes=2, decoder=decoder)}
    assert STRONG in one and WEAK not in one
    assert {STRONG, WEAK} <= two


@pytest.mark.parametrize("passes", [2, 3])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_multipass_matches_jax(jax_multipass, decoder, scene, passes):
    mine = decode_window(SCENES[scene](), passes=passes, decoder=decoder)
    _assert_same(mine, jax_multipass[(scene, passes)])


@pytest.mark.parametrize("passes", [1, 2])
def test_return_stats_match_jax(decoder, passes):
    iq = read_iq(os.path.join(FIX, "golden_busy.iq"))
    ref, ref_stats = jpipe.decode_window(iq, passes=passes,
                                         return_stats=True)
    mine, stats = decode_window(iq, passes=passes, decoder=decoder,
                                return_stats=True)
    _assert_same(mine, ref)
    for key in ("channels", "candidates_scored", "candidates_above_min",
                "ldpc_converged", "crc_passed", "messages_unique"):
        assert getattr(stats, key) == getattr(ref_stats, key), key


# ---- the padded (B, M) function before the pair split, frozen --------
def _padded_windows(start_half_blocks, sample_offset=None):
    sym = torch.arange(79)
    start = start_half_blocks[..., None] * 256 + sym[None, None, :] * 512
    if sample_offset is not None:
        start = start + sample_offset[..., None]
    idx = start[..., None] + torch.arange(512)
    in_range = (idx >= 0) & (idx < 48000)
    return idx.clamp(0, 47999), in_range


def _padded_angles(f_hz):
    inc = (2.0 * math.pi * 512 / 3200) * f_hz
    n = torch.arange(512, dtype=torch.float32)
    return (torch.cumsum(inc, dim=-1) - inc)[..., None] \
        + (2.0 * math.pi / 3200) * f_hz[..., None] * n


def _padded_gains(i_s, q_s, f_hz, idx_c, in_range):
    bi = torch.arange(i_s.shape[0])[:, None, None, None]
    xi, xq = i_s[bi, idx_c], q_s[bi, idx_c]
    ang = _padded_angles(f_hz)
    c, s = torch.cos(ang), torch.sin(ang)
    mask = in_range.to(torch.float32)
    gr = torch.sum((xi * c + xq * s) * mask, dim=-1) / 512
    gi = torch.sum((xq * c - xi * s) * mask, dim=-1) / 512
    return gr, gi, torch.sum(gr * gr + gi * gi, dim=-1)


def _padded_search(i_s, q_s, f_hz, start, base_shift, offsets):
    cohs = []
    for dt in offsets:
        idx_s, inr_s = _padded_windows(start, base_shift + dt)
        g_r, g_i, _ = _padded_gains(i_s, q_s, f_hz, idx_s, inr_s)
        sv = inr_s.any(dim=-1).to(torch.float32)
        pr = g_r[..., 1:] * g_r[..., :-1] + g_i[..., 1:] * g_i[..., :-1]
        pi_ = g_i[..., 1:] * g_r[..., :-1] - g_r[..., 1:] * g_i[..., :-1]
        svv = sv[..., 1:] * sv[..., :-1]
        cohs.append(torch.sum(pr * svv, dim=-1) ** 2
                    + torch.sum(pi_ * svv, dim=-1) ** 2)
    k = torch.argmax(torch.stack(cohs, dim=-1), dim=-1)
    return base_shift + torch.tensor(offsets)[k]


def _padded_subtract(i_s, q_s, tones, base_freq_bin2, start_half_blocks,
                     valid):
    B = i_s.shape[0]
    start_half_blocks = start_half_blocks.to(torch.int64)
    f_hz = (base_freq_bin2[..., None].to(torch.float32) * 0.5
            + tones.to(torch.float32)) * 6.25
    energies = []
    for dv in (-1, 0, 1):
        idx_c, in_range = _padded_windows(start_half_blocks + dv)
        energies.append(_padded_gains(i_s, q_s, f_hz, idx_c, in_range)[2])
    best_v = torch.argmax(torch.stack(energies, dim=-1), dim=-1)
    start_best = start_half_blocks + (best_v - 1)
    shift = _padded_search(i_s, q_s, f_hz, start_best,
                           torch.zeros_like(start_best),
                           list(range(-128, 129, 16)))
    shift = _padded_search(i_s, q_s, f_hz, start_best, shift,
                           list(range(-8, 9, 2)))
    idx_c, in_range = _padded_windows(start_best, shift)
    gr, gi, _ = _padded_gains(i_s, q_s, f_hz, idx_c, in_range)
    dot_r = torch.sum(gr[..., 1:] * gr[..., :-1]
                      + gi[..., 1:] * gi[..., :-1], dim=-1)
    dot_i = torch.sum(gi[..., 1:] * gr[..., :-1]
                      - gr[..., 1:] * gi[..., :-1], dim=-1)
    f_err = torch.atan2(dot_i, dot_r) / (2.0 * math.pi * 0.16)
    f_hz2 = f_hz + f_err[..., None]
    gr, gi, _ = _padded_gains(i_s, q_s, f_hz2, idx_c, in_range)
    sym_valid = in_range.any(dim=-1).to(torch.float32)
    denom = torch.clamp(torch.sum(sym_valid, dim=-1), min=1.0)
    g_r = (torch.sum(gr * sym_valid, dim=-1) / denom)[..., None]
    g_i = (torch.sum(gi * sym_valid, dim=-1) / denom)[..., None]
    ang = _padded_angles(f_hz2)
    c, s = torch.cos(ang), torch.sin(ang)
    rec_i = g_r[..., None] * c - g_i[..., None] * s
    rec_q = g_r[..., None] * s + g_i[..., None] * c
    w = in_range.to(torch.float32) * valid[..., None, None].to(torch.float32)
    bi = torch.arange(B)[:, None, None, None]
    flat_idx = (idx_c + bi * 48000).reshape(-1)
    acc_i = torch.zeros(B * 48000, dtype=torch.float32)
    acc_q = torch.zeros_like(acc_i)
    acc_i.index_add_(0, flat_idx, (rec_i * w).reshape(-1))
    acc_q.index_add_(0, flat_idx, (rec_q * w).reshape(-1))
    return (i_s - acc_i.reshape(B, 48000), q_s - acc_q.reshape(B, 48000))
# ----------------------------------------------------------------------


def _burst(text, f0_hz, start_sample, amplitude):
    """A burst and its subtraction parameters (91 message bits, tone-0
    frequency in half bins, start in half symbols), as unpack_survivors
    gives them for a decode on the grid."""
    bits = add_crc(pack77(text))
    tones = codeword_to_tones(ldpc_encode(bits))
    iq = synthesize_tones(tones, f0_hz=f0_hz, start_sample=start_sample,
                          amplitude=amplitude)
    fb2 = int(round((f0_hz - 3.5 * 6.25) / 3.125))
    return iq, (bits, fb2, int(round(start_sample / 256)))


def _batch4():
    """(B=4) windows and their per-channel subtraction parameters: channel
    0 noise alone with no pair; channel 1 17 bursts off the half-symbol
    grid (MAX_SUBTRACT takes 16); channel 2 one burst that starts 3,000
    samples before the window and one that ends 3,000 after it; channel 3
    one burst."""
    rng = np.random.default_rng(3)
    windows = 0.05 * (rng.standard_normal((4, 48000))
                      + 1j * rng.standard_normal((4, 48000)))
    plan = {1: [(f"K1ABC W9XY{chr(65 + m)} EN37", 150.0 + 80.0 * m,
                 256 * (2 + m % 5) + 37 * m % 200, 0.1 + 0.02 * (m % 8))
                for m in range(17)],
            2: [("CQ K1JT FN20", 700.0, -3000, 0.3),
                ("CQ W9XYZ EN37", 1200.0, 48000 - 79 * 512 + 3000, 0.3)],
            3: [(STRONG, 900.0, 640, 0.5)]}
    sub = [[] for _ in range(4)]
    for b, bursts in plan.items():
        for text, f0, start, amp in bursts:
            iq, params = _burst(text, f0, start, amp)
            windows[b] += iq
            sub[b].append(params)
    return (windows.real.astype(np.float32), windows.imag.astype(np.float32),
            sub)


def _scene_params(scene, decoder):
    """(i, q) of a scene as (B, 48000) float32 and its per-channel
    subtraction parameters: the port's own first pass for the masked and
    clean scenes."""
    if scene == "batch4":
        return _batch4()
    iq = SCENES[scene]()
    i_s = np.real(iq)[None].astype(np.float32)
    q_s = np.imag(iq)[None].astype(np.float32)
    _, sub, _ = pipeline._decode_pass(
        decoder, torch.from_numpy(i_s), torch.from_numpy(q_s), None,
        pipeline.NO_TIMER)
    assert sub[0]
    return i_s, q_s, sub


def _padded_operands(sub):
    """sub_params -> the padded (B, 16) operands, first 16 a channel."""
    B = len(sub)
    tones = np.zeros((B, 16, 79), np.int32)
    fbin2 = np.zeros((B, 16), np.int32)
    start2 = np.zeros((B, 16), np.int32)
    valid = np.zeros((B, 16), bool)
    for b, params in enumerate(sub):
        for m, (bits, fb2, st2) in enumerate(params[:16]):
            tones[b, m] = codeword_to_tones(ldpc_encode(bits))
            fbin2[b, m], start2[b, m], valid[b, m] = fb2, st2, True
    return [torch.from_numpy(a) for a in (tones, fbin2, start2, valid)]


@pytest.mark.parametrize("scene", ["masked", "clean", "batch4"])
def test_pairs_equal_the_padded_function(decoder, scene):
    """refine_pairs + reconstruct over the pairs (through the pipeline's
    pair list, with its counters) give the padded function's residual
    within 1e-6; the padded entry point subtract_signals gives it too."""
    i_s, q_s, sub = _scene_params(scene, decoder)
    x = (torch.from_numpy(i_s), torch.from_numpy(q_s))
    ops = _padded_operands(sub)
    want = _padded_subtract(*x, *ops)
    timer = StageTimer(detail=True)
    before = build.KERNELS["subtract"].launches
    got = pipeline._subtract_decoded(*x, sub, timer)
    assert build.KERNELS["subtract"].launches == before
    n_pairs = sum(min(len(p), 16) for p in sub)
    assert timer.counters == {"subtract_pairs": n_pairs,
                              "launches.subtract": 0}
    padded = subtract_signals(*x, *ops)
    for w, g, p in zip(want, got, padded):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(p.numpy(), w.numpy(), rtol=0, atol=1e-6)
    if scene == "batch4":
        assert n_pairs == 19
        np.testing.assert_array_equal(got[0][0].numpy(), i_s[0])
        # the subtraction takes out most of each channel's bursts
        for b in (1, 2, 3):
            assert np.sqrt(np.mean(got[0][b].numpy() ** 2)) < \
                0.5 * np.sqrt(np.mean(i_s[b] ** 2))


def test_refine_pairs_finds_the_burst_parameters():
    """On a burst off the grid by 200 samples and 1.3 Hz, the refinement
    picks the start variant and shift that land within a step of the
    truth, and an f_err within 0.2 Hz; reconstruct takes out 35 dB."""
    f0, start = 800.0 + 1.3, 512 * 3 + 200
    iq, (bits, fb2, st2) = _burst(STRONG, f0, start, 0.5)
    x = [torch.from_numpy(a.astype(np.float32)[None])
         for a in (iq.real, iq.imag)]
    tones = torch.from_numpy(codeword_to_tones(ldpc_encode(bits))
                             .astype(np.int32))[None]
    chan, fb, st = (torch.tensor([v], dtype=torch.int32)
                    for v in (0, fb2, st2))
    fit = refine_pairs(*x, chan, tones, fb, st)
    sample0 = int(fit.choice[0, 0]) * 256 + int(fit.choice[0, 1])
    assert abs(sample0 - start) <= 2
    assert abs(float(fit.fit[0, 0]) - 1.3) < 0.2
    assert abs(math.hypot(*fit.fit[0, 1:].tolist()) - 0.5) < 0.01
    ri, rq = reconstruct(*x, chan, tones, fb, fit)
    power = np.mean(np.abs(iq) ** 2)
    left = np.mean(ri.numpy() ** 2 + rq.numpy() ** 2)
    assert 10 * np.log10(power / left) > 35


def test_subtract_pairs_with_no_pair_copies_the_window():
    rng = np.random.default_rng(5)
    x = [torch.from_numpy(rng.standard_normal((2, 48000)).astype(np.float32))
         for _ in range(2)]
    empty = torch.zeros(0, dtype=torch.int32)
    out = subtract_pairs(*x, empty, torch.zeros((0, 79), dtype=torch.int32),
                         empty, empty)
    for o, a in zip(out, x):
        assert o is not a
        np.testing.assert_array_equal(o.numpy(), a.numpy())


def test_kernel_path_refuses_host_channels_out_of_order():
    """The residual launch finds a channel's pairs by binary search:
    host-built pairs out of (channel, message) order raise before any
    launch, where the plain path takes them in any order."""
    x = torch.zeros((3, 48000))
    chan = torch.tensor([2, 0, 1], dtype=torch.int32)
    tones = torch.zeros((3, 79), dtype=torch.int32)
    fb2 = torch.full((3,), 100, dtype=torch.int32)
    fit = PairFit(torch.zeros((3, 2), dtype=torch.int32),
                  torch.zeros((3, 3)), torch.zeros((3, 79)))
    with pytest.raises(ValueError, match="ascend"):
        reconstruct_cuda(x, x, chan, tones, fb2, fit)
    out = subtract_pairs(x, x, chan, tones, fb2, fb2)
    assert all(torch.equal(o, x) for o in out)
