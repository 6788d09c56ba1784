"""The traffic generators: deterministic per seed, the same work for
every seed, messages that pack, and the bulk renderers equal to the
frozen synthesis."""

import numpy as np
import pytest
import torch

import registry
from generators import baseband_ft8, ft8synth, messages, wideband_capture
from reference.protocol.pack import pack77

BUSY = registry.traffic("busy")
SUBBAND = registry.traffic("subband")


def test_messages_pack_and_round_trip():
    rng = np.random.default_rng(2**31 + 77)
    for _ in range(300):
        text = messages.message(rng, BUSY["messages"])
        assert pack77(text).shape == (77,)
        canon = messages.canonical(text)
        assert messages.canonical(canon) == canon


def test_baseband_plan_deterministic_and_same_work_per_seed():
    a = baseband_ft8.plan(BUSY, 2**32 + 5, 64)
    b = baseband_ft8.plan(BUSY, 2**32 + 5, 64)
    c = baseband_ft8.plan(BUSY, 9, 64)
    assert a == b and a != c
    for wa, wc in zip(a, c):
        assert len(wa) == len(wc) == 64 * 12.5
        assert sorted(x["snr_db"] for x in wa) == \
            sorted(x["snr_db"] for x in wc)
        counts = np.bincount([x["chan"] for x in wa], minlength=64)
        assert counts.min() == 5 and counts.max() == 20
        for ch in range(64):
            f0 = sorted(x["f0_hz"] for x in wa if x["chan"] == ch)
            assert all(b - a >= 50 - BUSY["f0_jitter_hz"]
                       for a, b in zip(f0, f0[1:]))


def test_wideband_plan_deterministic_and_same_work_per_seed():
    a = wideband_capture.plan(SUBBAND, 2**31 + 3)
    assert a == wideband_capture.plan(SUBBAND, 2**31 + 3)
    c = wideband_capture.plan(SUBBAND, 4)
    assert sorted(map(len, a)) == sorted(map(len, c)) == [20, 30, 40]
    lo = SUBBAND["subband_channel"] * 1600 + SUBBAND["subband_offset_hz"]
    for w in a:
        assert all(lo <= x["abs_hz"] < lo + 3000 for x in w)


def test_render_baseband_equals_frozen_synthesis():
    rng = np.random.default_rng(1)
    texts = [messages.canonical(messages.message(rng, BUSY["messages"]))
             for _ in range(3)]
    f0 = [312.5, 1000.0, 1450.3]
    start = [-600, 0, 4000]
    amp = [0.5, 0.1, 1.0]
    out_i = torch.zeros((2, 48000))
    out_q = torch.zeros((2, 48000))
    tones = np.stack([ft8synth.tones_of(t) for t in texts])
    ft8synth.render_baseband(
        out_i, out_q, torch.tensor([0, 1, 1]), torch.from_numpy(tones),
        torch.tensor(f0, dtype=torch.float64), torch.tensor(start),
        torch.tensor(amp, dtype=torch.float64), chunk=2)
    want = np.zeros((2, 48000), np.complex64)
    for ch, t, f, s, a in zip([0, 1, 1], tones, f0, start, amp):
        want[ch] += ft8synth.synthesize_tones(t, f, s, a)
    np.testing.assert_allclose(out_i.numpy(), want.real, atol=2e-6)
    np.testing.assert_allclose(out_q.numpy(), want.imag, atol=2e-6)


def test_render_fullrate_is_the_phase_continuous_burst():
    tones = ft8synth.tones_of("CQ K1JT FN20")
    n = 3 * 384_000
    out_i, out_q = torch.zeros(n), torch.zeros(n)
    ft8synth.render_fullrate(out_i, out_q, tones, 600_000 + 320_150.0,
                             -1000, 0.2, block=2)
    phi, x = 0.0, np.zeros(n + 1000, np.complex128)
    for j, tone in enumerate(tones[:4]):
        f = 920_150.0 + (float(tone) - 3.5) * 6.25
        dphi = 2 * np.pi * f / 2.4e6
        seg = 0.2 * np.exp(1j * (phi + dphi * np.arange(384_000)))
        lo = j * 384_000
        x[lo:lo + 384_000] = seg[:len(x[lo:lo + 384_000])]
        phi = (phi + dphi * 384_000) % (2 * np.pi)
    x = x[1000:1000 + n]
    np.testing.assert_allclose(out_i.numpy(), x.real, atol=1e-6)
    np.testing.assert_allclose(out_q.numpy(), x.imag, atol=1e-6)


def test_to_u8_is_the_synthetic_source_quantization():
    x = np.array([-1.5, -0.2, 0.0, 0.37, 1.2], np.float32)
    y = np.array([0.9, -0.99, 0.5, -0.01, 0.0], np.float32)
    got = ft8synth.to_u8(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    want = np.empty(10, np.uint8)
    want[0::2] = np.clip(x * 127 + 128, 0, 255).astype(np.uint8)
    want[1::2] = np.clip(y * 127 + 128, 0, 255).astype(np.uint8)
    assert np.array_equal(got, want)


def test_generators_deterministic_per_seed():
    small = dict(BUSY, windows=1, signals_per_channel=[1, 2])
    a = baseband_ft8.generate(small, 2**31 + 9, "cpu", channels=2)
    b = baseband_ft8.generate(small, 2**31 + 9, "cpu", channels=2)
    assert all(np.array_equal(x, y) for x, y in zip(a["windows"][0],
                                                   b["windows"][0]))
    assert a["truth"] == b["truth"]
    assert a["windows"][0][0].dtype == np.float32


@pytest.mark.parametrize("seed", [5, 2**31 + 1])
def test_wideband_capture_deterministic_and_unclipped(seed):
    small = dict(SUBBAND, windows=1, signals_per_window=[1, 1])
    a = wideband_capture.generate(small, seed, "cpu")
    b = wideband_capture.generate(small, seed, "cpu")
    assert np.array_equal(a["captures"][0], b["captures"][0])
    assert a["captures"][0].shape == (72_000_000,)
    assert 40 < a["peak_counts"] < 127
    u = a["captures"][0]
    assert u.min() > 0 and u.max() < 255
