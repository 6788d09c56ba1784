"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked `cuda`; without a CUDA card every test skips. On the GPU machine,
which has no JAX (tests/conftest.py imports it), run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

These cover what chip_smoke.py's main-path shapes do not: ragged sizes
(a batch or candidate count that does not fill a block), longer rows and
rows whose length is not a multiple of 4 (the waterfall's scalar loads),
leading batch shapes, int32 and int64 candidate fields, out-of-window
candidates, the fused sync survivors on ties and on an unaligned view,
BP's early exit at several iteration counts, operand checks and the
launch counters; the int8 decimator on unaligned rows, on blocks of many
tiles and on chunks shorter than its history; BP with posteriors on the
deep decode's stacked rungs, and the deep decode's PyTorch stages
(refinement, the codeword bank) on the card against the CPU; the
channelizer on the card against the CPU and across odd chunks, the
decode of a device-resident (1500, 48000) batch with no host copy of
its I/Q, and the waterfall and sync kernels at B = 1500; the subtraction
kernel's two launches against the plain refine_pairs and reconstruct on
the card, stage by stage, at 0, 1, 16 and ~300 pairs. Holds as in
chip_smoke.py: waterfall <= 1 step on < 0.1% of cells, sync / s2 / BP
bit-exact, LLRs within 1e-5, the int8 decimator within rtol 1e-4,
atol 1e-5 of its plain version; refined LLRs within 1e-3 of the CPU's
(cuBLAS and the CPU sum the basis products in other orders), the
channelizer within rtol 1e-4, atol 1e-4 of the CPU's; the subtraction's
start and shift equal to the plain version's on the multipass scenes
(on 99% of the deep cell's pairs), its f_err and gains within 1e-4
relative (sums in another order), its start phases bit-equal to
PyTorch's cumsum on the card at its own f_err, and its residual at the
same refinement within 1e-5 of the window's RMS.
"""

import os

import numpy as np
import pytest
import torch

from rtlsdr_ft8d_tpu_torch import pipeline
from rtlsdr_ft8d_tpu_torch.host.io import read_iq
from rtlsdr_ft8d_tpu_torch.host.synth import (synthesize_message,
                                              synthesize_tones)
from rtlsdr_ft8d_tpu_torch.ops import (ap, build, channelize, decimate,
                                       ldpc, llr, refine, subtract, sync,
                                       tables, waterfall)
from rtlsdr_ft8d_tpu_torch.pipeline import (WindowDecoder, decode_window,
                                            normalize_peak)
from rtlsdr_ft8d_tpu_torch.protocol.crc import add_crc
from rtlsdr_ft8d_tpu_torch.protocol.encode import encode, ldpc_encode
from rtlsdr_ft8d_tpu_torch.protocol.pack import pack77

pytestmark = pytest.mark.cuda
FIX = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(scope="module")
def dec():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    build.load()
    return WindowDecoder().to("cuda")


def _assert_wf_close(a, b):
    d = (a.int() - b.int()).abs()
    assert d.max().item() <= 1
    assert (d == 0).double().mean().item() > 0.999


def _wf_tables(dec):
    return (dec.wf_cos, dec.wf_sin, dec.wf_cos_minus_sin, dec.wf_twiddle,
            dec.wf_window)


def test_waterfall_ragged_batch_and_long_rows(dec):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 3, 48100))
                         .astype(np.float32)).cuda() * 0.1
    y = torch.from_numpy(rng.standard_normal((2, 3, 48100))
                         .astype(np.float32)).cuda() * 0.1
    before = waterfall.KERNEL.launches
    got = waterfall.waterfall(x, y, *_wf_tables(dec))
    assert waterfall.KERNEL.launches == before + 1
    assert got.shape == (2, 3, 92, 2, 2, 256)
    _assert_wf_close(got,
                     waterfall.waterfall_plain(x, y, *_wf_tables(dec)[:3]))
    fft = (dec.wf_twiddle, dec.wf_window)
    with pytest.raises(ValueError):
        waterfall.waterfall_cuda(x[..., :40000], y[..., :40000], *fft)
    with pytest.raises(TypeError):
        waterfall.waterfall_cuda(x.double(), y.double(), *fft)


@pytest.mark.parametrize("batch,n", [(1, 48000), (130, 48000),
                                     (3, 47873)])
def test_waterfall_batch_and_row_stride(dec, batch, n):
    """B = 1, B = 130 and rows of 47,873 samples (not a multiple of 4:
    the same kernel with 4-byte loads) against the plain version."""
    rng = np.random.default_rng(batch + n)
    x, y = (torch.from_numpy(rng.standard_normal((batch, n))
                             .astype(np.float32)).cuda() * 0.1
            for _ in range(2))
    got = waterfall.waterfall(x, y, *_wf_tables(dec))
    assert got.shape == (batch, 92, 2, 2, 256)
    _assert_wf_close(got, waterfall.waterfall_plain(x, y,
                                                    *_wf_tables(dec)[:3]))


def _assert_same_candidates(got, want):
    for k, v in want.items():
        assert torch.equal(got[k].cpu(), v), k


@pytest.mark.parametrize("batch", [1, 3, 65, "equal"])
def test_sync_ragged_batch(dec, batch):
    """The fused first stage at B = 1, 3, 65 and on an all-equal
    waterfall (every score 0, so every chunk ties throughout): v1, gidx,
    the scores-only mode and find_sync's dict equal the plain path's."""
    rng = np.random.default_rng(2)
    if batch == "equal":
        host = np.full((2, 92, 2, 2, 256), 9, np.uint8)
    else:
        host = rng.integers(0, 256, (batch, 92, 2, 2, 256), dtype=np.uint8)
    wf = torch.from_numpy(host).cuda()
    count = dec.sync_count
    before = sync.KERNEL.launches
    v1, gidx = sync.sync_survivors(wf, count)
    assert sync.KERNEL.launches == before + 1
    assert v1.shape == gidx.shape == (host.shape[0], sync.NUM_SURVIVORS)
    want_scores = sync.sync_scores_plain(wf.cpu(), count.cpu())
    assert torch.equal(sync.sync_scores(wf, count).cpu(), want_scores)
    want_v1, want_gidx = sync.chunk_survivors(want_scores)
    assert torch.equal(v1.cpu(), want_v1)
    assert torch.equal(gidx.cpu(), want_gidx)
    _assert_same_candidates(sync.find_sync(wf, count),
                            sync.find_sync(wf.cpu(), count.cpu()))


def test_sync_leading_shape_and_unaligned_view(dec):
    """A (2, 2, ...) batch and a waterfall view that does not start on a
    16-byte boundary (the wrapper stages it into an aligned copy)."""
    rng = np.random.default_rng(21)
    flat = torch.from_numpy(rng.integers(0, 256, 4 * 92 * 1024 + 1,
                                         dtype=np.uint8)).cuda()
    wf = flat[1:].view(2, 2, 92, 2, 2, 256)
    assert wf.data_ptr() % 16
    v1, gidx = sync.sync_survivors(wf, dec.sync_count)
    want = sync.chunk_survivors(sync.sync_scores_plain(wf.cpu(),
                                                       dec.sync_count.cpu()))
    assert v1.shape == (2, 2, sync.NUM_SURVIVORS)
    assert torch.equal(v1.cpu(), want[0]) and torch.equal(gidx.cpu(), want[1])


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32, "mixed"])
def test_llr_ragged_and_out_of_window(dec, dtype):
    rng = np.random.default_rng(3)
    wf = torch.from_numpy(rng.integers(0, 256, (3, 92, 2, 2, 256),
                                       dtype=np.uint8)).cuda()
    n = 61
    cand = {"time_sub": rng.integers(0, 2, n),
            "freq_sub": rng.integers(0, 2, n),
            "time_offset": rng.integers(-30, 40, n),    # some get clipped
            "freq_offset": rng.integers(-5, 260, n)}
    types = ([torch.int32, torch.int64] * 3 if dtype == "mixed"
             else [dtype] * 5)
    cand = {k: torch.from_numpy(v).cuda().to(t)
            for (k, v), t in zip(cand.items(), types)}
    chan = torch.from_numpy(rng.integers(0, 3, n)).cuda().to(types[4])
    before = llr.KERNEL.launches
    s2_k, v_k, l_k = llr.tone_llrs(wf, cand, chan)
    assert llr.KERNEL.launches == before + 1
    assert not v_k.all() and v_k.any()
    s2_p, v_p, l_p = llr.tone_llrs_plain(wf, cand, chan)
    assert torch.equal(s2_k, s2_p) and torch.equal(v_k, v_p)
    torch.testing.assert_close(l_k, l_p, rtol=1e-5, atol=1e-5)
    snr_k = llr.estimate_snr_flat(wf, cand, chan)
    snr_p = llr.estimate_snr_flat(wf.cpu(), {k: v.cpu() for k, v in
                                             cand.items()}, chan.cpu())
    torch.testing.assert_close(snr_k.cpu(), snr_p, rtol=0, atol=1e-3)


def test_bp_ragged_batch_shape_and_posterior(dec):
    """A (2, 31, 174) batch at 0, 1, 2, 7 and 20 iterations: with the
    posterior every output, and without it (early exit) the hard bits and
    errors, equal the plain version's."""
    rng = np.random.default_rng(4)
    rows = []
    for t in range(2 * 31):
        if t % 2:
            rows.append(rng.normal(0, 2.0, 174))
        else:
            cw = ldpc_encode(add_crc(rng.integers(0, 2, 77).astype(np.uint8)))
            rows.append((2.0 * cw - 1.0) * 1.5 + rng.normal(0, 1.0, 174))
    x = torch.from_numpy(np.stack(rows).astype(np.float32)
                         .reshape(2, 31, 174) * 2.0).cuda()
    graph = (dec.ldpc_edge_var, dec.ldpc_edge_slot, dec.ldpc_slot_edge)
    for iters in (0, 1, 2, 7, 20):
        ref = ldpc.bp_decode_plain(x, *graph, iters, True)
        got = ldpc.bp_decode(x, *graph, iters, True)
        early = ldpc.bp_decode(x, *graph, iters)
        assert got[0].shape == (2, 31, 174) and got[1].shape == (2, 31)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        assert torch.equal(early[0], ref[0])
        assert torch.equal(early[1], ref[1])
    assert int((got[1] == 0).sum()) >= 10


def _bp_rows(n, seed):
    rng = np.random.default_rng(seed)
    rows = []
    for t in range(n):
        if t % 3 == 2:
            rows.append(rng.normal(0, 2.0, 174))
        else:
            cw = ldpc_encode(add_crc(rng.integers(0, 2, 77).astype(np.uint8)))
            rows.append((2.0 * cw - 1.0) * [1.5, 0.8][t % 2]
                        + rng.normal(0, 1.0, 174))
    x = np.stack(rows).astype(np.float32) * 2.0
    x[1::4, :30] = 0.0        # exact zeros, as out-of-window symbols give
    return x


@pytest.mark.parametrize("n", [1, 5, 97, 7681])
def test_bp_every_row_with_and_without_posterior(dec, n):
    """Hard bits and error counts equal the plain version's on every row,
    with the posterior (all iterations) and without it (early exit), and
    the posterior is bit-equal."""
    x = torch.from_numpy(_bp_rows(n, n)).cuda()
    graph = (dec.ldpc_edge_var, dec.ldpc_edge_slot, dec.ldpc_slot_edge)
    h_p, e_p, p_p = ldpc.bp_decode_plain(x, *graph, 20, True)
    h_k, e_k, p_k = ldpc.bp_decode(x, *graph, 20, True)
    h_e, e_e = ldpc.bp_decode(x, *graph, 20)
    for h, e in ((h_k, e_k), (h_e, e_e)):
        assert torch.equal(h, h_p) and torch.equal(e, e_p)
    assert torch.equal(p_k, p_p)


def test_decode_window_cuda_equals_cpu(dec):
    iq = read_iq(os.path.join(FIX, "golden_10sig.iq"))
    decode_kernels = [waterfall.KERNEL, sync.KERNEL, llr.KERNEL, ldpc.KERNEL]
    before = [k.launches for k in decode_kernels]
    on_card = decode_window(iq, decoder=dec)
    assert all(k.launches > n for k, n in zip(decode_kernels, before))
    on_cpu = decode_window(iq, device="cpu")
    assert [(d.text, d.freq_hz, d.time_sec, d.score) for d in on_card] == \
        [(d.text, d.freq_hz, d.time_sec, d.score) for d in on_cpu]


@pytest.mark.parametrize("m,rows", [(1, 1), (48_001, 1), (130, 3),
                                    (48_000, 5)])
def test_decimate_int8_ragged(dec, m, rows):
    """M = 1, M = 48,001 (not a multiple of the 8-output range step),
    several rows, and 5 rows of a full window (blocks of many tiles each)
    against the plain version on the card."""
    rng = np.random.default_rng(m)
    n = decimate.HISTORY + m * decimate.R
    i8, q8 = (torch.from_numpy(rng.integers(-128, 128, (rows, n))
                               .astype(np.int8)).cuda() for _ in range(2))
    bank = decimate.DecimatorBank()
    before = decimate.KERNEL.launches
    got = decimate.decimate_int8(i8, q8, bank)
    assert decimate.KERNEL.launches == before + 1
    ref = decimate.decimate_int8_plain(i8, q8, bank.f32)
    for a, b in zip(got, ref):
        assert a.shape == (rows, m)
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError):
        decimate.decimate_int8(i8[..., :-1], q8[..., :-1], bank)


def test_streaming_int8_history_across_calls(dec):
    """Chunks through StreamingDecimatorInt8 on the card equal the
    same chunks through it on the CPU (plain version): the int8 history
    carried on the device is the tail of [history, chunk]."""
    rng = np.random.default_rng(9)
    bank = tables.polyphase_bank()
    on_card = decimate.StreamingDecimatorInt8(bank, "cuda")
    on_cpu = decimate.StreamingDecimatorInt8(bank, "cpu")
    # chunks of 1-6 frames are shorter than the 7-frame history, which
    # then overlaps the carried tail; odd calls write the chunk into the
    # pinned staging buffer, as the daemon's ring pop does
    for call, m in enumerate((64, 1, 300, 3, 6, 2, 5)):
        i8, q8 = (rng.integers(-128, 128, m * decimate.R).astype(np.int8)
                  for _ in range(2))
        want = on_cpu.process(i8, q8)
        if call % 2:
            i_st, q_st = on_card.staging(m * decimate.R)
            i_st[:], q_st[:] = i8, q8
            i8, q8 = i_st, q_st
        for a, b in zip(on_card.process(i8, q8), want):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_decimate_int8_unaligned_view(dec, monkeypatch):
    """full[1] of a (2, n) tensor starts 2 bytes past a 16-byte boundary:
    the wrapper copies it into the kernel's layout. A CUDA input never
    reaches the plain version: one launch per call."""
    bank = decimate.DecimatorBank()
    rng = np.random.default_rng(12)
    n = decimate.HISTORY + 48_000 * decimate.R
    full = torch.from_numpy(rng.integers(-128, 128, (2, n))
                            .astype(np.int8)).cuda()
    assert full[1].data_ptr() % 16
    ref = decimate.decimate_int8_plain(full[1], full[0], bank.f32)

    def refuse(*args):
        raise AssertionError("a CUDA input reached the plain version")

    monkeypatch.setattr(decimate, "decimate_int8_plain", refuse)
    before = decimate.KERNEL.launches
    got = decimate.decimate_int8(full[1], full[0], bank)
    assert decimate.KERNEL.launches == before + 1
    for a, b in zip(got, ref):
        assert a.shape == (48_000,)
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_bp_stacked_rungs_with_posterior(dec):
    """The deep decode's launch shape: (R, N, 174) rungs, N = 37 (no
    multiple of anything the kernel tiles by), one launch; every output
    bit-equal to the plain version's."""
    x = torch.from_numpy(_bp_rows(9 * 37, 11).reshape(9, 37, 174)).cuda()
    graph = (dec.ldpc_edge_var, dec.ldpc_edge_slot, dec.ldpc_slot_edge)
    before = ldpc.KERNEL.launches
    got = ldpc.bp_decode(x, *graph, 20, True)
    assert ldpc.KERNEL.launches == before + 1
    ref = ldpc.bp_decode_plain(x, *graph, 20, True)
    assert got[0].shape == (9, 37, 174) and got[1].shape == (9, 37)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def _refine_inputs(dec):
    """The golden captures' 48 best find_sync candidates each, as the
    deep decode's selection would hold them, and the normalized samples."""
    i_s, q_s = (torch.from_numpy(np.stack(x)) for x in zip(*(
        read_iq(os.path.join(FIX, f"{n}.iq"))
        for n in ("golden_10sig", "golden_busy"))))
    i_n, q_n = normalize_peak(i_s, q_s)
    cand = sync.find_sync(dec.waterfall(i_n.cuda(), q_n.cuda()),
                          dec.sync_count, 48)
    flat, chan, _, _ = llr.flatten_grid(cand)
    return i_n, q_n, {k: v.cpu() for k, v in flat.items()}, chan.cpu()


def test_refine_on_card_equals_cpu(dec):
    """refine_llrs_flat on the card against the CPU on 96 candidates of
    two channels: LLRs within 1e-3, the Costas power within 1e-5."""
    i_n, q_n, cand, chan = _refine_inputs(dec)
    cpu = refine.refine_llrs_flat(i_n, q_n, cand, chan,
                                  *(torch.from_numpy(a)
                                    for a in tables.tone_basis()))
    card = refine.refine_llrs_flat(i_n.cuda(), q_n.cuda(),
                                   {k: v.cuda() for k, v in cand.items()},
                                   chan.cuda(), dec.refine_cos,
                                   dec.refine_sin)
    for k, (a, b) in enumerate(zip(card, cpu)):
        assert torch.isfinite(a).all()
        if k == 1:
            torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=0)
        else:
            assert (a.cpu() - b).abs().max().item() <= 1e-3


def test_bank_correlate_on_card_equals_cpu(dec):
    rng = np.random.default_rng(6)
    bank = ap.codeword_signs(ap.continuation_texts("K1ABC", "W9XYZ")
                             + ap.continuation_texts("W9XYZ", "K1ABC"),
                             h_pad=1024)
    rows = [bank[rng.integers(0, 250)] * [6.0, 2.0, 1.2][t % 3]
            + rng.normal(0, 3.0, 174) for t in range(515)]
    llrs = torch.from_numpy(np.stack(rows).astype(np.float32))
    scores = torch.from_numpy(rng.integers(8, 20, 515))
    cpu = ap.bank_correlate(llrs, torch.from_numpy(bank), scores)
    card = ap.bank_correlate(llrs.cuda(), torch.from_numpy(bank).cuda(),
                             scores.cuda())
    for a, b in zip(card, cpu):
        assert torch.equal(a.cpu(), b)


def test_deep_decode_window_cuda_equals_cpu(dec):
    iq = read_iq(os.path.join(FIX, "golden_10sig.iq"))
    kw = dict(osd_cands=8, passes=2, ap_cq=True, ap_call="K1ABC")
    on_card = decode_window(iq, decoder=dec, **kw)
    on_cpu = decode_window(iq, device="cpu", **kw)
    assert [(d.text, d.freq_hz, d.time_sec, d.score) for d in on_card] == \
        [(d.text, d.freq_hz, d.time_sec, d.score) for d in on_cpu]


def test_channelizer_on_card_equals_cpu(dec):
    """channelize_int8 on the card against the CPU on 64 frames of random
    int8 I/Q (within 1e-4; cuBLAS and the CPU sum the DFT in other
    orders), and the int8 stream on the card across chunks of 23, 17 and
    24 frames (two shorter than the history, two odd) equal to the
    one-shot call on the card; the staging buffer's path gives the
    same."""
    rng = np.random.default_rng(21)
    frames = (23, 17, 24)
    m = sum(frames)
    x8 = rng.integers(-128, 128, (2, m * channelize.R), dtype=np.int8)
    full = np.concatenate([np.zeros((2, channelize.WB_HISTORY), np.int8),
                           x8], axis=1)
    cpu = channelize.channelize_int8(*torch.from_numpy(full))
    card = channelize.channelize_int8(*torch.from_numpy(full).cuda())
    for a, b in zip(card, cpu):
        assert a.is_cuda and a.shape == (channelize.NUM_CHANNELS, m)
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
    for staged in (False, True):
        stream = channelize.StreamingChannelizerInt8()
        outs, pos = [], 0
        for f in frames:
            i8, q8 = x8[0, pos:pos + f * 750], x8[1, pos:pos + f * 750]
            if staged:
                i_st, q_st = stream.staging(i8.shape[0])
                i_st[:], q_st[:] = i8, q8
                i8, q8 = i_st, q_st
            outs.append(stream.process(i8, q8))
            pos += f * 750
        for c in (0, 1):
            got = torch.cat([o[c] for o in outs], dim=1)
            assert got.is_cuda
            torch.testing.assert_close(got, card[c], rtol=1e-4, atol=1e-5)


def _full_band_batch(n_chan=1500, seeded=range(0, 1500, 37)):
    """(n_chan, 48000) float32 I/Q on the card: 0.05-sigma noise, a
    strong CQ K1JT FN20 in the seeded channels."""
    from rtlsdr_ft8d_tpu_torch.host.synth import synthesize_message

    gen = torch.Generator(device="cuda").manual_seed(1)
    i_b = 0.05 * torch.randn((n_chan, 48000), generator=gen, device="cuda")
    q_b = 0.05 * torch.randn((n_chan, 48000), generator=gen, device="cuda")
    sig = synthesize_message("CQ K1JT FN20", f0_hz=700.0, noise_sigma=0.0)
    idx = torch.as_tensor(list(seeded), device="cuda")
    i_b[idx] += torch.from_numpy(np.real(sig).astype(np.float32)).cuda()
    q_b[idx] += torch.from_numpy(np.imag(sig).astype(np.float32)).cuda()
    return i_b, q_b, list(seeded)


def test_decode_window_device_bank_no_host_copy(dec, monkeypatch):
    """decode_window on a (1500, 48000) batch on the card, as the wideband
    daemon hands it over: the I/Q is never copied to the host, and every
    seeded channel decodes."""
    i_b, q_b, seeded = _full_band_batch()
    big = i_b.numel()
    host_copies = []

    def spy(name):
        real = getattr(torch.Tensor, name)

        def method(self, *a, **kw):
            if self.numel() >= big and self.is_cuda and (
                    name != "to" or "cpu" in str(a) + str(kw)):
                host_copies.append((name, tuple(self.shape)))
            return real(self, *a, **kw)
        return method

    for name in ("cpu", "to", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, spy(name))
    res = decode_window((i_b, q_b), budget=4096, decoder=dec)
    assert not host_copies, host_copies
    assert len(res) == 1500
    assert all("CQ K1JT FN20" in {d.text for d in res[k]} for k in seeded)


def test_waterfall_and_sync_at_full_band(dec):
    """waterfall.cu and sync.cu at B = 1500 (the wideband batch) against
    their plain versions."""
    i_b, q_b, _ = _full_band_batch()
    i_n, q_n = normalize_peak(i_b, q_b)
    wf = waterfall.waterfall(i_n, q_n, *_wf_tables(dec))
    assert wf.shape == (1500, 92, 2, 2, 256)
    _assert_wf_close(wf, waterfall.waterfall_plain(i_n, q_n,
                                                   *_wf_tables(dec)[:3]))
    count = dec.sync_count
    v1, gidx = sync.sync_survivors(wf, count)
    want_v1, want_gidx = sync.chunk_survivors(sync.sync_scores_plain(wf,
                                                                     count))
    assert torch.equal(v1, want_v1) and torch.equal(gidx, want_gidx)


def _multipass_scene(name):
    """tests/test_torch_subtract.py's scenes: a strong burst over a 23 dB
    weaker one at overlapping tones, or one burst in noise."""
    if name == "clean":
        return synthesize_message("CQ K1JT FN20", f0_hz=700.0, amplitude=0.5,
                                  noise_sigma=0.1,
                                  rng=np.random.default_rng(9))
    rng = np.random.default_rng(7)
    return (synthesize_message("CQ K1JT FN20", f0_hz=500.0, amplitude=0.5)
            + synthesize_message("K1ABC W9XYZ EN37", f0_hz=506.25,
                                 amplitude=0.035)
            + 0.004 * (rng.standard_normal(48000)
                       + 1j * rng.standard_normal(48000))
            ).astype(np.complex64)


SUB_TEXTS = ["CQ K1JT FN20", "K1ABC W9XYZ EN37", "W9XYZ K1ABC -11",
             "K1ABC W9XYZ R-09", "W9XYZ K1ABC RRR", "CQ DX W9XYZ EN37",
             "K1ABC W9XYZ RR73", "DE VA2GKA FN35", "QRZ K9AN EN50"]


def _subtract_scene(counts, seed):
    """Windows of white noise (sigma 1), channel b holding counts[b]
    bursts in distinct 50-Hz slots of 100-1,500 Hz, up to 3 Hz and 0-1.5 s
    off the grid, at -20..+5 dB in 2,500 Hz; and their pairs in (channel,
    message) order on the grid as unpack_survivors gives them."""
    rng = np.random.default_rng(seed)
    B = len(counts)
    x = rng.standard_normal((B, 48000)) + 1j * rng.standard_normal(
        (B, 48000))
    chan, tones, fb2, st2 = [], [], [], []
    for b, count in enumerate(counts):
        for slot in rng.choice(28, size=count, replace=False):
            f0 = 100.0 + 50.0 * slot + rng.uniform(-3.0, 3.0)
            start = int(rng.integers(0, 4800))
            amp = np.sqrt(2 * 2500 / 3200 * 10 ** (rng.uniform(-20, 5) / 10))
            t = encode(pack77(SUB_TEXTS[int(rng.integers(len(SUB_TEXTS)))]))
            x[b] += synthesize_tones(t, f0_hz=f0, start_sample=start,
                                     amplitude=amp)
            chan.append(b)
            tones.append(t)
            fb2.append(int(round((f0 - 21.875) / 3.125)))
            st2.append(int(round(start / 256)))
    pairs = (np.array(chan, np.int32), np.array(tones, np.int32).reshape(
        -1, 79), np.array(fb2, np.int32), np.array(st2, np.int32))
    return (torch.from_numpy(x.real.astype(np.float32)),
            torch.from_numpy(x.imag.astype(np.float32)),
            [torch.from_numpy(a) for a in pairs])


def _scene_pairs(dec, name):
    """(i, q) on the CPU and the pairs of the port's own first pass on the
    card (multipass scenes) or of _subtract_scene."""
    if name in ("masked", "clean"):
        iq = _multipass_scene(name)
        i_s = torch.from_numpy(np.real(iq)[None].astype(np.float32))
        q_s = torch.from_numpy(np.imag(iq)[None].astype(np.float32))
        _, sub, _ = pipeline._decode_pass(dec, i_s.cuda(), q_s.cuda(), None,
                                          pipeline.NO_TIMER)
        return i_s, q_s, [torch.from_numpy(a)
                          for a in pipeline.subtraction_pairs(sub)]
    counts = {"sixteen": [16], "one": [1], "none": [0, 0],
              "deep": np.random.default_rng(11).integers(2, 8, 64)}[name]
    return _subtract_scene(list(counts), seed=len(counts))


PHASE_SCAN_CHECKED_ON = "PyTorch 2.11.0+cu128 (CUDA 12.8), H100"


def _over_65_rows(fn, *rows):
    """fn over the pairs repeated to more than 64 rows, its rows for the
    pairs: on the card PyTorch's cumsum over rows of 79 sums in the
    order the kernel follows from 65 rows on (the padded (B, 16, 79)
    layout of the JAX package's function from 5 channels on), in
    another below."""
    k = -(-65 // max(rows[0].shape[0], 1))
    out = fn(*(torch.cat([r] * k) for r in rows))
    return type(out)(*(t[:rows[0].shape[0]] for t in out)) \
        if isinstance(out, tuple) else out[:rows[0].shape[0]]


@pytest.mark.parametrize("scene", ["masked", "clean", "sixteen", "deep"])
def test_subtract_refine_equals_plain(dec, scene):
    """The refine launch against refine_pairs on the card: the same start
    and shift on every pair of the multipass scenes and of 16 bursts
    (one pair in a hundred may differ at the deep cell's ~300, where two
    shifts come within rounding of each other); where they agree f_err
    within 1e-4 relative (1e-5 Hz near 0) and f + f_err equal to
    rounding, and the gains within 1e-4 relative where f + f_err rounds
    alike, within 5e-3 where it rounds to the next float (a 1.2e-4 Hz
    step drifts the phase ~0.01 rad over the window); the start phases
    bit-equal to PyTorch's on the card at the kernel's own f_err (the
    kernel emulates torch.cumsum's scan on the card, checked on
    PHASE_SCAN_CHECKED_ON)."""
    i_s, q_s, pairs = _scene_pairs(dec, scene)
    x = (i_s.cuda(), q_s.cuda())
    card = [p.cuda() for p in pairs]
    want = _over_65_rows(lambda *p: subtract.refine_pairs(*x, *p), *card)
    before = subtract.KERNEL.launches
    got = subtract.refine_pairs_cuda(*x, *card)
    assert subtract.KERNEL.launches == before + 1
    same = (got.choice.long() == want.choice).all(-1)
    assert same.double().mean().item() >= (0.99 if scene == "deep" else 1)
    torch.testing.assert_close(got.fit[same, 0], want.fit[same, 0],
                               rtol=1e-4, atol=1e-5)
    f_hz = subtract._freqs(card[1], card[2])
    f2, f2_want = (f_hz + fit[:, 0, None] for fit in (got.fit, want.fit))
    ulps = (f2.view(torch.int32) - f2_want.view(torch.int32)).abs()
    assert ulps[same].max().item() <= 1
    g, g_want = got.fit[:, 1:], want.fit[:, 1:]
    rel = (g - g_want).norm(dim=-1) / g_want.norm(dim=-1)
    alike = same & (ulps == 0).all(-1)
    if alike.any():
        assert rel[alike].max().item() <= 1e-4
    assert rel[same].max().item() <= 5e-3
    assert torch.equal(got.phase0,
                       _over_65_rows(lambda f: subtract._phase0(f), f2)), \
        f"phases differ from torch.cumsum's on PyTorch {torch.__version__} " \
        f"(bit-equal on {PHASE_SCAN_CHECKED_ON})"


@pytest.mark.parametrize("scene", ["none", "one", "sixteen", "deep"])
def test_subtract_residual_equals_plain(dec, scene):
    """The residual launch against reconstruct on the card, both at the
    plain refinement: within 1e-5 of the window's RMS at 0, 1, 16 and
    ~300 pairs (the deep cell's shape, 64 channels); channels with no
    pair come back unchanged. subtract_pairs launches the kernel
    twice."""
    i_s, q_s, pairs = _scene_pairs(dec, scene)
    x = (i_s.cuda(), q_s.cuda())
    card = [p.cuda() for p in pairs]
    fit = subtract.refine_pairs(*x, *card)
    want = subtract.reconstruct(*x, *card[:3], fit)
    got = subtract.reconstruct_cuda(*x, *card[:3], fit)
    rms = torch.sqrt(torch.mean(i_s ** 2 + q_s ** 2) / 2).item()
    empty = sorted(set(range(i_s.shape[0])) - set(pairs[0].tolist()))
    for g, w, orig in zip(got, want, (i_s, q_s)):
        assert (g - w).abs().max().item() <= 1e-5 * rms
        assert torch.equal(g.cpu()[empty], orig[empty])
    before = subtract.KERNEL.launches
    out = subtract.subtract_pairs(*x, *card)
    assert subtract.KERNEL.launches == before + (2 if len(pairs[0]) else 0)
    assert out[0].shape == i_s.shape and torch.isfinite(out[0]).all()
    if scene == "deep":
        assert 250 <= len(pairs[0]) <= 350


def test_subtract_operand_checks(dec):
    x = torch.zeros((2, 48000), device="cuda")
    pairs = [torch.zeros(1, dtype=torch.int32, device="cuda"),
             torch.zeros((1, 79), dtype=torch.int32, device="cuda"),
             torch.zeros(1, dtype=torch.int32, device="cuda"),
             torch.zeros(1, dtype=torch.int32, device="cuda")]
    with pytest.raises(ValueError):
        subtract.subtract_pairs(x[:, :40000], x[:, :40000], *pairs)
    with pytest.raises(ValueError):
        subtract.subtract_pairs(x, x, pairs[0], pairs[1][:, :78], *pairs[2:])
    with pytest.raises(TypeError):
        subtract.subtract_pairs(x.double(), x.double(), *pairs)
    backwards = [torch.tensor([1, 0], dtype=torch.int32),
                 torch.zeros((2, 79), dtype=torch.int32),
                 torch.zeros(2, dtype=torch.int32),
                 torch.zeros(2, dtype=torch.int32)]
    with pytest.raises(ValueError, match="ascend"):
        subtract.subtract_pairs(x, x, *backwards)
