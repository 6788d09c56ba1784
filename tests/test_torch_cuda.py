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
tiles and on chunks shorter than its history. Holds as in
chip_smoke.py: waterfall <= 1 step on < 0.1% of cells, sync / s2 / BP
bit-exact, LLRs within 1e-5, the int8 decimator within rtol 1e-4,
atol 1e-5 of its plain version.
"""

import os

import numpy as np
import pytest
import torch

from rtlsdr_ft8d_tpu_torch.host.io import read_iq
from rtlsdr_ft8d_tpu_torch.ops import (build, decimate, ldpc, llr, sync,
                                       tables, waterfall)
from rtlsdr_ft8d_tpu_torch.pipeline import WindowDecoder, decode_window
from rtlsdr_ft8d_tpu_torch.protocol.crc import add_crc
from rtlsdr_ft8d_tpu_torch.protocol.encode import ldpc_encode

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
