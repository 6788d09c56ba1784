"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked `cuda`; without a CUDA card every test skips. On the GPU machine,
which has no JAX (tests/conftest.py imports it), run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

These cover what chip_smoke.py's main-path shapes do not: ragged sizes
(a batch or candidate count that does not fill a block), longer rows,
leading batch shapes, out-of-window candidates, operand checks and the
launch counters. Holds as in chip_smoke.py: waterfall <= 1 step on
< 0.1% of cells, sync / s2 / BP bit-exact, LLRs within 1e-5.
"""

import os

import numpy as np
import pytest
import torch

from rtlsdr_ft8d_tpu.host.io import read_iq
from rtlsdr_ft8d_tpu.protocol.crc import add_crc
from rtlsdr_ft8d_tpu.protocol.encode import ldpc_encode
from rtlsdr_ft8d_tpu_torch.ops import build, ldpc, llr, sync, waterfall
from rtlsdr_ft8d_tpu_torch.pipeline import WindowDecoder, decode_window

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


def test_waterfall_ragged_batch_and_long_rows(dec):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 3, 48100))
                         .astype(np.float32)).cuda() * 0.1
    y = torch.from_numpy(rng.standard_normal((2, 3, 48100))
                         .astype(np.float32)).cuda() * 0.1
    bases = (dec.wf_cos, dec.wf_sin, dec.wf_cos_minus_sin)
    before = waterfall.KERNEL.launches
    got = waterfall.waterfall(x, y, *bases)
    assert waterfall.KERNEL.launches == before + 1
    assert got.shape == (2, 3, 92, 2, 2, 256)
    _assert_wf_close(got, waterfall.waterfall_plain(x, y, *bases))
    with pytest.raises(ValueError):
        waterfall.waterfall_cuda(x[..., :40000], y[..., :40000], *bases)
    with pytest.raises(TypeError):
        waterfall.waterfall_cuda(x.double(), y.double(), *bases)


def test_sync_ragged_batch(dec):
    rng = np.random.default_rng(2)
    wf = torch.from_numpy(rng.integers(0, 256, (3, 92, 2, 2, 256),
                                       dtype=np.uint8)).cuda()
    got = sync.sync_scores(wf, dec.sync_count)
    assert torch.equal(got, sync.sync_scores_plain(wf, dec.sync_count))
    top = sync.find_sync(wf, dec.sync_count)
    ref = sync.find_sync(wf.cpu(), dec.sync_count.cpu())
    for k, v in ref.items():
        assert torch.equal(top[k].cpu(), v), k


def test_llr_ragged_and_out_of_window(dec):
    rng = np.random.default_rng(3)
    wf = torch.from_numpy(rng.integers(0, 256, (3, 92, 2, 2, 256),
                                       dtype=np.uint8)).cuda()
    n = 61
    cand = {"time_sub": rng.integers(0, 2, n),
            "freq_sub": rng.integers(0, 2, n),
            "time_offset": rng.integers(-14, 26, n),    # some get clipped
            "freq_offset": rng.integers(0, 252, n)}
    cand = {k: torch.from_numpy(v).cuda() for k, v in cand.items()}
    chan = torch.from_numpy(rng.integers(0, 3, n)).cuda()
    s2_k, v_k, l_k = llr.tone_llrs(wf, cand, chan)
    s2_p, v_p, l_p = llr.tone_llrs_plain(wf, cand, chan)
    assert torch.equal(s2_k, s2_p) and torch.equal(v_k, v_p)
    torch.testing.assert_close(l_k, l_p, rtol=1e-5, atol=1e-5)
    snr_k = llr.estimate_snr_flat(wf, cand, chan)
    snr_p = llr.estimate_snr_flat(wf.cpu(), {k: v.cpu() for k, v in
                                             cand.items()}, chan.cpu())
    torch.testing.assert_close(snr_k.cpu(), snr_p, rtol=0, atol=1e-3)


def test_bp_ragged_batch_shape_and_posterior(dec):
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
    for post in (False, True):
        got = ldpc.bp_decode(x, *graph, 20, post)
        ref = ldpc.bp_decode_plain(x, *graph, 20, post)
        assert got[0].shape == (2, 31, 174) and got[1].shape == (2, 31)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    assert int((got[1] == 0).sum()) >= 10


def test_decode_window_cuda_equals_cpu(dec):
    iq = read_iq(os.path.join(FIX, "golden_10sig.iq"))
    before = {n: k.launches for n, k in build.KERNELS.items()}
    on_card = decode_window(iq, decoder=dec)
    assert all(k.launches > before[n] for n, k in build.KERNELS.items())
    on_cpu = decode_window(iq, device="cpu")
    assert [(d.text, d.freq_hz, d.time_sec, d.score) for d in on_card] == \
        [(d.text, d.freq_hz, d.time_sec, d.score) for d in on_cpu]
