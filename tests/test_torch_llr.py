"""The port's tone magnitudes, LLRs and SNR estimates against the JAX
package.

s2 masked by `valid` must be bit-identical to the XLA gather and to the
Pallas kernel in interpret mode (integers <= 255); LLRs agree within
rtol = atol = 1e-5 (the variance normalization may round differently
after its sums) and SNR estimates within 1e-3 dB.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtlsdr_ft8d_tpu.ops.llr import _llrs_from_mags as jax_llrs_from_mags
from rtlsdr_ft8d_tpu.ops.llr import _tone_mags_flat_xla
from rtlsdr_ft8d_tpu.ops.llr import estimate_snr as jax_estimate_snr
from rtlsdr_ft8d_tpu.ops.llr import estimate_snr_flat as jax_snr_flat
from rtlsdr_ft8d_tpu.ops.llr import extract_llrs as jax_extract_llrs
from rtlsdr_ft8d_tpu.ops.llr import extract_llrs_flat as jax_llrs_flat
from rtlsdr_ft8d_tpu.ops.llr_pallas import tone_mags_flat_pallas
from rtlsdr_ft8d_tpu.ops.sync import find_sync as jax_find_sync
from rtlsdr_ft8d_tpu_torch.ops import llr

from .torch_cpu import few_torch_threads  # noqa: F401

KEYS = ("time_sub", "freq_sub", "time_offset", "freq_offset")


def _random(rng, n, b):
    cand = {"time_sub": rng.integers(0, 2, n),
            "freq_sub": rng.integers(0, 2, n),
            "time_offset": rng.integers(-12, 24, n),
            "freq_offset": rng.integers(0, 249, n)}
    return ({k: v.astype(np.int32) for k, v in cand.items()},
            rng.integers(0, b, n).astype(np.int32))


def _edges(b):
    # every (to, fo) extreme, including fully and partly out-of-window dts
    rows = np.array([(t, f, ts, fs) for t in (-12, -11, -5, 0, 11, 23)
                     for f in (0, 1, 247, 248) for ts in (0, 1)
                     for fs in (0, 1)], np.int32)
    cand = {"time_offset": rows[:, 0], "freq_offset": rows[:, 1],
            "time_sub": rows[:, 2], "freq_sub": rows[:, 3]}
    return cand, (np.arange(len(rows)) % b).astype(np.int32)


@pytest.fixture(scope="module")
def wf():
    return np.random.default_rng(7).integers(
        0, 256, (3, 92, 2, 2, 256), dtype=np.uint8)


def _cands(maker, b):
    return _edges(b) if maker == "edges" else \
        _random(np.random.default_rng(11), 61, b)


def _port(wf, cand, chan):
    return llr.tone_llrs(torch.from_numpy(wf),
                         {k: torch.from_numpy(v) for k, v in cand.items()},
                         torch.from_numpy(chan))


def _jax(cand, chan):
    return {k: jnp.asarray(v) for k, v in cand.items()}, jnp.asarray(chan)


@pytest.mark.parametrize("maker", ["random", "edges"])
@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_masked_s2_bit_identical(wf, maker, impl):
    cand, chan = _cands(maker, wf.shape[0])
    s2, valid, _ = _port(wf, cand, chan)
    fn = _tone_mags_flat_xla if impl == "xla" else tone_mags_flat_pallas
    s2_j, valid_j = fn(jnp.asarray(wf), *_jax(cand, chan))
    assert np.array_equal(valid.numpy(), np.asarray(valid_j))
    vm = valid.numpy()[..., None]
    assert np.array_equal(s2.numpy() * vm, np.asarray(s2_j) * vm)
    # out-of-window symbols read as zero, as in the Pallas kernel
    assert not s2.numpy()[~valid.numpy()].any()


@pytest.mark.parametrize("maker", ["random", "edges"])
def test_llrs_match(wf, maker):
    cand, chan = _cands(maker, wf.shape[0])
    _, _, got = _port(wf, cand, chan)
    want = np.asarray(jax_llrs_flat(jnp.asarray(wf), *_jax(cand, chan)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    cand_t = {k: torch.from_numpy(v) for k, v in cand.items()}
    flat = llr.extract_llrs_flat(torch.from_numpy(wf), cand_t,
                                 torch.from_numpy(chan))
    assert torch.equal(flat, got)


def test_llrs_from_mags_matches_jax(wf):
    cand, chan = _cands("random", wf.shape[0])
    s2_j, valid_j = _tone_mags_flat_xla(jnp.asarray(wf), *_jax(cand, chan))
    got = llr._llrs_from_mags(torch.from_numpy(np.array(s2_j)),
                              torch.from_numpy(np.array(valid_j)))
    want = np.asarray(jax_llrs_from_mags(s2_j, valid_j))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("maker", ["random", "edges"])
def test_snr_flat_matches(wf, maker):
    cand, chan = _cands(maker, wf.shape[0])
    cand_t = {k: torch.from_numpy(v) for k, v in cand.items()}
    got = llr.estimate_snr_flat(torch.from_numpy(wf), cand_t,
                                torch.from_numpy(chan))
    want = np.asarray(jax_snr_flat(jnp.asarray(wf), *_jax(cand, chan)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


def test_grid_llrs_and_snr_on_find_sync_candidates(wf):
    cand_j = jax_find_sync(jnp.asarray(wf))
    cand = {k: torch.from_numpy(np.asarray(cand_j[k]).astype(np.int64))
            for k in KEYS}
    w = torch.from_numpy(wf)
    np.testing.assert_allclose(
        llr.extract_llrs(w, cand).numpy(),
        np.asarray(jax_extract_llrs(jnp.asarray(wf), cand_j)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        llr.estimate_snr(w, cand).numpy(),
        np.asarray(jax_estimate_snr(jnp.asarray(wf), cand_j)),
        rtol=0, atol=1e-3)
