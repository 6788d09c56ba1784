"""The port's sync scores and top-K search against the JAX package.

Scores are integer math and must be bit-identical to the JAX difference-
plane algebra and to the Pallas kernel in interpret mode. find_sync's
candidate dicts must be identical IN ORDER, which needs jax.lax.top_k's
tie rule (lower index first) — a waterfall built to tie tests it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtlsdr_ft8d_tpu.host.synth import synthesize_message
from rtlsdr_ft8d_tpu.ops.sync import find_sync as jax_find_sync
from rtlsdr_ft8d_tpu.ops.sync import sync_scores as jax_sync_scores
from rtlsdr_ft8d_tpu.ops.sync_pallas import sync_scores_pallas
from rtlsdr_ft8d_tpu.ops.waterfall import waterfall_xla
from rtlsdr_ft8d_tpu_torch.ops import tables
from rtlsdr_ft8d_tpu_torch.ops.sync import (find_sync, sync_scores,
                                            sync_scores_plain, top_k)

from .torch_cpu import few_torch_threads  # noqa: F401

COUNT = torch.from_numpy(tables.sync_count())
KEYS = ("score", "time_sub", "freq_sub", "time_offset", "freq_offset")


NAMES = ["flat", "signal", "ties"]


@pytest.fixture(scope="module")
def waterfalls():
    rng = np.random.default_rng(12)
    sig = np.stack([synthesize_message(
        "CQ K1JT FN20", f0_hz=300 + 77 * b, noise_sigma=0.4, rng=rng)
        for b in range(2)])
    wf_sig = np.array(jax.jit(waterfall_xla)(
        jnp.asarray(np.real(sig).astype(np.float32)),
        jnp.asarray(np.imag(sig).astype(np.float32))))
    # few distinct levels: integer scores tie everywhere
    ties = rng.integers(100, 103, (2, 92, 2, 2, 256)).astype(np.uint8)
    flat = np.full((1, 92, 2, 2, 256), 7, np.uint8)       # every score 0
    return {"signal": wf_sig, "ties": ties, "flat": flat}


@pytest.mark.parametrize("name", NAMES)
def test_scores_bit_exact(waterfalls, name):
    wf = waterfalls[name]
    mine = sync_scores_plain(torch.from_numpy(wf), COUNT)
    assert mine.dtype == torch.int32
    assert torch.equal(sync_scores(torch.from_numpy(wf), COUNT), mine)
    assert np.array_equal(mine.numpy(),
                          np.asarray(jax_sync_scores(jnp.asarray(wf))))
    assert np.array_equal(mine.numpy(),
                          np.asarray(sync_scores_pallas(jnp.asarray(wf))))


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_find_sync_identical_in_order(waterfalls, name, exact):
    wf = waterfalls[name]
    mine = find_sync(torch.from_numpy(wf), COUNT, exact=exact)
    ref = jax_find_sync(jnp.asarray(wf), exact=exact)
    for k in KEYS:
        assert np.array_equal(mine[k].numpy(), np.asarray(ref[k])), k


def test_top_k_takes_lower_index_first():
    x = torch.tensor([3, 5, 5, 1, 5, 3, 3, 0, 5])
    vals, idx = top_k(x, 5)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 5)
    assert idx.tolist() == np.asarray(ji).tolist() == [1, 2, 4, 8, 0]
    assert vals.tolist() == np.asarray(jv).tolist()
    neg = torch.tensor([[-2, -1, -1, -(1 << 20), -2]])
    assert top_k(neg, 4)[1].tolist() == [[1, 2, 0, 4]]
