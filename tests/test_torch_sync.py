"""The port's sync scores and top-K search against the JAX package.

Scores are integer math and must be bit-identical to the JAX difference-
plane algebra and to the Pallas kernel in interpret mode. find_sync's
candidate dicts must be identical IN ORDER, which needs jax.lax.top_k's
tie rule (lower index first) — a waterfall built to tie tests it. The
first top-K stage, which csrc/sync.cu fuses into the score kernel, is
held to the JAX stage, and a numpy model of the kernel's half-warp rank
selection is held to top_k.
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
from rtlsdr_ft8d_tpu_torch.ops.sync import (CHUNK, CHUNK_K, NUM_SURVIVORS,
                                            PAD_WIDTH, chunk_survivors,
                                            find_sync, sync_scores,
                                            sync_scores_plain, sync_survivors,
                                            top_k)

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


def _jax_first_stage(scores):
    """rtlsdr_ft8d_tpu/ops/sync.py:163-176 on a (B, 2, 2, 36, 249) grid."""
    sp = jnp.pad(jnp.asarray(scores),
                 [(0, 0)] * 4 + [(0, PAD_WIDTH - scores.shape[-1])],
                 constant_values=-(1 << 20))
    chunks = sp.reshape(scores.shape[0], -1, CHUNK)
    v1, i1 = jax.lax.top_k(chunks, CHUNK_K)
    gidx = i1 + (jnp.arange(chunks.shape[1]) * CHUNK)[:, None]
    return (np.asarray(v1).reshape(scores.shape[0], -1),
            np.asarray(gidx).reshape(scores.shape[0], -1))


def _half_warp_top(chunks):
    """Numpy model of csrc/sync.cu's selection: lane `pos` of a 16-lane
    chunk forms the unique key score * 16 + (15 - pos) and ranks itself
    by comparing with the other 15 lanes; ranks < CHUNK_K write slot
    `rank`. (..., 16) int scores -> (values, positions), (..., CHUNK_K)."""
    chunks = np.asarray(chunks, np.int64)
    pos = np.arange(CHUNK)
    key = chunks * CHUNK + (CHUNK - 1 - pos)
    rank = (key[..., None, :] > key[..., :, None]).sum(-1)
    vals = np.zeros(chunks.shape[:-1] + (CHUNK_K,), np.int64)
    idx = np.zeros_like(vals)
    for lane in range(CHUNK):
        r = rank[..., lane]
        for k in range(CHUNK_K):
            hit = r == k
            vals[..., k] = np.where(hit, chunks[..., lane], vals[..., k])
            idx[..., k] = np.where(hit, lane, idx[..., k])
    return vals, idx


@pytest.mark.parametrize("name", NAMES)
def test_chunk_survivors_match_jax_first_stage(waterfalls, name):
    scores = sync_scores_plain(torch.from_numpy(waterfalls[name]), COUNT)
    v1, gidx = chunk_survivors(scores)
    assert v1.dtype == gidx.dtype == torch.int32
    assert v1.shape == (scores.shape[0], NUM_SURVIVORS)
    want_v1, want_gidx = _jax_first_stage(scores.numpy())
    assert np.array_equal(v1.numpy(), want_v1)
    assert np.array_equal(gidx.numpy(), want_gidx)
    got = sync_survivors(torch.from_numpy(waterfalls[name]), COUNT)
    assert torch.equal(got[0], v1) and torch.equal(got[1], gidx)


@pytest.mark.parametrize("name", NAMES)
def test_half_warp_model_on_score_grids(waterfalls, name):
    """The kernel's selection, modelled over whole padded score grids,
    gives chunk_survivors' (v1, gidx) in order."""
    scores = sync_scores_plain(torch.from_numpy(waterfalls[name]), COUNT)
    sp = np.pad(scores.numpy(), [(0, 0)] * 4 + [(0, PAD_WIDTH - 249)],
                constant_values=-(1 << 20))
    chunks = sp.reshape(sp.shape[0], -1, CHUNK)
    vals, pos = _half_warp_top(chunks)
    gidx = pos + (np.arange(chunks.shape[1]) * CHUNK)[:, None]
    v1, want_gidx = chunk_survivors(scores)
    assert np.array_equal(vals.reshape(sp.shape[0], -1), v1.numpy())
    assert np.array_equal(gidx.reshape(sp.shape[0], -1), want_gidx.numpy())


@pytest.mark.parametrize("levels", [1, 2, 3, 40])
def test_half_warp_model_matches_top_k_with_ties(levels):
    """Random int chunks over few levels (heavy ties; 1 level = all
    equal), negative scores and the pad value among them."""
    rng = np.random.default_rng(levels)
    chunks = rng.integers(-levels // 2, levels - levels // 2, (500, CHUNK))
    chunks[::7, -3:] = -(1 << 20)
    vals, idx = _half_warp_top(chunks)
    tv, ti = top_k(torch.from_numpy(chunks), CHUNK_K)
    jv, ji = jax.lax.top_k(jnp.asarray(chunks.astype(np.int32)), CHUNK_K)
    assert np.array_equal(idx, ti.numpy()) and np.array_equal(idx, ji)
    assert np.array_equal(vals, tv.numpy()) and np.array_equal(vals, jv)
