"""The port's BP decoder and CRC check against the JAX package.

On the codeword-and-noise set of tests/test_kernels_vs_reference.py:
135-145 the plain port must give the same error counts as the XLA
decoder and the Pallas kernel in interpret mode, the same hard bits on
every success, and posteriors within 1e-4 (float32 rational tanh/atanh
evaluated in another order). crc_check must equal the JAX function.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtlsdr_ft8d_tpu.ops.ldpc import bp_decode_xla
from rtlsdr_ft8d_tpu.ops.ldpc import crc_check as jax_crc_check
from rtlsdr_ft8d_tpu.ops.ldpc_pallas import bp_decode_pallas
from rtlsdr_ft8d_tpu.protocol.crc import add_crc
from rtlsdr_ft8d_tpu.protocol.encode import ldpc_encode
from rtlsdr_ft8d_tpu_torch.ops import ldpc, tables

from .torch_cpu import few_torch_threads  # noqa: F401

BUF = tables.from_reference(tables.reference_arrays())
GRAPH = (BUF["ldpc_edge_var"], BUF["ldpc_edge_slot"], BUF["ldpc_slot_edge"])


def _bp(llr, **kw):
    return ldpc.bp_decode(torch.from_numpy(np.asarray(llr, np.float32)),
                          *GRAPH, **kw)


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(7)
    out = []
    for t in range(40):
        payload = rng.integers(0, 2, 77).astype(np.uint8)
        cw = ldpc_encode(add_crc(payload)).astype(np.float32)
        scale = [4.0, 1.2, 0.7][t % 3]
        out.append((2.0 * cw - 1.0) * scale
                   + rng.normal(0, 1.0, 174).astype(np.float32))
    for _ in range(24):
        out.append(rng.normal(0, 2.0, 174).astype(np.float32))
    return np.stack(out) * 2.0


@pytest.fixture(scope="module")
def port_out(rows):
    h, e, p = _bp(rows, return_posterior=True)
    assert h.dtype == torch.int8 and e.dtype == torch.int32
    return h.numpy(), e.numpy(), p.numpy()


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_bp_matches_jax(rows, port_out, impl):
    fn = bp_decode_xla if impl == "xla" else bp_decode_pallas
    h_j, e_j, p_j = map(np.asarray, fn(jnp.asarray(rows), 20,
                                       return_posterior=True))
    h, e, p = port_out
    assert (e == e_j).all(), np.nonzero(e != e_j)
    ok = e == 0
    assert ok.sum() >= 14
    assert (h[ok] == h_j[ok]).all()
    np.testing.assert_allclose(p, p_j, rtol=0, atol=1e-4)


def test_bp_without_posterior_and_batch_shape(rows, port_out):
    h, e = _bp(rows.reshape(4, 16, 174))
    assert h.shape == (4, 16, 174) and e.shape == (4, 16)
    assert np.array_equal(h.numpy().reshape(64, 174), port_out[0])
    assert np.array_equal(e.numpy().reshape(64), port_out[1])


def test_bp_early_exit_matches_fixed_iterations(rows):
    """csrc/ldpc.cu stops a codeword (when no posterior is asked for) at
    its first iteration whose best error count is 0. A plain BP that
    freezes each row there gives the fixed-20 hard bits and errors:
    best_err only drops on a strict '<', so nothing changes after it."""
    x = torch.from_numpy(rows)
    h20, e20 = ldpc.bp_decode_plain(x, *GRAPH, 20)
    hard, errors = h20.clone(), e20.clone()
    stop_at = np.full(len(rows), 20)
    for it in range(19, 0, -1):
        h, e = ldpc.bp_decode_plain(x, *GRAPH, it)
        stop = e == 0
        hard[stop], errors[stop] = h[stop], e[stop]
        stop_at[stop.numpy()] = it
    assert torch.equal(hard, h20) and torch.equal(errors, e20)
    assert (stop_at[e20.numpy() == 0] < 10).sum() >= 14


def test_bp_decodes_clean_codeword():
    rng = np.random.default_rng(5)
    msg = rng.integers(0, 2, 91).astype(np.uint8)
    cw = ldpc_encode(msg)
    hard, err = _bp(((2.0 * cw.astype(np.float32) - 1.0) * 4.0)[None])
    assert int(err[0]) == 0
    assert np.array_equal(hard[0].numpy(), cw)


def test_bp_corrects_noisy_codeword():
    rng = np.random.default_rng(6)
    msg = np.zeros(77, dtype=np.uint8)
    msg[::5] = 1
    cw = ldpc_encode(add_crc(msg))
    llr = (2.0 * cw.astype(np.float32) - 1.0) * 2.0
    llr += rng.normal(0, 1.3, size=174).astype(np.float32)
    hard, err = _bp(llr[None])
    assert int(err[0]) == 0
    assert np.array_equal(hard[0].numpy(), cw)
    assert bool(ldpc.crc_check(hard, BUF["crc_mat"])[0])


def test_crc_check_matches_jax():
    rng = np.random.default_rng(13)
    hard = rng.integers(0, 2, (256, 174)).astype(np.int8)
    for r in range(0, 256, 4):           # a quarter carry a valid CRC
        hard[r, :91] = add_crc(rng.integers(0, 2, 77).astype(np.uint8))
    got = ldpc.crc_check(torch.from_numpy(hard), BUF["crc_mat"]).numpy()
    want = np.asarray(jax_crc_check(jnp.asarray(hard)))
    assert np.array_equal(got, want)
    assert got.sum() >= 64
