"""The port's plain waterfall against the JAX formulations and the naive
reference.

Same inputs (numpy, seeded) through waterfall_plain, the JAX XLA
waterfall, the Pallas kernel in interpret mode and
tests/reference_impl.waterfall_ref. Hold: the criterion of
tests/test_kernels_vs_reference.py:37-43 — at most one quantization step
on any cell and more than 99.9% of cells exact (float32 products summed
in another order, and log10 ulps, can flip cells that sit on a step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtlsdr_ft8d_tpu.host.synth import synthesize_message
from rtlsdr_ft8d_tpu.ops.waterfall import waterfall_xla
from rtlsdr_ft8d_tpu.ops.waterfall_pallas import waterfall_pallas
from rtlsdr_ft8d_tpu_torch.ops import tables
from rtlsdr_ft8d_tpu_torch.ops.waterfall import waterfall, waterfall_plain

from . import reference_impl as ref
from .torch_cpu import few_torch_threads  # noqa: F401


def _assert_close(a, b):
    d = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
    assert d.max() <= 1, d.max()
    assert (d == 0).mean() > 0.999, (d == 0).mean()


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(21)
    return np.stack([synthesize_message(
        "CQ K1JT FN20", f0_hz=300 + 250 * b, noise_sigma=0.3, rng=rng)
        for b in range(2)])


@pytest.fixture(scope="module")
def port_wf(batch):
    cos, sin, cms = (torch.from_numpy(a) for a in tables.dft_bases())
    i_t = torch.from_numpy(np.real(batch).astype(np.float32))
    q_t = torch.from_numpy(np.imag(batch).astype(np.float32))
    out = waterfall_plain(i_t, q_t, cos, sin, cms)
    assert out.dtype == torch.uint8 and out.shape == (2, 92, 2, 2, 256)
    # a CPU tensor dispatches to the plain version
    assert torch.equal(waterfall(i_t, q_t, cos, sin, cms), out)
    return out.numpy()


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_plain_waterfall_matches_jax(batch, port_wf, impl):
    i_s = jnp.asarray(np.real(batch).astype(np.float32))
    q_s = jnp.asarray(np.imag(batch).astype(np.float32))
    fn = jax.jit(waterfall_xla) if impl == "xla" else waterfall_pallas
    _assert_close(port_wf, fn(i_s, q_s))


def test_plain_waterfall_matches_naive_reference(batch, port_wf):
    _assert_close(port_wf[1], ref.waterfall_ref(batch[1]))


def test_plain_waterfall_keeps_batch_shape():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 1, 48000)).astype(np.float32)
    cos, sin, cms = (torch.from_numpy(a) for a in tables.dft_bases())
    t = torch.from_numpy(x)
    out = waterfall_plain(t, t, cos, sin, cms)
    assert out.shape == (2, 1, 92, 2, 2, 256)
    flat = waterfall_plain(t[:, 0], t[:, 0], cos, sin, cms)
    assert torch.equal(out[:, 0], flat)
