"""The port's static tables, its JAX-free imports and its dispatch rule.

The tables built with numpy alone (rtlsdr_ft8d_tpu_torch/ops/tables.py)
must equal the JAX modules' own constants bit for bit; the port's
modules must load without jax; ops/build.py must raise, never fall
back, when the kernels cannot be built or launched; and CPU tensors must
never reach a kernel.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rtlsdr_ft8d_tpu.ops import ldpc as jldpc
from rtlsdr_ft8d_tpu.ops import sync as jsync
from rtlsdr_ft8d_tpu.ops import waterfall as jwf
from rtlsdr_ft8d_tpu_torch.ops import build, tables
from rtlsdr_ft8d_tpu_torch.pipeline import WindowDecoder

from .torch_cpu import few_torch_threads  # noqa: F401


def _jax_arrays():
    return {"wf_cos": jwf._COS, "wf_sin": jwf._SIN,
            "wf_cos_minus_sin": jwf._COS_MINUS_SIN,
            "sync_count": jsync._COUNT, "ldpc_nm": jldpc._NM,
            "ldpc_mn": jldpc._MN, "ldpc_nm_pos": jldpc._NM_POS,
            "crc_mat": jldpc._CRC_MAT}


@pytest.mark.parametrize("key", sorted(tables.SPEC))
def test_table_equals_jax_constant(key):
    mine = tables.reference_arrays()[key]
    ref = np.asarray(_jax_arrays()[key])
    assert mine.shape == ref.shape and mine.dtype == ref.dtype
    assert np.array_equal(mine, ref)


def test_from_reference_round_trips_and_accepts_jax_arrays():
    arrays = tables.reference_arrays()
    bufs = tables.from_reference(arrays)
    for k, a in arrays.items():
        assert np.array_equal(bufs[k].numpy(), a), k
    from_jax = tables.from_reference(_jax_arrays())
    for k, t in bufs.items():
        assert torch.equal(from_jax[k], t), k
    # the derived edge maps invert each other on every message slot
    slot = bufs["ldpc_edge_slot"].long()
    edge = bufs["ldpc_slot_edge"]
    assert torch.equal(slot[edge], torch.arange(522))
    with pytest.raises(ValueError):
        tables.from_reference({**arrays, "sync_count": np.ones(5, np.int32)})


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import rtlsdr_ft8d_tpu_torch.pipeline\n"
            "import rtlsdr_ft8d_tpu_torch.host.cli\n"
            "import rtlsdr_ft8d_tpu_torch.host.selftest\n"
            "assert 'jax' not in sys.modules, sorted(\n"
            "    m for m in sys.modules if m.split('.')[0] == 'jax')\n"
            "print('no jax')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=root)
    assert out.returncode == 0 and "no jax" in out.stdout, out.stderr


def test_load_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build.load()


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_NVCC_TOOLKIT_PATH", str(tmp_path / "nvcc"))
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load()
    assert not list(tmp_path.iterdir())


def test_dispatch_rule():
    assert build.on_cuda(torch.zeros(1)) is False
    with pytest.raises(ValueError):
        build.on_cuda(torch.zeros(1, device="meta"))
    with pytest.raises(ValueError):
        build.check(torch.zeros(3), torch.float32)     # not on CUDA


def test_cpu_tensors_never_launch_a_kernel():
    assert sorted(build.KERNELS) == ["bp", "llr", "sync", "waterfall"]
    for k in build.KERNELS.values():
        k.launches = 0
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 48000)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((2, 48000)).astype(np.float32))
    dec = WindowDecoder()
    with torch.no_grad():
        dec(x, y)
        dec(x, y, budget=64)
    assert {n: k.launches for n, k in build.KERNELS.items()} == \
        {"bp": 0, "llr": 0, "sync": 0, "waterfall": 0}
