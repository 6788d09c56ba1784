"""The port stands alone: it imports nothing of the JAX package.

1. No module of rtlsdr_ft8d_tpu_torch/ (parallel/ included) and not
   chip_smoke.py imports rtlsdr_ft8d_tpu (the JAX package) or jax, at
   top level or inside a function (an AST scan of every `import` and
   `from` statement).
2. Importing the port's entry points and its parallel modules loads
   neither (a fresh interpreter).
3. The port's copies of the JAX package's JAX-free modules
   (rtlsdr_ft8d_tpu_torch/protocol/, host/{io,log,reporter,sources,synth},
   host/cli's band plan and parsers, native.py, the numpy half of
   ops/ap.py, ops/osd.py, the channelizer's tables and helpers in
   ops/channelize.py and pipeline.ap_prefix_for_call) give what their
   originals give: constants and parity tables, CRC, LDPC encoding,
   pack77 and unpack77 over the message forms of tests/test_pack_unpack.py,
   batched spot unpack, synthesized samples for a fixed seed, the AP
   gate's constants and clamp rows, OSD's encoding matrix, flip-pair
   order and CRC matrix, the channelizer's constants, bank, DFT bases
   and twiddle (the last three in tests/test_torch_channelize.py), and
   the subtraction's constants.
"""

import ast
import glob
import os
import subprocess
import sys

import numpy as np
import pytest

from rtlsdr_ft8d_tpu.host import cli as ref_cli
from rtlsdr_ft8d_tpu.host import io as ref_io
from rtlsdr_ft8d_tpu.host import synth as ref_synth
from rtlsdr_ft8d_tpu.ops import ap as ref_ap
from rtlsdr_ft8d_tpu.ops import channelize as ref_channelize
from rtlsdr_ft8d_tpu.ops import ldpc as ref_ldpc
from rtlsdr_ft8d_tpu.ops import osd as ref_osd
from rtlsdr_ft8d_tpu.ops import subtract as ref_subtract
from rtlsdr_ft8d_tpu.pipeline import ap_prefix_for_call as ref_prefix
from rtlsdr_ft8d_tpu.protocol import constants as ref_constants
from rtlsdr_ft8d_tpu.protocol import crc as ref_crc
from rtlsdr_ft8d_tpu.protocol import encode as ref_encode
from rtlsdr_ft8d_tpu.protocol import pack as ref_pack
from rtlsdr_ft8d_tpu.protocol import parity_tables as ref_parity
from rtlsdr_ft8d_tpu.protocol import text as ref_text
from rtlsdr_ft8d_tpu.protocol import unpack as ref_unpack
from rtlsdr_ft8d_tpu_torch.host import cli, io, synth
from rtlsdr_ft8d_tpu_torch.ops import ap, channelize, osd, subtract
from rtlsdr_ft8d_tpu_torch.pipeline import ap_prefix_for_call
from rtlsdr_ft8d_tpu_torch.protocol import (constants, crc, encode, pack,
                                            parity_tables, text, unpack)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(
    os.path.relpath(p, ROOT) for p in
    glob.glob(os.path.join(ROOT, "rtlsdr_ft8d_tpu_torch", "**", "*.py"),
              recursive=True)) + ["chip_smoke.py"]
MESSAGES = [
    "CQ K1JT FN20", "CQ K1JT FN20QI", "CQ DX W9XYZ EN37", "K1ABC W9XYZ EN37",
    "W9XYZ K1ABC -11", "K1ABC W9XYZ R-09", "W9XYZ K1ABC RRR",
    "K1ABC W9XYZ 73", "K1ABC W9XYZ RR73", "CQ TEST K1ABC/R FN42",
    "K1ABC/R W9XYZ/R RR73", "DE VA2GKA FN35", "QRZ K9AN EN50",
    "CQ 021 K1ABC FN42", "TNX BOB 73 GL", "CQ VA2GKA/P FN35",
    "CQ PJ4/K1ABC"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "rtlsdr_ft8d_tpu")


@pytest.mark.parametrize("path", PORT_FILES)
def test_no_import_of_jax_or_the_jax_package(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


REFERENCE_FILES = sorted(
    os.path.relpath(p, ROOT) for p in
    glob.glob(os.path.join(ROOT, "benchmark", "reference", "**", "*.py"),
              recursive=True))


@pytest.mark.parametrize("path", REFERENCE_FILES)
def test_benchmark_reference_imports_neither_jax_nor_the_port(path):
    """The benchmark's plain reference (the deep decode's included)
    imports no JAX, nothing of the JAX package and nothing of the port,
    so no kernel of the port either."""
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        names = ([a.name for a in node.names]
                 if isinstance(node, ast.Import) else
                 [node.module or ""] if isinstance(node, ast.ImportFrom)
                 and node.level == 0 else [])
        bad += [n for n in names if _forbidden(n)
                or n.split(".")[0] == "rtlsdr_ft8d_tpu_torch"]
    assert not bad, f"{path} imports {bad}"


def test_benchmark_deep_reference_loads_alone():
    code = ("import sys\n"
            "sys.path.insert(0, 'benchmark')\n"
            "import reference.deep, reference.tracker\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "    ('jax', 'rtlsdr_ft8d_tpu', 'rtlsdr_ft8d_tpu_torch'))\n"
            "assert not bad, bad\n"
            "print('standalone')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=ROOT)
    assert out.returncode == 0 and "standalone" in out.stdout, out.stderr


def test_entry_points_load_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            "import rtlsdr_ft8d_tpu_torch.pipeline\n"
            "import rtlsdr_ft8d_tpu_torch.host.cli\n"
            "import rtlsdr_ft8d_tpu_torch.host.daemon\n"
            "import rtlsdr_ft8d_tpu_torch.host.selftest\n"
            "import rtlsdr_ft8d_tpu_torch.ops.channelize\n"
            "import rtlsdr_ft8d_tpu_torch.parallel.sharding\n"
            "import rtlsdr_ft8d_tpu_torch.parallel.dense\n"
            "import rtlsdr_ft8d_tpu_torch.parallel.elastic\n"
            "import rtlsdr_ft8d_tpu_torch.parallel.halo\n"
            "import rtlsdr_ft8d_tpu_torch.parallel.distributed\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'rtlsdr_ft8d_tpu'))\n"
            "assert not bad, bad\n"
            "print('standalone')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=ROOT, env=env)
    assert out.returncode == 0 and "standalone" in out.stdout, out.stderr


def _public(module):
    return sorted(n for n in vars(module) if n.isupper())


# the upper-case names a copied module adds to its original's: the handles
# of the OSD and subtraction kernels (csrc/osd.cu, csrc/subtract.cu), which
# the JAX package does not have
PORT_NAMES = {"osd": {"KERNEL"}, "subtract": {"KERNEL"}}


@pytest.mark.parametrize("mine,ref", [(constants, ref_constants),
                                      (parity_tables, ref_parity),
                                      (text, ref_text), (ap, ref_ap),
                                      (osd, ref_osd),
                                      (channelize, ref_channelize),
                                      (subtract, ref_subtract)],
                         ids=["constants", "parity_tables", "text", "ap",
                              "osd", "channelize", "subtract"])
def test_tables_equal(mine, ref):
    extra = PORT_NAMES.get(mine.__name__.rsplit(".", 1)[-1], set())
    assert _public(mine) == sorted(set(_public(ref)) | extra)
    for name in _public(ref):
        a, b = getattr(mine, name), getattr(ref, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        else:
            assert a == b, name


@pytest.mark.parametrize("call", ["K1ABC", "VA2GKA/P", "PJ4/K1ABC", "CQ"])
def test_ap_clamp_rows_equal(call):
    mine, ref = ap_prefix_for_call(call), ref_prefix(call)
    assert (mine is None) == (ref is None)
    if ref is not None:
        assert np.array_equal(mine, ref)
    assert np.array_equal(ap.clamp_row_cq(), ref_ap.clamp_row_cq())


@pytest.mark.parametrize("pair_depth", [0, 3, 10])
def test_osd_tables_equal(pair_depth):
    assert np.array_equal(osd.encode_matrix(), ref_osd.encode_matrix())
    for a, b in zip(osd.pair_indices(pair_depth),
                    ref_osd.pair_indices(pair_depth)):
        assert np.array_equal(a, b)
    assert np.array_equal(osd._crc_mat(),
                          ref_ldpc._CRC_MAT.astype(np.float32))


def test_band_plan_and_frequency_parsing_equal():
    assert (cli.BAND_PLAN, cli.VERSION) == (ref_cli.BAND_PLAN,
                                            ref_cli.VERSION)
    for value, ds in (("20m", 0), ("6m", 0), ("20m", 1), ("14.074M", 0),
                      ("7074k", 2), ("50313000", 0)):
        assert cli.parse_frequency(value, ds) == \
            ref_cli.parse_frequency(value, ds)
    assert cli.atofs("1.5G") == ref_cli.atofs("1.5G")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crc_and_ldpc_encode_equal(seed):
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 2, 77).astype(np.uint8)
    assert crc.payload_crc(payload) == ref_crc.payload_crc(payload)
    msg = crc.add_crc(payload)
    assert np.array_equal(msg, ref_crc.add_crc(payload))
    assert crc.check_crc(msg) and ref_crc.check_crc(msg)
    cw = encode.ldpc_encode(msg)
    assert np.array_equal(cw, ref_encode.ldpc_encode(msg))
    assert np.array_equal(encode.encode(payload), ref_encode.encode(payload))


@pytest.mark.parametrize("message", MESSAGES)
def test_pack_unpack_equal(message):
    bits = pack.pack77(message)
    assert np.array_equal(bits, ref_pack.pack77(message))
    mine, ref = text.CallsignHashTable(), ref_text.CallsignHashTable()
    assert unpack.unpack77(bits, mine) == ref_unpack.unpack77(bits, ref)
    packed = np.packbits(np.concatenate([bits, np.zeros(19, np.uint8)]))
    assert unpack.unpack_spots_batch(packed[None], text.CallsignHashTable()) \
        == ref_unpack.unpack_spots_batch(packed[None],
                                         ref_text.CallsignHashTable())


def test_synthesized_samples_equal(tmp_path):
    kw = dict(f0_hz=612.5, noise_sigma=0.2, amplitude=0.4)
    mine = synth.synthesize_message("K1ABC W9XYZ EN37", **kw,
                                    rng=np.random.default_rng(11))
    ref = ref_synth.synthesize_message("K1ABC W9XYZ EN37", **kw,
                                       rng=np.random.default_rng(11))
    assert mine.dtype == ref.dtype and np.array_equal(mine, ref)
    path = str(tmp_path / "w.iq")
    io.write_iq(path, np.real(mine), np.imag(mine))
    for a, b in zip(io.read_iq(path), ref_io.read_iq(path)):
        assert np.array_equal(a, b)
