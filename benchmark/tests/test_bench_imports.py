"""No JAX: the check on loaded modules compares top-level names whole,
and the plain reference and the generators import nothing of the port."""

import ast
import os
import subprocess
import sys

import harness

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    for name in ("rtlsdr_ft8d_tpu_torch", "rtlsdr_ft8d_tpu_torch.ops",
                 "jaxtyping", "flax_like"):
        monkeypatch.setitem(sys.modules, name, sys)
    base = set(harness.forbidden_modules())
    assert "rtlsdr_ft8d_tpu" not in base and "jax" not in base
    monkeypatch.setitem(sys.modules, "rtlsdr_ft8d_tpu.pipeline", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert {"rtlsdr_ft8d_tpu", "jaxlib"} <= set(harness.forbidden_modules())


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_and_generators_import_nothing_of_the_port():
    for sub in ("reference", "reference/protocol", "generators"):
        d = os.path.join(BENCH_DIR, sub)
        for f in os.listdir(d):
            if f.endswith(".py"):
                for mod in _imports(os.path.join(d, f)):
                    top = mod.split(".")[0]
                    assert top not in ("rtlsdr_ft8d_tpu",
                                       "rtlsdr_ft8d_tpu_torch", "jax",
                                       "jaxlib", "flax"), (f, mod)


def test_reference_loads_alone():
    code = ("import sys; sys.path.insert(0, %r); "
            "import reference.decoder, reference.channelizer, "
            "reference.compare, generators.baseband_ft8, "
            "generators.wideband_capture; "
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'rtlsdr_ft8d_tpu', "
            "'rtlsdr_ft8d_tpu_torch'}; print(sorted(bad))") % BENCH_DIR
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=BENCH_DIR)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
