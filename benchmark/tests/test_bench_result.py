"""The result line: exactly the contract's keys, the checks last; and a
run without enough CUDA devices, or without the port beside the
benchmark, prints no result and exits non-zero."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import harness
import registry

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
SMALL = {"config": {"channels": 2, "warmup_windows": 1},
         "traffic": {"windows": 1, "signals_per_channel": [1, 2]}}


@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(trace):
    out = harness.run("baseband64.busy", 2**31 + 5, 0.1, trace, "cpu",
                      overrides=SMALL, log=lambda m: None)
    res = out["result"]
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    bench = registry.benchmark()
    names = {m["name"] for m in
             bench["per_layer" if trace else "end_to_end"]}
    assert set(res["metrics"]) <= names
    if not trace:
        assert set(res["metrics"]) == names
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out["result"])
    json.dumps(out["record"])


def test_breakdown_shape():
    prof = {"device": [("k1", 0.0, 10.0), ("k2", 20.0, 25.0),
                       ("k1", 60.0, 70.0)],
            "host": [("bench.window", 0.0, 40.0),
                     ("bench.unpack", 9.0, 30.0),
                     ("bench.window", 55.0, 70.0)],
            "windows_us": [(0.0, 40.0), (55.0, 70.0)]}
    b = harness.breakdown(prof)
    assert b["device_ops"] == [["k1", 2e-5], ["k2", 5e-6]]
    # the gap 10-20 has its middle inside the unpack, 25-40 and 55-60
    # outside it; 40-55 lies between the windows, in the hand-over
    got = {k: round(v, 12) for k, v in b["idle_gaps"]}
    assert got == {"bench.unpack": 1e-5,
                   "outside the harness's ranges": 2e-5}


def _run(cwd):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "baseband64.busy",
         "--seed", str(2**31 + 1), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def _no_result(out):
    for line in out.stdout.splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        assert "correct" not in rec


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    _no_result(out)


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    _no_result(out)
