"""The port's span recorder (host/log.StageTimer) and its spans and
counters in decode_window and the daemon.

A timer without detail keeps only the top-level parts; a detailed one
records every span of decode_window under the caller's part, with its
parent and window, the counters (bytes up and down, survivors, kernel
launches), the spans of every pass under the same paths, and, while
torch.profiler runs, a range "ft8d.<path>" per span nested as the spans
are. run_daemon --stats logs one window_spans record a window beside the
window_seconds and window_stats records; decode_ms is monotonic time.
Imports no JAX: the `cuda` test runs on the GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_trace.py -q
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from rtlsdr_ft8d_tpu_torch import pipeline
from rtlsdr_ft8d_tpu_torch.host import cli, daemon
from rtlsdr_ft8d_tpu_torch.host.io import read_iq
from rtlsdr_ft8d_tpu_torch.host.log import NO_TIMER, StageTimer
from rtlsdr_ft8d_tpu_torch.ops import build
from rtlsdr_ft8d_tpu_torch.pipeline import WindowDecoder, decode_window
from rtlsdr_ft8d_tpu_torch.protocol.text import CallsignHashTable

from .torch_cpu import few_torch_threads  # noqa: F401

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
BASE = ["-f", "20m", "-c", "T1ST", "-l", "AA00"]
DECODE_SPANS = {"decode", "decode.upload", "decode.forward",
                "decode.download", "decode.unpack", "decode.stats"}
DEEP_COUNTERS = ("passes", "ap_rows", "bank_rows", "deep_rows",
                 "osd_candidates", "osd_device_rows", "osd_recovered",
                 "subtract_pairs")


@pytest.fixture(scope="module")
def batch():
    """Two channels as host float32: golden_10sig's window and silence."""
    i, q = read_iq(os.path.join(FIX, "golden_10sig.iq"))
    return np.stack([i, 0 * i]), np.stack([q, 0 * q])


@pytest.fixture(scope="module")
def decoder():
    return WindowDecoder()


@pytest.fixture
def unpacked(monkeypatch):
    """The survivor dicts decode_window hands to unpack_survivors."""
    seen = []
    orig = pipeline.unpack_survivors

    def spy(out, *a, **k):
        seen.append(out)
        return orig(out, *a, **k)

    monkeypatch.setattr(pipeline, "unpack_survivors", spy)
    return seen


def _decode(batch, decoder, timer, **kw):
    with timer.stage("decode"):
        return decode_window(batch, hashes=CallsignHashTable(),
                             decoder=decoder, return_stats=True,
                             timer=timer, **kw)


def test_timer_without_detail_records_no_nested_span(batch, decoder):
    timer = StageTimer()
    with timer.stage("pop"):
        with timer.stage("inner") as inner:
            timer.count("n", 3)
    results, _ = _decode(batch, decoder, timer)
    assert set(timer.timings) == {"pop", "decode"}
    assert timer.timings["decode"] > 0 and inner.ms == 0.0
    assert timer.spans == [] and timer.counters == {}
    assert timer.by_path() == {}
    assert decode_window(batch, hashes=CallsignHashTable(), decoder=decoder,
                         timer=None) == results
    assert (NO_TIMER.timings, NO_TIMER.spans, NO_TIMER.counters) == \
        ({}, [], {})


@pytest.mark.parametrize("passes", [1, 2])
def test_detailed_decode_window_spans_and_counters(batch, decoder, unpacked,
                                                   passes):
    timer = StageTimer(detail=True, window=7)
    results, stats = _decode(batch, decoder, timer, passes=passes)
    assert "CQ K1JT FN20" in {d.text for d in results[0]}
    paths = timer.by_path()
    want = DECODE_SPANS | ({"decode.subtract"} if passes > 1 else set())
    assert set(paths) == want
    assert list(timer.timings) == ["decode"]
    for s in timer.spans:
        assert s.window == 7 and s.end_ns >= s.start_ns
        assert s.parent == (None if s.path == "decode" else "decode")
        assert s.events is None and s.device_ms is None     # the CPU
    for path in ("decode.forward", "decode.download", "decode.unpack"):
        assert paths[path]["count"] == passes
    for path in ("decode", "decode.upload", "decode.stats"):
        assert paths[path]["count"] == 1
    children = sum(v["host_ms"] for p, v in paths.items() if p != "decode")
    assert paths["decode"]["self_ms"] == pytest.approx(
        paths["decode"]["host_ms"] - children)
    assert len(unpacked) == passes
    c = timer.counters
    assert c["decode.upload_bytes"] == 2 * batch[0].size * 4
    assert c["decode.download_bytes"] == sum(
        v.nbytes for out in unpacked for k, v in out.items()
        if k not in pipeline.OSD_POSTERIORS)
    assert c["decode.survivors"] == sum(
        int(np.count_nonzero(out["ok"])) for out in unpacked)
    assert c["decode.survivors"] >= stats.messages_unique > 0
    assert {f"decode.launches.{n}" for n in build.KERNELS} <= set(c)
    assert all(c[f"decode.launches.{n}"] == 0 for n in build.KERNELS)
    assert (c["decode.passes"], c["decode.ap_rows"],
            c["decode.bank_rows"]) == (passes, 0, 0)
    assert not {f"decode.{k}" for k in DEEP_COUNTERS[3:-1]} & set(c)
    # the subtraction's pairs: the first pass's ten decodes of channel 0
    # (golden_10sig.single_pass.txt), none of the silent channel; no
    # kernel on the CPU
    assert c.get("decode.subtract_pairs") == (None if passes == 1 else 10)
    assert c["decode.launches.subtract"] == 0


def test_upload_bytes_zero_for_tensors_on_the_device(batch, decoder):
    timer = StageTimer(detail=True)
    iq = tuple(torch.from_numpy(x) for x in batch)
    _decode(iq, decoder, timer, ap_cq=True)
    # the I/Q sit on the decoder's device; only the CQ clamp row goes up
    assert timer.counters["decode.upload_bytes"] == 77 * 4


def test_profiler_ranges_match_the_spans(batch, decoder):
    from torch.profiler import ProfilerActivity, profile

    timer = StageTimer(detail=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _decode(batch, decoder, timer, passes=2)
    ranges = {}
    for e in prof.events():
        if e.name.startswith("ft8d."):
            parent = e.cpu_parent
            while parent is not None and not parent.name.startswith("ft8d."):
                parent = parent.cpu_parent
            ranges.setdefault(e.name[5:], []).append(
                (e.time_range.start, parent.name if parent else None,
                 (e.time_range.end - e.time_range.start) / 1e3))
    spans = {}
    for s in timer.spans:
        spans.setdefault(s.path, []).append(s)
    assert set(ranges) == set(spans)
    for path, mine in spans.items():
        got = sorted(ranges[path])
        assert len(got) == len(mine)
        for s, (_, parent, ms) in zip(mine, got):
            assert parent == (None if s.parent is None
                              else "ft8d." + s.parent)
            assert abs(ms - s.host_ms) <= max(0.2 * s.host_ms, 0.2), \
                (path, s.host_ms, ms)


def test_stats_daemon_logs_window_spans(monkeypatch):
    from rtlsdr_ft8d_tpu_torch import native

    if native.load() is None:
        pytest.skip("native lib unavailable")
    records = []
    monkeypatch.setattr(daemon.logger, "info", records.append)
    args = cli.build_parser().parse_args(
        BASE + ["--synthetic", "-n", "2", "-x", "--stats", "--backend",
                "cpu", "--wideband", "--wideband-channels", "0,1,2,3"])
    assert daemon.run_daemon(args) == 0
    seconds = [json.loads(r) for r in records if '"window_seconds"' in r]
    assert len(seconds) == 2
    for rec in seconds:
        assert set(rec) == {"window_seconds", "bands"}
        assert set(rec["window_seconds"]) == {"source", "pop", "channelize",
                                              "decode", "spots"}
    stats = [json.loads(r)["window_stats"] for r in records
             if '"window_stats"' in r]
    spans = [json.loads(r) for r in records if '"window_spans"' in r]
    assert len(spans) == 2 and len(stats) == 2
    for rec, st, sec in zip(spans, stats, seconds):
        assert set(rec) == {"window_spans", "counters", "epoch"}
        assert rec["epoch"] == st["epoch"]
        paths = rec["window_spans"]
        assert DECODE_SPANS | {"source", "pop", "channelize",
                               "channelize.bank", "spots"} == set(paths)
        assert all(set(v) == {"host_ms", "device_ms"}
                   and v["device_ms"] is None for v in paths.values())
        for part, s in sec["window_seconds"].items():
            assert paths[part]["host_ms"] == pytest.approx(s * 1e3)
        assert st["decode_ms"] == pytest.approx(paths["decode"]["host_ms"])
        c = rec["counters"]
        assert c["decode.upload_bytes"] == 0       # the bank stays put
        assert c["decode.survivors"] >= st["messages_unique"] >= 1
        assert c["decode.unpack_fallbacks"] == 0   # no hashed call
        assert c["decode.download_bytes"] > 0
        assert all(c[f"decode.launches.{n}"] == 0 for n in build.KERNELS)


def test_detailed_deep_decode_spans_and_counters(batch, decoder, unpacked):
    """With the deep decode, the clamp rows and a bank: the span
    forward.deep under forward in every pass, and each counter of the
    deep decode summed over the passes run."""
    from rtlsdr_ft8d_tpu_torch.ops.ap import codeword_signs, continuation_texts

    bank = codeword_signs(continuation_texts("K1ABC", "W9XYZ"), h_pad=256)
    osd_seen = []
    real_osd = pipeline._merge_osd_decodes

    def spy(out, *a, **k):
        osd_seen.append(int(np.count_nonzero(out["osd_valid"])))
        return real_osd(out, *a, **k)

    timer = StageTimer(detail=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pipeline, "_merge_osd_decodes", spy)
        results, stats = _decode(batch, decoder, timer, passes=2,
                                 osd_cands=2, ap_cq=True, ap_call="K1ABC",
                                 ap_texts=bank)
    assert "CQ K1JT FN20" in {d.text for d in results[0]}
    n = len(unpacked)
    assert n == 2
    paths = timer.by_path()
    assert DECODE_SPANS | {"decode.forward.deep", "decode.osd",
                           "decode.subtract"} == set(paths)
    assert paths["decode.forward.deep"]["count"] == n
    assert all(s.parent == "decode.forward" for s in timer.spans
               if s.path == "decode.forward.deep")
    c = timer.counters
    assert c["decode.passes"] == n
    assert c["decode.ap_rows"] == 2 * n
    assert c["decode.bank_rows"] == int(np.count_nonzero(
        bank.any(-1))) * n > 0
    assert c["decode.deep_rows"] == sum(out["osd_valid"].shape[0]
                                        for out in unpacked) == 2 * 2 * n
    assert c["decode.osd_candidates"] >= sum(osd_seen)
    assert c["decode.osd_candidates"] <= 2 * sum(osd_seen)
    assert c["decode.osd_device_rows"] == 0                 # the CPU
    assert c["decode.osd_recovered"] == stats.extra["osd_recovered"]
    assert c["decode.subtract_pairs"] > 0
    assert c["decode.launches.subtract"] == 0               # the CPU


def test_elastic_window_records_the_decode_spans(batch, unpacked):
    """--wideband --elastic --osd: the daemon's decode step runs
    decode_window with the ElasticDecoder as its decoder, so the window
    records the spans and counters every decode records, in one pass."""
    args = cli.build_parser().parse_args(
        BASE + ["-n", "1", "--backend", "cpu", "--wideband",
                "--wideband-channels", "0,1", "--elastic", "--osd", "2",
                "--multipass", "2"])
    proc = daemon.WindowProcessor(args, 14_074_000, WindowDecoder())
    proc.timer = timer = StageTimer(detail=True)
    iq = tuple(torch.from_numpy(x) for x in batch)
    with timer.stage("decode"):
        results, stats = proc._decode_wideband(*iq, None)
    assert "CQ K1JT FN20" in {d.text for d in results[0]}
    paths = timer.by_path()
    assert DECODE_SPANS | {"decode.osd"} == set(paths)
    for path in ("decode.forward", "decode.download", "decode.unpack",
                 "decode.osd"):
        assert paths[path]["count"] == 1
    c = timer.counters
    assert c["decode.passes"] == 1 and len(unpacked) == 1
    assert c["decode.upload_bytes"] == 0       # the channels stay put
    assert c["decode.survivors"] == int(np.count_nonzero(
        unpacked[0]["ok"])) >= stats.messages_unique
    assert c["decode.osd_recovered"] == stats.extra["osd_recovered"]
    assert stats.extra["mesh_devices"] == 1
    assert stats.extra["windows_recovered"] == 0


def test_stats_multiband_deep_daemon_logs_deep_spans(monkeypatch):
    """run_daemon --stats with --osd 8 --ap --multipass 3 on two bands:
    the window_spans record holds the deep decode's spans and every one
    of its counters."""
    from rtlsdr_ft8d_tpu_torch import native

    if native.load() is None:
        pytest.skip("native lib unavailable")
    records = []
    monkeypatch.setattr(daemon.logger, "info", records.append)
    args = cli.build_parser().parse_args(
        ["-f", "20m", "-f", "40m", "-c", "K1ABC", "-l", "FN42",
         "--synthetic", "-n", "1", "-x", "--stats", "--ap", "--osd", "8",
         "--multipass", "3", "--backend", "cpu"])
    assert daemon.run_daemon(args) == 0
    spans = [json.loads(r) for r in records if '"window_spans"' in r]
    stats = [json.loads(r)["window_stats"] for r in records
             if '"window_stats"' in r]
    assert len(spans) == 1 and len(stats) == 1
    paths, c = spans[0]["window_spans"], spans[0]["counters"]
    assert {"decode.forward.deep", "decode.osd",
            "decode.subtract"} <= set(paths)
    assert {f"decode.{k}" for k in DEEP_COUNTERS} <= set(c)
    assert c["decode.passes"] >= 2
    assert c["decode.ap_rows"] == 2 * c["decode.passes"]
    assert c["decode.bank_rows"] == 0          # no QSO heard yet
    assert c["decode.deep_rows"] == 16 * c["decode.passes"]
    assert c["decode.osd_recovered"] == stats[0]["extra"]["osd_recovered"]


def test_decode_ms_is_monotonic_when_the_clock_steps_back(monkeypatch):
    records = []
    monkeypatch.setattr(daemon.logger, "info", records.append)
    args = cli.build_parser().parse_args(
        BASE + ["-n", "1", "--stats", "--backend", "cpu"])
    proc = daemon.WindowProcessor(args, 14_074_000, WindowDecoder())
    wall = [2_000_000_000.0]

    def stepping_back():
        wall[0] -= 3600.0          # an NTP step back on every read
        return wall[0]

    monkeypatch.setattr(time, "time", stepping_back)
    monkeypatch.setattr(daemon, "_now", stepping_back)
    i, q = read_iq(os.path.join(FIX, "golden_10sig.iq"))
    proc.process_baseband(i, q)
    stats = [json.loads(r)["window_stats"] for r in records
             if '"window_stats"' in r]
    assert len(stats) == 1
    assert stats[0]["decode_ms"] > 0
    assert stats[0]["decode_ms"] == pytest.approx(
        proc.timer.timings["decode"])


@pytest.mark.cuda
def test_device_ms_of_forward_and_bank():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    from rtlsdr_ft8d_tpu_torch.ops.channelize import StreamingChannelizerInt8

    build.load()
    dec = WindowDecoder().to("cuda")
    ch = StreamingChannelizerInt8("cuda")
    timer = StageTimer(detail=True)
    n = daemon.FULLRATE_WINDOW // 8
    rng = np.random.default_rng(3)
    i8, q8 = ch.staging(n)
    i8[:] = rng.integers(-100, 100, n, dtype=np.int8)
    q8[:] = rng.integers(-100, 100, n, dtype=np.int8)
    with timer.stage("channelize"):
        with timer.stage("bank", device=ch.device):
            i_ch, q_ch = ch.process(i8, q8)
    i, q = read_iq(os.path.join(FIX, "golden_10sig.iq"))
    _decode((i[None], q[None]), dec, timer)
    paths = timer.by_path()
    assert paths["channelize.bank"]["device_ms"] > 0
    assert paths["decode.forward"]["device_ms"] > 0
    assert paths["decode.upload"]["device_ms"] is None
    assert timer.counters["decode.launches.waterfall"] == 1
    assert timer.counters["decode.launches.bp"] >= 1
    assert i_ch.shape[0] == 1500


@pytest.mark.cuda
def test_device_ms_of_deep_and_subtract():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    build.load()
    dec = WindowDecoder().to("cuda")
    timer = StageTimer(detail=True)
    i, q = read_iq(os.path.join(FIX, "golden_10sig.iq"))
    _decode((i[None], q[None]), dec, timer, passes=2, osd_cands=8,
            ap_cq=True, ap_call="K1ABC")
    paths = timer.by_path()
    assert paths["decode.forward.deep"]["device_ms"] > 0
    assert paths["decode.subtract"]["device_ms"] > 0
    assert paths["decode.osd"]["device_ms"] > 0
    c = timer.counters
    assert c["decode.deep_rows"] == 8 * 2
    assert c["decode.osd_device_rows"] == c["decode.osd_candidates"] > 0
    assert 1 <= c["decode.launches.osd"] <= 2           # one a pass with rows
    # refine and residual: two launches a subtraction
    assert paths["decode.subtract"]["count"] == 1
    assert c["decode.launches.subtract"] == 2
    assert c["decode.subtract_pairs"] > 0
