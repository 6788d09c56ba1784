"""One run of one cell: set-up, warm-up, the measured window, an optional
profiled stretch, then the comparison with the plain reference and the
result line.

The loop is closed with one window in flight, as run_daemon works: the
next window is handed over only after the previous one is emitted. The
hand-over (the driver's `ready`: load generation, such as the push of a
capture into the ring) is untimed; each timed window runs from the
entry's taking it to its decode lists. The measured window is those
timed windows back to back: it runs until they sum to `seconds`, and
every window in it counts. Outputs are compared after it closes: the
first window of each input and a share of the rest drawn from the seed
(`compare_share` of the configuration), kept as tuples meanwhile.
"""

import collections
import contextlib
import random
import subprocess
import sys
import time

import torch

import peaks
import registry
import stats
from profiling import profiled
from reference.compare import freeze

FORBIDDEN = ("jax", "jaxlib", "flax", "rtlsdr_ft8d_tpu")


class Spans:
    """Host-clock spans in milliseconds, by name; with `ranges`, each is
    also a torch.profiler range named "bench.<name>"."""

    def __init__(self, ranges: bool):
        self.ranges = ranges
        self._d = collections.defaultdict(list)

    def range(self, name: str):
        """A torch.profiler range "bench.<name>" with `ranges`, else
        nothing."""
        return (torch.profiler.record_function("bench." + name)
                if self.ranges else contextlib.nullcontext())

    @contextlib.contextmanager
    def span(self, name: str):
        with self.range(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._d[name].append((time.perf_counter() - t0) * 1e3)

    def add(self, name: str, ms: float):
        self._d[name].append(ms)

    def items(self):
        return self._d.items()

    def snapshot(self) -> dict:
        return {k: list(v) for k, v in self._d.items()}

    def clear(self):
        self._d.clear()


@contextlib.contextmanager
def unpack_span(spans: Spans):
    """Wrap pipeline.unpack_survivors, a module global of the program's
    pipeline, in a span for the traced run."""
    from rtlsdr_ft8d_tpu_torch import pipeline

    orig = pipeline.unpack_survivors

    def wrapped(*a, **k):
        with spans.span("unpack"):
            return orig(*a, **k)

    pipeline.unpack_survivors = wrapped
    try:
        yield
    finally:
        pipeline.unpack_survivors = orig


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def nvidia_smi() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read: {e}"
    return out.stdout.strip() if out.returncode == 0 else \
        f"not read: rc {out.returncode}"


def _sync(device: str):
    if device != "cpu":
        torch.cuda.synchronize()


def breakdown(prof: dict) -> dict:
    """The device operations that took most time and the device's idle
    time inside the profiled windows by the innermost harness range open
    at each gap's middle, ten each, in seconds."""
    ops = collections.Counter()
    for name, s, e in prof["device"]:
        ops[name[:120]] += (e - s) / 1e6
    intervals = [(s, e) for _, s, e in prof["device"]]
    idle = collections.Counter()
    host = [h for h in prof["host"] if h[0] != "bench.window"]
    for ws, we in prof["windows_us"]:
        for gs, ge in stats.gaps(intervals, ws, we):
            mid = 0.5 * (gs + ge)
            inner = [h for h in host if h[1] <= mid <= h[2]]
            label = (min(inner, key=lambda h: h[2] - h[1])[0] if inner
                     else "outside the harness's ranges")
            idle[label] += (ge - gs) / 1e6
    return {"device_ops": [[n, v] for n, v in ops.most_common(10)],
            "idle_gaps": [[n, v] for n, v in idle.most_common(10)]}


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: float | None = None,
        overrides: dict | None = None, log=None) -> dict:
    """One run; returns {"result": the result line's dict, "record": what
    is no metric}. `overrides` updates the configuration ("config") and
    the traffic ("traffic") of the cell, for tests at a small size."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    bench = registry.benchmark()
    w, cfg, traffic = registry.cell(bench, workload)
    cfg.update((overrides or {}).get("config", {}))
    traffic.update((overrides or {}).get("traffic", {}))
    cuda = device != "cpu"
    spans = Spans(ranges=trace)
    drv_mod = registry.driver(cfg["driver"])
    prof = None
    with contextlib.ExitStack() as stack:
        if trace:
            stack.enter_context(unpack_span(spans))
        drv = drv_mod.Driver(cfg, traffic, seed, device, spans)
        stack.callback(drv.close)
        for _ in range(int(cfg["warmup_windows"])):
            drv.ready()
            drv.step()
        _sync(device)
        setup_s = time.perf_counter() - t_start
        spans.clear()
        # the windows compared: the first of each input, then a share
        # drawn from the seed; the rest are dropped as they come, as the
        # daemon drops them
        pick = random.Random(seed)
        share = float(cfg["compare_share"])
        kept, seen = [], set()
        times, handover = [], []
        elapsed = 0.0
        while elapsed < seconds:
            handover.append(drv.ready())
            a = time.perf_counter()
            r, output = drv.step()
            b = time.perf_counter()
            times.append((b - a) * 1e3)
            elapsed += b - a
            if r not in seen or pick.random() < share:
                seen.add(r)
                kept.append((r, freeze(output)))
            del output
        span_ms = spans.snapshot()
        if trace and cuda:
            k = int(cfg["profile_windows"])
            symbols = peaks.KERNEL_SYMBOLS.values()
            prof = profiled(drv.step, k, lambda ev: all(
                sum(s in name for name, _, _ in ev) >= k for s in symbols),
                prepare=drv.ready)
            if prof is None:
                raise RuntimeError("torch.profiler recorded no launch of "
                                   "some decode kernel in 3 passes")
            kept.extend((r, freeze(out)) for r, out in prof.pop("results"))
            prof["inputs"] = [r for r, _ in kept[-k:]]
            prof["windows"] = k
        memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
        program = drv.window_record()
    log(f"{len(times)} windows in {elapsed:.3f} s; comparing with the "
        "plain reference")
    t_ref = time.perf_counter()
    ref = drv.reference()
    nums = drv.checks(ref, kept)
    limits = cfg["limits"]
    checks = {k: {"value": nums[k], "limit": limits[k]} for k in limits
              if k in nums}
    correct = (set(checks) == set(limits)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    ref_s = time.perf_counter() - t_ref

    metrics = {}
    if not trace:
        metrics["channel_windows_per_s"] = {
            "value": stats.rate(drv.channels * len(times), elapsed),
            "unit": "windows/s"}
        metrics["window_ms_p95"] = {"value": stats.percentile(times, 95),
                                    "unit": "ms"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    else:
        tr = {"spans": span_ms, "windows": len(times), "profile": prof,
              "work": ([drv.work(r, ref) for r in prof["inputs"]]
                       if prof else None)}
        for m in bench["per_layer"]:
            if workload not in m.get("workloads", [workload]):
                continue
            v = registry.metric(m["name"]).read(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(w["chips"]), "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": len(times),
              "failed": 0, "metrics": metrics, "device": dev}
    if prof is not None:
        busy = stats.merged_length([(s, e) for _, s, e in prof["device"]])
        dev["busy_s"] = busy / 1e6
        dev["window_s"] = prof["wall_s"]
        result["breakdown"] = breakdown(prof)
    result["checks"] = checks
    record = {"workload": workload, "seed": seed, "seconds": seconds,
              "trace": bool(trace), "windows": len(times),
              "window_s": elapsed, "window_ms_p50": stats.percentile(
                  times, 50), "window_ms_max": max(times),
              "first_window_ms": times[0],
              "handover_ms": {"p50": stats.percentile(handover, 50) * 1e3,
                              "max": max(handover) * 1e3},
              "windows_compared": len(kept), "setup_s": setup_s,
              "reference_s": ref_s, "memory_peak_bytes": int(memory_peak),
              "card": nvidia_smi() if cuda else "cpu",
              "program": program, "numbers": nums,
              "spans_mean_ms": {k: sum(v) / len(v)
                                for k, v in span_ms.items() if v},
              "tail": tail_record(times, span_ms)}
    return {"result": result, "record": record}


def tail_record(times: list, span_ms: dict) -> dict:
    """The windows at or above the p95: how many, and the mean of each
    span that has one entry a window, over those windows."""
    p95 = stats.percentile(times, 95)
    idx = [i for i, t in enumerate(times) if t >= p95]
    return {"windows": len(idx), "window_ms_p99": stats.percentile(
        times, 99), "spans_mean_ms": {
            k: sum(v[i] for i in idx) / len(idx)
            for k, v in span_ms.items() if len(v) == len(times)}}
