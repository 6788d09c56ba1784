# Copied from rtlsdr_ft8d_tpu/host/log.py:1-46; StageTimer is the port's
# own, a span recorder.
"""Logging + per-window metrics.

The reference has a compile-time LOG macro to stderr and nothing else
(C20, rtlsdr_ft8d.h:68-74; SURVEY.md §5 calls out the
missing observability). Here: standard leveled logging plus structured
per-window counters (decode counts, candidate stats, stage timings) that
the daemon emits as single-line JSON records for scraping.
"""

import json
import logging
import sys
import time
from dataclasses import asdict, dataclass, field

import torch

logger = logging.getLogger("tpu_ft8d")


def setup_logging(level=logging.INFO, stream=None):
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(levelname).1s %(name)s: %(message)s"))
    logger.handlers[:] = [handler]
    logger.setLevel(level)
    # don't propagate to the root handler: embedding scripts that called
    # logging.basicConfig would otherwise see every scrape-oriented
    # single-line JSON record twice
    logger.propagate = False
    return logger


@dataclass
class WindowStats:
    """Structured per-window decode metrics."""
    epoch: int = 0
    channels: int = 0
    candidates_scored: int = 0
    candidates_above_min: int = 0
    ldpc_converged: int = 0
    crc_passed: int = 0
    messages_unique: int = 0
    decode_ms: float = 0.0
    extra: dict = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps({"window_stats": asdict(self)}, sort_keys=True)


class Span:
    """One span of a detailed StageTimer: its dotted path, its parent's
    path (None for a top-level part), the window it belongs to, its start
    and end (time.perf_counter_ns) and, for a span timed on a CUDA stream,
    its (start, end) pair of CUDA events."""

    __slots__ = ("path", "parent", "window", "start_ns", "end_ns", "events")

    def __init__(self, path, parent, window):
        self.path, self.parent, self.window = path, parent, window
        self.start_ns = self.end_ns = 0
        self.events = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def device_ms(self) -> float | None:
        """The device time between the span's events; waits for the end
        event, which the window's own download has usually passed."""
        if self.events is None:
            return None
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)


class _Off:
    """The stage of a timer that records nothing."""

    ms = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_OFF = _Off()


class _Stage:
    """One stage of a StageTimer, opened and closed as a context manager."""

    __slots__ = ("timer", "name", "device", "ms", "_span", "_range", "_t0")

    def __init__(self, timer, name, device):
        self.timer, self.name, self.device = timer, name, device
        self.ms = 0.0
        self._span = self._range = None

    def __enter__(self):
        t = self.timer
        parent = t._open[-1] if t._open else None
        path = self.name if parent is None else f"{parent}.{self.name}"
        t._open.append(path)
        if t.detail:
            self._span = span = Span(path, parent, t.window)
            t.spans.append(span)
            if torch.autograd._profiler_enabled():
                self._range = torch.profiler.record_function("ft8d." + path)
                self._range.__enter__()
            dev = self.device
            if dev is not None and torch.device(dev).type == "cuda":
                span.events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
                span.events[0].record(torch.cuda.current_stream(dev))
        self._t0 = time.perf_counter_ns()   # monotonic: immune to NTP steps
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        t = self.timer
        path = t._open.pop()
        self.ms = (t1 - self._t0) / 1e6
        span = self._span
        if span is not None:
            span.start_ns, span.end_ns = self._t0, t1
            if span.events is not None:
                span.events[1].record(torch.cuda.current_stream(self.device))
            if self._range is not None:
                self._range.__exit__(None, None, None)
        if not t._open:
            t.timings[path] = t.timings.get(path, 0.0) + self.ms


class StageTimer:
    """The window's host-side stage accounting and the program's span
    recorder.

    `stage(name)` times a part of the window on the monotonic clock; the
    top-level parts sum their host milliseconds by name into `timings`,
    always. A stage opened inside another is a span whose path is dotted
    under it (`decode.unpack`); a timer built with `detail=True` records
    every span, top-level parts too, in `spans` (a Span each: path,
    parent, window, start and end), and a timer without it records
    nothing for a nested stage. The context manager's `ms` holds the
    stage's host milliseconds once it has closed.

    On a detailed timer, `device` (a torch.device) also times the span on
    that device's current CUDA stream by a pair of events, recorded
    without a synchronize; the device milliseconds are read when the
    spans are, after the window has waited for the card. While
    torch.profiler runs, each recorded span is also a profiler range
    "ft8d.<path>": the profiler's timeline counts from its own wall-clock
    epoch, on which perf_counter stamps cannot be placed, so the ranges
    are how the spans share the device trace's clock. `count(name, n)`
    adds to a named integer counter, named under the outermost open
    stage (`decode.survivors`); only a detailed timer keeps counters.
    """

    def __init__(self, detail: bool = False, window: int = 0):
        self.timings = {}
        self.detail = detail
        self.window = window
        self.spans = []
        self.counters = {}
        self._open = []             # the paths of the open stages

    def stage(self, name, device=None):
        if self._open and not self.detail:
            return _OFF
        return _Stage(self, name, device)

    def count(self, name, n=1):
        if self.detail:
            key = f"{self._open[0]}.{name}" if self._open else name
            self.counters[key] = self.counters.get(key, 0) + int(n)

    def by_path(self) -> dict:
        """{path: {"host_ms", "self_ms", "device_ms", "count"}} summed
        over the recorded spans of each path, in the order they opened;
        a span's self time is its host time less its children's, and
        device_ms is None where no span of the path was timed on a
        device."""
        out = {}
        for s in self.spans:
            d = out.setdefault(s.path, {"host_ms": 0.0, "self_ms": 0.0,
                                        "device_ms": None, "count": 0})
            ms = s.host_ms
            d["host_ms"] += ms
            d["self_ms"] += ms
            d["count"] += 1
            dev = s.device_ms
            if dev is not None:
                d["device_ms"] = (d["device_ms"] or 0.0) + dev
            if s.parent is not None:
                out[s.parent]["self_ms"] -= ms
        return out


class _NoTimer(StageTimer):
    """The timer of a caller that passed none: records nothing."""

    def stage(self, name, device=None):
        return _OFF


NO_TIMER = _NoTimer()
