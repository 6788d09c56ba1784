"""The benchmark's arithmetic on samples: percentiles, rates and the
union of busy intervals."""

import math


def percentile(values, q: float) -> float:
    """Nearest-rank q-th percentile (0 < q <= 100): the smallest sample
    with at least q% of the samples at or below it."""
    if not values:
        raise ValueError("percentile of no samples")
    if not 0 < q <= 100:
        raise ValueError(f"q must be in (0, 100], got {q}")
    s = sorted(values)
    return s[max(math.ceil(q / 100.0 * len(s)), 1) - 1]


def rate(count: float, seconds: float) -> float:
    """Work per second over a window of `seconds`."""
    if seconds <= 0:
        raise ValueError(f"window of {seconds} s")
    return count / seconds


def merged_length(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_e is None or start > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    return busy + (cur_e - cur_s if cur_e is not None else 0.0)


def gaps(intervals, start: float, end: float):
    """The (start, end) stretches of [start, end] that no interval
    covers, in order."""
    out, cur = [], start
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, end)))
        cur = max(cur, e)
        if cur >= end:
            break
    if cur < end:
        out.append((cur, end))
    return [(s, e) for s, e in out if e > s]
