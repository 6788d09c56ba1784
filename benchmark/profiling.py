"""torch.profiler over a few windows, with the retry the card needs.

After chip_smoke.py:253-286 (profiled, device_events): the profiler has
been seen to drop device records on the card, once all of a pass's, so a
pass whose device events fail `enough` runs again, up to `tries` passes.
Each pass also keeps the host ranges the harness opened with
torch.profiler.record_function (names starting with "bench.").
"""

import time

import torch


def device_events(prof, prefix="bench."):
    """(name, start us, end us) of every operation that ran on the card;
    the harness's ranges, which the profiler also draws on the card's
    timeline as user annotations, are left out."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(prefix)]


def host_ranges(prof, prefix="bench."):
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU
            and e.name.startswith(prefix)]


def profiled(fn, calls: int, enough, prepare=None, tries: int = 3):
    """Run fn `calls` times under torch.profiler, each call in a range
    "bench.window" that ends in a synchronize, with `prepare` run
    untimed before each. Returns {"device": events, "host": ranges,
    "wall_s": the calls' summed time, "windows_us": their ranges,
    "results": fn's results} of the first pass whose device events pass
    `enough`, or None after `tries` passes."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        results, wall = [], 0.0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                if prepare is not None:
                    prepare()
                with torch.profiler.record_function("bench.window"):
                    t0 = time.perf_counter()
                    results.append(fn())
                    torch.cuda.synchronize()
                    wall += time.perf_counter() - t0
        dev = device_events(prof)
        host = host_ranges(prof)
        if enough(dev):
            return {"device": dev, "host": host, "wall_s": wall,
                    "windows_us": [(s, e) for n, s, e in host
                                   if n == "bench.window"],
                    "results": results}
    return None
