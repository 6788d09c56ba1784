"""device.busy_ms: the union of the intervals in which an operation ran
on the card, from torch.profiler's CUDA activity, per profiled window."""

from stats import merged_length


def read(trace):
    prof = trace.get("profile")
    if not prof or not prof["device"]:
        return None
    busy_us = merged_length([(s, e) for _, s, e in prof["device"]])
    return busy_us / 1e3 / prof["windows"]
