"""device.idle_share: the share of the profiled windows' wall time in
which nothing ran on the card (%)."""

from stats import merged_length


def read(trace):
    prof = trace.get("profile")
    if not prof or not prof["device"] or prof["wall_s"] <= 0:
        return None
    busy_s = merged_length([(s, e) for _, s, e in prof["device"]]) / 1e6
    return 100.0 * (1.0 - busy_s / prof["wall_s"])
