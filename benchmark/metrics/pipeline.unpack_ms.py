"""pipeline.unpack_ms: pipeline.unpack_survivors, the host's unpack and
per-channel dedup of the survivors, host clock, summed over a window's
calls and averaged over the windows of the traced window."""


def read(trace):
    v = trace["spans"].get("unpack")
    return sum(v) / trace["windows"] if v and trace["windows"] else None
