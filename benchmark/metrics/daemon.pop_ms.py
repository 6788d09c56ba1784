"""daemon.pop_ms: the native ingest_ring_pop into the channelizer's
staging buffer, host clock, mean per window of the traced window."""


def read(trace):
    v = trace["spans"].get("pop")
    return sum(v) / len(v) if v else None
