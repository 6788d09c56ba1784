"""llr_roofline: the share of its roofline that the llr kernel
reaches in the profiled windows (%), its bound counted from the cell's
shapes and inputs by peaks.py."""

from peaks import roofline_pct


def read(trace):
    return roofline_pct(trace, "llr")
