"""Filter 2 (the vector SW) against its roofline: the least time of the
work counted from the windows it was given (`mapbench/work.py`,
`mapbench/peaks.py`) over the profiler's device time of its kernels."""
from mapbench.metrics import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "filter2")
