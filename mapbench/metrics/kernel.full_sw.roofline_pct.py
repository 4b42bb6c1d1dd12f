"""Filter 3 (the full SW: letter-space statistics, or backpointers and
traceback; the colour-space DP and traceback) against its roofline, as
`kernel.vector_sw.roofline_pct` counts it."""
from mapbench.metrics import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "filter3")
