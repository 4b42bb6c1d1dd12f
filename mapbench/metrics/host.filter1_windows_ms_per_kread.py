"""The rest of filter 1, host seconds per 1,000 reads: the `filter1
windows` stage (the postings' sort, the anchor walk and collapse, the
window generation), summed over lanes."""
from mapbench.metrics import stage_ms_per_kread


def read(ctx):
    return stage_ms_per_kread(ctx, ["filter1 windows"])
