"""Filter 1 (native C++ candidate windows) host seconds per 1,000 reads:
the mapper's `filter1` stage, summed over the pipeline's lanes."""
from mapbench.metrics import stage_ms_per_kread


def read(ctx):
    return stage_ms_per_kread(ctx, ["filter1"])
