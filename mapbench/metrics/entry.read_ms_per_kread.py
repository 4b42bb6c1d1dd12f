"""The map CLI's reading of its input, host seconds per 1,000 reads: the
`cli read` stage, the Python parse that collects each CLI window's
records from standard input before the window is mapped."""
from mapbench.metrics import stage_ms_per_kread


def read(ctx):
    return stage_ms_per_kread(ctx, ["cli read"])
