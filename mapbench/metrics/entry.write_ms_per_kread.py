"""The map CLI's SAM output, host seconds per 1,000 reads: the `cli
write` stage, each SAM chunk written to standard output (back-pressure
from the SAM's reader shows here)."""
from mapbench.metrics import stage_ms_per_kread


def read(ctx):
    return stage_ms_per_kread(ctx, ["cli write"])
