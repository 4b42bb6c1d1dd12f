"""The device step's host-to-device copies, host seconds per 1,000 reads:
the `device upload` stage (read tables and launch arguments from pageable
memory, a part of `device dispatch` and `device full (2ph)`), summed over
lanes."""
from mapbench.metrics import stage_ms_per_kread


def read(ctx):
    return stage_ms_per_kread(ctx, ["device upload"])
