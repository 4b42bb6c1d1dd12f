"""The device step's host seconds per 1,000 reads: packing and launching
(`device dispatch`), waiting for and fetching the results (`device
fetch`) and the two-phase dispatch's second phase (`device full
(2ph)`), summed over lanes."""
from mapbench.metrics import stage_ms_per_kread


def read(ctx):
    return stage_ms_per_kread(ctx, ["device dispatch", "device fetch",
                                    "device full (2ph)"])
