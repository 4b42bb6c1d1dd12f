"""Filter 1's k-mer lookup, host seconds per 1,000 reads: the `filter1
lookup` stage (the k-mer keys and the CSR postings collection, timed in
the native code and scaled to the call's duration), summed over lanes."""
from mapbench.metrics import stage_ms_per_kread


def read(ctx):
    return stage_ms_per_kread(ctx, ["filter1 lookup"])
