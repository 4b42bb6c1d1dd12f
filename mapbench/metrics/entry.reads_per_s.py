"""The map CLI's rate over the untraced window, as `reads_per_s` takes
it: the reads of the whole CLI windows that ended in it, over the time
between the first and the last of those ends. A per-layer reading in the
cells whose rate spreads too widely from run to run to be held to a
bound end to end."""


def read(ctx):
    v = ctx.get("reads_per_s")
    return v if v and v > 0 else None
