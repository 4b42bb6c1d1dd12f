"""The flow's finalize and SAM render host seconds per 1,000 reads,
summed over lanes: `finalize + render` (letter-space stats flow),
`alignment expand` (the traceback flow's host side), `cs finalize +
render` (colour space), `cs paired select + render` (colour-space
pairs)."""
from mapbench.metrics import stage_ms_per_kread

NAMES = ["finalize + render", "alignment expand", "cs finalize + render",
         "cs paired select + render"]


def read(ctx):
    return stage_ms_per_kread(ctx, NAMES)
