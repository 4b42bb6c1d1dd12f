"""The share of the card's idle time in the traced span, as
`device.idle_pct` takes it, during which no work span of the program
was open on any thread (`mapbench/spans.py`): the host work the program
does not yet record. It reads the traced report's `spans` and
`clock_pair`; a report without them gives nothing."""
from mapbench.spans import unattributed_pct


def read(ctx):
    rep = ctx.get("report")
    return None if rep is None else unattributed_pct(rep)
