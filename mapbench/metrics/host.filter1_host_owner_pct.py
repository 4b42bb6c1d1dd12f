"""Filter 1's owners (a read's strand) whose front half ran on the host,
over all owners, in %, over the untraced window: `filter1 host owners`
(spilled past the card's capacity, or of a call that kept the host path)
over those and `filter1 device owners` (`MapperStats.counts`). None where
neither counter moved."""


def read(ctx):
    o = ctx["open"].get("counts", {})
    c = ctx["close"].get("counts", {})

    def moved(name):
        return c.get(name, 0) - o.get(name, 0)
    host = moved("filter1 host owners")
    total = host + moved("filter1 device owners")
    return 100.0 * host / total if total > 0 else None
