"""Per-layer metric readers, one file each, found by the metric's name
(`mapbench/metrics/<name>.py`, loaded by path: names hold dots). Each has
`read(ctx) -> float | None`; `ctx` holds the child's snapshots at the
untraced window's `open` and `close`, the traced span's summary
(`mapbench.trace.summarize`), the untraced window's `reads_per_s` and the
cell's configuration and traffic. A reader that finds nothing returns
None."""
import importlib.util
import os


def load(name: str):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"mapbench.metrics._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stage_ms_per_kread(ctx: dict, names) -> "float | None":
    """The window's change in the mapper's stage seconds of `names`,
    in ms per 1,000 reads the mapper handled in the window; None where
    the flow has none of these stages."""
    o, c = ctx["open"], ctx["close"]
    reads = c["stats"]["reads"] - o["stats"]["reads"]
    if reads <= 0 or not any(n in c["stage_secs"] for n in names):
        return None
    secs = sum(c["stage_secs"].get(n, 0.0) - o["stage_secs"].get(n, 0.0)
               for n in names)
    return secs * 1e6 / reads


def roofline_pct(ctx: dict, stage: str) -> "float | None":
    """The least time the stage's counted work could take on the card,
    over the device time the profiler gives the stage's kernels, in %."""
    t = ctx["trace"]["stage_time"].get(stage, 0.0)
    w = ctx["trace"]["work"].get(stage)
    if t <= 0 or not w:
        return None
    return 100.0 * w["least_s"] / t
