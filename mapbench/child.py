"""The process that runs the system under test: `shrimp_tpu_torch`'s
`map` CLI, as a user runs it.

    python -m mapbench.child --report PATH --control FD [--trace DIR]
        -- <map args>

It imports `shrimp_tpu_torch.cli` and calls `main(["map", ...])`; the
reads come on standard input (`-`) and the SAM goes to standard output.
A control thread reads the harness's commands from the pipe FD, one a
line: `open` snapshots the port's counters (the mapper's stage seconds,
its read and window counts, its event counters and the kernels' launch
counts); with `--trace`, `trace` snapshots them again (`host_close`),
starts the profiler and the launch recorder, snapshots the launch counts
(`trace_open`) and writes PATH.traced; `close` snapshots them at the
end, stops the profiler and writes the report (JSON) to PATH. The
harness then ends the process.

With `--trace`, the benchmark wraps the port's kernel launch functions
(`_launch*` in `core/sw_vector.py`, `core/sw_full.py`,
`core/sw_cs_full.py`) to count, on a CUDA stream of its own and without
a sync, the DP cells and bytes of each launch's real windows, and wraps
`Mapper.tally` to record when each host stage ran; until `trace` the
wrappers only test a flag. The profiler records
device activity only; a spin kernel on the benchmark's stream marks the
window's two ends, and the readers leave that stream's kernels out.
"""
from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time

JAX_NAMES = ("jax", "jaxlib", "flax", "shrimp_tpu")
MARKER_CYCLES = 20_000

# the kernel launch functions whose work the traced run counts:
# (module, function, stage, kind)
LAUNCHES = (
    ("shrimp_tpu_torch.core.sw_vector", "_launch", "filter2", "vector"),
    ("shrimp_tpu_torch.core.sw_full", "_launch", "filter3", "ls_stats"),
    ("shrimp_tpu_torch.core.sw_full", "_launch_bp", "filter3", "ls_bp"),
    ("shrimp_tpu_torch.core.sw_full", "_launch_tb", "filter3", "ls_tb"),
    ("shrimp_tpu_torch.core.sw_cs_full", "_launch_dp", "filter3", "cs_dp"),
    ("shrimp_tpu_torch.core.sw_cs_full", "_launch_tb", "filter3", "cs_tb"),
)
# the port's launch counters, by kernel family
COUNTERS = (
    ("sw_vector", "shrimp_tpu_torch.core.sw_vector", ("LAUNCHES",
                                                      "CS_LAUNCHES")),
    ("sw_full_stats", "shrimp_tpu_torch.core.sw_full", ("LAUNCHES",)),
    ("sw_full_bp", "shrimp_tpu_torch.core.sw_full", ("BP_LAUNCHES",)),
    ("ls_traceback", "shrimp_tpu_torch.core.sw_full", ("TB_LAUNCHES",)),
    ("sw_cs_full", "shrimp_tpu_torch.core.sw_cs_full", ("DP_LAUNCHES",)),
    ("cs_traceback", "shrimp_tpu_torch.core.sw_cs_full", ("TB_LAUNCHES",)),
)


def jax_modules() -> list:
    """The JAX modules (by whole top-level name) this process holds."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in JAX_NAMES})


class Probe:
    """What the harness reads from the port: its mappers' stage seconds,
    its launch counters and, traced, the recorded launches, the host
    stages' times and the profiler."""

    def __init__(self, trace_dir: str | None):
        self.trace_dir = trace_dir
        self.mappers = []
        self.launch_work = []       # (stage, device tensor [cells, bytes])
        self.recording = False
        self.stage_times = []       # (stage, t_end_ns, secs) when recording
        self.prof = None
        self.marker_ns = None

    # ---- wrappers, installed before the CLI runs
    def install(self) -> None:
        import importlib
        from shrimp_tpu_torch import mapper as port_mapper
        probe = self
        init = port_mapper.Mapper.__init__

        def init_and_register(m, *a, **kw):
            init(m, *a, **kw)
            probe.mappers.append(m)
        port_mapper.Mapper.__init__ = init_and_register
        if self.trace_dir is None:
            return
        tally = port_mapper.Mapper.tally

        def tally_and_time(m, stage=None, secs=0.0, **counts):
            tally(m, stage, secs, **counts)
            if stage is not None and probe.recording:
                probe.stage_times.append((stage, time.time_ns(), secs))
        port_mapper.Mapper.tally = tally_and_time
        from mapbench import work
        for mod_name, fn_name, stage, kind in LAUNCHES:
            mod = importlib.import_module(mod_name)
            setattr(mod, fn_name, self._recorder(getattr(mod, fn_name),
                                                 stage, kind, work))

    def _recorder(self, fn, stage, kind, work):
        probe = self

        def launch(*args, **kw):
            out = fn(*args, **kw)
            if probe.recording:
                import torch
                ps = probe.stream
                ps.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(ps):
                    w = work.launch_work(kind, args)
                for t in args:
                    if isinstance(t, torch.Tensor):
                        t.record_stream(ps)
                probe.launch_work.append((stage, w))
            return out
        return launch

    # ---- snapshots
    def counters(self) -> dict:
        import importlib
        out = {}
        for name, mod_name, attrs in COUNTERS:
            mod = importlib.import_module(mod_name)
            out[name] = sum(getattr(mod, a).n for a in attrs)
        return out

    def stage_secs(self) -> dict:
        tot = {}
        for m in self.mappers:
            with m._stats_lock:
                for k, v in m.stats.stage_secs.items():
                    tot[k] = tot.get(k, 0.0) + v
        return tot

    def stats(self) -> dict:
        tot = {"reads": 0, "vec_invocs": 0, "full_invocs": 0}
        for m in self.mappers:
            with m._stats_lock:
                for k in tot:
                    tot[k] += getattr(m.stats, k)
        return tot

    def counts(self) -> dict:
        """The mappers' event counters (`MapperStats.counts`: filter 1's
        owners sent to the card and kept on the host), summed."""
        tot = {}
        for m in self.mappers:
            with m._stats_lock:
                for k, v in m.stats.counts.items():
                    tot[k] = tot.get(k, 0) + v
        return tot

    def snapshot(self) -> dict:
        return {"t_ns": time.time_ns(), "counters": self.counters(),
                "stage_secs": self.stage_secs(), "stats": self.stats(),
                "counts": self.counts()}

    # ---- the window
    def open(self) -> dict:
        return self.snapshot()

    def start_trace(self) -> dict:
        """The end of the untraced window, then the traced span's start."""
        out = {"host_close": self.snapshot()}
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.stream = torch.cuda.Stream()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.marker_ns = self._marker()
        self.recording = True
        out["trace_open"] = self.snapshot()
        return out

    def _marker(self) -> int:
        """A short spin kernel on the benchmark's own stream, the trace's
        mark of this host instant (the card is idle nearly all the time,
        so the kernel starts within microseconds of its launch)."""
        import torch
        torch.cuda.synchronize()
        t = time.time_ns()
        with torch.cuda.stream(self.stream):
            torch.cuda._sleep(MARKER_CYCLES)
        return t

    def close(self) -> dict:
        out = {"close": self.snapshot()}
        if self.trace_dir is not None:
            import torch
            self.recording = False
            close_ns = self._marker()
            torch.cuda.synchronize()
            self.prof.stop()
            path = os.path.join(self.trace_dir, "trace.json")
            self.prof.export_chrome_trace(path)
            work = {}
            if self.launch_work:
                from mapbench.peaks import HBM_BYTES_PER_S, INT32_OPS_PER_S
                by_stage = {}
                for stage, t in self.launch_work:
                    by_stage.setdefault(stage, []).append(t)
                for stage, ts in by_stage.items():
                    w = torch.stack(ts).double()
                    least = torch.maximum(w[:, 0] / INT32_OPS_PER_S,
                                          w[:, 1] / HBM_BYTES_PER_S)
                    work[stage] = {"ops": float(w[:, 0].sum()),
                                   "bytes": float(w[:, 1].sum()),
                                   "least_s": float(least.sum()),
                                   "launches": len(ts)}
            out.update(trace=path, marker_ns=self.marker_ns,
                       close_ns=close_ns, work=work,
                       stage_times=self.stage_times)
        return out


class MainThreadCalls:
    """Runs a probe call in the main thread: torch.profiler has to start
    and stop in the thread that loaded torch. The control thread raises
    SIGUSR1; the handler runs between the main thread's bytecodes (a
    blocking read or lock wait is interrupted and resumed)."""

    def __init__(self):
        self.fn = None
        self.result = None
        self.done = threading.Event()
        signal.signal(signal.SIGUSR1, self._handler)

    def _handler(self, signum, frame) -> None:
        try:
            self.result = ("ok", self.fn())
        except Exception as exc:   # handed to the control thread
            import traceback
            self.result = ("error", f"{exc!r}\n{traceback.format_exc()}")
        self.done.set()

    def __call__(self, fn, timeout: float = 120.0):
        self.fn, self.result = fn, None
        self.done.clear()
        os.kill(os.getpid(), signal.SIGUSR1)
        if not self.done.wait(timeout):
            raise RuntimeError("the main thread did not take the call")
        kind, val = self.result
        if kind == "error":
            raise RuntimeError(val)
        return val


def _control(probe: Probe, report: str, fd: int,
             on_main: MainThreadCalls) -> None:
    """Serve the harness's `open` / `close` commands from the pipe `fd`."""
    rep = {}
    for line in os.fdopen(fd, "r"):
        cmd = line.strip()
        try:
            if cmd == "open":
                rep["open"] = on_main(probe.open)
            elif cmd == "trace":
                rep.update(on_main(probe.start_trace))
                with open(report + ".traced", "w"):
                    pass
            elif cmd == "close":
                rep.update(on_main(probe.close))
                import torch
                dev = torch.cuda.is_available()
                rep["device"] = {
                    "kind": torch.cuda.get_device_name(0) if dev else "cpu",
                    "count": 1,
                    "memory_peak_bytes": (torch.cuda.max_memory_allocated(0)
                                          if dev else 0)}
                rep["jax_modules"] = jax_modules()
                break
        except Exception as exc:   # the harness reads the failure
            import traceback
            rep["error"] = f"{cmd}: {exc!r}\n{traceback.format_exc()}"
            break
    tmp = report + ".tmp"
    with open(tmp, "w") as f:
        json.dump(rep, f)
    os.replace(tmp, report)


def main(argv: list) -> int:
    i = argv.index("--")
    own, cli_args = argv[:i], argv[i + 1:]
    report = own[own.index("--report") + 1]
    trace_dir = own[own.index("--trace") + 1] if "--trace" in own else None
    control = int(own[own.index("--control") + 1])
    device = cli_args[cli_args.index("--device") + 1]
    if device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            print("mapbench.child: no CUDA device", file=sys.stderr)
            return 3
    probe = Probe(trace_dir)
    probe.install()
    threading.Thread(target=_control, args=(probe, report, control,
                                            MainThreadCalls()),
                     daemon=True).start()
    from shrimp_tpu_torch import cli
    return cli.main(["map", *cli_args])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
