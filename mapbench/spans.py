"""The program's own spans (`shrimp_tpu_torch/utils/spans.py`) on the
device trace's clock: how much of the card's idle time falls under the
host work they record.

A traced report that carries them holds `spans` (the records: name,
start and end in CLOCK_MONOTONIC ns, thread, id, parent, window, batch,
attributes) and `clock_pair` (`time.time_ns()`, `time.perf_counter_ns()`
sampled back to back). The pair moves a span onto the host's wall clock,
and the two marker kernels (`Probe._marker`, launched at `marker_ns` and
`close_ns` on that clock) move it onto the profiler's: a host instant t
is device time t0 + (t - marker_ns) / 1e3 us, t0 the first marker's
start. The markers' interval has to agree on both clocks within
`AGREE_US`; where it does not, nothing is read.

Work spans are every span but the groupings `NOT_WORK`: the CLI window,
a pipeline lane and the caller's wait for a result. The card's idle time
is taken as `device.idle_pct` takes it (`trace.summarize`): the window
between the markers less the union of the device's kernels, copies and
sets, the markers' own stream left out.
"""
from __future__ import annotations

import json
import sys

from mapbench.trace import GPU_CATS, union

NOT_WORK = ("cli window", "lane", "result wait")
AGREE_US = 1000.0


def device_idle(trace_path: str):
    """(t0, t1, idle intervals) of the traced window on the device's
    clock (us), or None without both markers."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    gpu = [e for e in events if e.get("cat") in GPU_CATS and "dur" in e]
    spins = sorted((e for e in gpu if "spin" in e.get("name", "")),
                   key=lambda e: float(e["ts"]))
    if len(spins) < 2:
        return None
    own = spins[0].get("args", {}).get("stream")
    t0, t1 = float(spins[0]["ts"]), float(spins[-1]["ts"])
    busy = union((max(float(e["ts"]), t0),
                  min(float(e["ts"]) + float(e["dur"]), t1))
                 for e in gpu if e.get("args", {}).get("stream") != own
                 and float(e["ts"]) < t1
                 and float(e["ts"]) + float(e["dur"]) > t0)
    idle, prev = [], t0
    for s, e in busy:
        if s > prev:
            idle.append([prev, s])
        prev = max(prev, e)
    if t1 > prev:
        idle.append([prev, t1])
    return t0, t1, idle


def on_device(rep: dict, t0: float, t1: float, log=None):
    """The report's spans as (name, start, end) on the device's clock
    (us); None where the report has none or the markers' interval
    disagrees between the clocks by more than AGREE_US."""
    recs, pair = rep.get("spans"), rep.get("clock_pair")
    if not recs or not pair:
        return None
    host_us = (rep["close_ns"] - rep["marker_ns"]) / 1e3
    if abs(host_us - (t1 - t0)) > AGREE_US:
        print(f"mapbench.spans: the markers lie {host_us} us apart on the "
              f"host's clock and {t1 - t0} us on the device's",
              file=log or sys.stderr)
        return None
    shift = pair[0] - pair[1] - rep["marker_ns"]       # mono ns -> host
    return [(r[0], t0 + (r[1] + shift) / 1e3, t0 + (r[2] + shift) / 1e3)
            for r in rep["spans"]]


def outside(idle, work) -> list:
    """The parts of the sorted `idle` intervals that no interval of the
    merged, sorted `work` covers."""
    gaps, k = [], 0
    for s, e in idle:
        while k < len(work) and work[k][1] <= s:
            k += 1
        cur, j = s, k
        while j < len(work) and work[j][0] < e:
            if work[j][0] > cur:
                gaps.append([cur, work[j][0]])
            cur = max(cur, work[j][1])
            j += 1
        if cur < e:
            gaps.append([cur, e])
    return gaps


def attribution(rep: dict, log=None):
    """(idle us, idle us under no work span, the unattributed intervals,
    the work spans as (name, start, end) on the device's clock), or None
    where the trace or the spans give nothing to read."""
    win = device_idle(rep["trace"]) if rep.get("trace") else None
    if win is None:
        return None
    t0, t1, idle = win
    sp = on_device(rep, t0, t1, log)
    if sp is None:
        return None
    sp = [x for x in sp if x[0] not in NOT_WORK]
    work = union((a, b) for _, a, b in sp)
    idle_us = sum(e - s for s, e in idle)
    gaps = outside(idle, work)
    return idle_us, sum(e - s for s, e in gaps), gaps, sp


def unattributed_pct(rep: dict, log=None):
    """The share of the card's idle time under no work span, in %."""
    got = attribution(rep, log)
    if got is None or got[0] <= 0:
        return None
    return 100.0 * got[1] / got[0]


def largest_gaps(rep: dict, n: int = 10, log=None) -> list:
    """The `n` longest unattributed idle intervals: (us, the work span
    that ended last before it, the first that started after it)."""
    got = attribution(rep, log)
    if got is None:
        return []
    sp = got[3]
    out = []
    for s, e in sorted(got[2], key=lambda g: g[0] - g[1])[:n]:
        before = max((x for x in sp if x[2] <= s + 1e-3),
                     key=lambda x: x[2], default=None)
        after = min((x for x in sp if x[1] >= e - 1e-3),
                    key=lambda x: x[1], default=None)
        out.append((e - s, before and before[0], after and after[0]))
    return out
