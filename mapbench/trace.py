"""The traced window, read from the child's report and its profiler
trace (chrome trace JSON of torch.profiler): device busy and window
seconds (the union of kernel, copy and set intervals), device time and
event count by kernel family, the work the launch recorder counted by
stage, the idle time under each host stage, and the breakdown."""
from __future__ import annotations

import json

import numpy as np

# kernel family -> algorithm stage
FAMILIES = {"sw_vector": "filter2", "sw_full_stats": "filter3",
            "sw_full_bp": "filter3", "ls_traceback": "filter3",
            "sw_cs_full": "filter3", "cs_traceback": "filter3"}
GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def family(name: str):
    for f in FAMILIES:
        if f in name:
            return f
    return None


def union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def overlap_sum(intervals, merged) -> float:
    """The total length of the (start, end) `intervals` that lies inside
    `merged` (sorted and disjoint, as `union` gives): each interval's
    share is the difference of the length `merged` covers up to its two
    ends, so a traced window of many device gaps and host stages costs
    a sort, not a product of the two counts."""
    if not len(intervals) or not len(merged):
        return 0.0
    m = np.asarray(merged, np.float64)
    iv = np.asarray(intervals, np.float64)
    lens = m[:, 1] - m[:, 0]
    before = np.concatenate(([0.0], np.cumsum(lens)))

    def covered(t):
        k = np.searchsorted(m[:, 0], t, side="right") - 1
        kk = np.maximum(k, 0)
        inside = np.clip(t - m[kk, 0], 0.0, lens[kk])
        return np.where(k >= 0, before[kk] + inside, 0.0)
    return float(np.maximum(covered(iv[:, 1]) - covered(iv[:, 0]),
                            0.0).sum())


def summarize(rep: dict) -> dict:
    with open(rep["trace"]) as f:
        events = json.load(f)["traceEvents"]
    notes = []
    gpu = [e for e in events if e.get("cat") in GPU_CATS and "dur" in e]
    spins = sorted((e for e in gpu if "spin" in e.get("name", "")),
                   key=lambda e: float(e["ts"]))
    own = None
    if len(spins) >= 2:
        own = spins[0].get("args", {}).get("stream")
        t0, t1 = float(spins[0]["ts"]), float(spins[-1]["ts"])
    else:
        notes.append("trace: window markers missing; the window is the "
                     "span of the device events")
        t0 = min((float(e["ts"]) for e in gpu), default=0.0)
        t1 = max((float(e["ts"]) + float(e["dur"]) for e in gpu),
                 default=0.0)
    gpu = [e for e in gpu if own is None
           or e.get("args", {}).get("stream") != own]
    clip = []
    by_name, by_family, count = {}, {}, {}
    for e in gpu:
        s = max(float(e["ts"]), t0)
        end = min(float(e["ts"]) + float(e["dur"]), t1)
        if end <= s:
            continue
        clip.append((s, end))
        nm = e["name"][:80]
        by_name[nm] = by_name.get(nm, 0.0) + (end - s) * 1e-6
        fam = family(e["name"]) if e["cat"] == "kernel" else None
        if fam is not None:
            by_family[fam] = by_family.get(fam, 0.0) + (end - s) * 1e-6
            count[fam] = count.get(fam, 0) + 1
    busy = union(clip)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    window_s = (t1 - t0) * 1e-6
    stage_time = {}
    for fam, secs in by_family.items():
        st = FAMILIES[fam]
        stage_time[st] = stage_time.get(st, 0.0) + secs
    # the port's launch counters against the profiler's kernel events
    o, c = rep["trace_open"]["counters"], rep["close"]["counters"]
    for fam in FAMILIES:
        want = c.get(fam, 0) - o.get(fam, 0)
        if want != count.get(fam, 0):
            notes.append(f"trace: {fam} launches counted {want}, kernel "
                         f"events in the trace {count.get(fam, 0)}")
    # idle time under each host stage, the stage times put on the
    # trace's clock through the open marker
    idle = []
    prev = t0
    for s, e in busy:
        if s > prev:
            idle.append([prev, s])
        prev = max(prev, e)
    if t1 > prev:
        idle.append([prev, t1])
    idle_s = sum(e - s for s, e in idle) * 1e-6
    spans = {}
    if len(spins) >= 2:
        off = t0 - rep["marker_ns"] / 1e3
        for stage, end_ns, secs in rep.get("stage_times", []):
            e = end_ns / 1e3 + off
            spans.setdefault(stage, []).append((e - secs * 1e6, e))
    under = {}
    for stage, iv in spans.items():
        under[stage] = overlap_sum(union(iv), idle) * 1e-6
    covered = union([iv for ivs in spans.values() for iv in ivs])
    under["no host stage"] = idle_s - overlap_sum(covered, idle) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:10]]
    host_s = (rep["close_ns"] - rep["marker_ns"]) * 1e-9
    notes.append(f"trace: window {window_s} s on the device's clock, "
                 f"{host_s} s on the host's; busy {busy_s} s; device time "
                 f"by stage {stage_time}; work {rep.get('work', {})}")
    return dict(busy_s=busy_s, window_s=window_s, stage_time=stage_time,
                work=rep.get("work", {}), notes=notes,
                breakdown={"device_ops": top(by_name),
                           "idle_gaps": top(under)})
