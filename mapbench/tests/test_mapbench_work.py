"""The roofline work count against a hand count on small windows, and
the union of device intervals behind the idle share."""
import json

import numpy as np
import torch

from mapbench import peaks, trace, work


def _hand_band(glen, rlen, ax, ay, alen, awid):
    """anchor_get_x_range row by row, clipped to [0, glen - 1]."""
    cells = 0
    for i in range(rlen):
        if i < ay:
            lo = 0
        elif i <= ay + alen - 1:
            lo = ax + (i - ay)
        else:
            lo = ax + alen
        lo = min(max(lo, 0), glen - 1)
        if i < ay - (awid - 1):
            hi = ax + (awid - 1) - 1
        elif i <= ay - (awid - 1) + alen - 1:
            hi = ax + (awid - 1) + (i - (ay - (awid - 1)))
        else:
            hi = glen - 1
        hi = min(max(hi, 0), glen - 1)
        cells += max(hi - lo + 1, 0)
    return cells


def test_band_cells_match_hand_count():
    rows = [(50, 36, 3, 4, 20, 9), (50, 36, -6, 10, 30, 17),
            (64, 36, 0, 0, 36, 1), (40, 36, 10, 2, 5, 3),
            (50, 30, 20, 30, 10, 9)]
    t = [torch.tensor(c, dtype=torch.int32) for c in zip(*rows)]
    got = work.band_cells(*t, R=36).tolist()
    assert got == [_hand_band(*r) for r in rows]


def test_vector_and_full_sw_work():
    g = torch.zeros((3, 64), dtype=torch.uint8)
    r = torch.zeros((3, 40), dtype=torch.uint8)
    glen = torch.tensor([50, 64, 1], dtype=torch.int32)
    rlen = torch.tensor([36, 40, 1], dtype=torch.int32)
    ops, nbytes = work.launch_work("vector", (g, glen, r, rlen,
                                              None)).tolist()
    cells = 50 * 36 + 64 * 40 + 1
    assert ops == peaks.OPS_PER_CELL["vector"] * cells
    assert nbytes == (50 + 64 + 1) + (36 + 40 + 1) + 4 * 3
    ax = torch.tensor([3, 0, 0], dtype=torch.int32)
    ay = torch.tensor([4, 0, 0], dtype=torch.int32)
    al = torch.tensor([20, 40, 1], dtype=torch.int32)
    aw = torch.tensor([9, 1, 1], dtype=torch.int32)
    rev = torch.zeros(3, dtype=torch.int32)
    ops, nbytes = work.launch_work(
        "ls_stats", (g, glen, r, rlen, ax, ay, al, aw, rev)).tolist()
    want = sum(_hand_band(*x) for x in [(50, 36, 3, 4, 20, 9),
                                        (64, 40, 0, 0, 40, 1),
                                        (1, 1, 0, 0, 1, 1)])
    assert ops == peaks.OPS_PER_CELL["ls_stats"] * want


def test_union_and_idle_share(tmp_path):
    assert trace.union([(5, 7), (1, 3), (2, 4), (7, 8)]) == [[1, 4], [5, 8]]
    ev = [{"cat": "kernel", "name": "spin_kernel", "ts": 1000, "dur": 1,
           "args": {"stream": 99}},
          {"cat": "kernel", "name": "void sw_vector_kernel<64, 8>", "ts":
           1100, "dur": 100, "args": {"stream": 7}},
          {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 1150, "dur":
           100, "args": {"stream": 7}},
          {"cat": "kernel", "name": "sw_full_stats_kernel", "ts": 1500,
           "dur": 50, "args": {"stream": 7}},
          {"cat": "kernel", "name": "work count", "ts": 1600, "dur": 300,
           "args": {"stream": 99}},
          {"cat": "kernel", "name": "spin_kernel", "ts": 2000, "dur": 1,
           "args": {"stream": 99}}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    snap = {"counters": {"sw_vector": 0, "sw_full_stats": 0}}
    rep = {"trace": str(path), "trace_open": snap,
           "close": {"counters": {"sw_vector": 1, "sw_full_stats": 1}},
           "marker_ns": 0, "close_ns": 1_000_000,
           "stage_times": [("filter1", 450_000, 0.0004)], "work": {}}
    s = trace.summarize(rep)
    # busy: [1100, 1250] and [1500, 1550]; the benchmark's own stream out
    assert abs(s["busy_s"] - 200e-6) < 1e-12
    assert abs(s["window_s"] - 1000e-6) < 1e-12
    assert abs(s["stage_time"]["filter2"] - 100e-6) < 1e-12
    assert not [n for n in s["notes"] if "launches counted" in n]
    idle = dict(s["breakdown"]["idle_gaps"])
    # filter1 ran over host [50, 450] us -> trace [1050, 1450]: idle
    # [1050, 1100] and [1250, 1450]
    assert abs(idle["filter1"] - 250e-6) < 1e-12


def test_overlap_sum_matches_interval_by_interval():
    rng = np.random.default_rng(7)
    for _ in range(100):
        s = rng.uniform(0, 100, rng.integers(0, 30))
        merged = trace.union(zip(s, s + rng.uniform(0, 10, len(s))))
        a = rng.uniform(-10, 110, rng.integers(0, 20))
        ivs = list(zip(a, a + rng.uniform(-2, 20, len(a))))
        want = sum(max(0.0, min(a1, e) - max(a0, b))
                   for a0, a1 in ivs for b, e in merged)
        assert abs(trace.overlap_sum(ivs, merged) - want) < 1e-9
