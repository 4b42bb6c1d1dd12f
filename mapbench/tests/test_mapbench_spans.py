"""Program spans on the device trace's clock (`mapbench/spans.py`): the
idle time under the work spans of a synthetic report, and nothing read
where the markers' interval disagrees between the clocks or the report
holds no spans."""
import io
import json

from mapbench import spans
from mapbench.metrics import load as load_metric

EVENTS = [
    {"cat": "kernel", "name": "spin_kernel", "ts": 1000, "dur": 1,
     "args": {"stream": 99}},
    {"cat": "kernel", "name": "sw_vector_kernel", "ts": 1100, "dur": 100,
     "args": {"stream": 7}},
    {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 1150, "dur": 100,
     "args": {"stream": 7}},
    {"cat": "kernel", "name": "sw_full_stats_kernel", "ts": 1500, "dur": 50,
     "args": {"stream": 7}},
    {"cat": "kernel", "name": "work count", "ts": 1600, "dur": 300,
     "args": {"stream": 99}},
    {"cat": "kernel", "name": "spin_kernel", "ts": 2000, "dur": 1,
     "args": {"stream": 99}}]
# (name, start, end) in CLOCK_MONOTONIC ns; with this clock pair and a
# first marker at host 0 ns, ns n lies at device 1000 + n / 1000 us
SPANS = [("lane", 0, 1_000_000), ("filter1", 50_000, 450_000),
         ("device upload", 400_000, 480_000),
         ("cli write", 600_000, 700_000),
         ("result wait", 700_000, 1_000_000)]


def _report(tmp_path, close_ns=1_000_000, recs=SPANS):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    return {"trace": str(path), "marker_ns": 0, "close_ns": close_ns,
            "clock_pair": [10**9, 10**9],
            "spans": [[n, a, b, 1, i + 1, 0, 0, 0, None]
                      for i, (n, a, b) in enumerate(recs)]}


def test_idle_under_work_spans(tmp_path):
    rep = _report(tmp_path)
    # idle [1000, 1100], [1250, 1500], [1550, 2000]: 800 us; the work
    # spans [1050, 1480] and [1600, 1700] cover 50 + 230 + 100 of it
    idle, free, gaps, work = spans.attribution(rep)
    assert [n for n, _, _ in work] == ["filter1", "device upload",
                                       "cli write"]
    assert abs(idle - 800) < 1e-9 and abs(free - 420) < 1e-9
    assert [[round(a), round(b)] for a, b in gaps] == [
        [1000, 1050], [1480, 1500], [1550, 1600], [1700, 2000]]
    assert abs(spans.unattributed_pct(rep) - 52.5) < 1e-9
    got = load_metric("device.idle_unattributed_pct").read(
        {"report": rep})
    assert abs(got - 52.5) < 1e-9
    top = spans.largest_gaps(rep, 2)
    assert [(round(u), b, a) for u, b, a in top] == [
        (300, "cli write", None), (50, None, "filter1")]


def test_nothing_read_where_the_clocks_disagree(tmp_path):
    # 2.1 ms apart on the host, 1 ms on the device
    err = io.StringIO()
    assert spans.unattributed_pct(_report(tmp_path, 2_100_000),
                                  err) is None
    assert "2100.0 us apart on the host's clock" in err.getvalue()
    # 1.9 ms against 1 ms: within the limit
    assert spans.unattributed_pct(_report(tmp_path, 1_900_000)) is not None
    assert spans.unattributed_pct(_report(tmp_path, recs=[])) is None
    assert load_metric("device.idle_unattributed_pct").read({}) is None
