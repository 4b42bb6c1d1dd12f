"""The port's span recorder (`shrimp_tpu_torch/utils/spans.py`): off it
keeps nothing and leaves the stage seconds as they were; on, spans nest,
carry their CLI window and batch ids across the pipeline's lanes and stop
at the bound; `map --spans` writes them without changing the SAM; filter
1's two native counters share out its stage; and the fast streams leave
`vec_secs` / `full_secs` to the generic mapper, whose SW calls they time."""
import contextlib
import io
import json
import sys
import threading

import pytest
import torch

from shrimp_tpu_torch import cli, fastpath
from shrimp_tpu_torch.core import encode
from shrimp_tpu_torch.index import build as port_build
from shrimp_tpu_torch.index.seeds import default_seeds
from shrimp_tpu_torch.io.fasta import SeqRecord
from shrimp_tpu_torch.mapper import Mapper
from shrimp_tpu_torch.utils import memmodel, spans

from .test_e2e_unpaired import make_dataset

STAGES = {"read prep", "filter1", "device dispatch", "device fetch",
          "pass1 select", "alignment expand", "finalize + render"}
WORK = STAGES | {"device upload", "filter1 lookup", "filter1 windows",
                 "cli read", "cli write"}


@pytest.fixture(autouse=True)
def _isolate(monkeypatch):
    """One torch thread, plain index arrays, the recorder off after."""
    monkeypatch.setattr(port_build, "to_hugepages", lambda a: a)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
    spans.disable()
    spans.drain()
    memmodel.init()


def _data(tmp_path, n_reads):
    gpath, rpath, g, reads = make_dataset(str(tmp_path), n_reads=n_reads)
    idx = port_build.build_index([("chr_test", encode.encode_ls(g))],
                                 default_seeds())
    return gpath, rpath, idx, [SeqRecord(n, s) for n, s in reads]


def _stream(idx, recs, batch_size=64):
    m = Mapper(idx, device="cpu")
    sam = b"".join(fastpath.map_unpaired_sam_stream(
        m, recs, batch_size=batch_size, lanes=4))
    return m, sam


def test_recorder_off_keeps_nothing(tmp_path):
    """Off: no records, the same SAM and the same stage keys as on; the
    stage keys hold every stage of the stats flow and the new ones;
    filter 1's lookup and windows share out its stage."""
    _, _, idx, recs = _data(tmp_path, 300)
    m_off, sam_off = _stream(idx, recs)
    assert spans.drain().records == []
    spans.enable()
    m_on, sam_on = _stream(idx, recs)
    spans.disable()
    assert spans.drain().records
    assert sam_on == sam_off
    keys = set(m_off.stats.stage_secs)
    assert keys == set(m_on.stats.stage_secs)
    assert keys >= STAGES | {"device upload", "filter1 lookup",
                             "filter1 windows"}
    for m in (m_off, m_on):
        st = m.stats.stage_secs
        assert st["filter1 lookup"] > 0 and st["filter1 windows"] > 0
        assert st["filter1 lookup"] + st["filter1 windows"] <= st["filter1"]


def test_spans_nest_and_carry_ids():
    """Parent ids nest on a thread, a lane's window and batch ids reach
    its spans on another thread, the ids come back after the block, and
    past the bound records are counted, not kept."""
    tallied = []
    tally = lambda name, secs: tallied.append((name, secs))
    spans.enable()
    with spans.span("cli window", window=3):
        w = spans.window()
        with spans.Span("cli read", tally):
            pass

        def lane(b):
            with spans.span("lane", window=w, batch=b):
                with spans.Span("filter1", tally, {"bytes": 8}):
                    with spans.Span("device upload", tally):
                        pass
            assert spans.window() is None
        ts = [threading.Thread(target=lane, args=(b,)) for b in (0, 1)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(10)
            assert not t.is_alive()
        with spans.ids(w, 0):
            with spans.Span("read prep", tally):
                pass
    d = spans.drain()
    assert d.dropped == 0 and len(d.records) == 9
    by_id = {r[4]: r for r in d.records}
    name = lambda r: r[0]
    for r in d.records:
        t0, t1, tid, parent, window, batch = r[1], r[2], r[3], r[5], r[6], \
            r[7]
        assert window == 3 and t0 <= t1
        if parent:
            p = by_id[parent]
            assert p[3] == tid and p[1] <= t0 and t1 <= p[2]
        if name(r) == "device upload":
            assert name(by_id[parent]) == "filter1"
        if name(r) == "filter1":
            assert name(by_id[parent]) == "lane"
            assert by_id[parent][7] == batch and r[8] == {"bytes": 8}
    assert {r[7] for r in d.records if name(r) == "lane"} == {0, 1}
    assert [r[7] for r in d.records if name(r) == "read prep"] == [0]
    assert name(by_id[[r for r in d.records if name(r) == "read prep"][0][5]]
                ) == "cli window"
    # the stages went to their tally, recorded or not
    assert sorted(n for n, _ in tallied) == sorted(
        ["cli read", "filter1", "filter1", "device upload", "device upload",
         "read prep"])
    spans.disable()
    with spans.Span("read prep", tally):
        pass
    assert spans.drain().records == [] and len(tallied) == 7
    # the bound
    old = spans.MAX_RECORDS
    spans.MAX_RECORDS = 5
    try:
        spans.enable()
        for _ in range(8):
            with spans.span("lane"):
                pass
        d = spans.drain()
    finally:
        spans.MAX_RECORDS = old
    assert len(d.records) == 5 and d.dropped == 3


def _map(argv):
    """The SAM bytes of one in-process `map --device cpu` call."""
    out = io.TextIOWrapper(io.BytesIO(), write_through=True)
    err = io.StringIO()
    old = sys.stdout
    sys.stdout = out
    try:
        with contextlib.redirect_stderr(err):
            assert cli.main(["map", "--device", "cpu", *argv]) == 0
    finally:
        sys.stdout = old
    return out.buffer.getvalue()


def test_map_spans_export(tmp_path, monkeypatch):
    """`map --spans`: the same SAM as without; in each of two CLI
    windows one `lane` span per batch; every stage span on a lane thread
    inside its lane, the others (batch 0's prepare) on the caller's
    thread inside their window; `cli read` and `cli write` spans."""
    monkeypatch.setattr(cli, "WINDOW_READS", 128)
    gpath, rpath, _, recs = _data(tmp_path, 150)
    B = 16              # windows of 8 * B = 128 reads: 128, 22
    plain = _map(["-B", str(B), rpath, gpath])
    path = tmp_path / "spans.json"
    traced = _map(["-B", str(B), "--spans", str(path), rpath, gpath])
    assert traced == plain and plain.count(b"\n") > 60
    ev = json.loads(path.read_text())["traceEvents"]
    assert ev and all(e["ph"] == "X" and e["dur"] >= 0 for e in ev)
    by_id = {e["args"]["id"]: e for e in ev}
    windows = [e for e in ev if e["name"] == "cli window"]
    assert sorted(e["args"]["window"] for e in windows) == [0, 1]
    lanes = {}
    for e in ev:
        if e["name"] == "lane":
            key = (e["args"]["window"], e["args"]["batch"])
            assert key not in lanes
            lanes[key] = e
    assert sorted(lanes) == [(w, b) for w, n in ((0, 8), (1, 2))
                             for b in range(n)]
    inside = lambda a, b: (b["ts"] <= a["ts"] and a["ts"] + a["dur"]
                           <= b["ts"] + b["dur"] + 1e-3)
    n_stage = 0
    for e in ev:
        if e["name"] not in WORK or e["name"].startswith("cli"):
            continue
        n_stage += 1
        a = e["args"]
        up = by_id.get(a["parent"])
        while up is not None and up["name"] not in ("lane", "cli window"):
            up = by_id.get(up["args"]["parent"])
        assert up is not None, e
        assert inside(e, up), (e, up)
        if up["name"] == "lane":
            assert (a["window"], a["batch"]) == (up["args"]["window"],
                                                 up["args"]["batch"])
            assert up["tid"] == e["tid"]
        else:           # batch 0's prepare, on the caller's thread
            assert a["batch"] == 0 and a["window"] == up["args"]["window"]
    assert n_stage > 10 * 6
    uploads = [e for e in ev if e["name"] == "device upload"]
    assert uploads and all(e["args"]["bytes"] > 0 for e in uploads)
    assert all(by_id[e["args"]["parent"]]["name"] == "device dispatch"
               for e in uploads if e["args"]["window"] is not None)
    for name in ("cli read", "cli write"):
        got = [e for e in ev if e["name"] == name]
        assert got and all(inside(e, by_id[e["args"]["parent"]])
                           for e in got)
    assert sum(e["args"]["bytes"] for e in ev if e["name"] == "cli write") \
        == len(traced) - sum(len(x) + 1 for x in traced.split(b"\n")
                             if x.startswith(b"@"))
    waits = [e for e in ev if e["name"] == "result wait"]
    assert {(e["args"]["window"], e["args"]["batch"]) for e in waits} == \
        set(lanes)


def test_fast_streams_leave_sw_seconds_to_the_generic_mapper(tmp_path):
    """The fused fast path's device step times neither SW alone, so it
    adds to neither `vec_secs` nor `full_secs` and the report prints no
    cells per second; the generic mapper's SW calls keep theirs."""
    _, _, idx, recs = _data(tmp_path, 120)
    m, _ = _stream(idx, recs)
    assert m.stats.vec_invocs > 0 and m.stats.full_invocs > 0
    assert m.stats.vec_secs == 0 and m.stats.full_secs == 0
    out = io.StringIO()
    m.stats.report(out)
    assert "Cells per Second" not in out.getvalue()
    g = Mapper(idx, device="cpu")
    list(g.map_unpaired(recs[:40]))
    assert g.stats.vec_secs > 0 and g.stats.full_secs > 0
