"""Spans: named intervals of the mapper's work, on CLOCK_MONOTONIC.

`Span` times a block with `time.perf_counter_ns()` (CLOCK_MONOTONIC on
Linux, the clock filter 1's native counters use too). A span made with a
`tally` (`Mapper.span`) hands its seconds to it on exit, so the mapper's
stage seconds see every stage whether or not anything is recorded; a
span without one (`span`: the CLI window, a pipeline lane, the caller's
wait for a result) is a grouping and is not a stage.

The recorder is off until `enable()`. Off, a span costs a flag test and
its timer, and keeps nothing. On, every span that ends appends a record
to its thread's list: `(name, start_ns, end_ns, thread, span_id,
parent_id, window, batch, attrs)`, the parent being the innermost span
recorded open on that thread, and the window and batch ids those of the
thread's context (set by the span that passes `window=` or `batch=`).
At most `MAX_RECORDS` are kept in all; the rest are counted. `drain()`
returns what was kept and a `(time.time_ns(), time.perf_counter_ns())`
pair sampled back to back, which puts the records on the wall clock.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple, Optional

MAX_RECORDS = 1 << 20

_on = False
_ids = itertools.count(1)
_lock = threading.Lock()
_local = threading.local()
_threads = []          # every thread's _Thread, for drain()


class _Thread:
    __slots__ = ("tid", "records", "dropped", "stack", "window", "batch")

    def __init__(self):
        self.tid = threading.get_native_id()
        self.records = []
        self.dropped = 0
        self.stack = []
        self.window = self.batch = None


def _thread() -> _Thread:
    st = getattr(_local, "st", None)
    if st is None:
        st = _local.st = _Thread()
        with _lock:
            _threads.append(st)
    return st


class Drained(NamedTuple):
    records: list
    clock_pair: tuple      # (time.time_ns(), time.perf_counter_ns())
    dropped: int


def enable() -> None:
    """Start recording spans (the ids restart at 1)."""
    global _on, _ids
    _ids = itertools.count(1)
    _on = True


def disable() -> None:
    global _on
    _on = False


def drain() -> Drained:
    """The records kept since `enable()` or the last drain, oldest
    first, and the clock pair; the lists start again empty."""
    records, dropped = [], 0
    with _lock:
        for st in _threads:
            got, st.records = st.records, []
            records += got
            dropped += st.dropped
            st.dropped = 0
    records.sort(key=lambda r: r[1])
    return Drained(records, (time.time_ns(), time.perf_counter_ns()),
                   dropped)


def window() -> Optional[int]:
    """The CLI window id of this thread's context (None: recorder off)."""
    return _thread().window if _on else None


class Span:
    """`with Span(name, tally, attrs):` times the block, hands its seconds
    to `tally(name, secs)` (None: not a stage) and, with the recorder on,
    records it. `window` and `batch` in `attrs` set this thread's context
    for the block."""

    __slots__ = ("name", "tally", "attrs", "t0", "sid", "st", "saved")

    def __init__(self, name: str, tally=None, attrs: Optional[dict] = None):
        self.name, self.tally, self.attrs = name, tally, attrs
        self.st = None

    def __enter__(self) -> "Span":
        if _on:
            st = self.st = _thread()
            self.sid = next(_ids)
            st.stack.append(self.sid)
            self.saved = (st.window, st.batch)
            a = self.attrs
            if a:
                st.window = a.pop("window", st.window)
                st.batch = a.pop("batch", st.batch)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter_ns()
        if self.tally is not None:
            self.tally(self.name, (t1 - self.t0) * 1e-9)
        st = self.st
        if st is None:
            if not _on:
                return
            # opened before the recorder was on: kept, with no parent
            # of its own on the stack
            st, sid = _thread(), next(_ids)
            parent = st.stack[-1] if st.stack else 0
            w, b = st.window, st.batch
        else:
            st.stack.pop()
            sid = self.sid
            parent = st.stack[-1] if st.stack else 0
            w, b = st.window, st.batch
            st.window, st.batch = self.saved
            if not _on:
                return
        if sid > MAX_RECORDS:
            st.dropped += 1
            return
        st.records.append((self.name, self.t0, t1, st.tid, sid, parent, w,
                           b, self.attrs or None))


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None


_NULL = _Null()


class _Ids:
    __slots__ = ("window", "batch", "st", "saved")

    def __init__(self, window, batch):
        self.window, self.batch = window, batch

    def __enter__(self) -> "_Ids":
        st = self.st = _thread()
        self.saved = (st.window, st.batch)
        st.window, st.batch = self.window, self.batch
        return self

    def __exit__(self, *exc) -> None:
        self.st.window, self.st.batch = self.saved


def ids(window: Optional[int], batch: Optional[int]):
    """This thread's window and batch ids for a block, with nothing
    recorded (nothing at all while the recorder is off)."""
    return _Ids(window, batch) if _on else _NULL


def span(name: str, **attrs):
    """A span that is not a stage: recorded while the recorder is on,
    nothing at all while it is off."""
    return Span(name, None, attrs) if _on else _NULL


def chrome_trace(d: Drained, pid: int = 0) -> dict:
    """The records as Chrome trace JSON (one complete event a span, `ts`
    in microseconds since the Unix epoch, `tid` the thread; `args` holds
    the window, batch, parent, id and attributes such as `bytes`), to
    load beside a torch.profiler trace."""
    wall_ns, mono_ns = d.clock_pair
    off = wall_ns - mono_ns
    events = []
    for name, t0, t1, tid, sid, parent, w, b, attrs in d.records:
        args = {"window": w, "batch": b, "parent": parent, "id": sid}
        if attrs:
            args.update(attrs)
        events.append({"name": name, "ph": "X", "cat": "span",
                       "ts": (t0 + off) / 1e3, "dur": (t1 - t0) / 1e3,
                       "pid": pid, "tid": tid, "args": args})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"spans_dropped": d.dropped}}
