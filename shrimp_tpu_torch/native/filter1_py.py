"""ctypes wrapper around the native filter-1 implementation.

Copied from `shrimp_tpu/native/filter1_py.py`: the same FlatHits
structure from the same C++ (`filter1.cpp`). The port's library raises
if it does not build, and the thread count is the caller's or the
host's core count (no environment override). The C++ splits each
call's time into its k-mer lookup and the rest, which a caller's
`tally` receives as the stages `filter1 lookup` and `filter1 windows`;
a call that overflowed its output cap and ran again is `filter1
overflow`. `generate_candidates_survivors` runs the back half alone
(filter1.cpp's filter1_survivors) over postings that the device's front
half collected, sorted and region-filtered (`core/filter1_front.py`).
"""
from __future__ import annotations

import ctypes
import time
from typing import Callable, Optional

import numpy as np

from . import get_lib
from ..core.batch_pipeline import FlatHits, _empty_flat


class _SeedSpec(ctypes.Structure):
    _fields_ = [
        ("span", ctypes.c_int32),
        ("weight", ctypes.c_int32),
        ("n_offsets", ctypes.c_int32),
        ("off_is_32", ctypes.c_int32),
        ("offsets", ctypes.c_void_p),
        ("csr_offsets", ctypes.c_void_p),
        ("csr_positions", ctypes.c_void_p),
    ]


class _Params(ctypes.Structure):
    _fields_ = [
        ("n_seeds", ctypes.c_int32),
        ("read_len", ctypes.c_int32),
        ("window_len", ctypes.c_int32),
        ("cutoff", ctypes.c_int64),
        ("match_mode", ctypes.c_int32),
        ("threshold", ctypes.c_double),
        ("match_score", ctypes.c_int32),
        ("b_gap_open", ctypes.c_int32),
        ("b_gap_extend", ctypes.c_int32),
        ("min_kmer_pos", ctypes.c_int32),
        ("use_region_counts", ctypes.c_int32),
        ("region_bits", ctypes.c_int32),
        ("region_overlap", ctypes.c_int32),
        ("collapse", ctypes.c_int32),
        ("gapless", ctypes.c_int32),
        ("search_fw", ctypes.c_int32),
        ("search_rv", ctypes.c_int32),
        ("hashed", ctypes.c_int32),
        ("max_seed_span", ctypes.c_int32),
        ("genome_total_len", ctypes.c_int64),
        ("n_contigs", ctypes.c_int32),
        ("contig_offsets", ctypes.c_void_p),
        ("contig_lengths", ctypes.c_void_p),
        ("mp_mode", ctypes.c_int32),
        ("mp_drmin", ctypes.c_void_p),
        ("mp_drmax", ctypes.c_void_p),
    ]


class _Out(ctypes.Structure):
    _fields_ = [
        ("cap", ctypes.c_int64),
        ("owner", ctypes.c_void_p),
        ("cn", ctypes.c_void_p),
        ("g_off", ctypes.c_void_p),
        ("w_len", ctypes.c_void_p),
        ("score_window_gen", ctypes.c_void_p),
        ("matches", ctypes.c_void_p),
        ("score_max", ctypes.c_void_p),
        ("ax", ctypes.c_void_p),
        ("ay", ctypes.c_void_p),
        ("alen", ctypes.c_void_p),
        ("awid", ctypes.c_void_p),
    ]


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def generate_candidates_native(index, codes: np.ndarray, read_len: int,
                               window_len: int, cutoff: int,
                               match_mode: int, threshold: float,
                               match_score: int, b_gap_open: int,
                               b_gap_extend: int, min_kmer_pos: int = 0,
                               use_region_counts: bool = True,
                               region_bits: int = 11,
                               region_overlap: int = 50,
                               collapse: bool = True,
                               gapless: bool = False,
                               search_strands=(True, True),
                               mp_mode: int = 0,
                               mp_drmin=None,
                               mp_drmax=None,
                               threads: Optional[int] = None,
                               tally: Optional[Callable] = None,
                               count: Optional[Callable] = None,
                               ) -> Optional[FlatHits]:
    """Filter 1 over `codes` [N, 2, read_len]; None when the native code
    refuses the shape (the caller rejects the batch). `tally(stage,
    secs)` (a Mapper's) receives the lookup, windows and overflow
    seconds; with the call split over threads, lookup and windows are
    scaled to the split's wall time, so that they share out what the
    caller's `filter1` stage sees. `count(name, n)` (a Mapper's) receives
    the call's owners as `filter1 host owners`."""
    N = codes.shape[0]
    n_owners = N * 2
    if mp_mode and (N % 2 or not use_region_counts):
        return None
    mp_drmin = (np.ascontiguousarray(mp_drmin, np.int64)
                if mp_mode else None)
    mp_drmax = (np.ascontiguousarray(mp_drmax, np.int64)
                if mp_mode else None)
    if count is not None:
        count("filter1 host owners", n_owners)

    def call(lib, params, seed_specs, flat_codes, o_lo, n_own, out, ns,
             seg):
        params.mp_drmin = (mp_drmin.ctypes.data + 8 * o_lo
                           if mp_mode else None)
        params.mp_drmax = (mp_drmax.ctypes.data + 8 * o_lo
                           if mp_mode else None)
        return lib.filter1_batch(
            ctypes.byref(params), seed_specs,
            ctypes.c_void_p(flat_codes.ctypes.data + o_lo * read_len),
            ctypes.c_int64(n_own), ctypes.byref(out),
            ctypes.c_void_p(ns.ctypes.data), ctypes.c_void_p(seg.ctypes.data))

    return _run(index, codes, read_len, window_len, cutoff, match_mode,
                threshold, match_score, b_gap_open, b_gap_extend,
                min_kmer_pos, use_region_counts, region_bits,
                region_overlap, collapse, gapless, search_strands, mp_mode,
                threads, tally, call)


def generate_candidates_survivors(index, codes: np.ndarray,
                                  surv: np.ndarray, surv_base: np.ndarray,
                                  surv_count: np.ndarray, read_len: int,
                                  window_len: int, cutoff: int,
                                  match_mode: int, threshold: float,
                                  match_score: int, b_gap_open: int,
                                  b_gap_extend: int, min_kmer_pos: int = 0,
                                  use_region_counts: bool = True,
                                  region_bits: int = 11,
                                  region_overlap: int = 50,
                                  collapse: bool = True,
                                  gapless: bool = False,
                                  search_strands=(True, True),
                                  threads: Optional[int] = None,
                                  tally: Optional[Callable] = None,
                                  ) -> Optional[FlatHits]:
    """Filter 1's back half (filter1.cpp's filter1_survivors) over the
    front half's survivors (`core/filter1_front.py`): owner o's sorted,
    region-filtered packed keys are surv[surv_base[o]:][:surv_count[o]];
    an owner whose count is -1 runs the host's own front half. The same
    FlatHits as generate_candidates_native on the same input, or None
    where it would give None. `tally` receives the back half's seconds as
    `filter1 windows` and the host front half's, if any owner took it,
    as `filter1 lookup`."""
    surv = np.ascontiguousarray(surv, np.uint64)
    surv_base = np.ascontiguousarray(surv_base, np.int64)
    surv_count = np.ascontiguousarray(surv_count, np.int64)

    def call(lib, params, seed_specs, flat_codes, o_lo, n_own, out, ns,
             seg):
        return lib.filter1_survivors(
            ctypes.byref(params), seed_specs,
            ctypes.c_void_p(flat_codes.ctypes.data + o_lo * read_len),
            ctypes.c_int64(n_own), ctypes.c_void_p(surv.ctypes.data),
            ctypes.c_void_p(surv_base.ctypes.data + 8 * o_lo),
            ctypes.c_void_p(surv_count.ctypes.data + 8 * o_lo),
            ctypes.byref(out), ctypes.c_void_p(ns.ctypes.data),
            ctypes.c_void_p(seg.ctypes.data))

    # a range's output starts at 8 windows an owner with a small floor:
    # the back half is quick, so a range that overflows runs again at
    # little cost, and a batch fanned out over threads does not hold a
    # floor's worth of output a thread
    return _run(index, codes, read_len, window_len, cutoff, match_mode,
                threshold, match_score, b_gap_open, b_gap_extend,
                min_kmer_pos, use_region_counts, region_bits,
                region_overlap, collapse, gapless, search_strands, 0,
                threads, tally, call, min_cap=1 << 12)


def _run(index, codes, read_len, window_len, cutoff, match_mode, threshold,
         match_score, b_gap_open, b_gap_extend, min_kmer_pos,
         use_region_counts, region_bits, region_overlap, collapse, gapless,
         search_strands, mp_mode, threads, tally, call, min_cap=1 << 16):
    """One native entry point (`call`) over the owners of `codes`, in
    contiguous read ranges on host threads, each with an output of
    max(8 an owner, `min_cap`) windows, retried larger on overflow; the
    parts merged into one FlatHits."""
    lib = get_lib()
    N = codes.shape[0]
    n_owners = N * 2
    flat_codes = np.ascontiguousarray(codes.reshape(n_owners, read_len),
                                      dtype=np.uint8)

    seed_specs = (_SeedSpec * len(index.seeds))()
    keepalive = []
    for i, si in enumerate(index.seeds):
        offs = np.ascontiguousarray(si.seed.offsets, dtype=np.int32)
        # CSR offsets pass through in their stored dtype (uint32 for
        # compacted indexes, int64 for legacy mmap images) — no copy
        csr_off = si.offsets if si.offsets.dtype in (np.uint32, np.int64) \
            else np.ascontiguousarray(si.offsets, dtype=np.int64)
        if not csr_off.flags.c_contiguous:
            csr_off = np.ascontiguousarray(csr_off)
        csr_pos = np.ascontiguousarray(si.positions, dtype=np.uint32)
        keepalive += [offs, csr_off, csr_pos]
        seed_specs[i] = _SeedSpec(
            si.seed.span, si.seed.weight, len(offs),
            int(csr_off.dtype == np.uint32),
            offs.ctypes.data, csr_off.ctypes.data, csr_pos.ctypes.data)

    c_off = np.ascontiguousarray(index.contig_offsets, dtype=np.uint32)
    c_len = np.ascontiguousarray(index.contig_lengths, dtype=np.uint32)

    def run_range(o_lo: int, o_hi: int):
        """One native call over owner rows [o_lo, o_hi); owners in the
        result are call-local (add o_lo to globalize)."""
        n_own = o_hi - o_lo
        params = _Params(
            len(index.seeds), read_len, window_len, cutoff, match_mode,
            float(threshold), match_score, b_gap_open, b_gap_extend,
            min_kmer_pos, int(use_region_counts), region_bits,
            region_overlap, int(collapse), int(gapless),
            int(search_strands[0]), int(search_strands[1]),
            int(index.hashed),
            max(si.seed.span for si in index.seeds), index.total_len,
            index.n_contigs, c_off.ctypes.data, c_len.ctypes.data,
            int(mp_mode), None, None)
        # start near the observed density (~1-2 windows per owner) and
        # grow on -1; the old 128/owner guess mmapped ~300MB per call
        cap = max(8 * n_own, min_cap)
        ns = np.zeros(2, np.int64)     # lookup, windows
        overflow_ns = 0
        while True:
            t0 = time.perf_counter_ns()
            owner = np.empty(cap, np.int64)
            cn = np.empty(cap, np.int32)
            g_off = np.empty(cap, np.int64)
            w_len = np.empty(cap, np.int32)
            swg = np.empty(cap, np.int64)
            matches = np.empty(cap, np.int32)
            score_max = np.empty(cap, np.int64)
            ax = np.empty(cap, np.int64)
            ay = np.empty(cap, np.int64)
            alen = np.empty(cap, np.int64)
            awid = np.empty(cap, np.int64)
            seg = np.zeros(n_own + 1, np.int64)
            out = _Out(cap, owner.ctypes.data, cn.ctypes.data,
                       g_off.ctypes.data, w_len.ctypes.data,
                       swg.ctypes.data, matches.ctypes.data,
                       score_max.ctypes.data, ax.ctypes.data,
                       ay.ctypes.data, alen.ctypes.data, awid.ctypes.data)
            n = call(lib, params, seed_specs, flat_codes, o_lo, n_own, out,
                     ns, seg)
            if n >= 0:
                break
            if n == -2:       # unsupported shape
                return None
            overflow_ns += time.perf_counter_ns() - t0
            cap *= 4
        return (n, owner, cn, g_off, w_len, swg, matches, score_max, ax,
                ay, alen, awid, seg, ns, overflow_ns)

    # the OpenMP analogue (launch_scan_threads, gmapper.c:287-645): the C
    # call releases the GIL and its scratch state is thread_local, so
    # contiguous read ranges fan out over host threads
    import os as _os
    # callers that already run many pipeline lanes pass threads=1: inner
    # fan-out on an oversubscribed host costs ~35% end-to-end throughput
    nthreads = threads if threads is not None else (_os.cpu_count() or 1)
    nthreads = min(nthreads, max(1, N // 512))
    t0 = time.perf_counter_ns()
    if nthreads <= 1:
        parts = [run_range(0, n_owners)]
    else:
        from concurrent.futures import ThreadPoolExecutor
        per = (N + nthreads - 1) // nthreads
        if mp_mode and per % 2:
            per += 1   # mp groups span two reads: split on pair bounds
        ranges = [(2 * i * per, 2 * min((i + 1) * per, N))
                  for i in range(nthreads) if i * per < N]
        with ThreadPoolExecutor(len(ranges)) as ex:
            parts = list(ex.map(lambda r: run_range(*r), ranges))

    if any(p is None for p in parts):
        return None
    if tally is not None:
        wall = time.perf_counter_ns() - t0
        lookup, windows = (sum(p[13][i] for p in parts) for i in (0, 1))
        scale = 1e-9 * min(1.0, wall / max(lookup + windows, 1))
        tally("filter1 lookup", lookup * scale)
        tally("filter1 windows", windows * scale)
        over = sum(p[14] for p in parts)
        if over:
            tally("filter1 overflow", over * 1e-9)
    total = sum(p[0] for p in parts)
    if total == 0:
        return _empty_flat(n_owners)
    if len(parts) == 1:
        (n, owner, cn, g_off, w_len, swg, matches, score_max, ax, ay,
         alen, awid, seg) = parts[0][:13]
        return FlatHits(owner=owner[:n], cn=cn[:n], g_off=g_off[:n],
                        w_len=w_len[:n], score_window_gen=swg[:n],
                        matches=matches[:n], score_max=score_max[:n],
                        ax=ax[:n], ay=ay[:n], alen=alen[:n], awid=awid[:n],
                        seg_start=seg)
    cat = lambda k: np.concatenate([p[k][:p[0]] for p in parts])
    own_parts = []
    seg_parts = []
    base_owner = 0
    base_n = 0
    for p in parts:
        n_p = p[0]
        own_parts.append(p[1][:n_p] + base_owner)
        seg_parts.append(p[12][:-1] + base_n)
        base_owner += len(p[12]) - 1
        base_n += n_p
    seg_all = np.concatenate(seg_parts + [np.array([base_n], np.int64)])
    return FlatHits(owner=np.concatenate(own_parts), cn=cat(2),
                    g_off=cat(3), w_len=cat(4), score_window_gen=cat(5),
                    matches=cat(6), score_max=cat(7), ax=cat(8), ay=cat(9),
                    alen=cat(10), awid=cat(11), seg_start=seg_all)
