"""Flat-array fast path for letter-space mapping to SAM, unpaired and
paired, on torch devices.

Port of the flows of `shrimp_tpu/fastpath.py`:

    read prep + filter 1 (native)  ->  one fused device step per chunk
    ->  pass1_select (native)  ->  vector-score gate  ->  alignments
    ->  finalize_render (native: MQV, SAM text)

- the stats flow, for windows the stats kernel takes (G <= 256: reads
  up to about 183 bp): vector SW + full-SW stats on the device
  (`core/sw.py::sw_vec_full_stats_packed`), closed-form diagonal
  alignments on the host and the native banded DP for indel paths;
- the traceback flow, for wider windows (long reads): vector SW, the
  full SW with backpointers and the traceback on the device
  (`core/sw.py::sw_vec_full_tb_packed`), whose [B, 10] rows and packed
  ops go to finalize_render as they are;
- the two-phase dispatch of either flow, for batches at
  LS_TWO_PHASE_WPR or more candidate windows per read: the vector SW
  alone on every window (launches of up to LS_VEC_BATCH rows), then the
  full SW on the pass-1 survivors only (`_tp_run_full`);
- the paired stream (`FastPaired`, `map_paired_sam_stream`): the same
  dispatch, then one native `paired_finalize_render` call; two-phase
  batches run select-then-full.

`_stats_flow_enabled` picks the flow from G alone, the same on every
device. Arguments go up on packed IO where `_packed_io` allows it (16 B a
window, 4-bit reads), else as [B, 10] int32 rows with a byte read table
(more than 2^16 read rows); the windows come from the mapper's word plane
or, where it has none (planes over ~1 Gbp), byte by byte. An index of
2^31 bases or more and windows wider than MAX_G_LONG raise
NotImplementedError. The host stages run through the port's own native
library (`native/`, a copy of the reference's C++), so the SAM bytes are
the reference's. The mesh tiers (`parallel/meshmap.py`) plug in through
the seams the reference has: `FastLS.dispatch_fn` (a `_fused_dispatch`
twin; its `win["fetch"]` returns the rows on the host), filter 1 as a
method (`FastLS._filter1`, `FastPaired._filter1_paired`), the per-job
posteriors (`surv_post`, `last_rows`, `last_ri`) and the cross-shard Z
hooks (`z1_merge_hook`, `zpair_merge_hook`). The multi-process tier
(`parallel/dist.py`) also shards the host work by reads: `read_slice`
with `slice_select` (FastLS, FastPaired) has a stage select, expand and
render only a slice of each batch; a rank-local batch with no jobs still
joins the tier's expansion exchange (`FastLS._no_jobs`). As in the
reference, a stream whose first batch the flat
encoder rejects returns None and the caller runs the generic mapper
(`mapper.Mapper.map_unpaired`, `paired.PairedMapper.map_paired`); a
later rejected batch goes through the generic mapper inside the stream
(its slow tail), with the same bytes.
"""
from __future__ import annotations

import ctypes
import time as _time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from . import constants as C
from .config import MapperConfig, abs_or_pct
from .io.fasta import SeqRecord
from .io.sam import _pair_qname
from .native import get_lib
from .native.filter1_py import generate_candidates_native
from .core._args import MAX_G, MAX_G_LONG
from .core.sw import (sw_vec_full_stats_from_index, sw_vec_full_stats_packed,
                      sw_vec_full_tb_from_index, sw_vec_full_tb_packed)
from .mapper import FULL_BATCH, FULL_BUCKETS, _round_up

# windows per read at or above which a batch takes the two-phase
# dispatch (the vector SW on every window, then the full SW on the
# pass-1 survivors only) instead of the fused speculative launch; and the
# vec-only launch's row cap
LS_TWO_PHASE_WPR = 8
LS_VEC_BATCH = 1 << 22

# SAM seq cleaning LUTs (io/sam.py _CLEAN_TBL / _COMP_TBL as byte maps)
_CLEAN_LUT = np.arange(256, dtype=np.uint8)
for _c in range(128):
    _u = chr(_c).upper()
    if _u in "RYSWKMBDHV":
        _CLEAN_LUT[_c] = ord("N")
    elif len(_u) == 1 and ord(_u) < 256:
        _CLEAN_LUT[_c] = ord(_u)
_COMP_LUT = np.arange(256, dtype=np.uint8)
for _a, _b in (("A", "T"), ("T", "A"), ("C", "G"), ("G", "C")):
    _COMP_LUT[ord(_a)] = ord(_b)


def fastpath_supported(cfg: MapperConfig) -> bool:
    """Gate: the native renderer covers the default LS unpaired SAM flow
    plus the renderer-level flags (--all-contigs, --sam-unaligned,
    --read-group, --sam-r2, --extra-sam-fields)."""
    return (cfg.mode == C.MODE_LETTER_SPACE
            and cfg.pair_mode == C.PAIR_NONE
            and len(cfg.unpaired_options()) == 1
            and not cfg.gapless
            and cfg.global_alignment
            and cfg.compute_mapping_qualities
            and not cfg.shrimp_format
            and cfg.search_forward and cfg.search_reverse)


def _config_supported(cfg: MapperConfig) -> bool:
    """`fastpath_supported` plus the config-level refusals of the
    reference's stage_prepare (raw-string trims, multi-round option
    sets), which the reference also answers with None. FastLS assumes a
    config that passed this gate."""
    return (fastpath_supported(cfg)
            and not (cfg.trim_front or cfg.trim_end or cfg.trim_illumina)
            and not (cfg.custom_unpaired_options
                     or cfg.custom_paired_options))


class _P1Params(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int64), ("n_owners", ctypes.c_int64),
                ("read_len", ctypes.c_int32),
                ("window_len", ctypes.c_int32),
                ("overlap", ctypes.c_int32), ("threshold", ctypes.c_double),
                ("min_matches", ctypes.c_int32),
                ("num_outputs", ctypes.c_int32),
                ("normalize", ctypes.c_int32),
                ("contig_lengths", ctypes.c_void_p)]


class _P1In(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in
                ("owner", "cn", "g_off", "w_len", "matches", "score_max",
                 "ax", "ay", "alen", "awid", "scores", "swg")]


class _P1Out(ctypes.Structure):
    _fields_ = [("cap", ctypes.c_int64)] + \
        [(f, ctypes.c_void_p) for f in
         ("ri", "gen_st", "cn", "g_off", "w_len", "score_max", "ax", "ay",
          "alen", "awid", "score_vector", "seg", "src",
          "matches", "swg")]


class _FRParams(ctypes.Structure):
    _fields_ = [("n_jobs", ctypes.c_int64), ("n_reads", ctypes.c_int64),
                ("read_len", ctypes.c_int32), ("ops_words", ctypes.c_int32),
                ("sw_full_threshold", ctypes.c_double),
                ("num_outputs", ctypes.c_int32), ("strata", ctypes.c_int32),
                ("max_alignments", ctypes.c_int32),
                ("single_best", ctypes.c_int32),
                ("compute_mqv", ctypes.c_int32),
                ("alpha", ctypes.c_double), ("beta", ctypes.c_double),
                ("contig_lengths", ctypes.c_void_p),
                ("contig_name_off", ctypes.c_void_p),
                ("contig_names", ctypes.c_void_p),
                ("name_off", ctypes.c_void_p), ("names", ctypes.c_void_p),
                ("seq_fwd", ctypes.c_void_p), ("seq_rc", ctypes.c_void_p),
                ("qual_fwd", ctypes.c_void_p),
                ("qual_rc", ctypes.c_void_p),
                ("surv_post", ctypes.c_void_p),
                ("ext_z1", ctypes.c_void_p),
                # renderer-level flags (hostpipe.cpp tail)
                ("rg", ctypes.c_void_p), ("rg_len", ctypes.c_int32),
                ("all_contigs", ctypes.c_int32),
                ("sam_unaligned", ctypes.c_int32),
                ("qual_raw", ctypes.c_void_p),
                ("una_lo", ctypes.c_int64),
                ("una_hi", ctypes.c_int64),
                ("extra_sam", ctypes.c_int32),
                ("genome", ctypes.c_void_p),
                ("genome_rc", ctypes.c_void_p),
                ("contig_offsets", ctypes.c_void_p)]


class _FRJobs(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in
                ("ri", "cn", "gen_st", "g_off", "score_max", "packed",
                 "ops_pk", "f_matches", "swg", "svec")]


class _FSWParams(ctypes.Structure):
    _fields_ = [("n_jobs", ctypes.c_int64), ("G", ctypes.c_int32),
                ("R", ctypes.c_int32), ("ops_words", ctypes.c_int32),
                ("match", ctypes.c_int32), ("mismatch", ctypes.c_int32),
                ("a_gap_open", ctypes.c_int32),
                ("a_gap_ext", ctypes.c_int32),
                ("b_gap_open", ctypes.c_int32),
                ("b_gap_ext", ctypes.c_int32), ("local", ctypes.c_int32)]


class _FSWJobs(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in
                ("gwin", "glen", "read", "rlen", "ax", "ay", "alen",
                 "awid", "rev")]


def _vp(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def _i32(x: np.ndarray) -> np.ndarray:
    """int64 -> int32 with C wraparound semantics (packed bit fields)."""
    return (x & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def _pack_args4(bucket: int, k: int, starts, glen, ri, rc, rx, ry,
                rl, rw, rev) -> np.ndarray:
    """Host side of core.sw._unpack_args4: 16 B/window packed argument
    rows; pad rows score a 1-cell window the host discards. ri and glen
    must fit their 16- and 14-bit fields."""
    ri64 = ri.astype(np.int64)
    glen64 = glen.astype(np.int64)
    if k and (ri64.min() < 0 or ri64.max() >= (1 << 16)):
        raise ValueError("_pack_args4: read row index outside [0, 2^16)")
    if k and (glen64.min() < 0 or glen64.max() >= (1 << 14)):
        raise ValueError("_pack_args4: window length outside [0, 2^14)")
    a = np.zeros((bucket, 4), np.int32)
    a[:k, 0] = starts.astype(np.int64).astype(np.int32)
    a[:k, 1] = _i32(ri64
                    | (rc.astype(np.int64) << 16)
                    | (rev.astype(np.int64) << 17)
                    | (glen64 << 18))
    a[:k, 2] = _i32((rx.astype(np.int64) & 0xFFFF)
                    | (ry.astype(np.int64) << 16))
    a[:k, 3] = _i32((rl.astype(np.int64) & 0xFFFF)
                    | (rw.astype(np.int64) << 16))
    a[k:, 1] = 1 << 18              # pad: glen = 1
    a[k:, 3] = (1 << 16) | 1        # pad: rl = rw = 1
    return a


def _pack_rtab(read_tab: np.ndarray) -> np.ndarray:
    """4-bit nibble pack of the read table (core.sw._unpack_rtab_nib).
    Codes are 4-bit (constants.CHAR_TO_INT <= 15); the 254 fill packs to
    junk nibbles that rlen/bucket masking keeps out of every score."""
    lo = read_tab[:, 0::2] & 15
    hi = read_tab[:, 1::2] & 15
    return np.ascontiguousarray(lo | (hi << 4))


def _unpack_stats3(pk: np.ndarray):
    """Host side of core.sw._pack_stats3: [n, 3] int32 -> (vec int64
    [n], stats int32 [n, 7]: score, mi, mj, plane, run, term,
    matches)."""
    w0 = pk[:, 0]
    w1 = pk[:, 1]
    w2 = pk[:, 2]
    vec = (w0 & 0xFFFF).astype(np.int64)
    st = np.empty((pk.shape[0], 7), np.int32)
    st[:, 0] = w0 >> 16
    st[:, 1] = w1 & 4095
    st[:, 2] = (w1 >> 12) & 4095
    st[:, 3] = (w1 >> 24) & 3
    st[:, 4] = (w2 >> 16) & 0x7FFF
    st[:, 5] = (w1 >> 26) & 1
    st[:, 6] = (w2 & 0xFFFF).astype(np.int16)   # sign-extend matches
    return vec, st


def _normalize_win(m, fh, L: int, rcf: np.ndarray):
    """Apply the reverse_hit strand transform (mapping.c:254-263) to
    every strand-1 window and assemble the flat window geometry used by
    the device launch and the host reconstruction stage."""
    cfg = m.config
    idx = m.index
    aw = cfg.anchor_width
    coff = idx.contig_offsets[fh.cn].astype(np.int64)
    clen = idx.contig_lengths[fh.cn].astype(np.int64)
    wl64 = fh.w_len.astype(np.int64)
    g_off_t = np.where(rcf, clen - fh.g_off - wl64, fh.g_off)
    ax_t = np.where(rcf, -fh.ax + (wl64 - 1) - (fh.alen - 1)
                    - (fh.awid - 1), fh.ax)
    ay_t = np.where(rcf, -fh.ay + (L - 1) - (fh.alen - 1)
                    + (fh.awid - 1), fh.ay)
    win = dict(
        starts=coff + g_off_t,
        g_off_t=g_off_t,
        rcmask=rcf,
        glen=fh.w_len.astype(np.int32),
        ri=(fh.owner >> 1).astype(np.int32),
        rx=(ax_t - aw // 2).astype(np.int32),
        ry=(ay_t + aw // 2).astype(np.int32),
        rl_=fh.alen.astype(np.int32),
        rw_=(fh.awid + aw).astype(np.int32),
        rev=rcf & cfg.rev_tiebreak)
    G = _round_up(max(int(fh.w_len.max()), 16), 32)
    return win, G


def _stats_flow_enabled(G: int) -> bool:
    """The flow of a batch whose windows are G wide: the stats flow
    where the stats kernel (csrc/sw_full.cu) takes the windows, the
    traceback flow otherwise. A function of the shape only, so the CPU
    walks the flow the card walks. (The reference gates on its Mosaic
    kernel's shapes, `pallas_full_ok`, R * G <= 8192 on a TPU.)"""
    return G <= MAX_G


def _chunk_bucket(k: int, eff_batch: int) -> int:
    """Launch rows for a chunk of k windows: above FULL_BUCKETS[-1] (the
    two-phase dispatch's vec-only launches) 5/8, 3/4 or all of the next
    power of two >= k, which bounds the pad rows to about a quarter;
    else the FULL_BUCKETS row counts, or under the traceback flow's
    long-read shrink the next power of two >= k (at least 8), as the
    reference pads them."""
    if k > FULL_BUCKETS[-1]:
        p2 = 1 << int(np.ceil(np.log2(k)))
        return next(b for b in (5 * (p2 // 8), 3 * (p2 // 4), p2) if b >= k)
    if eff_batch >= FULL_BUCKETS[0]:
        return FULL_BUCKETS[int(np.searchsorted(FULL_BUCKETS, k))]
    return 1 << int(np.ceil(np.log2(max(k, 8))))


def _tb_batch(R: int, G: int) -> int:
    """Windows per chunk of the traceback flow: at most 2^28 backpointer
    cells (bucket * R * G), as the reference's chunks hold."""
    return max(8, min(FULL_BATCH, (1 << 28) // max(R * G, 1)))


def _packed_io(G: int, R: int, w_max: int, n_rows: int) -> bool:
    """Whether a batch fits the packed-IO flow's bit fields (G and R up
    to 4095, window lengths under 2^14, at most 2^16 read rows), as the
    reference's gate has it; other batches take the unpacked flow."""
    return (G <= 4095 and R <= 4095 and w_max < (1 << 14)
            and n_rows <= (1 << 16))


def _check_index_len(idx) -> None:
    """Both flows carry absolute window starts in int32, which wrap at
    2^31 bases: refuse such an index (the reference's windows are wrong
    there)."""
    if idx.total_len >= (1 << 31):
        raise NotImplementedError(
            f"an index of {idx.total_len} bases: window starts are int32 "
            "and wrap at 2^31 bases; split the genome into smaller "
            "indexes")


def _launch_args(win, rows, k: int, bucket: int, L: int,
                 packed_io: bool) -> np.ndarray:
    """The launch argument rows of the windows `rows` (a slice or an
    index array of k windows), padded to `bucket` rows: [bucket, 4]
    packed (`_pack_args4`) or [bucket, 10] int32 (gstart, glen, ri, rc,
    rlen, ax, ay, alen, awid, rev) for the unpacked flow. Pad rows score
    a 1-cell window the host discards."""
    cols = [win[f][rows] for f in ("starts", "glen", "ri", "rcmask", "rx",
                                   "ry", "rl_", "rw_", "rev")]
    if packed_io:
        return _pack_args4(bucket, k, *cols)
    a = np.zeros((bucket, 10), np.int32)
    for c, v in zip((0, 1, 2, 3, 5, 6, 7, 8, 9), cols):
        a[:k, c] = v
    a[:k, 4] = L
    a[k:, [1, 4, 7, 8]] = 1
    return a


def _stats_rows(res, k: int, packed_io: bool):
    """A stats-flow launch's first k rows on the host: (vector scores
    int64 [k], stats int32 [k, 7]: score, mi, mj, plane, run, term,
    matches). Packed: the [B, 3] rows (`_unpack_stats3`); unpacked: (vec,
    stats) or, from phase "full", (stats,) int16 [B, 8] (matches = deq -
    base), whose vector scores read 0."""
    if packed_io:
        return _unpack_stats3(res[:k].cpu().numpy())
    s = res[-1][:k].cpu().numpy().astype(np.int32)
    st = np.empty((k, 7), np.int32)
    st[:, :6] = s[:, :6]
    st[:, 6] = s[:, 6] - s[:, 7]
    vec = (res[0][:k].cpu().numpy().astype(np.int64) if len(res) == 2
           else np.zeros(k, np.int64))
    return vec, st


def _fused_dispatch(m, fh, read_tab: np.ndarray, L: int, R: int,
                    rcf: np.ndarray, n_reads: Optional[int] = None):
    """Filter 2 + speculative filter 3 over every candidate window, in
    chunks on m.device. `rcf` marks windows needing the reverse_hit
    normalization (strand 1 for unpaired reads; paired legs may be
    pre-flipped by the pair mode). Returns (futures, win, G,
    stats_flow): futures are (off, k, result) with result the step's
    output on the device (`_stats_rows` reads the stats flow's; the
    traceback flow's is (vec, packed, ops)); `win` is the normalized
    window geometry that the host reconstruction stage reuses. The
    traceback flow's chunks hold at most 2^28 backpointer cells (bucket
    * R * G), as the reference's do.

    Batches that fit `_packed_io` go up on packed IO (16 B a window,
    4-bit reads); others (more than 2^16 read rows) on the unpacked
    flow's [B, 10] rows and byte read table. Without the mapper's word
    plane (planes over ~1 Gbp) the windows are gathered byte by byte.
    Windows wider than MAX_G_LONG, and indexes of 2^31 bases or more,
    raise NotImplementedError.

    At LS_TWO_PHASE_WPR or more windows per read of the `n_reads` reads
    (None: never) the dispatch takes two phases, as the reference's
    does: here the vector SW alone, up to LS_VEC_BATCH rows a launch
    (futures hold (vec,)), and `win["two_phase"]` keeps what
    `_tp_run_full` needs to run the full SW later on the pass-1
    survivors only. A row's results do not depend on the launch it is
    in, so both ways give the same bytes."""
    cfg = m.config
    sc = cfg.scores
    _check_index_len(m.index)
    n = fh.n
    win, G = _normalize_win(m, fh, L, rcf)
    if G > MAX_G_LONG:
        raise NotImplementedError(
            f"windows of G={G} columns: the long-read kernels take G <= "
            f"{MAX_G_LONG}")
    packed_io = _packed_io(G, R, int(fh.w_len.max()), read_tab.shape[0])
    kw = dict(G=G, match=sc.match, mismatch=sc.mismatch,
              a_gap_open=sc.a_gap_open, a_gap_ext=sc.a_gap_extend,
              b_gap_open=sc.b_gap_open, b_gap_ext=sc.b_gap_extend,
              local_alignment=False)
    stats_flow = _stats_flow_enabled(G)
    dev = m.device
    if packed_io:
        fn = sw_vec_full_stats_packed if stats_flow else sw_vec_full_tb_packed
        kw.update(L=L, cat_words=m._dev_cat_words())
        rtab_dev = torch.from_numpy(_pack_rtab(read_tab)).to(dev)
    else:
        fn = (sw_vec_full_stats_from_index if stats_flow
              else sw_vec_full_tb_from_index)
        rtab_dev = torch.from_numpy(read_tab).to(dev)
    two_phase = (n_reads is not None
                 and n >= LS_TWO_PHASE_WPR * max(n_reads, 1))
    eff_batch = LS_VEC_BATCH if two_phase else FULL_BATCH
    if not stats_flow:
        eff_batch = _tb_batch(R, G)
    futures = []
    off = 0
    while off < n:
        k = min(n - off, eff_batch)
        args = _launch_args(win, slice(off, off + k), k,
                            _chunk_bucket(k, eff_batch), L, packed_io)
        res = fn(m._dev_codes(), m._dev_codes_rc(),
                 torch.from_numpy(args).to(dev), rtab_dev, **kw,
                 **(dict(phase="vec") if two_phase else {}))
        futures.append((off, k, res))
        off += k
    win["packed_io"] = packed_io
    if two_phase:
        win["two_phase"] = dict(fn=fn, kw=kw, rtab_dev=rtab_dev)
    cells = int(fh.w_len.astype(np.int64).sum()) * L
    m.tally(vec_invocs=n, vec_cells=cells)
    if not two_phase:
        m.tally(full_invocs=n, full_cells=cells)
    return futures, win, G, stats_flow


def _tp_run_full(m, tp, win, G: int, rows: np.ndarray, stats_flow: bool,
                 fh, L: int, R: int):
    """Two-phase phase B: the full SW for the window rows `rows` only,
    in launches of up to FULL_BUCKETS[-1] rows (the traceback flow keeps
    its 2^28-cell chunks), fetched. Returns the [k, 7] stats rows (stats
    flow) or (packed [k, 10], ops [k, W]) (traceback flow). No rows: no
    launch. Shared by the unpaired pass-1 survivor flow
    (FastLS.stage_finish) and the paired select-then-full flow
    (FastPaired.stage_finish)."""
    t0 = _time.perf_counter()
    n_jobs = len(rows)
    eff_batch = FULL_BUCKETS[-1] if stats_flow else _tb_batch(R, G)
    dev = m.device
    futures = []
    for off in range(0, n_jobs, eff_batch):
        k = min(n_jobs - off, eff_batch)
        args = _launch_args(win, rows[off:off + k], k,
                            _chunk_bucket(k, eff_batch), L,
                            win["packed_io"])
        futures.append((off, k, tp["fn"](
            m._dev_codes(), m._dev_codes_rc(),
            torch.from_numpy(args).to(dev), tp["rtab_dev"], **tp["kw"],
            phase="full")))
    if stats_flow:
        out = np.empty((n_jobs, 7), np.int32)
        for off, k, res in futures:
            out[off:off + k] = _stats_rows(res, k, win["packed_io"])[1]
    else:
        W = (R + G + 3) // 4
        out = (np.empty((n_jobs, 10), np.int32),
               np.empty((n_jobs, W), np.uint8))
        for off, k, (pk, opk) in futures:
            out[0][off:off + k] = pk[:k].cpu().numpy()
            out[1][off:off + k] = opk[:k].cpu().numpy()
    m.tally("device full (2ph)", _time.perf_counter() - t0,
            full_invocs=n_jobs,
            full_cells=int(fh.w_len[rows].astype(np.int64).sum()) * L)
    return out


def _fetch(ctx, n: int):
    """The dispatch's device results on the host: (vector scores int64
    [n], stats [n, 7] of the stats flow, (packed [n, 10], ops [n, W]) of
    the traceback flow); a two-phase dispatch returns the scores alone,
    the others None. A dispatch that leaves `win["fetch"]` (the sharded
    tiers') is read through it: () -> the packed [n, 3] stats rows, or
    the traceback flow's (vec, packed, ops). The device tensors are
    freed."""
    scores = np.empty(n, np.int64)
    stats = tb = None
    fetch = ctx["win"].get("fetch")
    if fetch is not None:
        # a sharded dispatch: its rows, in window order
        got = fetch()
        if ctx["stats_flow"]:
            scores, stats = _unpack_stats3(got)
        else:
            scores, tb = got[0], tuple(got[1:])
    elif ctx["win"].get("two_phase") is not None:
        for off, k, (vec,) in ctx["futures"]:
            scores[off:off + k] = vec[:k].cpu().numpy()
    elif ctx["stats_flow"]:
        stats = np.empty((n, 7), np.int32)
        for off, k, res in ctx["futures"]:
            scores[off:off + k], stats[off:off + k] = _stats_rows(
                res, k, ctx["win"]["packed_io"])
    else:
        tb = (np.empty((n, 10), np.int32),
              np.empty((n, (ctx["R"] + ctx["G"] + 3) // 4), np.uint8))
        for off, k, (vec, pk, opk) in ctx["futures"]:
            scores[off:off + k] = vec[:k].cpu().numpy()
            tb[0][off:off + k] = pk[:k].cpu().numpy()
            tb[1][off:off + k] = opk[:k].cpu().numpy()
    ctx["futures"] = None
    return scores, stats, tb


class FastLS:
    """Per-Mapper fast-path state (contig name blobs, native library)."""

    def __init__(self, mapper) -> None:
        self.lib = get_lib()
        self.m = mapper
        # filter1 internal fan-out (the mapper's, None: every core);
        # multi-lane streams set 1 (the lanes already keep every core
        # busy, inner threads just contend)
        self.f1_threads: Optional[int] = mapper.f1_threads
        # the device dispatch, `_fused_dispatch`'s signature (None: the
        # module's `_fused_dispatch`); the mesh tiers set theirs
        self.dispatch_fn = None
        # set to an empty array to ask for each emitted alignment's
        # posterior: stage_finish then leaves them here, job t's window
        # row in last_rows[t] and its read in last_ri[t] (the per-shard
        # z1 partials of the mesh tiers)
        self.surv_post: Optional[np.ndarray] = None
        self.last_rows = self.last_ri = None
        # (posteriors [n_jobs], job_ri, job_rows, n_reads) -> the z1
        # [n_reads] the render divides by, merged across shards (the
        # sharded-index tier); None: the run's own z1
        self.z1_merge_hook = None
        # read sharding (the multi-process tier): (lo, hi) has
        # finalize + render run only for the batch's reads [lo, hi); with
        # slice_select pass-1 selection, the vector gate and the
        # expansion are sliced too (the expansion then asks the owner
        # ranks for remote shards' rows); last_slice_jobs counts the
        # jobs of the slices
        self.read_slice = None
        self.slice_select = False
        self.last_slice_jobs = 0
        idx = mapper.index
        blob = b""
        offs = [0]
        for nm in idx.contig_names:
            blob += nm.encode()
            offs.append(len(blob))
        self.contig_names_blob = np.frombuffer(blob, np.uint8).copy() \
            if blob else np.zeros(1, np.uint8)
        self.contig_name_off = np.array(offs, np.int32)
        self.contig_lengths32 = np.ascontiguousarray(idx.contig_lengths,
                                                     np.uint32)
        self.contig_offsets32 = np.ascontiguousarray(idx.contig_offsets,
                                                     np.uint32)

    def _filter1(self, codes2: np.ndarray, L: int, wlen: int,
                 min_kmer_pos: int = 0, index=None):
        """Candidate window generation over `index` (None: the mapper's;
        colour space starts its k-mers at colour 1: min_kmer_pos=1).
        The sharded-index tier overrides it."""
        m = self.m
        cfg = m.config
        opts = m._unpaired_opts[0]
        return generate_candidates_native(
            m.index if index is None else index, codes2, L, wlen, m.cutoff,
            opts.hit_list.match_mode,
            opts.hit_list.threshold, cfg.scores.match,
            cfg.scores.b_gap_open, cfg.scores.b_gap_extend,
            min_kmer_pos=min_kmer_pos,
            use_region_counts=opts.anchor_list.use_region_counts,
            region_bits=cfg.region_bits,
            region_overlap=cfg.region_overlap,
            collapse=opts.anchor_list.collapse, gapless=False,
            search_strands=(True, True), threads=self.f1_threads)

    # ---------------------------------------------------------- stage A
    def stage_prepare(self, records: Sequence[SeqRecord],
                      batch_cap: Optional[int] = None):
        """Encode batch + filter1 + device dispatch. Returns None when
        the batch shape is unsupported (the config was screened by
        map_unpaired_sam_stream). `batch_cap` pads the device read
        table to a fixed row count."""
        m = self.m
        cfg = m.config
        t0 = _time.perf_counter()
        if not records:
            return None
        has_qual = any(r.qual is not None for r in records)
        L = len(records[0].seq)
        if L == 0 or L > cfg.longest_read_len:
            return None
        try:
            buf = "".join(r.seq for r in records).encode("ascii")
        except UnicodeEncodeError:
            return None
        B = len(records)
        if len(buf) != B * L:
            return None
        raw = np.frombuffer(buf, np.uint8).reshape(B, L)
        qual_fwd = qual_rc = qual_raw = None
        if has_qual:
            try:
                qbuf = "".join(r.qual for r in records).encode("ascii")
            except (UnicodeEncodeError, TypeError):
                return None
            if len(qbuf) != B * L:
                return None   # mixed/missing quals: generic path
            qarr = np.frombuffer(qbuf, np.uint8).reshape(B, L)
            qv = qarr.astype(np.int32) - cfg.qual_delta
            if not cfg.ignore_qvs and not cfg.no_qv_check:
                # PHRED offset sanity check (gmapper.c:464-473)
                bad = (qv < -10) | (qv > 50)
                if bad.any():
                    q0 = int(qv[bad][0])
                    raise ValueError(
                        "The qv-offset might be set incorrectly! "
                        "Currently qvs are interpreted as PHRED+"
                        f"{cfg.qual_delta} and a qv of {q0} was "
                        "observed.")
            if not cfg.ignore_qvs and cfg.min_avg_qv >= 0:
                # average-qv read drop (gmapper.c:455-462; C int division)
                s = qv.sum(axis=1, dtype=np.int64)
                avg = np.where(s < 0, -((-s) // L), s // L)
                keep = avg >= cfg.min_avg_qv
                if not keep.all():
                    records = [r for r, k in zip(records, keep) if k]
                    if not records:
                        return dict(B=0)
                    raw = np.ascontiguousarray(raw[keep])
                    qarr = np.ascontiguousarray(qarr[keep])
                    B = len(records)
            qual_raw = np.ascontiguousarray(qarr)  # unrescaled (for
            # the sam-unaligned records, output.c:419-421)
            if cfg.qual_delta != 33:
                # rescale to PHRED+33 (output.c:562-568)
                qarr = (qarr.astype(np.int32) - cfg.qual_delta + 33
                        ).astype(np.uint8)
            qual_fwd = np.ascontiguousarray(qarr)
            qual_rc = np.ascontiguousarray(qarr[:, ::-1])
        codes16 = C.CHAR_TO_INT[raw]
        if (codes16 < 0).any():
            return None
        codes = codes16.astype(np.uint8)
        rc = C.COMPLEMENT[codes[:, ::-1]]
        # SAM SEQ blobs
        seq_fwd = np.ascontiguousarray(_CLEAN_LUT[raw])
        seq_rc = np.ascontiguousarray(_COMP_LUT[seq_fwd[:, ::-1]])
        offs = np.empty(B + 1, np.int64)
        offs[0] = 0
        parts = []
        for i, r in enumerate(records):
            parts.append(r.name.encode())
            offs[i + 1] = offs[i] + len(parts[-1])
        nm_blob = np.frombuffer(b"".join(parts), np.uint8).copy() \
            if parts else np.zeros(1, np.uint8)
        wlen = int(abs_or_pct(cfg.window_len, L))
        m.tally("read prep", _time.perf_counter() - t0)
        t1 = _time.perf_counter()
        # interleave strand rows for filter1's owner convention
        codes2 = np.empty((B, 2, L), np.uint8)
        codes2[:, 0] = codes
        codes2[:, 1] = rc
        fh = self._filter1(codes2, L, wlen)
        if fh is None:
            return None
        m.tally("filter1", _time.perf_counter() - t1)
        t2 = _time.perf_counter()
        # Fused filter 2 + SPECULATIVE filter 3: the full-SW DP runs on
        # every candidate window in the same step as the vector SW, so a
        # batch pays one host->device->host round trip. The per-batch
        # read table holds forward rows only: strand-1 windows carry
        # reverse_hit coordinates and gather from the revcomp plane.
        Bcap = max(batch_cap or B, B)
        R = _round_up(L, 8)
        read_tab = np.full((Bcap, R), 254, np.uint8)
        read_tab[:B, :L] = codes
        win = None
        futures = []
        G = 16
        stats_flow = True
        if fh.n:
            futures, win, G, stats_flow = (
                self.dispatch_fn or _fused_dispatch)(
                m, fh, read_tab, L, R, (fh.owner & 1) == 1, n_reads=B)
        m.tally("device dispatch", _time.perf_counter() - t2)
        return dict(B=B, L=L, wlen=wlen, fh=fh, win=win, futures=futures,
                    G=G, R=R, stats_flow=stats_flow, codes=codes,
                    names=nm_blob, name_off=offs,
                    seq_fwd=seq_fwd, seq_rc=seq_rc,
                    qual_fwd=qual_fwd, qual_rc=qual_rc,
                    qual_raw=qual_raw,
                    Bcap=Bcap, read_tab=read_tab,
                    t_dispatch=_time.perf_counter() - t2)

    def _unaligned_block(self, ctx, nhits) -> bytes:
        """--sam-unaligned records for the reads in `ctx` with no
        emitted alignments, for the early-return paths where the native
        renderer never runs (same bytes hostpipe emits,
        output.c:417-474)."""
        cfg = self.m.config
        if not cfg.sam_unaligned:
            return b""
        seq_fwd = ctx["seq_fwd"]
        qual_raw = ctx.get("qual_raw")
        rg = (f"\tRG:Z:{cfg.read_group_name}".encode()
              if cfg.read_group_name else b"")
        parts = []
        name_off = ctx["name_off"]
        names = ctx["names"].tobytes()
        for r in range(*(self.read_slice or (0, ctx["B"]))):
            if nhits[r]:
                continue
            q = (qual_raw[r].tobytes() if qual_raw is not None
                 else b"*")
            parts.append(names[name_off[r]:name_off[r + 1]]
                         + b"\t4\t*\t0\t0\t*\t*\t0\t0\t"
                         + seq_fwd[r].tobytes() + b"\t" + q + rg
                         + b"\n")
        return b"".join(parts)

    def _stats_to_packed(self, stats, ctx2):
        """Expand the [n, 7] int32 stats rows (score, max_i, max_j,
        plane, run, term, matches, from _unpack_stats3) into the
        finalize_render job format. Rows whose best path is a single
        diagonal chain (plane == 0, term == 0) are reconstructed closed
        form, vectorized; the rare indel / cross-plane paths are re-run
        by the native banded DP (hostpipe.cpp sw_full_tb_host)."""
        n_jobs = ctx2["n_jobs"]
        W = (ctx2["R"] + ctx2["G"] + 3) // 4
        packed = np.zeros((n_jobs, 10), np.int32)
        ops_pk = np.zeros((n_jobs, W), np.uint8)
        score, mi, mj, plane, run, term, matches = (
            stats[:, k] for k in range(7))
        packed[:, 0] = score
        packed[:, 1] = mi
        packed[:, 2] = mj
        pos = score > 0
        closed = pos & (plane == 0) & (term == 0)
        packed[closed, 3] = run[closed]
        packed[closed, 4] = (mi - run + 1)[closed]
        packed[closed, 5] = (mj - run + 1)[closed]
        packed[closed, 6] = matches[closed]
        packed[closed, 7] = (run - matches)[closed]
        rows = np.nonzero(closed)[0]
        if rows.size:
            # walk-order op string: `run` diagonal ops (0b11), 4/byte
            fb = run[rows] // 4
            rem = run[rows] % 4
            sub = np.zeros((rows.size, W), np.uint8)
            sub[np.arange(W, dtype=np.int32)[None, :] < fb[:, None]] = 255
            ii = np.nonzero(rem > 0)[0]
            sub[ii, fb[ii]] = ((1 << (2 * rem[ii])) - 1).astype(np.uint8)
            ops_pk[rows] = sub
        need = np.nonzero(pos & ~closed)[0]
        self.m.tally(full_host_tb=int(need.size))
        self._expand_need(need, ctx2, packed, ops_pk)
        return packed, ops_pk, W

    def _expand_need(self, need, ctx2, packed, ops_pk) -> None:
        """The rows of the jobs `need` (indel and cross-plane paths) into
        `packed` / `ops_pk`: the native banded DP re-run on their windows,
        whose bytes come from the mapper's index. The multi-process tier
        overrides it (the owner ranks expand, and exchange)."""
        if not need.size:
            return
        m = self.m
        sc = m.config.scores
        jobs = ctx2["jobs"]
        R, G, L = ctx2["R"], ctx2["G"], ctx2["L"]
        W = ops_pk.shape[1]
        idx = m.index
        k2 = need.size
        starts = ctx2["starts"][need]
        rc = ctx2["rcmask"][need]
        gpos = np.clip(starts[:, None]
                       + np.arange(G, dtype=np.int64)[None, :],
                       0, idx.total_len - 1)
        gwin = np.ascontiguousarray(
            np.where(rc[:, None], idx.codes_rc[gpos],
                     idx.codes[gpos]).astype(np.uint8))
        read = np.ascontiguousarray(
            ctx2["read_tab"][jobs["ri"][need]])
        glen = np.ascontiguousarray(
            jobs["w_len"][need].astype(np.int32))
        rlen = np.full(k2, L, np.int32)
        ax = np.ascontiguousarray(ctx2["rx"][need])
        ay = np.ascontiguousarray(ctx2["ry"][need])
        alen = np.ascontiguousarray(ctx2["rl_"][need])
        awid = np.ascontiguousarray(ctx2["rw_"][need])
        rev = np.ascontiguousarray(ctx2["rev"][need].astype(np.uint8))
        pk2 = np.zeros((k2, 10), np.int32)
        op2 = np.zeros((k2, W), np.uint8)
        p = _FSWParams(k2, G, R, W, sc.match, sc.mismatch,
                       sc.a_gap_open, sc.a_gap_extend, sc.b_gap_open,
                       sc.b_gap_extend, 0)
        jb = _FSWJobs(_vp(gwin), _vp(glen), _vp(read), _vp(rlen),
                      _vp(ax), _vp(ay), _vp(alen), _vp(awid),
                      _vp(rev))
        rv = self.lib.sw_full_tb_host(ctypes.byref(p),
                                      ctypes.byref(jb), _vp(pk2),
                                      _vp(op2))
        if rv != 0:
            raise RuntimeError(f"sw_full_tb_host failed ({rv})")
        packed[need] = pk2
        ops_pk[need] = op2

    # ---------------------------------------------------------- stage B
    def stage_finish(self, ctx) -> Tuple[bytes, np.ndarray]:
        """Fetch the fused device results, run the native pass1
        selection on the vector scores, keep the selected rows'
        speculative full-SW results (stats expanded on the host, or the
        device traceback's rows and ops as they are), then native
        finalize/render."""
        m = self.m
        cfg = m.config
        B = ctx["B"]
        if B == 0:     # whole batch dropped by the avg-qv gate
            return b"", np.zeros(0, np.int32)
        fh = ctx["fh"]
        L, wlen = ctx["L"], ctx["wlen"]
        nhits = np.zeros(B, np.int32)
        if self.read_slice is not None and self.z1_merge_hook is not None:
            raise ValueError("read_slice and z1_merge_hook are mutually "
                             "exclusive")
        if fh.n == 0:
            m.tally(reads=B)
            return self._unaligned_block(ctx, nhits), nhits
        n = int(fh.n)
        t0 = _time.perf_counter()
        stats_flow = ctx["stats_flow"]
        tp = ctx["win"].get("two_phase")
        scores, stats_all, tb_all = _fetch(ctx, n)
        dev_secs = _time.perf_counter() - t0 + ctx["t_dispatch"]
        m.tally("device fetch", _time.perf_counter() - t0,
                vec_secs=dev_secs, full_secs=dev_secs)

        # ---- native pass1 selection over vector scores
        t0 = _time.perf_counter()
        sliced = self.read_slice is not None and self.slice_select
        sel_sl = slice(0, n)
        if sliced:
            # read sharding at full depth: pass-1 selection, the vector
            # gate, the expansion and the render run on this rank's read
            # slice only. Window rows are owner-major, so the slice's rows
            # are one span (seg_start bounds); each sliced read's windows
            # span every shard (the allgather ran before this), so its
            # MQV denominator is whole without a merge
            lo_s, hi_s = self.read_slice
            sel_sl = slice(int(fh.seg_start[min(2 * lo_s, 2 * B)]),
                           int(fh.seg_start[min(2 * hi_s, 2 * B)]))
            n = sel_sl.stop - sel_sl.start
            if n == 0:
                return self._no_jobs(ctx, nhits)
        opts = m._unpaired_opts[0].pass1
        cap = max(n, 1)
        sel = {k: np.empty(cap, dt) for k, dt in
               (("ri", np.int32), ("gen_st", np.int8), ("cn", np.int32),
                ("g_off", np.int64), ("w_len", np.int32),
                ("score_max", np.int64), ("ax", np.int64),
                ("ay", np.int64), ("alen", np.int64), ("awid", np.int64),
                ("score_vector", np.int64), ("src", np.int64),
                ("matches", np.int32), ("swg", np.int64))}
        seg = np.zeros(B + 1, np.int64)
        p1 = _P1Params(
            n, 2 * B, L, wlen,
            int(abs_or_pct(opts.window_overlap, wlen)),
            float(opts.threshold), opts.min_matches, opts.num_outputs,
            1, self.contig_lengths32.ctypes.data)
        arrs = dict(owner=np.ascontiguousarray(fh.owner[sel_sl], np.int64),
                    cn=np.ascontiguousarray(fh.cn[sel_sl], np.int32),
                    g_off=np.ascontiguousarray(fh.g_off[sel_sl], np.int64),
                    w_len=np.ascontiguousarray(fh.w_len[sel_sl], np.int32),
                    matches=np.ascontiguousarray(fh.matches[sel_sl],
                                                 np.int32),
                    score_max=np.ascontiguousarray(fh.score_max[sel_sl],
                                                   np.int64),
                    ax=np.ascontiguousarray(fh.ax[sel_sl], np.int64),
                    ay=np.ascontiguousarray(fh.ay[sel_sl], np.int64),
                    alen=np.ascontiguousarray(fh.alen[sel_sl], np.int64),
                    awid=np.ascontiguousarray(fh.awid[sel_sl], np.int64),
                    scores=np.ascontiguousarray(scores[sel_sl]),
                    swg=np.ascontiguousarray(fh.score_window_gen[sel_sl],
                                             np.int64))
        p1in = _P1In(**{k: _vp(v) for k, v in arrs.items()})
        p1out = _P1Out(cap, *[_vp(sel[k]) for k in
                              ("ri", "gen_st", "cn", "g_off", "w_len",
                               "score_max", "ax", "ay", "alen",
                               "awid", "score_vector")],
                       _vp(seg), _vp(sel["src"]),
                       _vp(sel["matches"]), _vp(sel["swg"]))
        n_sel = int(self.lib.pass1_select(ctypes.byref(p1),
                                          ctypes.byref(p1in),
                                          ctypes.byref(p1out)))
        if n_sel < 0:
            raise RuntimeError(f"pass1_select failed ({n_sel})")

        # pass2 vector-score gate (read_pass2 threshold pre-check)
        thr = cfg.sw_full_threshold
        if n_sel:
            smax = sel["score_max"][:n_sel]
            if thr < 0:
                thresh = np.full(n_sel, int(-thr), np.int64)
            else:
                thresh = (smax * (thr / 100.0)).astype(np.int64)
            jsel = np.nonzero(sel["score_vector"][:n_sel] >= thresh)[0]
        else:
            jsel = np.zeros(0, np.int64)
        n_jobs = len(jsel)
        m.tally("pass1 select", _time.perf_counter() - t0)
        if n_jobs == 0:
            return self._no_jobs(ctx, nhits)
        jobs = {k: np.ascontiguousarray(sel[k][:n_sel][jsel]) for k in
                ("ri", "gen_st", "cn", "g_off", "w_len", "score_max",
                 "ax", "ay", "alen", "awid", "matches", "swg",
                 "score_vector")}
        rows = sel["src"][:n_sel][jsel] + sel_sl.start
        if tp is not None:
            # two-phase phase B: the full SW on the pass-1 + vector-gate
            # survivors only
            out2 = _tp_run_full(m, tp, ctx["win"], ctx["G"], rows,
                                stats_flow, fh, L, ctx["R"])
        t0 = _time.perf_counter()
        if stats_flow:
            packed, ops_pk, W = self._stats_to_packed(
                out2 if tp is not None else stats_all[rows],
                _expand_ctx(ctx, rows, jobs, sliced))
        elif tp is not None:
            packed, ops_pk = out2
            W = ops_pk.shape[1]
        else:
            packed = np.ascontiguousarray(tb_all[0][rows])
            ops_pk = np.ascontiguousarray(tb_all[1][rows])
            W = ops_pk.shape[1]
        m.tally("alignment expand", _time.perf_counter() - t0)
        if sliced:
            self.last_slice_jobs += n_jobs
        elif self.read_slice is not None:
            # read sharding, shallow: selection and the expansion ran over
            # the whole batch on every rank; this rank renders only its
            # slice (splitreads recast, README:236-276)
            lo, hi = self.read_slice
            smask = (jobs["ri"] >= lo) & (jobs["ri"] < hi)
            jobs = {k: np.ascontiguousarray(v[smask])
                    for k, v in jobs.items()}
            rows = rows[smask]
            packed = np.ascontiguousarray(packed[smask])
            ops_pk = np.ascontiguousarray(ops_pk[smask])
            n_jobs = int(smask.sum())
            self.last_slice_jobs += n_jobs
            if n_jobs == 0:
                return self._no_jobs(ctx, nhits)
        t1 = _time.perf_counter()
        cal = m.cal
        fr = _FRParams(
            n_jobs, B, L, W, float(cfg.sw_full_threshold),
            cfg.num_outputs, int(cfg.strata), cfg.max_alignments,
            int(cfg.single_best_mapping),
            int(cfg.compute_mapping_qualities), cal.alpha, cal.beta,
            self.contig_lengths32.ctypes.data,
            self.contig_name_off.ctypes.data,
            self.contig_names_blob.ctypes.data,
            ctx["name_off"].ctypes.data, ctx["names"].ctypes.data,
            ctx["seq_fwd"].ctypes.data, ctx["seq_rc"].ctypes.data,
            ctx["qual_fwd"].ctypes.data
            if ctx.get("qual_fwd") is not None else None,
            ctx["qual_rc"].ctypes.data
            if ctx.get("qual_rc") is not None else None,
            None)
        # renderer-level flags (output.c:227-774, native renderer)
        rg_bytes = None
        if cfg.read_group_name:
            rg_bytes = f"\tRG:Z:{cfg.read_group_name}".encode()
            fr.rg = ctypes.cast(ctypes.c_char_p(rg_bytes),
                                ctypes.c_void_p)
            fr.rg_len = len(rg_bytes)
        fr.all_contigs = int(cfg.all_contigs)
        fr.sam_unaligned = int(cfg.sam_unaligned)
        fr.extra_sam = int(cfg.extra_sam_fields)
        if cfg.extra_sam_fields:
            idx0 = m.index
            if idx0.codes is None:
                # the multi-process tier: no rank holds the whole genome
                # the ZE field is built from
                raise ValueError("--extra-sam-fields needs the whole "
                                 "genome on the host")
            fr.genome = idx0.codes.ctypes.data
            fr.genome_rc = idx0.codes_rc.ctypes.data
            fr.contig_offsets = self.contig_offsets32.ctypes.data
        if cfg.sam_unaligned:
            if ctx.get("qual_raw") is not None:
                fr.qual_raw = ctx["qual_raw"].ctypes.data
            fr.una_lo, fr.una_hi = self.read_slice or (0, B)
        if self.surv_post is not None:
            # each emitted alignment's posterior at its job index
            self.surv_post = np.zeros(n_jobs, np.float64)
            self.last_rows = rows
            self.last_ri = jobs["ri"]
            fr.surv_post = self.surv_post.ctypes.data
        frj = _FRJobs(_vp(jobs["ri"]), _vp(jobs["cn"]),
                      _vp(jobs["gen_st"]), _vp(jobs["g_off"]),
                      _vp(jobs["score_max"]), _vp(packed), _vp(ops_pk),
                      _vp(jobs["matches"]), _vp(jobs["swg"]),
                      _vp(jobs["score_vector"]))
        cap = n_jobs * (2 * L + 224) + 4096
        if self.z1_merge_hook is not None:
            # a first pass writes the posteriors of the alignments that
            # enter z1 (the per-shard partials), the hook merges them
            # across shards, and the render below divides by the merged
            # z1 (MAPPING_QUALITIES Part 1c)
            sp = np.zeros(n_jobs, np.float64)
            fr.surv_post = sp.ctypes.data
            _finalize_render(self.lib, fr, frj, cap, nhits)
            fr.surv_post = None
            z1m = np.ascontiguousarray(
                self.z1_merge_hook(sp, jobs["ri"], rows, B), np.float64)
            if z1m.shape != (B,):
                raise ValueError(f"z1_merge_hook returned {z1m.shape}, "
                                 f"not ({B},)")
            fr.ext_z1 = z1m.ctypes.data
        buf, nb = _finalize_render(self.lib, fr, frj, cap, nhits)
        m.tally("finalize + render", _time.perf_counter() - t1, reads=B,
                reads_mapped=int((nhits > 0).sum()),
                alignments=int(nhits.sum()))
        return buf[:nb].tobytes(), nhits

    def _no_jobs(self, ctx, nhits):
        """The return of a batch with no jobs to render. A rank-local
        batch (read_slice with slice_select) of the stats flow first
        expands its none: the multi-process tier's expansion is an
        exchange every rank joins (shrimp_tpu returns before it there,
        and the other ranks wait for it)."""
        if (ctx["stats_flow"] and self.read_slice is not None
                and self.slice_select):
            none = np.zeros(0, np.int64)
            self._stats_to_packed(np.zeros((0, 7), np.int32), _expand_ctx(
                ctx, none, dict(ri=none.astype(np.int32),
                                w_len=none.astype(np.int32)), True))
        self.m.tally(reads=ctx["B"])
        return self._unaligned_block(ctx, nhits), nhits


def _expand_ctx(ctx, rows, jobs, rank_local: bool) -> dict:
    """What `FastLS._stats_to_packed` reads of the jobs at window rows
    `rows` of the batch `ctx`: the jobs' read rows and window lengths
    (`jobs`), their windows' geometry, and whether the job list is this
    rank's own (`rank_local`: read_slice with slice_select) or the same
    on every rank."""
    win = ctx["win"]
    return dict(n_jobs=len(rows), jobs=jobs, R=ctx["R"], G=ctx["G"],
                L=ctx["L"], read_tab=ctx["read_tab"], rows=rows,
                rank_local_jobs=rank_local, starts=win["starts"][rows],
                rcmask=win["rcmask"][rows], rx=win["rx"][rows],
                ry=win["ry"][rows], rl_=win["rl_"][rows],
                rw_=win["rw_"][rows], rev=win["rev"][rows])


def _finalize_render(lib, fr, frj, cap: int, nhits):
    """One finalize_render call into a buffer that grows until the text
    fits: (buffer, bytes written)."""
    while True:
        buf = np.empty(cap, np.uint8)
        nb = lib.finalize_render(ctypes.byref(fr), ctypes.byref(frj),
                                 _vp(buf), cap, _vp(nhits))
        if nb >= 0:
            return buf, nb
        if nb == -2:
            raise RuntimeError("fastpath finalize unsupported config")
        cap *= 4


def auto_batch_size(mapper) -> int:
    """Density-aware default batch size: big genomes carry thousands of
    candidate windows per read, so smaller batches give the lane
    pipeline depth; small genomes amortize per-batch overheads with big
    batches."""
    return 2048 if mapper.index.total_len >= (1 << 28) else 8192


def map_unpaired_sam_stream(mapper, records: Sequence[SeqRecord],
                            batch_size: Optional[int] = None,
                            lanes: Optional[int] = None
                            ) -> Optional[Iterator[bytes]]:
    """Pipelined LS unpaired mapping straight to SAM bytes, batch by
    batch in input order; None when the config needs a feature outside
    the fast path or the first batch is one the flat encoder rejects
    (mixed read lengths, non-ACGTN bases, mixed qualities): the caller
    maps those with `mapper.map_unpaired`. A later rejected batch takes
    the slow tail (`unpaired_slow_tail`).

    `lanes` > 1 (default 16) runs that many whole-batch pipelines on
    worker threads, output re-ordered to input order; results are
    byte-identical to lanes=1."""
    if not _config_supported(mapper.config):
        return None
    fast = FastLS(mapper)
    batch_size = batch_size or auto_batch_size(mapper)
    return batch_pipeline(
        fast, fast.stage_prepare, fast.stage_finish, records, batch_size,
        lanes, unpaired_slow_tail(mapper, records, batch_size))


def unpaired_slow_tail(mapper, records: Sequence[SeqRecord],
                       batch_size: int):
    """slow_tail(off) -> the SAM bytes of the batch at `off` through the
    generic mapper (`Mapper.map_unpaired`), as the reference's streams
    write them (hits only)."""
    from .io.sam import render_unpaired

    def slow_tail(off: int) -> bytes:
        batch = list(records[off:off + batch_size])
        fq = any(r.qual is not None for r in batch)
        lines = []
        for re_, hits in mapper.map_unpaired(batch):
            for h in hits:
                lines.append(render_unpaired(re_, h, mapper.index,
                                             mapper.config, fastq=fq))
        return ("\n".join(lines) + "\n").encode() if lines else b""
    return slow_tail


def paired_slow_tail(mapper, records: Sequence[SeqRecord], batch_size: int):
    """slow_tail(off) -> the SAM bytes of the pairs at `off` through the
    generic paired mapper (`PairedMapper.map_paired`, `select_output`)."""
    from .io.sam import render_pair_entry

    def slow_tail(off: int) -> bytes:
        batch = records[off:off + batch_size]
        fq = any(r.qual is not None for r in batch)
        lines = []
        for pe in mapper.map_paired(batch):
            p_out, u_out = mapper.select_output(pe)
            lines.extend(render_pair_entry(pe, mapper.index, mapper.config,
                                           p_out, u_out, fastq=fq))
        return ("\n".join(lines) + "\n").encode() if lines else b""
    return slow_tail


def batch_pipeline(fls: FastLS, stage_prepare, stage_finish,
                   records: Sequence[SeqRecord], batch_size: int,
                   lanes: Optional[int],
                   slow_tail) -> Optional[Iterator[bytes]]:
    """SAM bytes batch by batch in input order, from `stage_prepare`
    (records, batch_cap) -> context and `stage_finish` (context) ->
    (bytes, hits). The first batch is prepared before this returns, and
    None is returned when stage_prepare rejects it (None): the caller
    maps such input with the generic mapper, as the reference's callers
    do. A later batch that stage_prepare rejects goes to `slow_tail(off)`
    -> bytes. A batch stage_prepare cannot take (NotImplementedError)
    raises NotImplementedError naming its reads. `lanes` > 1 (default
    16) runs that many whole-batch pipelines on worker threads, output
    re-ordered to input order; results are byte-identical to
    lanes=1."""
    def prepare(off: int):
        try:
            return stage_prepare(records[off:off + batch_size],
                                 batch_cap=batch_size)
        except NotImplementedError as e:
            end = min(off + batch_size, len(records)) - 1
            raise NotImplementedError(f"reads {off}..{end}: {e}") from e

    if not len(records):
        return iter(())
    # probe the first batch before committing
    first = prepare(0)
    if first is None:
        return None
    if lanes is None:
        lanes = 16
    if lanes > 1 and len(records) > batch_size:
        # lanes keep every host core busy; filter1's inner fan-out would
        # only contend with them
        fls.f1_threads = 1

        def work(off: int, pre) -> bytes:
            a = pre if pre is not None else prepare(off)
            return slow_tail(off) if a is None else stage_finish(a)[0]

        def gen_mt():
            offs = list(range(0, len(records), batch_size))
            with ThreadPoolExecutor(lanes) as ex:
                futs = {}
                ahead = lanes + 2
                sub = 0
                for i in range(len(offs)):
                    while sub < len(offs) and sub - i < ahead:
                        futs[sub] = ex.submit(work, offs[sub],
                                              first if sub == 0 else None)
                        sub += 1
                    yield futs.pop(i).result()
        return gen_mt()

    def gen():
        pend, off = first, batch_size
        while pend is not None or off < len(records):
            nxt = prepare(off) if off < len(records) else None
            if nxt is None and off < len(records):
                # drain in input order, then the slow batch
                if pend is not None:
                    yield stage_finish(pend)[0]
                    pend = None
                yield slow_tail(off)
                off += batch_size
                continue
            off += batch_size
            if pend is not None:
                yield stage_finish(pend)[0]
            pend = nxt
    return gen()


# ===================================================================
# Paired-end fast path
# ===================================================================

class _PPParams(ctypes.Structure):
    _fields_ = [("n_pairs", ctypes.c_int64), ("n_windows", ctypes.c_int64),
                ("read_len", ctypes.c_int32),
                ("window_len", ctypes.c_int32),
                ("ops_words", ctypes.c_int32),
                ("d_min", ctypes.c_int64 * 2),
                ("d_max", ctypes.c_int64 * 2),
                ("p1_min_matches", ctypes.c_int32),
                ("p1_overlap", ctypes.c_int32),
                ("p1_threshold", ctypes.c_double),
                ("pair1_num_outputs", ctypes.c_int32),
                ("pair1_threshold", ctypes.c_double),
                ("foot_threshold", ctypes.c_double),
                ("pair2_threshold", ctypes.c_double),
                ("pair2_num_outputs", ctypes.c_int32),
                ("strata", ctypes.c_int32),
                ("max_alignments", ctypes.c_int32),
                ("hp_enabled", ctypes.c_int32),
                ("hp_min_matches", ctypes.c_int32),
                ("hp_overlap", ctypes.c_int32),
                ("hp_threshold", ctypes.c_double),
                ("hp_num_tmp", ctypes.c_int32),
                ("hp_full_threshold", ctypes.c_double),
                ("hp_num_outputs", ctypes.c_int32),
                ("compute_mqv", ctypes.c_int32),
                ("alpha", ctypes.c_double), ("beta", ctypes.c_double),
                ("match_score", ctypes.c_int32),
                ("mismatch_score", ctypes.c_int32),
                ("total_genome_size", ctypes.c_double),
                ("ins_mean", ctypes.c_double),
                ("ins_stddev", ctypes.c_double),
                ("mode_sign_st0", ctypes.c_int32),
                ("contig_lengths", ctypes.c_void_p),
                ("contig_name_off", ctypes.c_void_p),
                ("contig_names", ctypes.c_void_p),
                ("name_off", ctypes.c_void_p), ("names", ctypes.c_void_p),
                ("seq_fwd", ctypes.c_void_p), ("seq_rc", ctypes.c_void_p),
                ("qual_fwd", ctypes.c_void_p),
                ("qual_rc", ctypes.c_void_p),
                ("qual_raw", ctypes.c_void_p),
                # colour-space mode extras (cs=0 for LS)
                ("cs", ctypes.c_int32),
                ("pr_random_den", ctypes.c_int32),
                ("pr_xover", ctypes.c_double), ("pr_snp", ctypes.c_double),
                ("pr_del_open", ctypes.c_double),
                ("pr_del_extend", ctypes.c_double),
                ("pr_ins_open", ctypes.c_double),
                ("pr_ins_extend", ctypes.c_double),
                ("cs_fastq", ctypes.c_int32),
                ("cs_use_read_qvs", ctypes.c_int32),
                ("cs_qual_delta", ctypes.c_int32),
                ("cs_use_sanger", ctypes.c_int32),
                ("cs_genome_fwd", ctypes.c_void_p),
                ("cs_genome_rc", ctypes.c_void_p),
                ("cs_colours", ctypes.c_void_p),
                ("cs_qr_tab", ctypes.c_void_p),
                ("cs_initbp", ctypes.c_void_p),
                ("cs_readseq", ctypes.c_void_p),
                ("cs_read_seq_len", ctypes.c_int32),
                ("cs_quals", ctypes.c_void_p),
                ("cs_cq", ctypes.c_void_p),
                ("cs_cq_len", ctypes.c_int32),
                # sharded-index MQV recombination (two-pass; see
                # pairedpipe.cpp PPParams tail): unused here
                ("win_shard", ctypes.c_void_p),
                ("n_shards", ctypes.c_int32),
                ("part_out", ctypes.c_void_p),
                ("ext_in", ctypes.c_void_p),
                # select-then-full two-phase (pairedpipe.cpp tail)
                ("full_valid", ctypes.c_void_p),
                ("rescue_flag", ctypes.c_void_p),
                ("select_only", ctypes.c_int32),
                ("sel_out", ctypes.c_void_p),
                # renderer-level flags
                ("rg", ctypes.c_void_p), ("rg_len", ctypes.c_int32),
                ("all_contigs", ctypes.c_int32),
                ("sam_unaligned", ctypes.c_int32),
                ("sam_r2", ctypes.c_int32),
                ("seq_raw", ctypes.c_void_p),
                ("una_lo", ctypes.c_int64),
                ("una_hi", ctypes.c_int64),
                ("rescue_cap", ctypes.c_int64)]


class _PPWin(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in
                ("seg", "cn", "g_off", "g_off_norm", "gen_st", "w_len",
                 "matches", "score_max", "vec", "packed", "ops_pk",
                 "cs_packed", "cs_steps", "start_abs")]


def fastpath_paired_supported(cfg: MapperConfig) -> bool:
    """Gate: the native paired renderer covers the default LS paired SAM
    flow (single option set, MQV on, no single-best) plus the
    renderer-level flags (--all-contigs without single-best is Z-field
    suppression only; --sam-unaligned / --sam-r2 / --read-group are
    output-side)."""
    if cfg.pair_mode == C.PAIR_NONE:
        return False
    if cfg.mode != C.MODE_LETTER_SPACE:
        return False
    if cfg.custom_paired_options or cfg.custom_unpaired_options:
        return False
    popts = cfg.paired_options()
    if len(popts) != 1:
        return False
    ro = popts[0].read[0]
    if (ro.anchor_list.use_mp_region_counts
            and not ro.anchor_list.use_region_counts):
        return False
    if cfg.gapless or not cfg.global_alignment:
        return False
    if not cfg.compute_mapping_qualities:
        return False
    if cfg.single_best_mapping:
        return False
    if cfg.extra_sam_fields or cfg.shrimp_format:
        return False
    if not (cfg.search_forward and cfg.search_reverse):
        return False
    return True


def _paired_config_supported(cfg: MapperConfig) -> bool:
    """`fastpath_paired_supported` plus the reference's stage_prepare
    refusal of raw-string trims, which the reference also answers with
    None. FastPaired assumes a config that passed this gate."""
    return (fastpath_paired_supported(cfg)
            and not (cfg.trim_front or cfg.trim_end or cfg.trim_illumina))


def _set_paired_render_flags(p, cfg, raw: np.ndarray, n_pairs: int):
    """Renderer-level flag fields on the native paired params (RG
    suffix, all-contigs, sam-unaligned range, sam-r2; `raw` is the
    batch's read text, which the LS R2:Z tag copies). Returns the RG
    bytes to keep alive through the native call."""
    rg_bytes = None
    if cfg.read_group_name:
        rg_bytes = f"\tRG:Z:{cfg.read_group_name}".encode()
        p.rg = ctypes.cast(ctypes.c_char_p(rg_bytes), ctypes.c_void_p)
        p.rg_len = len(rg_bytes)
    p.all_contigs = int(cfg.all_contigs)
    p.sam_unaligned = int(cfg.sam_unaligned)
    p.sam_r2 = int(cfg.sam_r2)
    p.seq_raw = raw.ctypes.data
    p.una_lo = 0
    p.una_hi = n_pairs
    return rg_bytes


def _paired_unaligned_block(cfg, ctx, body, r2_tag: bytes,
                            pairs=None) -> bytes:
    """--sam-unaligned records for every pair of a batch with no
    candidate windows (the bytes pairedpipe emits), or for the pairs
    [lo, hi) of `pairs`: the pair's QNAME, the unmapped flags, `body(ri)`
    (the fields from SEQ on of read row ri), the mate's read text under
    `r2_tag` with --sam-r2, the RG suffix."""
    if not cfg.sam_unaligned:
        return b""
    name_off = ctx["name_off"]
    names = ctx["names"].tobytes()
    raw = ctx["raw"]
    rg = (f"\tRG:Z:{cfg.read_group_name}".encode()
          if cfg.read_group_name else b"")
    parts = []
    for pi in range(*(pairs or (0, ctx["B"] // 2))):
        nms = [names[name_off[2 * pi + k]:name_off[2 * pi + k + 1]].decode()
               for k in (0, 1)]
        q = _pair_qname(nms[0], nms[1]).encode()
        for nip in (0, 1):
            ri = 2 * pi + nip
            flags = 0x1 | 0x4 | 0x8 | (0x40 if nip == 0 else 0x80)
            line = (q + f"\t{flags}\t*\t0\t0\t*\t*\t0\t0\t".encode()
                    + body(ri))
            if cfg.sam_r2:
                line += r2_tag + raw[2 * pi + 1 - nip].tobytes()
            parts.append(line + rg + b"\n")
    return b"".join(parts)


def _mp_kw(m, ro, wlen: int, L: int, B: int) -> dict:
    """filter 1's mate-pair region filter arguments for a batch of B
    interleaved reads of length L (readpair_compute_mp_ranges,
    mapping.c:2317-2442; all pairs share the deltas at equal lengths),
    or {} where the option set does not use it."""
    if not ro.anchor_list.use_mp_region_counts:
        return {}
    re1 = SimpleNamespace(window_len=wlen, read_len=L)
    re2 = SimpleNamespace(window_len=wlen, read_len=L)
    m._compute_mp_ranges(re1, re2, m._paired_opts[0].pairing)
    drmin = np.empty(2 * B, np.int64)
    drmax = np.empty(2 * B, np.int64)
    for st in (0, 1):
        drmin[st::4] = re1.delta_region_min[st]
        drmax[st::4] = re1.delta_region_max[st]
        drmin[2 + st::4] = re2.delta_region_min[st]
        drmax[2 + st::4] = re2.delta_region_max[st]
    return dict(mp_mode=ro.anchor_list.use_mp_region_counts,
                mp_drmin=drmin, mp_drmax=drmax)


def _filter1_paired(m, f1_threads, codes2, L: int, wlen: int, ro,
                    min_kmer_pos: int, index=None):
    """Paired candidate generation over `index` (None: the mapper's),
    the mate-pair region filter included (colour space starts its k-mers
    at colour 1: min_kmer_pos=1)."""
    cfg = m.config
    return generate_candidates_native(
        m.index if index is None else index, codes2, L, wlen, m.cutoff,
        ro.hit_list.match_mode,
        ro.hit_list.threshold, cfg.scores.match,
        cfg.scores.b_gap_open, cfg.scores.b_gap_extend,
        min_kmer_pos=min_kmer_pos,
        use_region_counts=ro.anchor_list.use_region_counts,
        region_bits=cfg.region_bits,
        region_overlap=cfg.region_overlap,
        collapse=ro.anchor_list.collapse, gapless=False,
        search_strands=(True, True), threads=f1_threads,
        **_mp_kw(m, ro, wlen, L, codes2.shape[0]))


def _paired_render(lib, p, wstruct, cap, pair_nhits, read_nhits):
    """One paired_finalize_render call into a buffer that grows until
    the text fits: (buffer, bytes written, buffer size)."""
    while True:
        out = np.empty(cap, np.uint8)
        rv = int(lib.paired_finalize_render(
            ctypes.byref(p), ctypes.byref(wstruct),
            out.ctypes.data_as(ctypes.c_char_p), cap,
            _vp(pair_nhits), _vp(read_nhits)))
        if rv >= 0:
            return out, rv, cap
        cap *= 4
        pair_nhits[:] = 0
        read_nhits[:] = 0


def _zpair_collect(lib, p, wstruct, cap: int, n_pairs: int, hook,
                   win_shard, n_shards: int, pair_nhits, read_nhits):
    """The sharded-index paired MQV recombination, LS and CS: a first
    render pass writes each (pair, shard)'s partial class statistics
    [n_pairs, n_shards, 9] (pairedpipe.cpp PPParams tail; `win_shard`
    is each window row's shard), `hook` merges them across shards into
    the [n_pairs, 7] rows that `p.ext_in` then points at for the render
    pass. Returns the merged rows, which must outlive that pass."""
    ws = np.ascontiguousarray(win_shard, np.int32)
    part = np.zeros((n_pairs, n_shards, 9), np.float64)
    p.win_shard = ws.ctypes.data
    p.n_shards = n_shards
    p.part_out = part.ctypes.data
    # the render sets each rendered pair's partials afresh, so a pass
    # that outgrows its buffer needs no reset of `part`
    _paired_render(lib, p, wstruct, cap, pair_nhits, read_nhits)
    ext = np.ascontiguousarray(hook(part), np.float64)
    if ext.shape != (n_pairs, 7):
        raise ValueError(f"zpair_merge_hook returned {ext.shape}, not "
                         f"({n_pairs}, 7)")
    p.win_shard = None
    p.part_out = None
    p.ext_in = ext.ctypes.data
    pair_nhits[:] = 0
    read_nhits[:] = 0
    return ext


def _select_then_full(m, lib, p, wstruct, pairing, hp, n: int,
                      n_pairs: int, cap: int, pair_nhits, read_nhits,
                      run_rows, fields, stage: str):
    """The two-phase paired render, LS and CS: the native select pass
    picks, from the vector scores alone, every window row that can need
    full-SW results (paired heap feet and the half-paired heap's
    superset); `run_rows(rows)` runs the full SW on those rows and
    returns their alignment rows [k, ...] and op or step codes [k, W],
    which go to the full-size arrays that the `_PPWin` fields `fields`
    point at (valid where `full_valid` is 1); the render records rows it
    finds missing (saved-anchor suppression can diverge at high
    density), which rescue rounds add, at most four, with every row as
    the last net. `stage` names the select pass's stage. Returns
    (buffer, bytes written)."""
    t0 = _time.perf_counter()
    cap_sel = int(n_pairs) * 2 * (
        pairing.pass1_num_outputs + hp.pass1.num_outputs
        + pairing.pass2_num_outputs) + 8
    sel_out = np.zeros(cap_sel, np.int32)
    p.select_only = 1
    p.sel_out = sel_out.ctypes.data
    dummy = np.zeros(8, np.uint8)
    nsel = int(lib.paired_finalize_render(
        ctypes.byref(p), ctypes.byref(wstruct),
        dummy.ctypes.data_as(ctypes.c_char_p), 0,
        _vp(pair_nhits), _vp(read_nhits)))
    if not 0 <= nsel <= cap_sel:
        raise RuntimeError(f"paired select pass failed ({nsel})")
    p.select_only = 0
    p.sel_out = None
    m.tally(stage, _time.perf_counter() - t0)
    # the full-size arrays the render reads: valid where fv is 1
    full = {}

    def add_full(rows_f):
        """The full SW for rows_f (those not yet valid), merged into the
        full-size arrays."""
        if full:
            rows_f = rows_f[full["fv"][rows_f] == 0]
        if len(rows_f) == 0:
            return
        aln, ops = run_rows(rows_f)
        if not full:
            p.ops_words = ops.shape[1]
            full.update(aln=np.zeros((n,) + aln.shape[1:], aln.dtype),
                        ops=np.zeros((n, ops.shape[1]), ops.dtype),
                        fv=np.zeros(n, np.uint8))
            setattr(wstruct, fields[0], _vp(full["aln"]))
            setattr(wstruct, fields[1], _vp(full["ops"]))
            p.full_valid = full["fv"].ctypes.data
        if ops.shape[1] != full["ops"].shape[1]:
            raise RuntimeError("paired select-then-full: op widths "
                               "differ between rounds")
        full["aln"][rows_f] = aln
        full["ops"][rows_f] = ops
        full["fv"][rows_f] = 1

    add_full(np.unique(sel_out[:nsel]).astype(np.int64))
    rescue = np.zeros(1, np.int32)
    p.rescue_flag = rescue.ctypes.data
    p.sel_out = sel_out.ctypes.data
    p.rescue_cap = cap_sel
    out, rv, cap = _paired_render(lib, p, wstruct, cap, pair_nhits,
                                  read_nhits)
    rounds = 0
    while rescue[0] and rounds < 4:
        add_full(np.unique(
            sel_out[:min(int(rescue[0]), cap_sel)]).astype(np.int64))
        rescue[0] = 0
        pair_nhits[:] = 0
        read_nhits[:] = 0
        out, rv, cap = _paired_render(lib, p, wstruct, cap, pair_nhits,
                                      read_nhits)
        rounds += 1
    if rescue[0]:
        add_full(np.arange(n, dtype=np.int64))
        p.full_valid = None
        pair_nhits[:] = 0
        read_nhits[:] = 0
        out, rv, cap = _paired_render(lib, p, wstruct, cap, pair_nhits,
                                      read_nhits)
    return out, rv


class FastPaired:
    """Flat-array paired-end pipeline: filter 1 and the device dispatch
    shared with the unpaired stream (`_fused_dispatch`, two-phase at
    LS_TWO_PHASE_WPR windows per read or more), then one native call
    (`paired_finalize_render`) for pair-up, the paired passes, the
    half-paired fallback, paired MQVs and the SAM text. Two-phase batches
    run select-then-full: the native select pass picks, from the vector
    scores alone, every window row that can need full-SW results, the
    full SW runs on those rows (`_tp_run_full`), and rows the render
    then finds missing are added in rescue rounds. `mapper` is a
    `paired.PairedMapper`.

    The sharded-index tier sets `zpair_merge_hook` ([n_pairs, D, 9]
    partials -> the merged [n_pairs, 7] rows the render divides by),
    `zpair_win_shard` (each window's shard) and `zpair_n_shards`; a
    batch takes two phases only with the module's own dispatch and no
    hook, as in the reference."""

    def __init__(self, mapper) -> None:
        self.fls = FastLS(mapper)
        self.lib = self.fls.lib
        self.m = mapper
        self.zpair_merge_hook = None
        self.zpair_win_shard = None
        self.zpair_n_shards = 0
        # read sharding (the multi-process tier), as FastLS's: (plo, phi)
        # has the native paired brain run only for the batch's pairs
        # [plo, phi); with slice_select the expansion is sliced too;
        # last_slice_jobs counts the windows of the slices
        self.read_slice = None
        self.slice_select = False
        self.last_slice_jobs = 0

    def _filter1_paired(self, codes2, L: int, wlen: int, ro):
        """Paired candidate generation (the mate-pair region filter
        included); the sharded-index tier overrides it."""
        return _filter1_paired(self.m, self.fls.f1_threads, codes2, L, wlen,
                               ro, min_kmer_pos=0)

    # ---------------------------------------------------------- stage A
    def stage_prepare(self, records: Sequence[SeqRecord],
                      batch_cap: Optional[int] = None):
        """Encode interleaved mate pairs + filter 1 + device dispatch.
        Returns None when the flat encoder rejects the batch (the config
        was screened by map_paired_sam_stream)."""
        m = self.m
        cfg = m.config
        t0 = _time.perf_counter()
        if not records or len(records) % 2:
            return None
        qual_raw = None
        has_qual = any(r.qual is not None for r in records)
        L = len(records[0].seq)
        if L == 0 or L > cfg.longest_read_len:
            return None
        try:
            buf = "".join(r.seq for r in records).encode("ascii")
        except UnicodeEncodeError:
            return None
        B = len(records)
        if len(buf) != B * L:
            return None
        raw = np.frombuffer(buf, np.uint8).reshape(B, L)
        qual_fwd = qual_rc = None
        if has_qual:
            try:
                qbuf = "".join(r.qual for r in records).encode("ascii")
            except (UnicodeEncodeError, TypeError):
                return None
            if len(qbuf) != B * L:
                return None
            qarr = np.frombuffer(qbuf, np.uint8).reshape(B, L)
            qv = qarr.astype(np.int32) - cfg.qual_delta
            if not cfg.ignore_qvs and not cfg.no_qv_check:
                bad = (qv < -10) | (qv > 50)
                if bad.any():
                    q0 = int(qv[bad][0])
                    raise ValueError(
                        "The qv-offset might be set incorrectly! "
                        "Currently qvs are interpreted as PHRED+"
                        f"{cfg.qual_delta} and a qv of {q0} was "
                        "observed.")
            if not cfg.ignore_qvs and cfg.min_avg_qv >= 0:
                s = qv.sum(axis=1, dtype=np.int64)
                avg = np.where(s < 0, -((-s) // L), s // L)
                if (avg < cfg.min_avg_qv).any():
                    return None   # pair drops: the generic path's
            qual_raw = np.ascontiguousarray(qarr)
            if cfg.qual_delta != 33:
                qarr = (qarr.astype(np.int32) - cfg.qual_delta + 33
                        ).astype(np.uint8)
            qual_fwd = np.ascontiguousarray(qarr)
            qual_rc = np.ascontiguousarray(qarr[:, ::-1])
        codes16 = C.CHAR_TO_INT[raw]
        if (codes16 < 0).any():
            return None
        codes = codes16.astype(np.uint8)
        rc = C.COMPLEMENT[codes[:, ::-1]]
        seq_fwd = np.ascontiguousarray(_CLEAN_LUT[raw])
        seq_rc = np.ascontiguousarray(_COMP_LUT[seq_fwd[:, ::-1]])
        offs = np.empty(B + 1, np.int64)
        offs[0] = 0
        parts = []
        for i, r in enumerate(records):
            parts.append(r.name.encode())
            offs[i + 1] = offs[i] + len(parts[-1])
        nm_blob = np.frombuffer(b"".join(parts), np.uint8).copy() \
            if parts else np.zeros(1, np.uint8)
        wlen = int(abs_or_pct(cfg.window_len, L))
        # per-leg strand flips (read_reverse, gmapper.c:175-186)
        flip1, flip2 = C.PAIR_REVERSE[cfg.pair_mode]
        input_strand = np.zeros(B, np.int8)
        input_strand[0::2] = int(flip1)
        input_strand[1::2] = int(flip2)
        codes2 = np.empty((B, 2, L), np.uint8)
        flipm = input_strand == 1
        codes2[~flipm, 0] = codes[~flipm]
        codes2[~flipm, 1] = rc[~flipm]
        codes2[flipm, 0] = rc[flipm]
        codes2[flipm, 1] = codes[flipm]
        m.tally("read prep", _time.perf_counter() - t0)
        t1 = _time.perf_counter()
        ro = m._paired_opts[0].read[0]
        fh = self._filter1_paired(codes2, L, wlen, ro)
        if fh is None:
            return None
        m.tally("filter1", _time.perf_counter() - t1)
        t2 = _time.perf_counter()
        R = _round_up(L, 8)
        Bcap = max(batch_cap or B, B)
        read_tab = np.full((Bcap, R), 254, np.uint8)
        read_tab[:B, :L] = codes        # raw forward rows for all legs
        win = None
        futures = []
        G = 16
        stats_flow = True
        if fh.n:
            rcf = (fh.owner & 1).astype(np.int8) != \
                input_strand[(fh.owner >> 1).astype(np.int64)]
            # n_reads gates the two-phase dispatch by density (vec-only
            # now; the full SW later on the rows the native select pass
            # picks: the reference's lazy full SW); the mesh tiers keep
            # the fused launch
            tp_ok = (self.fls.dispatch_fn is None
                     and self.zpair_merge_hook is None
                     and self.read_slice is None)
            futures, win, G, stats_flow = (
                self.fls.dispatch_fn or _fused_dispatch)(
                m, fh, read_tab, L, R, rcf, n_reads=B if tp_ok else None)
        m.tally("device dispatch", _time.perf_counter() - t2)
        return dict(B=B, L=L, wlen=wlen, fh=fh, win=win, futures=futures,
                    G=G, R=R, stats_flow=stats_flow, codes=codes,
                    names=nm_blob, name_off=offs, seq_fwd=seq_fwd,
                    seq_rc=seq_rc, Bcap=Bcap, read_tab=read_tab,
                    input_strand=input_strand,
                    qual_fwd=qual_fwd, qual_rc=qual_rc,
                    qual_raw=qual_raw, raw=np.ascontiguousarray(raw),
                    t_dispatch=_time.perf_counter() - t2)

    def _run_rows(self, ctx, tp, rows):
        """Select-then-full's row runner: the full SW on the window rows
        `rows` (`_tp_run_full`) and their alignment rows [k, 10] and
        packed ops [k, W]."""
        out2 = _tp_run_full(self.m, tp, ctx["win"], ctx["G"], rows,
                            ctx["stats_flow"], ctx["fh"], ctx["L"],
                            ctx["R"])
        t0 = _time.perf_counter()
        if ctx["stats_flow"]:
            out2 = self._expand(ctx, rows, out2)[:2]
        self.m.tally("alignment expand", _time.perf_counter() - t0)
        return out2

    def _expand(self, ctx, rows, stats, rank_local: bool = False):
        """Alignment rows [k, 10] and packed ops of the window rows
        `rows` from their [k, 7] full-SW stats (FastLS._stats_to_packed;
        `rank_local`: rows of this rank's pair slice): (packed, ops,
        W)."""
        jobs = dict(ri=ctx["win"]["ri"][rows],
                    w_len=np.ascontiguousarray(ctx["fh"].w_len[rows],
                                               np.int32))
        return self.fls._stats_to_packed(
            stats, _expand_ctx(ctx, rows, jobs, rank_local))

    # ---------------------------------------------------------- stage B
    def stage_finish(self, ctx) -> Tuple[bytes, np.ndarray, np.ndarray]:
        """Fetch device results, expand alignments for every window (or,
        two-phase, for the rows the select pass picks), and run the whole
        paired brain in one native call."""
        m = self.m
        cfg = m.config
        fh = ctx["fh"]
        B, L = ctx["B"], ctx["L"]
        n_pairs = B // 2
        pair_nhits = np.zeros(n_pairs, np.int32)
        read_nhits = np.zeros(B, np.int32)
        m.tally(reads=B)
        if self.read_slice is not None and self.zpair_merge_hook is not None:
            raise ValueError("read_slice and zpair_merge_hook are mutually "
                             "exclusive")
        qual_raw = ctx.get("qual_raw")

        def unaligned():
            return (_paired_unaligned_block(
                cfg, ctx, lambda ri: ctx["seq_fwd"][ri].tobytes() + b"\t"
                + (b"*" if qual_raw is None else qual_raw[ri].tobytes()),
                b"\tR2:Z:", self.read_slice), pair_nhits, read_nhits)
        if fh.n == 0:
            return unaligned()
        n = int(fh.n)
        win = ctx["win"]
        tp = win.get("two_phase")
        t0 = _time.perf_counter()
        scores, stats_all, tb_all = _fetch(ctx, n)
        dev_secs = _time.perf_counter() - t0 + ctx["t_dispatch"]
        m.tally("device fetch", _time.perf_counter() - t0,
                vec_secs=dev_secs, full_secs=dev_secs)

        owner = np.ascontiguousarray(fh.owner, np.int64)
        seg = np.ascontiguousarray(
            np.searchsorted(owner, np.arange(2 * B + 1)), np.int64)
        rsl = slice(0, n)
        sliced = False
        if self.read_slice is not None:
            # pair pi owns legs 2pi, 2pi + 1, owners 4pi..4pi + 3, whose
            # window rows are one span (owner-major)
            plo, phi = self.read_slice
            rsl = slice(int(seg[min(4 * plo, 2 * B)]),
                        int(seg[min(4 * phi, 2 * B)]))
            seg = np.ascontiguousarray(
                np.clip(seg, rsl.start, rsl.stop) - rsl.start, np.int64)
            n = rsl.stop - rsl.start
            self.last_slice_jobs += n
            sliced = self.slice_select
            if n == 0:
                if sliced and stats_all is not None:
                    # the multi-process tier's expansion is an exchange
                    # every rank joins (FastLS._no_jobs)
                    none = np.zeros(0, np.int64)
                    self._expand(ctx, none, stats_all[none], True)
                return unaligned()
        t0 = _time.perf_counter()
        W = (ctx["R"] + ctx["G"] + 3) // 4
        if stats_all is not None:
            # sliced: the expansion of this rank's pair span only
            ex = np.arange(rsl.start, rsl.stop) if sliced else np.arange(
                int(fh.n))
            packed, ops_pk, W = self._expand(ctx, ex, stats_all[ex], sliced)
            if not sliced:
                packed, ops_pk = packed[rsl], ops_pk[rsl]
        elif tb_all is not None:
            packed, ops_pk = tb_all[0][rsl], tb_all[1][rsl]
        m.tally("alignment expand", _time.perf_counter() - t0)

        # ---- one native call: pair-up .. SAM text
        t0 = _time.perf_counter()
        popts = m._paired_opts[0]
        ro = popts.read[0]
        pairing = popts.pairing
        hp = cfg.half_paired_unpaired_options(0)[0]
        re1 = SimpleNamespace(window_len=ctx["wlen"], read_len=L)
        re2 = SimpleNamespace(window_len=ctx["wlen"], read_len=L)
        m._compute_mp_ranges(re1, re2, pairing)
        cal = m.cal
        sc = cfg.scores
        arrs = dict(
            seg=seg,
            cn=np.ascontiguousarray(fh.cn[rsl], np.int32),
            g_off=np.ascontiguousarray(fh.g_off[rsl], np.int64),
            g_off_norm=np.ascontiguousarray(win["g_off_t"][rsl], np.int64),
            gen_st=np.ascontiguousarray(win["rcmask"][rsl], np.int8),
            w_len=np.ascontiguousarray(fh.w_len[rsl], np.int32),
            matches=np.ascontiguousarray(fh.matches[rsl], np.int32),
            score_max=np.ascontiguousarray(fh.score_max[rsl], np.int64),
            vec=np.ascontiguousarray(scores[rsl]))
        if tp is None:
            arrs["packed"] = np.ascontiguousarray(packed, np.int32)
            arrs["ops_pk"] = np.ascontiguousarray(ops_pk, np.uint8)
        fls = self.fls
        p = _PPParams(
            n_pairs, n, L, ctx["wlen"], W,
            (ctypes.c_int64 * 2)(int(re1.delta_g_off_min[0]),
                                 int(re1.delta_g_off_min[1])),
            (ctypes.c_int64 * 2)(int(re1.delta_g_off_max[0]),
                                 int(re1.delta_g_off_max[1])),
            ro.pass1.min_matches,
            int(abs_or_pct(ro.pass1.window_overlap, ctx["wlen"])),
            float(ro.pass1.threshold),
            pairing.pass1_num_outputs, float(pairing.pass1_threshold),
            float(ro.pass2.threshold),
            float(pairing.pass2_threshold), pairing.pass2_num_outputs,
            int(pairing.strata), cfg.max_alignments,
            int(cfg.half_paired), hp.pass1.min_matches,
            int(abs_or_pct(hp.pass1.window_overlap, ctx["wlen"])),
            float(hp.pass1.threshold), hp.pass1.num_outputs,
            float(hp.pass2.threshold), hp.pass2.num_outputs,
            int(cfg.compute_mapping_qualities), cal.alpha, cal.beta,
            sc.match, sc.mismatch,
            float(m.total_genome_size),
            float(cfg.insert_size_mean), float(cfg.insert_size_stddev),
            int(cfg.pair_mode in (C.PAIR_OPP_IN, C.PAIR_COL_FW)),
            fls.contig_lengths32.ctypes.data,
            fls.contig_name_off.ctypes.data,
            fls.contig_names_blob.ctypes.data,
            ctx["name_off"].ctypes.data, ctx["names"].ctypes.data,
            ctx["seq_fwd"].ctypes.data, ctx["seq_rc"].ctypes.data,
            ctx["qual_fwd"].ctypes.data
            if ctx.get("qual_fwd") is not None else None,
            ctx["qual_rc"].ctypes.data
            if ctx.get("qual_rc") is not None else None,
            ctx["qual_raw"].ctypes.data
            if ctx.get("qual_raw") is not None else None,
            0, sc.match - sc.mismatch,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0, 0, 0, 0, None, None, None, None, None, None, 0,
            None, None, 0)
        # the RG bytes stay alive through the native calls
        rg_bytes = _set_paired_render_flags(p, cfg, ctx["raw"], n_pairs)
        if self.read_slice is not None:
            p.una_lo, p.una_hi = self.read_slice
        wstruct = _PPWin(**{k: _vp(v) for k, v in arrs.items()})
        cap = max(1 << 20, n_pairs * 4 * (L + 320))
        ext = None        # p.ext_in points into it through the render
        if self.zpair_merge_hook is not None:
            ext = _zpair_collect(self.lib, p, wstruct, cap, n_pairs,
                                 self.zpair_merge_hook, self.zpair_win_shard,
                                 self.zpair_n_shards, pair_nhits, read_nhits)
        if tp is None:
            out, rv, cap = _paired_render(self.lib, p, wstruct, cap,
                                          pair_nhits, read_nhits)
        else:
            out, rv = _select_then_full(
                m, self.lib, p, wstruct, pairing, hp, n, n_pairs, cap,
                pair_nhits, read_nhits,
                lambda rows: self._run_rows(ctx, tp, rows),
                ("packed", "ops_pk"), "paired select (2ph)")
        del ext
        m.tally("paired select + render", _time.perf_counter() - t0,
                reads_mapped=int((pair_nhits > 0).sum()) * 2,
                alignments=2 * int(pair_nhits.sum())
                + int(read_nhits.sum()))
        return bytes(out[:rv]), pair_nhits, read_nhits

def map_paired_sam_stream(mapper, records: Sequence[SeqRecord],
                          batch_size: Optional[int] = None,
                          lanes: Optional[int] = None
                          ) -> Optional[Iterator[bytes]]:
    """Pipelined LS paired mapping straight to SAM bytes, batch by batch
    in input order; None when the config needs a feature outside the
    fast path or the first batch is one the flat encoder rejects (an odd
    record count, mixed read lengths, non-ACGTN bases, mixed qualities,
    a read under --min-avg-qv): the caller maps those with
    `mapper.map_paired`. A later rejected batch takes the slow tail
    (`paired_slow_tail`). `mapper` is a `paired.PairedMapper`;
    `records` are interleaved mate pairs (an odd batch size is rounded
    up).

    `lanes` > 1 (default 16) runs that many whole-batch pipelines on
    worker threads, output re-ordered to input order; results are
    byte-identical to lanes=1."""
    if not _paired_config_supported(mapper.config):
        return None
    batch_size = batch_size or auto_batch_size(mapper)
    batch_size += batch_size % 2
    fast = FastPaired(mapper)
    return batch_pipeline(
        fast.fls, fast.stage_prepare, fast.stage_finish, records,
        batch_size, lanes, paired_slow_tail(mapper, records, batch_size))
