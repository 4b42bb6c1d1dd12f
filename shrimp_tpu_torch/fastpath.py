"""Flat-array fast path for letter-space unpaired mapping to SAM, on
torch devices.

Port of the two fused flows of `shrimp_tpu/fastpath.py`, on packed IO:

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
  ops go to finalize_render as they are.

`_stats_flow_enabled` picks the flow from G alone, the same on every
device. The host stages run through the port's own native library
(`native/`, a copy of the reference's C++), so the SAM bytes are the
reference's. Not ported here: two-phase dispatch, the unpacked-IO and
byte-gather flows, read sharding and the sharded-index MQV hooks. A
batch the flat encoder rejects raises NotImplementedError: there is no
generic mapper behind this path.
"""
from __future__ import annotations

import ctypes
import time as _time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from . import constants as C
from .config import MapperConfig, abs_or_pct
from .io.fasta import SeqRecord
from .native import get_lib
from .native.filter1_py import generate_candidates_native
from .core._args import MAX_G
from .core.sw import sw_vec_full_stats_packed, sw_vec_full_tb_packed
from .mapper import FULL_BATCH, FULL_BUCKETS, _round_up

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
    """Launch rows for a chunk of k windows: the FULL_BUCKETS row counts,
    or under the traceback flow's long-read shrink the next power of two
    >= k (at least 8), as the reference pads them."""
    if eff_batch >= FULL_BUCKETS[0]:
        return FULL_BUCKETS[int(np.searchsorted(FULL_BUCKETS, k))]
    return 1 << int(np.ceil(np.log2(max(k, 8))))


def _fused_dispatch(m, fh, read_tab: np.ndarray, L: int, R: int,
                    rcf: np.ndarray):
    """Fused filter 2 + speculative filter 3 over every candidate window,
    in chunks on m.device. `rcf` marks windows needing the reverse_hit
    normalization (strand 1 for unpaired reads). Returns (futures, win,
    G, stats_flow): futures are (off, k, result) with result the
    [bucket, 3] int32 stats rows (stats flow) or (vec, packed, ops)
    (traceback flow) on the device; `win` is the normalized window
    geometry that the host reconstruction stage reuses. The traceback
    flow's chunks hold at most 2^28 backpointer cells (bucket * R * G),
    as the reference's do."""
    cfg = m.config
    idx = m.index
    sc = cfg.scores
    n = fh.n
    win, G = _normalize_win(m, fh, L, rcf)
    packed_io = (G <= 4095 and R <= 4095
                 and int(fh.w_len.max()) < (1 << 14)
                 and read_tab.shape[0] <= (1 << 16)
                 and idx.total_len < (1 << 31))
    if not packed_io:
        raise NotImplementedError(
            f"window or read shape outside the packed-IO flow (G={G}, "
            f"R={R}, read table rows={read_tab.shape[0]}); the unpacked "
            "flow is not ported")
    cat_dev = m._dev_cat_words()
    if cat_dev is None:
        raise NotImplementedError(
            "genome planes over ~1 Gbp: the word-plane gather overflows "
            "int32 and the byte-gather flow is not ported")
    kw = dict(G=G, L=L, match=sc.match, mismatch=sc.mismatch,
              a_gap_open=sc.a_gap_open, a_gap_ext=sc.a_gap_extend,
              b_gap_open=sc.b_gap_open, b_gap_ext=sc.b_gap_extend,
              local_alignment=False)
    stats_flow = _stats_flow_enabled(G)
    if stats_flow:
        fn, eff_batch = sw_vec_full_stats_packed, FULL_BATCH
    else:
        fn = sw_vec_full_tb_packed
        eff_batch = max(8, min(FULL_BATCH, (1 << 28) // max(R * G, 1)))
    dev = m.device
    rtab_dev = torch.from_numpy(_pack_rtab(read_tab)).to(dev)
    futures = []
    off = 0
    while off < n:
        k = min(n - off, eff_batch)
        bucket = _chunk_bucket(k, eff_batch)
        sl = slice(off, off + k)
        args = _pack_args4(
            bucket, k, win["starts"][sl], win["glen"][sl], win["ri"][sl],
            win["rcmask"][sl], win["rx"][sl], win["ry"][sl],
            win["rl_"][sl], win["rw_"][sl], win["rev"][sl])
        res = fn(m._dev_codes(), m._dev_codes_rc(),
                 torch.from_numpy(args).to(dev), rtab_dev, cat_dev, **kw)
        futures.append((off, k, res))
        off += k
    cells = int(fh.w_len.astype(np.int64).sum()) * L
    m.tally(vec_invocs=n, vec_cells=cells, full_invocs=n, full_cells=cells)
    return futures, win, G, stats_flow


class FastLS:
    """Per-Mapper fast-path state (contig name blobs, native library)."""

    def __init__(self, mapper) -> None:
        self.lib = get_lib()
        self.m = mapper
        # filter1 internal fan-out; multi-lane streams set 1 (the lanes
        # already keep every core busy, inner threads just contend)
        self.f1_threads: Optional[int] = None
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
                 min_kmer_pos: int = 0):
        """Candidate window generation over the mapper's index (colour
        space starts its k-mers at colour 1: min_kmer_pos=1)."""
        m = self.m
        cfg = m.config
        opts = m._unpaired_opts[0]
        return generate_candidates_native(
            m.index, codes2, L, wlen, m.cutoff, opts.hit_list.match_mode,
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
            futures, win, G, stats_flow = _fused_dispatch(
                m, fh, read_tab, L, R, (fh.owner & 1) == 1)
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
        for r in range(ctx["B"]):
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
        m = self.m
        sc = m.config.scores
        n_jobs = ctx2["n_jobs"]
        jobs = ctx2["jobs"]
        R, G = ctx2["R"], ctx2["G"]
        L = ctx2["L"]
        W = (R + G + 3) // 4
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
        m.tally(full_host_tb=int(need.size))
        if need.size:
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
        return packed, ops_pk, W

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
        if fh.n == 0:
            m.tally(reads=B)
            return self._unaligned_block(ctx, nhits), nhits
        n = int(fh.n)
        t0 = _time.perf_counter()
        scores = np.empty(n, np.int64)
        stats_flow = ctx["stats_flow"]
        if stats_flow:
            stats_all = np.empty((n, 7), np.int32)
            for off, k, res in ctx["futures"]:
                v, st = _unpack_stats3(res[:k].cpu().numpy())
                scores[off:off + k] = v
                stats_all[off:off + k] = st
        else:
            W_all = (ctx["R"] + ctx["G"] + 3) // 4
            packed_all = np.empty((n, 10), np.int32)
            ops_all = np.empty((n, W_all), np.uint8)
            for off, k, (vec, pk, opk) in ctx["futures"]:
                scores[off:off + k] = vec[:k].cpu().numpy()
                packed_all[off:off + k] = pk[:k].cpu().numpy()
                ops_all[off:off + k] = opk[:k].cpu().numpy()
        dev_secs = _time.perf_counter() - t0 + ctx["t_dispatch"]
        m.tally("device fetch", _time.perf_counter() - t0,
                vec_secs=dev_secs, full_secs=dev_secs)

        # ---- native pass1 selection over vector scores
        t0 = _time.perf_counter()
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
        arrs = dict(owner=np.ascontiguousarray(fh.owner, np.int64),
                    cn=np.ascontiguousarray(fh.cn, np.int32),
                    g_off=np.ascontiguousarray(fh.g_off, np.int64),
                    w_len=np.ascontiguousarray(fh.w_len, np.int32),
                    matches=np.ascontiguousarray(fh.matches, np.int32),
                    score_max=np.ascontiguousarray(fh.score_max, np.int64),
                    ax=np.ascontiguousarray(fh.ax, np.int64),
                    ay=np.ascontiguousarray(fh.ay, np.int64),
                    alen=np.ascontiguousarray(fh.alen, np.int64),
                    awid=np.ascontiguousarray(fh.awid, np.int64),
                    scores=scores,
                    swg=np.ascontiguousarray(fh.score_window_gen,
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
            m.tally(reads=B)
            return self._unaligned_block(ctx, nhits), nhits
        jobs = {k: np.ascontiguousarray(sel[k][:n_sel][jsel]) for k in
                ("ri", "gen_st", "cn", "g_off", "w_len", "score_max",
                 "ax", "ay", "alen", "awid", "matches", "swg",
                 "score_vector")}
        rows = sel["src"][:n_sel][jsel]
        t0 = _time.perf_counter()
        if stats_flow:
            win = ctx["win"]
            ctx2 = dict(n_jobs=n_jobs, jobs=jobs, R=ctx["R"], G=ctx["G"],
                        L=L, read_tab=ctx["read_tab"],
                        starts=win["starts"][rows],
                        rcmask=win["rcmask"][rows],
                        rx=win["rx"][rows], ry=win["ry"][rows],
                        rl_=win["rl_"][rows], rw_=win["rw_"][rows],
                        rev=win["rev"][rows])
            packed, ops_pk, W = self._stats_to_packed(stats_all[rows],
                                                      ctx2)
        else:
            W = ops_all.shape[1]
            packed = np.ascontiguousarray(packed_all[rows])
            ops_pk = np.ascontiguousarray(ops_all[rows])
        m.tally("alignment expand", _time.perf_counter() - t0)
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
            fr.genome = idx0.codes.ctypes.data
            fr.genome_rc = idx0.codes_rc.ctypes.data
            fr.contig_offsets = self.contig_offsets32.ctypes.data
        if cfg.sam_unaligned:
            if ctx.get("qual_raw") is not None:
                fr.qual_raw = ctx["qual_raw"].ctypes.data
            fr.una_lo = 0
            fr.una_hi = B
        frj = _FRJobs(_vp(jobs["ri"]), _vp(jobs["cn"]),
                      _vp(jobs["gen_st"]), _vp(jobs["g_off"]),
                      _vp(jobs["score_max"]), _vp(packed), _vp(ops_pk),
                      _vp(jobs["matches"]), _vp(jobs["swg"]),
                      _vp(jobs["score_vector"]))
        cap = n_jobs * (2 * L + 224) + 4096
        while True:
            buf = np.empty(cap, np.uint8)
            nb = self.lib.finalize_render(ctypes.byref(fr),
                                          ctypes.byref(frj),
                                          _vp(buf), cap, _vp(nhits))
            if nb >= 0:
                break
            if nb == -2:
                raise RuntimeError("fastpath finalize unsupported config")
            cap *= 4
        m.tally("finalize + render", _time.perf_counter() - t1, reads=B,
                reads_mapped=int((nhits > 0).sum()),
                alignments=int(nhits.sum()))
        return buf[:nb].tobytes(), nhits


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
    the fast path. A batch the flat encoder rejects (mixed read lengths,
    non-ACGTN bases, mixed qualities) raises NotImplementedError.

    `lanes` > 1 (default 16) runs that many whole-batch pipelines on
    worker threads, output re-ordered to input order; results are
    byte-identical to lanes=1."""
    if not _config_supported(mapper.config):
        return None
    fast = FastLS(mapper)
    return batch_pipeline(
        fast, fast.stage_prepare, fast.stage_finish, records,
        batch_size or auto_batch_size(mapper), lanes,
        "mixed read lengths, non-ACGTN bases or mixed qualities")


def batch_pipeline(fls: FastLS, stage_prepare, stage_finish,
                   records: Sequence[SeqRecord], batch_size: int,
                   lanes: Optional[int], rejected: str) -> Iterator[bytes]:
    """SAM bytes batch by batch in input order, from `stage_prepare`
    (records, batch_cap) -> context and `stage_finish` (context) ->
    (bytes, hits). The first batch is prepared before this returns. A
    batch that stage_prepare rejects (None, for the reasons `rejected`
    names) or cannot take (NotImplementedError) raises
    NotImplementedError naming its reads. `lanes` > 1 (default 16) runs
    that many whole-batch pipelines on worker threads, output re-ordered
    to input order; results are byte-identical to lanes=1."""
    def prepare(off: int):
        what = f"reads {off}..{min(off + batch_size, len(records)) - 1}"
        try:
            a = stage_prepare(records[off:off + batch_size],
                              batch_cap=batch_size)
        except NotImplementedError as e:
            raise NotImplementedError(f"{what}: {e}") from e
        if a is None:
            raise NotImplementedError(
                f"{what}: batch rejected by the flat encoder ({rejected}); "
                "shrimp_tpu_torch has no generic mapper for it")
        return a

    if not len(records):
        return iter(())
    # probe the first batch before committing
    first = prepare(0)
    if lanes is None:
        lanes = 16
    if lanes > 1 and len(records) > batch_size:
        # lanes keep every host core busy; filter1's inner fan-out would
        # only contend with them
        fls.f1_threads = 1

        def work(off: int, pre) -> bytes:
            a = pre if pre is not None else prepare(off)
            return stage_finish(a)[0]

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
        pend = first
        off = batch_size
        while pend is not None:
            nxt = prepare(off) if off < len(records) else None
            off += batch_size
            yield stage_finish(pend)[0]
            pend = nxt
    return gen()
