"""Flat-array fast path for colour-space mapping to SAM, unpaired and
paired, on torch devices.

Port of the flows of `shrimp_tpu/fastpath_cs.py`:

    read prep + filter 1 (native)  ->  one fused device step per chunk
    (CS vector SW + 4-layer full SW + traceback, core/sw_cs.py)  ->
    pass1_select (native)  ->  cs_finalize_render (native: post-SW
    forward-backward, threshold, dedup, sort, MQV, SAM text)

and, at CS_TWO_PHASE_WPR or more candidate windows per read, the
two-phase dispatch: the vector SW alone on every window, then the
4-layer DP and the traceback on the pass-1 survivors only. The paired
stream (`FastPairedCS`, `map_paired_cs_sam_stream`) shares the encoding
and the dispatch and ends in one native `paired_finalize_render` call in
CS mode; its two-phase batches run select-then-full
(`fastpath._select_then_full`). Without the mapper's word planes (planes
over ~1 Gbp) the device step gathers its windows byte by byte.

The host stages run through the port's native library (`native/`, a
copy of the reference's C++), so the SAM bytes are the reference's. It builds on the port's
`fastpath.FastLS` (contig blobs, native library, filter 1 fan-out) and
counts every statistic through `Mapper.tally`, which the lane threads
share. As in the LS streams, a stream whose first batch the flat
encoder rejects returns None (the caller runs the generic mapper), and
a later rejected batch takes the generic mapper's slow tail
(`fastpath.unpaired_slow_tail`, `fastpath.paired_slow_tail`). The mesh
tiers (`parallel/meshmap.py`) override filter 1 (`FastCS._filter1_cs`,
`FastPairedCS._filter1_cs_paired`) and the device dispatch
(`FastCS._fused_dispatch_cs`), and set the paired Z hooks that
`FastPairedCS` shares with `fastpath.FastPaired`.
"""
from __future__ import annotations

import ctypes
import math
from types import SimpleNamespace
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from . import constants as C
from .config import MapperConfig, abs_or_pct
from .core.sw_cs import cs_wide_rows, sw_vec_cs_full_from_index
from .core.sw_cs_batch import cs_layers_batch
from .fastpath import (FastLS, _P1In, _P1Out, _P1Params, _PPParams, _PPWin,
                       _check_index_len, _filter1_paired,
                       _paired_render, _paired_unaligned_block,
                       _select_then_full, _set_paired_render_flags, _vp,
                       _zpair_collect, auto_batch_size, batch_pipeline,
                       paired_slow_tail, unpaired_slow_tail)
from .io.fasta import SeqRecord
from .mapper import _round_up

# launch row buckets: the chunk adapts to the window count, bucketed so
# that few kernel shapes occur (fastpath_cs.py:32-65)
CS_CHUNK_BUCKETS = (2048, 8192, 32768, 131072, 262144, 393216, 524288,
                    786432, 1048576, 1572864, 2097152)
# windows per read at or above which a batch takes the two-phase
# dispatch (the CS vector SW on every window, then the 4-layer DP and
# the traceback on the pass-1 survivors only)
CS_TWO_PHASE_WPR = 8


def _cs_chunk(n: int) -> int:
    """The chunk bucket minimizing launches * 1024 + pad rows."""
    best, best_cost = CS_CHUNK_BUCKETS[0], None
    for b in CS_CHUNK_BUCKETS:
        launches = -(-n // b) if n else 1
        cost = launches * 1024 + (launches * b - n)
        if best_cost is None or cost < best_cost:
            best, best_cost = b, cost
    return best


def fastpath_cs_supported(cfg: MapperConfig) -> bool:
    """Gate: the native CS renderer covers the default CS unpaired SAM
    flow (single option set, global alignment, MQV on) plus the
    renderer-level flags (--all-contigs, --sam-unaligned, --read-group,
    --sam-r2)."""
    return (cfg.mode == C.MODE_COLOUR_SPACE
            and cfg.pair_mode == C.PAIR_NONE
            and len(cfg.unpaired_options()) == 1
            and not cfg.gapless
            and cfg.global_alignment
            and cfg.compute_mapping_qualities
            and not cfg.extra_sam_fields
            and not cfg.shrimp_format
            and not cfg.bfast
            and cfg.search_forward and cfg.search_reverse)


def _config_supported(cfg: MapperConfig) -> bool:
    """`fastpath_cs_supported` plus the config-level refusals of the
    reference's stage_prepare (raw-string trims, custom option sets),
    which the reference also answers with None. FastCS assumes a config
    that passed this gate."""
    return (fastpath_cs_supported(cfg)
            and not (cfg.trim_front or cfg.trim_end)
            and not (cfg.custom_unpaired_options
                     or cfg.custom_paired_options))


class _CSFRParams(ctypes.Structure):
    _fields_ = [("n_jobs", ctypes.c_int64), ("n_reads", ctypes.c_int64),
                ("read_len", ctypes.c_int32),
                ("steps_words", ctypes.c_int32),
                ("read_seq_len", ctypes.c_int32),
                ("sw_full_threshold", ctypes.c_double),
                ("num_outputs", ctypes.c_int32),
                ("strata", ctypes.c_int32),
                ("max_alignments", ctypes.c_int32),
                ("single_best", ctypes.c_int32),
                ("compute_mqv", ctypes.c_int32),
                ("alpha", ctypes.c_double), ("beta", ctypes.c_double),
                ("pr_xover", ctypes.c_double), ("pr_snp", ctypes.c_double),
                ("pr_del_open", ctypes.c_double),
                ("pr_del_extend", ctypes.c_double),
                ("pr_ins_open", ctypes.c_double),
                ("pr_ins_extend", ctypes.c_double),
                ("genome_len", ctypes.c_int64),
                ("genome_fwd", ctypes.c_void_p),
                ("genome_rc", ctypes.c_void_p),
                ("contig_lengths", ctypes.c_void_p),
                ("contig_name_off", ctypes.c_void_p),
                ("contig_names", ctypes.c_void_p),
                ("name_off", ctypes.c_void_p), ("names", ctypes.c_void_p),
                ("colours", ctypes.c_void_p), ("qr_tab", ctypes.c_void_p),
                ("initbp", ctypes.c_void_p), ("readseq", ctypes.c_void_p),
                ("fastq", ctypes.c_int32), ("use_read_qvs", ctypes.c_int32),
                ("qual_delta", ctypes.c_int32),
                ("use_sanger_qvs", ctypes.c_int32),
                ("quals", ctypes.c_void_p), ("cq", ctypes.c_void_p),
                ("cq_len", ctypes.c_int32),
                # renderer-level flags (cspipe.cpp tail)
                ("rg", ctypes.c_void_p), ("rg_len", ctypes.c_int32),
                ("all_contigs", ctypes.c_int32),
                ("sam_unaligned", ctypes.c_int32)]


class _CSFRJobs(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in
                ("ri", "cn", "gen_st", "g_off", "start_abs", "score_max",
                 "packed", "steps_rev")]


def _pr_err_from_qv_py(qv: int) -> float:
    """util.h:284-293 (scalar libm math, exact vs the reference)."""
    if qv <= 0:
        return .99999999
    if qv >= 250:
        return 1e-25
    return math.pow(10.0, -qv / 10.0)


def _revcomp_cs_batch(codes: np.ndarray, initbp: np.ndarray) -> np.ndarray:
    """Vectorized encode.revcomp_cs (util.c:580-616) over [B, R] rows."""
    B, R = codes.shape
    cur = initbp.astype(np.int64).copy()
    for jc in range(R):
        c = codes[:, jc].astype(np.int64)
        even = cur % 2 == 0
        nxt = np.where(even, (4 + cur + c) % 4, (4 + cur - c) % 4)
        cur = np.where((cur != C.BASE_N) & (c <= 3), nxt, C.BASE_N)
    out = np.empty_like(codes)
    out[:, 1:] = codes[:, :0:-1]
    comp_init = C.COMPLEMENT[initbp]
    first = np.where(cur <= 3,
                     C.COLOUR_MAT[np.clip(cur, 0, 15), comp_init],
                     C.BASE_N)
    out[:, 0] = first
    return out


class FastCS:
    """Per-Mapper colour-space fast-path state."""

    def __init__(self, mapper) -> None:
        self.fls = FastLS(mapper)
        self.lib = self.fls.lib
        self.m = mapper

    def _filter1_cs(self, codes2, R: int, wlen: int):
        """Candidate window generation, k-mers from colour 1; the
        sharded-index tier overrides it."""
        return self.fls._filter1(codes2, R, wlen, min_kmer_pos=1)

    def _encode(self, records: Sequence[SeqRecord], drop_low_qv: bool):
        """The flat CS encoding of a batch: read text, qualities, primer
        bases, colour rows of both strands, the crossover penalties from
        qualities, the name blob. None when the flat encoder rejects the
        batch (mixed lengths, bad colours or primers, mixed qualities).
        Reads under --min-avg-qv are dropped (`drop_low_qv`; dict(B=0)
        when none is left) or, for pairs, reject the batch."""
        m = self.m
        cfg = m.config
        if not records:
            return None
        has_qual = any(r.qual is not None for r in records)
        Lseq = len(records[0].seq)
        R = Lseq - 1
        if R <= 0 or R > cfg.longest_read_len:
            return None
        try:
            buf = "".join(r.seq for r in records).encode("ascii")
        except UnicodeEncodeError:
            return None
        B = len(records)
        if len(buf) != B * Lseq:
            return None
        raw = np.frombuffer(buf, np.uint8).reshape(B, Lseq)
        quals = cq = None
        if has_qual:
            try:
                qbuf = "".join(r.qual for r in records).encode("ascii")
            except (UnicodeEncodeError, TypeError):
                return None
            # SOLiD fastq carries one qv per colour (R) or one per seq
            # char incl. the primer (R+1); scoring reads the first R
            if len(qbuf) == B * R:
                Lq = R
            elif len(qbuf) == B * Lseq:
                Lq = Lseq
            else:
                return None
            cq = np.frombuffer(qbuf, np.uint8).reshape(B, Lq)
            qv_full = cq.astype(np.int32) - cfg.qual_delta
            if not cfg.ignore_qvs and not cfg.no_qv_check:
                bad = (qv_full < -10) | (qv_full > 50)
                if bad.any():
                    q0 = int(qv_full[bad][0])
                    raise ValueError(
                        "The qv-offset might be set incorrectly! "
                        "Currently qvs are interpreted as PHRED+"
                        f"{cfg.qual_delta} and a qv of {q0} was "
                        "observed.")
            if not cfg.ignore_qvs and cfg.min_avg_qv >= 0:
                # avg-qv read drop (gmapper.c:455-462; C int division;
                # the sum spans the whole qual string, the divisor is
                # the colour count)
                s = qv_full.sum(axis=1, dtype=np.int64)
                avg = np.where(s < 0, -((-s) // R), s // R)
                keep = avg >= cfg.min_avg_qv
                if not keep.all():
                    if not drop_low_qv:
                        return None
                    records = [r for r, k in zip(records, keep) if k]
                    if not records:
                        return dict(B=0)
                    raw = np.ascontiguousarray(raw[keep])
                    cq = np.ascontiguousarray(cq[keep])
                    B = len(records)
            cq = np.ascontiguousarray(cq)
            quals = np.ascontiguousarray(cq[:, :R])
        init16 = C.CHAR_TO_INT[raw[:, 0]]
        if ((init16 < 0) | (init16 > 3)).any():
            return None
        codes16 = C.CHAR_TO_INT[raw[:, 1:]]
        if (codes16 < 0).any():
            return None
        initbp = init16.astype(np.int64)
        codes0 = codes16.astype(np.uint8)
        # per-position crossover scores from qvs (gmapper.c:532-543); a
        # 256-entry LUT over raw qual chars built with libm math so the
        # DP integers match the reference exactly
        xover_tab = None
        if quals is not None and not cfg.ignore_qvs:
            lut = np.empty(256, np.int32)
            for ch in range(256):
                pe = _pr_err_from_qv_py(ch - cfg.qual_delta)
                v = int(m.cal.alpha * math.log2(pe / 3.0))
                lut[ch] = max(min(v, -1), 2 * cfg.scores.crossover)
            xover_tab = lut[quals]
        nm_parts = [r.name.encode() for r in records]
        offs = np.zeros(B + 1, np.int64)
        np.cumsum([len(x) for x in nm_parts], out=offs[1:])
        nm_blob = (np.frombuffer(b"".join(nm_parts), np.uint8).copy()
                   if nm_parts else np.zeros(1, np.uint8))
        return dict(B=B, R=R, wlen=int(abs_or_pct(cfg.window_len, R)),
                    raw=raw, quals=quals, cq=cq, initbp=initbp,
                    codes0=codes0, codes1=_revcomp_cs_batch(codes0, initbp),
                    xover_tab=xover_tab, names=nm_blob, name_off=offs)

    def _dispatch(self, enc, fh, batch_cap, **kw):
        """The device dispatch of an encoded batch's windows (`fh`) and
        the stage-B context: the encoding, the windows, the futures."""
        m = self.m
        B, R = enc["B"], enc["R"]
        Bcap = max(batch_cap or B, B)
        with m.span("device dispatch"):
            qr_tab = cs_layers_batch(enc["codes0"], enc["initbp"])
            win = None
            futures = []
            G = 32
            if fh.n:
                futures, win, G = self._fused_dispatch_cs(
                    fh, enc["codes0"], qr_tab, enc["initbp"], R, Bcap,
                    enc["xover_tab"], n_reads=B, **kw)
        ctx = dict(enc, fh=fh, win=win, futures=futures, G=G,
                   qr_tab=qr_tab, initbp=enc["initbp"].astype(np.int32),
                   Bcap=Bcap)
        del ctx["codes1"], ctx["xover_tab"]
        return ctx

    # ---------------------------------------------------------- stage A
    def stage_prepare(self, records: Sequence[SeqRecord],
                      batch_cap: Optional[int] = None):
        """Encode the CS batch + filter 1 + fused device dispatch.
        Returns None when the flat encoder rejects the batch (the config
        was screened by map_unpaired_cs_sam_stream)."""
        m = self.m
        with m.span("read prep"):
            enc = self._encode(records, drop_low_qv=True)
            if enc is None or enc["B"] == 0:
                return enc
            B, R = enc["B"], enc["R"]

        with m.span("filter1"):
            codes2 = np.empty((B, 2, R), np.uint8)
            codes2[:, 0] = enc["codes0"]
            codes2[:, 1] = enc["codes1"]
            fh = self._filter1_cs(codes2, R, enc["wlen"])
            if fh is None:
                return None
        return self._dispatch(enc, fh, batch_cap)

    def _cs_args(self, fh, R, rcf, thresh_override, initbp):
        """Normalized CS window geometry (reverse_hit, mapping.c:254-263)
        and the launch arguments. `rcf` marks the windows to normalize
        (None: the strand-1 windows, as for unpaired reads);
        `thresh_override` replaces the per-window full-SW threshold
        (None: from --sw-full-threshold). Returns (args_all [n, 12]
        int32, win dict, G)."""
        m = self.m
        cfg = m.config
        idx = m.index
        _check_index_len(idx)
        aw = cfg.anchor_width
        n = fh.n
        coff = idx.contig_offsets[fh.cn].astype(np.int64)
        clen = idx.contig_lengths[fh.cn].astype(np.int64)
        wl64 = fh.w_len.astype(np.int64)
        if rcf is None:
            rcf = (fh.owner & 1) == 1    # unpaired CS: input strand 0
        g_off_t = np.where(rcf, clen - fh.g_off - wl64, fh.g_off)
        ax_t = np.where(rcf, -fh.ax + (wl64 - 1) - (fh.alen - 1)
                        - (fh.awid - 1), fh.ax)
        ay_t = np.where(rcf, -fh.ay + (R - 1) - (fh.alen - 1)
                        + (fh.awid - 1), fh.ay)
        thr = cfg.sw_full_threshold
        smax = fh.score_max.astype(np.int64)
        if thresh_override is not None:
            thresh = np.full(n, thresh_override, np.int64)
        elif thr < 0:
            thresh = np.full(n, int(-thr), np.int64)
        else:
            thresh = (smax.astype(np.float64) * (thr / 100.0)
                      ).astype(np.int64)
        win = dict(starts=coff + g_off_t, g_off_t=g_off_t, rcmask=rcf)
        G = _round_up(max(int(fh.w_len.max()), 16), 32)
        owner_ri = (fh.owner >> 1).astype(np.int64)
        args_all = np.zeros((n, 12), np.int32)
        args_all[:, 0] = win["starts"]
        args_all[:, 1] = fh.w_len
        args_all[:, 2] = owner_ri.astype(np.int32)
        args_all[:, 3] = rcf
        args_all[:, 4] = R
        args_all[:, 5] = ax_t - aw // 2
        args_all[:, 6] = ay_t + aw // 2
        args_all[:, 7] = fh.alen
        args_all[:, 8] = np.asarray(fh.awid) + aw
        args_all[:, 9] = rcf & cfg.rev_tiebreak
        args_all[:, 10] = thresh
        args_all[:, 11] = initbp[owner_ri]
        return args_all, win, G

    def _fused_dispatch_cs(self, fh, codes0, qr_tab, initbp, R, Bcap,
                           xover_tab=None, rcf=None, thresh_override=None,
                           n_reads=None):
        """Launch the fused CS vector + full chunks against the device
        planes (`_cs_args` reads `rcf` and `thresh_override`: paired
        legs may be pre-flipped, and the paired flow passes 1 so that
        the raw DP score comes back and the native code applies each
        context's threshold). Returns (futures, win, G): futures are
        (off, k, (vec, packed, steps_rev) tensors on the device). At
        CS_TWO_PHASE_WPR or more windows per read of the `n_reads` reads
        (None: never)
        the chunks run the vector SW alone (futures hold (vec,)) and
        `win["two_phase"]` keeps what `_cs_run_full_rows` needs to align
        the pass-1 survivors later. A row's results do not depend on the
        chunk it is in, so both ways give the same bytes."""
        m = self.m
        cfg = m.config
        sc = cfg.scores
        n = fh.n
        args_all, win, G = self._cs_args(fh, R, rcf, thresh_override,
                                         initbp)
        CB = _cs_chunk(int(n))
        kw = dict(G=G, xover=sc.crossover, match=sc.match,
                  mismatch=sc.mismatch, a_gap_open=sc.a_gap_open,
                  a_gap_ext=sc.a_gap_extend, b_gap_open=sc.b_gap_open,
                  b_gap_ext=sc.b_gap_extend,
                  local_alignment=not cfg.global_alignment,
                  indel_taboo_len=cfg.indel_taboo_len)
        rows = _round_up(max(Bcap, 1), 1024)
        rtab_pad = np.full((rows, R), C.BASE_N, np.uint8)
        rtab_pad[:codes0.shape[0]] = codes0
        qr_pad = np.full((rows, 4, R), C.BASE_N, np.uint8)
        qr_pad[:qr_tab.shape[0]] = qr_tab
        xov_pad = np.full((rows, R), sc.crossover, np.int32)
        if xover_tab is not None:
            xov_pad[:xover_tab.shape[0]] = xover_tab
        rtab_dev, qr_dev, xov_dev = (m._upload(a)
                                     for a in (rtab_pad, qr_pad, xov_pad))
        two_phase = (n_reads is not None
                     and n >= CS_TWO_PHASE_WPR * max(n_reads, 1))
        futures = self._cs_chunks(args_all, CB, rtab_dev, qr_dev, xov_dev,
                                  dict(kw, phase="vec") if two_phase
                                  else kw)
        if two_phase:
            win["two_phase"] = dict(args_all=args_all, kw=kw,
                                    rtab_dev=rtab_dev, qr_dev=qr_dev,
                                    xov_dev=xov_dev)
        cells = int(fh.w_len.astype(np.int64).sum()) * R
        m.tally(vec_invocs=n, vec_cells=cells)
        if not two_phase:
            m.tally(full_invocs=n, full_cells=cells * 4)
        return futures, win, G

    def _cs_chunks(self, args, CB, rtab_dev, qr_dev, xov_dev, kw):
        """sw_vec_cs_full_from_index over the rows of `args` in chunks of
        CB rows, the last padded with 1-cell windows: [(off, k,
        result)]. A chunk that runs the 4-layer DP on windows wider than
        MAX_G holds at most `cs_wide_rows` rows, so that its backpointers
        stay within 2^28 cells. Without the mapper's word planes (planes
        over ~1 Gbp) the step gathers its windows byte by byte."""
        m = self.m
        cap = cs_wide_rows(rtab_dev.shape[1], kw["G"])
        if cap is not None and kw.get("phase", "fused") != "vec":
            CB = min(CB, cap)
        planes = m._dev_cs_planes()
        cats = m._dev_cs_cat_words() or (None, None)
        n = len(args)
        futures = []
        for off in range(0, n, CB):
            k = min(off + CB, n) - off
            chunk = np.zeros((CB, 12), np.int32)
            chunk[:k] = args[off:off + k]
            chunk[k:, [1, 4, 7, 8]] = 1   # pad rows: 1-cell windows
            chunk[k:, 10] = 1             # threshold 1 zeroes pad scores
            res = sw_vec_cs_full_from_index(
                *planes, m._upload(chunk), rtab_dev, qr_dev,
                xov_dev, *cats, **kw)
            futures.append((off, k, res))
        return futures

    def _cs_run_full_rows(self, tp, rows, fh, R, G):
        """Two-phase phase B: the 4-layer DP and the traceback for the
        window rows `rows` only, in chunks of `_cs_chunk(len(rows))`
        rows, fetched: (packed [k, 12] int16, steps_rev [k, R + G]
        int8). No rows: no launch. Shared by the unpaired pass-1
        survivor flow and the paired select-then-full flow, whose render
        takes the steps' width as its ops_words."""
        m = self.m
        n_sel = len(rows)
        with m.span("device full (2ph)"):
            futures = self._cs_chunks(
                tp["args_all"][rows], _cs_chunk(n_sel), tp["rtab_dev"],
                tp["qr_dev"], tp["xov_dev"], dict(tp["kw"], phase="full"))
            packed = np.empty((n_sel, 12), np.int16)
            steps = np.empty((n_sel, R + G), np.int8)
            for off, k, (pk, st) in futures:
                packed[off:off + k] = pk[:k].cpu().numpy()
                steps[off:off + k] = st[:k].cpu().numpy()
        m.tally(full_invocs=n_sel,
                full_cells=int(fh.w_len[rows].astype(np.int64).sum()) * R * 4)
        return packed, steps

    def _unaligned_block_cs(self, ctx, nhits) -> bytes:
        """--sam-unaligned CS records for reads with no alignments, for
        the early-return paths (same bytes cspipe emits)."""
        cfg = self.m.config
        if not cfg.sam_unaligned:
            return b""
        rg = (f"\tRG:Z:{cfg.read_group_name}".encode()
              if cfg.read_group_name else b"")
        name_off = ctx["name_off"]
        names = ctx["names"].tobytes()
        raw = ctx["raw"]
        cq = ctx.get("cq")
        fastq = ctx.get("quals") is not None
        parts = []
        for r in range(ctx["B"]):
            if nhits[r]:
                continue
            cqs = (cq[r].tobytes() if fastq and cq is not None
                   else b"*")
            parts.append(names[name_off[r]:name_off[r + 1]]
                         + b"\t4\t*\t0\t0\t*\t*\t0\t0\t*\t*\tCQ:Z:"
                         + cqs + b"\tCS:Z:" + raw[r].tobytes() + rg
                         + b"\n")
        return b"".join(parts)

    def _cs_genome_view(self, rows, ctx):
        """Letter planes the native post-SW eval reads, with each job's
        absolute window start: (genome_fwd, genome_rc, start_abs[rows],
        genome_len)."""
        idx = self.m.index
        return (idx.codes, idx.codes_rc,
                np.ascontiguousarray(ctx["win"]["starts"][rows]),
                int(idx.total_len))

    def _fetch(self, ctx, n: int):
        """The dispatch's device results on the host, the device tensors
        freed, and the device stages tallied: (vector scores int64 [n],
        packed [n, 12] int16, steps_rev [n, R + G] int8), the last two
        None after a two-phase dispatch."""
        scores = np.empty(n, np.int64)
        packed = steps = None
        with self.m.span("device fetch"):
            if ctx["win"].get("two_phase") is not None:
                for off, k, (vec,) in ctx["futures"]:
                    scores[off:off + k] = vec[:k].cpu().numpy()
            else:
                packed = np.empty((n, 12), np.int16)
                steps = np.empty((n, ctx["R"] + ctx["G"]), np.int8)
                for off, k, (vec, pk, st) in ctx["futures"]:
                    scores[off:off + k] = vec[:k].cpu().numpy()
                    packed[off:off + k] = pk[:k].cpu().numpy()
                    steps[off:off + k] = st[:k].cpu().numpy()
        ctx["futures"] = None
        return scores, packed, steps

    # ---------------------------------------------------------- stage B
    def stage_finish(self, ctx) -> Tuple[bytes, np.ndarray]:
        """Fetch the fused device results, native pass1 selection, then
        one native call for post-SW + finalize + SAM text."""
        m = self.m
        cfg = m.config
        fls = self.fls
        B = ctx["B"]
        if B == 0:     # whole batch dropped by the avg-qv gate
            return b"", np.zeros(0, np.int32)
        fh = ctx["fh"]
        R, wlen = ctx["R"], ctx["wlen"]
        nhits = np.zeros(B, np.int32)
        if fh.n == 0:
            m.tally(reads=B)
            return self._unaligned_block_cs(ctx, nhits), nhits
        n = int(fh.n)
        W = R + ctx["G"]
        tp = ctx["win"].get("two_phase")
        scores, packed_all, steps_all = self._fetch(ctx, n)

        # ---- native pass1 selection on the vector scores
        with m.span("pass1 select"):
            opts = m._unpaired_opts[0].pass1
            cap = max(n, 1)
            sel = {k: np.empty(cap, dt) for k, dt in
                   (("ri", np.int32), ("gen_st", np.int8), ("cn", np.int32),
                    ("g_off", np.int64), ("w_len", np.int32),
                    ("score_max", np.int64), ("ax", np.int64),
                    ("ay", np.int64), ("alen", np.int64), ("awid", np.int64),
                    ("score_vector", np.int64), ("src", np.int64))}
            seg = np.zeros(B + 1, np.int64)
            p1 = _P1Params(
                n, 2 * B, R, wlen,
                int(abs_or_pct(opts.window_overlap, wlen)),
                float(opts.threshold), opts.min_matches, opts.num_outputs,
                1, fls.contig_lengths32.ctypes.data)
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
                        scores=scores)
            p1in = _P1In(**{k: _vp(v) for k, v in arrs.items()})
            p1out = _P1Out(cap, *[_vp(sel[k]) for k in
                                  ("ri", "gen_st", "cn", "g_off", "w_len",
                                   "score_max", "ax", "ay", "alen",
                                   "awid", "score_vector")],
                           _vp(seg), _vp(sel["src"]))
            n_sel = int(self.lib.pass1_select(ctypes.byref(p1),
                                              ctypes.byref(p1in),
                                              ctypes.byref(p1out)))
            if n_sel < 0:
                raise RuntimeError(f"pass1_select failed ({n_sel})")
        if n_sel == 0:
            m.tally(reads=B)
            return self._unaligned_block_cs(ctx, nhits), nhits

        # CS pass 2 runs the full SW on every selected hit (no vector
        # gate, hit_run_full_sw mapping.c:375-379): keep all rows
        rows = sel["src"][:n_sel]
        if tp is None:
            packed_sel = np.ascontiguousarray(packed_all[rows])
            steps_sel = np.ascontiguousarray(steps_all[rows])
        else:
            # two-phase phase B: the full SW on the pass-1 survivors only
            packed_sel, steps_sel = self._cs_run_full_rows(tp, rows, fh, R,
                                                           ctx["G"])
        with m.span("cs finalize + render"):
            cal = m.cal
            g_fwd, g_rc, start_abs_sel, g_len = self._cs_genome_view(rows,
                                                                     ctx)
            job_arrs = dict(
                ri=np.ascontiguousarray(sel["ri"][:n_sel]),
                cn=np.ascontiguousarray(sel["cn"][:n_sel]),
                gen_st=np.ascontiguousarray(sel["gen_st"][:n_sel]),
                g_off=np.ascontiguousarray(sel["g_off"][:n_sel]),
                start_abs=start_abs_sel,
                score_max=np.ascontiguousarray(sel["score_max"][:n_sel]),
                packed=packed_sel, steps_rev=steps_sel)
            raw = ctx["raw"]
            quals, cq = ctx.get("quals"), ctx.get("cq")
            fr = _CSFRParams(
                n_sel, B, R, W, raw.shape[1],
                float(cfg.sw_full_threshold), cfg.num_outputs,
                int(cfg.strata), cfg.max_alignments,
                int(cfg.single_best_mapping),
                int(cfg.compute_mapping_qualities),
                cal.alpha, cal.beta, cal.pr_xover, cal.pr_mismatch,
                cal.pr_del_open, cal.pr_del_extend, cal.pr_ins_open,
                cal.pr_ins_extend,
                g_len,
                g_fwd.ctypes.data, g_rc.ctypes.data,
                fls.contig_lengths32.ctypes.data,
                fls.contig_name_off.ctypes.data,
                fls.contig_names_blob.ctypes.data,
                ctx["name_off"].ctypes.data, ctx["names"].ctypes.data,
                ctx["codes0"].ctypes.data, ctx["qr_tab"].ctypes.data,
                ctx["initbp"].ctypes.data, raw.ctypes.data,
                int(quals is not None),
                int(quals is not None and not cfg.ignore_qvs),
                cfg.qual_delta, 1,
                quals.ctypes.data if quals is not None else None,
                cq.ctypes.data if cq is not None else None,
                cq.shape[1] if cq is not None else 0)
            # renderer-level flags (kept out of the gate)
            rg_bytes = None
            if cfg.read_group_name:
                rg_bytes = f"\tRG:Z:{cfg.read_group_name}".encode()
                fr.rg = ctypes.cast(ctypes.c_char_p(rg_bytes), ctypes.c_void_p)
                fr.rg_len = len(rg_bytes)
            fr.all_contigs = int(cfg.all_contigs)
            fr.sam_unaligned = int(cfg.sam_unaligned)
            frj = _CSFRJobs(**{k: _vp(v) for k, v in job_arrs.items()})
            cap_b = n_sel * (3 * R + 256) + 4096
            while True:
                buf = np.empty(cap_b, np.uint8)
                nb = self.lib.cs_finalize_render(
                    ctypes.byref(fr), ctypes.byref(frj), _vp(buf),
                    ctypes.c_int64(cap_b), _vp(nhits))
                if nb >= 0:
                    break
                if nb == -2:
                    raise RuntimeError("cs fastpath unsupported config")
                cap_b *= 4
        m.tally(reads=B,
                reads_mapped=int((nhits > 0).sum()),
                alignments=int(nhits.sum()))
        return buf[:nb].tobytes(), nhits


def map_unpaired_cs_sam_stream(mapper, records: Sequence[SeqRecord],
                               batch_size: Optional[int] = None,
                               lanes: Optional[int] = None
                               ) -> Optional[Iterator[bytes]]:
    """Pipelined CS unpaired mapping straight to SAM bytes, batch by batch
    in input order; None when the config needs a feature outside the
    fast path or the first batch is one the flat encoder rejects (mixed
    read lengths, bad colours or primers, mixed qualities): the caller
    maps those with `mapper.map_unpaired`. A later rejected batch takes
    the slow tail (`fastpath.unpaired_slow_tail`).

    `lanes` > 1 (default 16) runs that many whole-batch pipelines on
    worker threads, output re-ordered to input order; results are
    byte-identical to lanes=1."""
    if not _config_supported(mapper.config):
        return None
    fast = FastCS(mapper)
    batch_size = batch_size or auto_batch_size(mapper)
    return batch_pipeline(
        fast.fls, fast.stage_prepare, fast.stage_finish, records,
        batch_size, lanes, unpaired_slow_tail(mapper, records, batch_size))


# ===================================================================
# Colour-space paired-end fast path
# ===================================================================

def fastpath_cs_paired_supported(cfg: MapperConfig) -> bool:
    """Gate: the native paired renderer's CS mode covers the default CS
    paired SAM flow (single option set, MQV on, no single-best) plus the
    renderer-level flags."""
    if cfg.pair_mode == C.PAIR_NONE or cfg.mode != C.MODE_COLOUR_SPACE:
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
    return (not cfg.gapless and cfg.global_alignment
            and cfg.compute_mapping_qualities
            and not cfg.single_best_mapping
            and not cfg.extra_sam_fields and not cfg.shrimp_format
            and not cfg.bfast
            and cfg.search_forward and cfg.search_reverse)


def _cs_paired_config_supported(cfg: MapperConfig) -> bool:
    """`fastpath_cs_paired_supported` plus the reference's stage_prepare
    refusal of raw-string trims, which the reference also answers with
    None. FastPairedCS assumes a config that passed this gate."""
    return (fastpath_cs_paired_supported(cfg)
            and not (cfg.trim_front or cfg.trim_end))


class FastPairedCS(FastCS):
    """Colour-space paired pipeline: the CS encoding and the CS device
    dispatch shared with FastCS (two-phase at CS_TWO_PHASE_WPR windows
    per read or more), then one native `paired_finalize_render` call in
    CS mode for pair-up, the paired passes with the post-SW foot
    rescoring, the half-paired fallback, paired MQVs and the CS SAM
    text. Two-phase batches run select-then-full (`fastpath.
    _select_then_full`), the 4-layer DP and the traceback on the rows
    the select pass picks. `mapper` is a `paired.PairedMapper`. The
    sharded-index tier sets the Z hooks of `fastpath.FastPaired`
    (`zpair_merge_hook`, `zpair_win_shard`, `zpair_n_shards`); its
    dispatch keeps the fused launch."""

    def __init__(self, mapper) -> None:
        super().__init__(mapper)
        self.zpair_merge_hook = None
        self.zpair_win_shard = None
        self.zpair_n_shards = 0

    def _filter1_cs_paired(self, codes2, R: int, wlen: int, ro):
        """Paired candidate generation, k-mers from colour 1, the
        mate-pair region filter included; the sharded-index tier
        overrides it."""
        return _filter1_paired(self.m, self.fls.f1_threads, codes2, R, wlen,
                               ro, min_kmer_pos=1)

    def _cs_genome_view_paired(self, ctx):
        """Letter planes the paired native render's post-SW eval reads,
        over every window (pair rescoring may eval any of them):
        (genome_fwd, genome_rc, start_abs)."""
        idx = self.m.index
        return (idx.codes, idx.codes_rc,
                np.ascontiguousarray(ctx["win"]["starts"], np.int64))

    # ---------------------------------------------------------- stage A
    def stage_prepare(self, records: Sequence[SeqRecord],
                      batch_cap: Optional[int] = None):
        """Encode interleaved CS mate pairs + filter 1 + device dispatch.
        Returns None when the flat encoder rejects the batch (an odd
        record count, or as FastCS's; a pair under --min-avg-qv too)."""
        m = self.m
        with m.span("read prep"):
            if len(records) % 2:
                return None
            enc = self._encode(records, drop_low_qv=False)
            if enc is None:
                return None
            B, R = enc["B"], enc["R"]
            # per-leg strand flips (read_reverse, gmapper.c:175-186); a
            # flipped leg's strand-0 row is the revcomp colours
            flip1, flip2 = C.PAIR_REVERSE[m.config.pair_mode]
            input_strand = np.zeros(B, np.int8)
            input_strand[0::2] = int(flip1)
            input_strand[1::2] = int(flip2)
            flipm = input_strand == 1
            codes2 = np.empty((B, 2, R), np.uint8)
            codes2[:, 0] = np.where(flipm[:, None], enc["codes1"],
                                    enc["codes0"])
            codes2[:, 1] = np.where(flipm[:, None], enc["codes0"],
                                    enc["codes1"])

        with m.span("filter1"):
            # colour k-mers from colour 1, the mate-pair region filter
            # included
            fh = self._filter1_cs_paired(codes2, R, enc["wlen"],
                                         m._paired_opts[0].read[0])
            if fh is None:
                return None
        # feet run the full SW in two contexts (paired 0.5x, half-paired
        # 1x): the dispatch zeroes nothing (threshold 1) and the native
        # render applies each context's threshold
        rcf = None
        if fh.n:
            rcf = ((fh.owner & 1).astype(np.int8)
                   != input_strand[(fh.owner >> 1).astype(np.int64)])
        ctx = self._dispatch(enc, fh, batch_cap,
                             rcf=rcf, thresh_override=1)
        ctx["input_strand"] = input_strand
        return ctx

    # ---------------------------------------------------------- stage B
    def stage_finish(self, ctx) -> Tuple[bytes, np.ndarray, np.ndarray]:
        """Fetch the device results and run the whole CS paired brain in
        one native call (select-then-full for a two-phase batch)."""
        m = self.m
        cfg = m.config
        fls = self.fls
        B = ctx["B"]
        fh = ctx["fh"]
        R, wlen = ctx["R"], ctx["wlen"]
        n_pairs = B // 2
        pair_nhits = np.zeros(n_pairs, np.int32)
        read_nhits = np.zeros(B, np.int32)
        m.tally(reads=B)
        if fh.n == 0:
            cq = ctx["cq"]
            return (_paired_unaligned_block(
                cfg, ctx, lambda ri: b"*\t*\tCQ:Z:"
                + (b"*" if cq is None else cq[ri].tobytes())
                + b"\tCS:Z:" + ctx["raw"][ri].tobytes(), b"\tX2:Z:"),
                pair_nhits, read_nhits)
        n = int(fh.n)
        win = ctx["win"]
        tp = win.get("two_phase")
        scores, packed_all, steps_all = self._fetch(ctx, n)

        with m.span("cs paired select + render"):
            popts = m._paired_opts[0]
            ro = popts.read[0]
            pairing = popts.pairing
            hp = cfg.half_paired_unpaired_options(0)[0]
            re1 = SimpleNamespace(window_len=wlen, read_len=R)
            re2 = SimpleNamespace(window_len=wlen, read_len=R)
            m._compute_mp_ranges(re1, re2, pairing)
            cal = m.cal
            sc = cfg.scores
            owner = np.ascontiguousarray(fh.owner, np.int64)
            g_fwd, g_rc, start_abs_all = self._cs_genome_view_paired(ctx)
            arrs = dict(
                seg=np.ascontiguousarray(
                    np.searchsorted(owner, np.arange(2 * B + 1)), np.int64),
                cn=np.ascontiguousarray(fh.cn, np.int32),
                g_off=np.ascontiguousarray(fh.g_off, np.int64),
                g_off_norm=np.ascontiguousarray(win["g_off_t"], np.int64),
                gen_st=np.ascontiguousarray(win["rcmask"], np.int8),
                w_len=np.ascontiguousarray(fh.w_len, np.int32),
                matches=np.ascontiguousarray(fh.matches, np.int32),
                score_max=np.ascontiguousarray(fh.score_max, np.int64),
                vec=scores, start_abs=start_abs_all)
            W = 1
            if tp is None:
                arrs["cs_packed"] = packed_all
                arrs["cs_steps"] = steps_all
                W = steps_all.shape[1]
            raw = ctx["raw"]
            quals, cq = ctx["quals"], ctx["cq"]
            p = _PPParams(
                n_pairs, n, R, wlen, W,
                (ctypes.c_int64 * 2)(int(re1.delta_g_off_min[0]),
                                     int(re1.delta_g_off_min[1])),
                (ctypes.c_int64 * 2)(int(re1.delta_g_off_max[0]),
                                     int(re1.delta_g_off_max[1])),
                ro.pass1.min_matches,
                int(abs_or_pct(ro.pass1.window_overlap, wlen)),
                float(ro.pass1.threshold),
                pairing.pass1_num_outputs, float(pairing.pass1_threshold),
                float(ro.pass2.threshold),
                float(pairing.pass2_threshold), pairing.pass2_num_outputs,
                int(pairing.strata), cfg.max_alignments,
                int(cfg.half_paired), hp.pass1.min_matches,
                int(abs_or_pct(hp.pass1.window_overlap, wlen)),
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
                None, None, None, None, None,
                1, abs(sc.crossover),
                cal.pr_xover, cal.pr_mismatch,
                cal.pr_del_open, cal.pr_del_extend, cal.pr_ins_open,
                cal.pr_ins_extend,
                int(quals is not None),
                int(quals is not None and not cfg.ignore_qvs),
                cfg.qual_delta, 1,
                g_fwd.ctypes.data, g_rc.ctypes.data,
                ctx["codes0"].ctypes.data, ctx["qr_tab"].ctypes.data,
                ctx["initbp"].ctypes.data, raw.ctypes.data, raw.shape[1],
                quals.ctypes.data if quals is not None else None,
                cq.ctypes.data if cq is not None else None,
                cq.shape[1] if cq is not None else 0)
            # the RG bytes stay alive through the native calls
            rg_bytes = _set_paired_render_flags(p, cfg, raw, n_pairs)
            wstruct = _PPWin(**{k: _vp(v) for k, v in arrs.items()})
            cap = max(1 << 20, n_pairs * 6 * (3 * R + 320))
            ext = None        # p.ext_in points into it through the render
            if self.zpair_merge_hook is not None:
                ext = _zpair_collect(
                    self.lib, p, wstruct, cap, n_pairs,
                    self.zpair_merge_hook, self.zpair_win_shard,
                    self.zpair_n_shards, pair_nhits, read_nhits)
            if tp is None:
                out, rv, cap = _paired_render(self.lib, p, wstruct, cap,
                                              pair_nhits, read_nhits)
            else:
                out, rv = _select_then_full(
                    m, self.lib, p, wstruct, pairing, hp, n, n_pairs, cap,
                    pair_nhits, read_nhits,
                    lambda rows: self._cs_run_full_rows(tp, rows, fh, R,
                                                        ctx["G"]),
                    ("cs_packed", "cs_steps"), "cs paired select (2ph)")
            del rg_bytes, ext
        m.tally(reads_mapped=int((pair_nhits > 0).sum()) * 2,
                alignments=2 * int(pair_nhits.sum())
                + int(read_nhits.sum()))
        return bytes(out[:rv]), pair_nhits, read_nhits


def map_paired_cs_sam_stream(mapper, records: Sequence[SeqRecord],
                             batch_size: Optional[int] = None,
                             lanes: Optional[int] = None
                             ) -> Optional[Iterator[bytes]]:
    """Pipelined CS paired mapping straight to SAM bytes, batch by batch
    in input order; None when the config needs a feature outside the
    fast path or the first batch is one the flat encoder rejects (an odd
    record count, mixed read lengths, bad colours or primers, mixed
    qualities, a read under --min-avg-qv): the caller maps those with
    `mapper.map_paired`. A later rejected batch takes the slow tail
    (`fastpath.paired_slow_tail`). `mapper` is a `paired.PairedMapper`;
    `records` are interleaved SOLiD mate pairs (an odd batch size is
    rounded up).

    `lanes` > 1 (default 16) runs that many whole-batch pipelines on
    worker threads (`fastpath.batch_pipeline`), output re-ordered to
    input order; results are byte-identical to lanes=1. The lanes run
    through the port's shared pipeline rather than a copy of the
    reference's, whose `lanes` > 1 raises UnboundLocalError (its `os`
    import sits under `if lanes is None`)."""
    if not _cs_paired_config_supported(mapper.config):
        return None
    batch_size = batch_size or auto_batch_size(mapper)
    batch_size += batch_size % 2
    fast = FastPairedCS(mapper)
    return batch_pipeline(
        fast.fls, fast.stage_prepare, fast.stage_finish, records,
        batch_size, lanes, paired_slow_tail(mapper, records, batch_size))
