"""Unpaired mapping pipeline: filter 1 -> batched vector SW (filter 2) ->
batched full SW + traceback (filter 3) -> MQV -> SAM records.

Orchestrates the stages of SHRiMP2's handle_read (gmapper/mapping.c:1773)
as batched device kernels plus exact host bookkeeping:

- pass1 walk / window overlap:    mapping.c:1261-1339
- top-k extheap:                  mapping.c:1376-1411 + common/heap.h
- pass2 / duplicates / strata:    mapping.c:1631-1750, 1520-1606
- LS posterior:                   mapping.c:1609-1625
- unpaired MQV:                   gmapper/output.c:777-793

Port of `shrimp_tpu/mapper.py`: the data classes (`ReadEntry`, `Hit`,
`ExtHeap`) and the host logic (read prep, trims and qv gating, filter 1,
the gapless Kadane scores, pass-1 selection, finalize, MQVs, the
option-set loop) are copied as they are. The device sites are torch
twins on the port's kernels: the vector SW (`core/sw_vector.py`, on
host-gathered windows or gathered from the resident planes), the full
SW with backpointers and its traceback (`core/sw_full.py::
sw_full_and_traceback`) and the colour-space 4-layer DP with its
traceback (`core/sw_cs.py::sw_full_cs_dispatch`). Every launch of a
batch is queued before one copy of each kind of result comes back.

The genome planes live on `device` from the moment the Mapper is made
(`_pad_plane`, `_dev_codes`, `_dev_codes_rc`, `_dev_cat_words`, and for a
colour-space config `_dev_cs_planes`, `_dev_cs_cat_words`), built from
the numpy arrays of the port's own `index.build.GenomeIndex` with the
reference's padding and word layout, so both packages compute on
identical bytes. The fast streams read the same planes. Every
statistics update goes through `tally`, which takes a lock: the streams'
lane threads share one Mapper (a bare `+=` loses updates).

On CUDA, windows wider than the kernels take (colour space over 256
columns, letter space over 4095) raise NotImplementedError naming their
reads; nothing falls back to the CPU.
"""
from __future__ import annotations

import math
import threading
import time as _time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import constants as C
from .config import (MapperConfig, Pass2Options, ReadMappingOptions,
                     abs_or_pct, is_absolute)
from .core import batch_pipeline as bp
from .core import candidates, encode, sw_cs_np
from .core._args import MAX_G, MAX_G_LONG
from .core.sw import cat_word_plane
from .core.sw_cs import sw_full_cs_dispatch, sw_full_cs_finish
from .core.sw_cs_batch import CSBatchResult, post_sw_forward_backward_batch
from .core.sw_full import sw_full_and_traceback
from .core.sw_np import _join2_rect
from .core.sw_vector import (sw_vector_batch, sw_vector_cs_from_index,
                             sw_vector_ls_from_index)
from .core.traceback import (TracebackResult, from_device as tb_from_device,
                             unpack_ops as tb_unpack_ops)
from .device import get_device
from .index.build import GenomeIndex
from .io.fasta import SeqRecord
from .native.filter1_py import generate_candidates_native
from .utils.stats import MapperStats


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pow2_bucket(n: int, lo: int = 256) -> int:
    """Pad batch sizes to powers of two so kernel shapes stay cached."""
    b = lo
    while b < n:
        b *= 2
    return b


# Rows per launch of the generic mapper (larger workloads are chunked;
# every chunk is queued before any result is fetched). The CUDA kernels
# take any row count, so the last chunk is not padded.
VEC_BATCH = 16384
FULL_BATCH = 8192
CS_FULL_BATCH = 2048
# the fast streams' launch row buckets
FULL_BUCKETS = (2048, 4096, 8192, 16384, 32768)


def _gather_rows(src: np.ndarray, starts: np.ndarray, width: int
                 ) -> np.ndarray:
    """Vectorized gather of [len(starts), width] windows from a 1-D array."""
    idx = starts[:, None] + np.arange(width, dtype=np.int64)[None, :]
    return src[np.clip(idx, 0, len(src) - 1)]


def _concat_cs_results(chunks):
    """Concatenate padded per-chunk CSBatchResults, trimming chunk padding."""
    import dataclasses
    fields = [f.name for f in dataclasses.fields(CSBatchResult)]
    out = {}
    for f in fields:
        out[f] = np.concatenate([getattr(r, f)[:k] for k, r in chunks])
    return CSBatchResult(**out)


@dataclass
class ReadEntry:
    name: str
    seq: str
    qual: Optional[str]
    read_len: int
    codes: Tuple[np.ndarray, np.ndarray]   # strand 0 (input), strand 1 (rc)
    window_len: int
    min_kmer_pos: int = 0
    initbp: Tuple[int, int] = (-1, -1)
    mapped: bool = False
    # paired-end state (gmapper read_entry)
    input_strand: int = 0
    paired: bool = False
    first_in_pair: bool = False
    mate_pair: Optional["ReadEntry"] = None
    delta_g_off_min: Tuple[int, int] = (0, 0)
    delta_g_off_max: Tuple[int, int] = (0, 0)
    delta_region_min: Tuple[int, int] = (0, 0)
    delta_region_max: Tuple[int, int] = (0, 0)
    final_unpaired_hits: List["Hit"] = field(default_factory=list)
    crossover_score: Optional[np.ndarray] = None  # per-colour, CS+qvs
    # paired-mode late trim (gmapper.c:412-439): mate 1 maps untrimmed
    # but its seq STRING was trimmed in place, which only unmapped-style
    # records print (hit_output strcpy, output.c:417-421)
    trimmed_seq: Optional[str] = None
    # CS paired mate-1 trim quirk: trim_read (gmapper.c:262-281) cuts
    # qual at an index derived from strlen(seq) — one MORE than the CS
    # qual length — and mate 1's post_sw runs on the UNTRIMMED colour
    # encoding, so it indexes past the planted NUL into the original
    # buffer bytes. qual_buf reproduces that raw C buffer; qual holds
    # the rendered C string (chars before the first NUL).
    qual_buf: Optional[str] = None


@dataclass
class Hit:
    """A surviving alignment (read_hit + sw_full_results fields)."""
    st: int
    gen_st: int
    cn: int
    g_off: int          # contig-local window start, gen_st coords
    w_len: int
    score_window_gen: int
    kmer_matches: int
    score_vector: int
    score_max: int
    score_full: int = -1
    pct_score_full: int = 0
    pass1_key: int = 0
    pass2_key: int = 0
    sort_idx: int = 0
    # anchor rectangle relative to g_off (gen_st coords)
    ax: int = 0
    ay: int = 0
    alen: int = 0
    awid: int = 0
    # sw_full_results
    sw_score: int = 0
    read_start: int = 0
    genome_start: int = 0    # contig-local, gen_st coords (incl. g_off)
    rmapped: int = 0
    gmapped: int = 0
    matches: int = 0
    mismatches: int = 0
    insertions: int = 0      # genome-only steps (CIGAR D)
    deletions: int = 0       # read-only steps (CIGAR I)
    ops: Optional[np.ndarray] = None
    posterior: float = 0.0
    posterior_score: int = 0
    mqv: int = 255
    z0: float = 0.0
    z1: float = 0.0
    # colour space extras
    crossovers: int = 0
    dbalign: Optional[str] = None
    qralign: Optional[str] = None
    qual_str: Optional[str] = None
    # paired-end state
    saved: int = 0
    pair_min: int = -1
    pair_max: int = -1
    g_off_pos_strand: int = 0
    pct_score_vector: int = 0
    z2: float = 0.0
    z3: float = 0.0
    pr_top_random_at_location: float = 1.0
    pr_missed_mp: float = 0.0
    insert_size_denom: float = 0.0


class ExtHeap:
    """Bounded top-k min-heap, bit-faithful to DEF_EXTHEAP
    (common/heap.h:226-318); the final array layout (heap order) matters
    because pass2 iterates it directly."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.a: List = []

    def _less(self, x, y) -> bool:
        return x.pass1_key < y.pass1_key

    def insert(self, e) -> None:
        self.a.append(e)
        node = len(self.a)
        parent = node // 2
        while node > 1 and self._less(self.a[node - 1], self.a[parent - 1]):
            self.a[node - 1], self.a[parent - 1] = (self.a[parent - 1],
                                                    self.a[node - 1])
            node = parent
            parent = node // 2

    def replace_min(self, e) -> None:
        self.a[0] = e
        node = 1
        load = len(self.a)
        while True:
            left, right = node * 2, node * 2 + 1
            mn = node
            if left <= load and self._less(self.a[left - 1], self.a[mn - 1]):
                mn = left
            if right <= load and self._less(self.a[right - 1], self.a[mn - 1]):
                mn = right
            if mn == node:
                break
            self.a[mn - 1], self.a[node - 1] = (self.a[node - 1],
                                                self.a[mn - 1])
            node = mn

    @property
    def min_key(self) -> int:
        return self.a[0].pass1_key

    @property
    def load(self) -> int:
        return len(self.a)


def qv_from_pr_corr(pr_corr: float) -> int:
    """util.h:267-282."""
    pr_err = 1 - pr_corr
    if pr_err > .99999999:
        return 0
    if pr_err < 1e-25:
        return 250
    return int(-10.0 * math.log(pr_err) / math.log(10.0))


def double_to_neglog(x: float, shift: int = 1000) -> int:
    """util.h:296-300."""
    return int(shift * -math.log(x))


def _pr_err_from_qv(qv: int) -> float:
    """util.h:284-293."""
    if qv <= 0:
        return .99999999
    if qv >= 250:
        return 1e-25
    return math.pow(10.0, -qv / 10.0)


class Mapper:
    """Mapper(index, config, device="cuda"): `index` is the port's
    GenomeIndex; `device` is a torch.device or a name ("cuda", "cuda:0",
    "cpu"). The mapper runs on the card unless the caller asks for the
    CPU, and CUDA is never swapped for the CPU."""

    def __init__(self, index: GenomeIndex,
                 config: Optional[MapperConfig] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.index = index
        self.config = config or MapperConfig()
        cfg = self.config
        self.cutoff = (cfg.list_cutoff if cfg.list_cutoff is not None
                       else index.auto_list_cutoff())
        self.cal = cfg.calibration
        sc = cfg.scores
        # CS vector filter scores a colour mismatch as match+crossover
        # (gmapper.c:2933-2936 f1_setup), not the full-SW mismatch —
        # this keeps dot-colour (N) reads above the pass1 threshold.
        vec_mm = (sc.match + sc.crossover
                  if cfg.mode == C.MODE_COLOUR_SPACE else sc.mismatch)
        self._vec_kw = dict(match=sc.match, mismatch=vec_mm,
                            a_gap_open=sc.a_gap_open,
                            a_gap_ext=sc.a_gap_extend,
                            b_gap_open=sc.b_gap_open,
                            b_gap_ext=sc.b_gap_extend)
        self._unpaired_opts = cfg.unpaired_options()
        self.stats = MapperStats()
        # filter 1's threads in the generic mapper (None: every core)
        self.f1_threads: Optional[int] = None
        self._stats_lock = threading.Lock()
        self.device = get_device(device)
        fp = self._pad_plane(index.codes)
        rp = self._pad_plane(index.codes_rc)
        self._codes_dev = self._upload(fp)
        self._codes_rc_dev = self._upload(rp)
        cat = cat_word_plane(fp, rp)
        self._cat_words_dev = None if cat is None else self._upload(cat)
        self._cs_planes_dev = self._cs_cat_words_dev = None
        if cfg.mode == C.MODE_COLOUR_SPACE:
            cfp = self._pad_plane(index.cs_codes)
            crp = self._pad_plane(index.cs_codes_rc)
            self._cs_planes_dev = (self._upload(cfp), self._upload(crp),
                                   self._codes_dev, self._codes_rc_dev)
            ccat = cat_word_plane(cfp, crp)
            # the letter cat plane is _cat_words_dev: the same bytes
            if ccat is not None and cat is not None:
                self._cs_cat_words_dev = (self._upload(ccat),
                                          self._cat_words_dev)

    def tally(self, stage: Optional[str] = None, secs: float = 0.0,
              **counts) -> None:
        """Add `counts` to the named MapperStats fields and `secs` to a
        stage. The lanes pipeline's threads share one Mapper, so every
        update takes the lock (a bare `+=` loses updates)."""
        with self._stats_lock:
            for name, v in counts.items():
                setattr(self.stats, name, getattr(self.stats, name) + v)
            if stage is not None:
                self.stats.add_stage(stage, secs)

    def _upload(self, a: np.ndarray, dtype=None) -> torch.Tensor:
        """`a` (cast to `dtype` where given) as a tensor on the device."""
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(
            self.device)

    @staticmethod
    def _pad_plane(a: np.ndarray) -> np.ndarray:
        """Pad a genome plane to a bucketed length: power of two up to
        256M, then multiples of 16M (pow2 padding of a 750M plane would
        push the concatenated word plane past int32 offsets). Pad cells
        are the 254 sentinel, which never matches; filter 1 clips
        windows at the contig end, so the pad is unreachable data."""
        if len(a) <= (1 << 28):
            n = _pow2_bucket(len(a), lo=1 << 22)
        else:
            n = -(-len(a) // (1 << 24)) * (1 << 24)
        if n == len(a):
            return a
        out = np.full(n, 254, np.uint8)
        out[:len(a)] = a
        return out

    def _dev_codes(self) -> torch.Tensor:
        """Padded forward genome plane on the device."""
        return self._codes_dev

    def _dev_codes_rc(self) -> torch.Tensor:
        """Padded reverse-complement genome plane on the device."""
        return self._codes_rc_dev

    def _dev_cat_words(self) -> Optional[torch.Tensor]:
        """The concatenated word plane (core.sw.cat_word_plane) on the
        device, or None when its offsets would overflow int32."""
        return self._cat_words_dev

    def _dev_cs_planes(self):
        """(colour, colour rc, letter, letter rc) padded planes on the
        device for a colour-space config, else None."""
        return self._cs_planes_dev

    def _dev_cs_cat_words(self):
        """(colour cat words, letter cat words) on the device for a
        colour-space config, or None (letter-space config, or offsets
        that would overflow int32)."""
        return self._cs_cat_words_dev

    def _check_width(self, G: int, max_g: int, rows, what: str) -> None:
        """On CUDA, a launch of windows wider than the kernel takes raises
        NotImplementedError naming its reads; `rows()` gives (read name,
        window length) of each window of the launch."""
        if self.device.type != "cuda" or G <= max_g:
            return
        names = sorted({nm for nm, w in rows() if _round_up(w, 32) > max_g})
        raise NotImplementedError(
            f"{what}: reads {names[:8]}{' ...' if len(names) > 8 else ''} "
            f"have windows of up to {G} columns; the CUDA kernels take "
            f"G <= {max_g}")

    # ------------------------------------------------------------ read prep
    def prepare_read(self, rec: SeqRecord,
                     trim: bool = True) -> Optional[ReadEntry]:
        cfg = self.config
        if trim and (cfg.trim_front or cfg.trim_end):
            # trim_read (gmapper.c:262-281): raw-string front/end trim
            end = len(rec.seq) - cfg.trim_end
            rec = SeqRecord(rec.name, rec.seq[cfg.trim_front:end],
                            rec.qual[cfg.trim_front:end]
                            if rec.qual is not None else None)
        if (cfg.mode == C.MODE_LETTER_SPACE and cfg.trim_illumina
                and rec.qual):
            # strip trailing Illumina 'B' quality run (gmapper.c:440-453)
            nb = len(rec.qual) - len(rec.qual.rstrip("B"))
            if nb:
                rec = SeqRecord(rec.name, rec.seq[:len(rec.seq) - nb],
                                rec.qual[:len(rec.qual) - nb])
        if rec.qual is not None and not cfg.ignore_qvs:
            if not cfg.no_qv_check:
                # PHRED offset sanity check (gmapper.c:464-473)
                for ch in rec.qual:
                    q = ord(ch) - cfg.qual_delta
                    if q < -10 or q > 50:
                        raise ValueError(
                            "The qv-offset might be set incorrectly! "
                            f"Currently qvs are interpreted as PHRED+"
                            f"{cfg.qual_delta} and a qv of {q} was "
                            "observed.")
        seq = rec.seq
        if cfg.mode == C.MODE_LETTER_SPACE:
            codes0 = encode.encode_ls(seq)
            read_len = len(codes0)
            codes1 = encode.revcomp_ls(codes0)
            initbp = (-1, -1)
            min_kmer_pos = 0
        else:
            init0, codes0 = encode.encode_cs(seq)
            read_len = len(codes0)
            codes1 = encode.revcomp_cs(codes0, init0, init0)
            initbp = (init0, init0)
            min_kmer_pos = 1
        if read_len > cfg.longest_read_len or read_len == 0:
            return None
        if (rec.qual is not None and not cfg.ignore_qvs
                and cfg.min_avg_qv >= 0):
            # average qv drop (gmapper.c:455-462, 496-498); C int division
            s = sum(ord(ch) - cfg.qual_delta for ch in rec.qual)
            avg = -(-s // read_len) if s < 0 else s // read_len
            if avg < cfg.min_avg_qv:
                return None
        window_len = int(abs_or_pct(cfg.window_len, read_len))
        e = ReadEntry(name=rec.name, seq=seq, qual=rec.qual,
                      read_len=read_len, codes=(codes0, codes1),
                      window_len=window_len, min_kmer_pos=min_kmer_pos,
                      initbp=initbp)
        if (cfg.mode == C.MODE_COLOUR_SPACE and rec.qual is not None
                and not cfg.ignore_qvs):
            # per-position crossover scores from qvs (gmapper.c:532-543)
            cal = self.cal
            xs = np.empty(read_len, np.int64)
            for j in range(read_len):
                pe = _pr_err_from_qv(ord(rec.qual[j]) - cfg.qual_delta)
                v = int(cal.alpha * math.log2(pe / 3.0))
                v = min(v, -1)
                v = max(v, 2 * cfg.scores.crossover)
                xs[j] = v
            e.crossover_score = xs
        return e

    # ------------------------------------------------------------- filter 1
    def hit_lists(self, re: ReadEntry) -> List[candidates.HitList]:
        cfg = self.config
        idx = self.index
        opts = self._unpaired_opts[0]
        out = []
        for st in (0, 1):
            if (st == 0 and not cfg.search_forward) or \
               (st == 1 and not cfg.search_reverse):
                out.append(_empty_hitlist(st))
                continue
            kmers = candidates.read_kmers(idx, re.codes[st], re.min_kmer_pos)
            has2 = None
            if opts.anchor_list.use_region_counts:
                has2 = candidates._region_marks(
                    idx, kmers, self.cutoff, cfg.region_bits,
                    cfg.region_overlap)
            anchors = candidates.get_anchor_list(
                idx, kmers, self.cutoff, re.read_len,
                collapse=opts.anchor_list.collapse, has2_regions=has2,
                region_bits=cfg.region_bits,
                region_overlap=cfg.region_overlap)
            hl = candidates.get_hit_list(
                idx, anchors, st, re.read_len, re.window_len,
                opts.hit_list.match_mode, opts.hit_list.threshold,
                cfg.scores.match, cfg.scores.b_gap_open,
                cfg.scores.b_gap_extend, gapless=opts.hit_list.gapless)
            out.append(hl)
        return out

    # ---------------------------------------------------------- vector pass
    def _score_windows(self, entries: List[ReadEntry],
                       hls: List[List[candidates.HitList]],
                       gapless: Optional[bool] = None
                       ) -> List[List[np.ndarray]]:
        """Batched sw_vector over every candidate window of every read.

        Replaces per-hit f1_run calls (mapping.c:1295-1330) with one device
        launch per shape bucket. Identical windows are deduped in-batch,
        which supersedes the per-thread SW cache (common/f1-wrapper.h)
        without its hash-collision inexactness.
        """
        idx = self.index
        ri_l, st_l, goff_l, wl_l = [], [], [], []
        counts = np.zeros((len(entries), 2), np.int64)
        for ri, hl2 in enumerate(hls):
            for st in (0, 1):
                hl = hl2[st]
                counts[ri, st] = hl.n
                if hl.n:
                    coff = idx.contig_offsets[hl.cn].astype(np.int64)
                    ri_l.append(np.full(hl.n, ri, np.int64))
                    st_l.append(np.full(hl.n, st, np.int64))
                    goff_l.append(coff + hl.g_off)
                    wl_l.append(hl.w_len.astype(np.int64))
        out = [[np.full(hl2[st].n, -1, np.int64) for st in (0, 1)]
               for hl2 in hls]
        if not ri_l:
            return out
        ri_a = np.concatenate(ri_l)
        st_a = np.concatenate(st_l)
        goff_a = np.concatenate(goff_l)
        wl_a = np.concatenate(wl_l)
        n = len(ri_a)

        G = _round_up(max(int(wl_a.max()), 16), 32)
        R = _round_up(max(e.read_len for e in entries), 8)
        glen = wl_a.astype(np.int32)
        rlens = np.array([e.read_len for e in entries], np.int32)
        rlen = rlens[ri_a]
        if gapless is None:
            gapless = self._unpaired_opts[0].pass1.gapless
        if gapless:
            ax_a = np.concatenate(
                [hl2[st].ax for hl2 in hls for st in (0, 1)
                 if hl2[st].n]) if n else np.zeros(0, np.int64)
            ay_a = np.concatenate(
                [hl2[st].ay for hl2 in hls for st in (0, 1)
                 if hl2[st].n]) if n else np.zeros(0, np.int64)
            scores = self._gapless_scores(entries, ri_a, st_a, goff_a,
                                          ax_a, ay_a, rlens)
        elif self.config.mode == C.MODE_LETTER_SPACE:
            self._check_width(G, MAX_G_LONG, lambda: _named(entries, ri_a, wl_a),
                              "vector SW")
            # LS pass1 scores the forward-strand window against the
            # strand-st read (mapping.c:1323-1328)
            gwin = _gather_rows(idx.codes, goff_a, G)
            rtab = np.full((len(entries) * 2, R), 254, np.uint8)
            for ri, e in enumerate(entries):
                rtab[2 * ri, :e.read_len] = e.codes[0]
                rtab[2 * ri + 1, :e.read_len] = e.codes[1]
            rwin = rtab[2 * ri_a + st_a]
            scores = self._vec_chunked(gwin, glen, rwin, rlen)
        else:
            # CS pass1 reverse-normalizes first (mapping.c:1297-1319):
            # window from the CS genome (fwd or per-contig rc), read is
            # the input-strand colour read, first row vs lstocs(ls, initbp)
            self._check_width(G, MAX_G_LONG, lambda: _named(entries, ri_a, wl_a),
                              "vector SW")
            inp = np.array([e.input_strand for e in entries], np.int64)
            eff_rc = st_a != inp[ri_a]
            cn_a = idx.contig_of(goff_a)
            coff2 = idx.contig_offsets[cn_a].astype(np.int64)
            clen2 = idx.contig_lengths[cn_a].astype(np.int64)
            local = goff_a - coff2
            local_rc = clen2 - local - wl_a
            starts = coff2 + np.where(eff_rc, local_rc, local)
            cs_f = _gather_rows(idx.cs_codes, starts, G)
            cs_r = _gather_rows(idx.cs_codes_rc, starts, G)
            gwin = np.where(eff_rc[:, None], cs_r, cs_f)
            ls_f = _gather_rows(idx.codes, starts, G)
            ls_r = _gather_rows(idx.codes_rc, starts, G)
            lswin = np.where(eff_rc[:, None], ls_r, ls_f)
            initbp = np.array([e.initbp[0] for e in entries], np.int64)
            g_row0 = C.COLOUR_MAT[lswin, initbp[ri_a][:, None]]
            rtab = np.full((len(entries) * 2, R), 254, np.uint8)
            for ri, e in enumerate(entries):
                rtab[2 * ri, :e.read_len] = e.codes[e.input_strand]
                rtab[2 * ri + 1, :e.read_len] = e.codes[e.input_strand]
            rwin = rtab[2 * ri_a + st_a]
            scores = self._vec_chunked(gwin, glen, rwin, rlen, g_row0)
        # scatter back per (read, strand)
        pos = 0
        for ri, hl2 in enumerate(hls):
            for st in (0, 1):
                c = int(counts[ri, st])
                if c:
                    out[ri][st] = scores[pos:pos + c]
                    pos += c
        return out

    def _gapless_scores(self, entries, ri_a, st_a, goff_abs, ax_a, ay_a,
                        rlens) -> np.ndarray:
        """Gapless (Kadane) scoring along each hit's anchor diagonal
        (sw_gapless, common/sw-gapless.c:57-117), vectorized in numpy.

        Ungapped mode is the miRNA path; the per-hit work is a single
        read-length diagonal, so the host handles it directly.
        """
        cfg = self.config
        idx = self.index
        sc = cfg.scores
        n = len(ri_a)
        if n == 0:
            return np.zeros(0, np.int64)
        cs = cfg.mode == C.MODE_COLOUR_SPACE
        inp = np.array([e.input_strand for e in entries], np.int64)
        cn_a = idx.contig_of(goff_abs)
        coff = idx.contig_offsets[cn_a].astype(np.int64)
        clen = idx.contig_lengths[cn_a].astype(np.int64)
        g_off_local = goff_abs - coff
        if cs:
            # CS normalizes strand first (mapping.c:1297-1319)
            eff_rc = st_a != inp[ri_a]
            # reverse_hit also flips g_off and the anchor
            wl = np.array([entries[ri].window_len for ri in ri_a], np.int64)
            rl = rlens[ri_a].astype(np.int64)
            g_loc = np.where(eff_rc, clen - g_off_local - wl, g_off_local)
            # gapless hits are unjoined (hit_list gapless skips pairing),
            # so the anchor is a width-1 rectangle and reverses simply
            ax = np.where(eff_rc, -ax_a + (wl - 1), ax_a)
            ay = np.where(eff_rc, -ay_a + (rl - 1), ay_a)
        else:
            g_loc = g_off_local
            ax, ay = ax_a, ay_a
            eff_rc = np.zeros(n, bool)
        g_idx = g_loc + ax          # contig-local anchor genome pos
        r_idx = ay
        rl = rlens[ri_a].astype(np.int64)

        gl0 = np.where(g_idx < r_idx, 0, g_idx - r_idx)
        rl0 = np.where(g_idx < r_idx, r_idx - g_idx, 0)
        L = int(rl.max())
        t = np.arange(L, dtype=np.int64)[None, :]
        gpos = gl0[:, None] + t
        rpos = rl0[:, None] + t
        valid = (gpos < clen[:, None]) & (rpos < rl[:, None])

        if cs:
            src = np.where(eff_rc[:, None],
                           idx.cs_codes_rc[np.clip(coff[:, None] + gpos, 0,
                                                   idx.total_len - 1)],
                           idx.cs_codes[np.clip(coff[:, None] + gpos, 0,
                                                idx.total_len - 1)])
        else:
            src = idx.codes[np.clip(coff[:, None] + gpos, 0,
                                    idx.total_len - 1)]
        rtab = np.full((len(entries) * 2, L), 254, np.uint8)
        for ri, e in enumerate(entries):
            cseq = e.codes[e.input_strand] if cs else None
            rtab[2 * ri, :e.read_len] = cseq if cs else e.codes[0]
            rtab[2 * ri + 1, :e.read_len] = cseq if cs else e.codes[1]
        rchars = rtab[2 * ri_a] if cs else rtab[2 * ri_a + st_a]
        rdiag = np.take_along_axis(rchars, np.clip(rpos, 0, L - 1), axis=1)

        # CS gapless scores a colour mismatch as match+crossover, same as
        # the vector filter (gmapper.c:2933-2936 routes the f1 scores into
        # sw_gapless_setup via f1-wrapper.h), not the full-SW mismatch.
        mm = sc.match + sc.crossover if cs else sc.mismatch
        s = np.where(src == rdiag, sc.match, mm).astype(np.int64)
        if cs:
            # forced first-colour match (sw-gapless.c:83-92)
            first = rl0 == 0
            g0 = np.where(
                eff_rc,
                idx.codes_rc[np.clip(coff + gl0, 0, idx.total_len - 1)],
                idx.codes[np.clip(coff + gl0, 0, idx.total_len - 1)])
            initbp = np.array([entries[ri].initbp[0] for ri in ri_a])
            col0 = C.COLOUR_MAT[g0, initbp]
            match0 = col0 == rdiag[:, 0]
            s[:, 0] = np.where(first, np.where(match0, sc.match, 0),
                               s[:, 0])
        s = np.where(valid, s, 0)
        # Kadane: running = max(0, running + s); vectorized via prefix sums
        prefix = np.cumsum(s, axis=1)
        zero = np.zeros((n, 1), np.int64)
        pref0 = np.concatenate([zero, prefix], axis=1)
        cummin = np.minimum.accumulate(pref0[:, :-1], axis=1)
        running_best = np.where(valid, prefix - cummin, 0)
        return np.maximum(running_best.max(axis=1), 0)

    def _vec_chunked(self, gwin, glen, rwin, rlen, g_row0=None) -> np.ndarray:
        """Run sw_vector_batch in fixed-size [VEC_BATCH] launches; all
        launches are dispatched asynchronously before any fetch."""
        return self._vec_finish(self._vec_dispatch(gwin, glen, rwin, rlen,
                                                   g_row0))

    def _vec_dispatch(self, gwin, glen, rwin, rlen, g_row0=None):
        """Launch the vector-SW batches on host-gathered windows; returns
        state for _vec_finish."""
        t0 = _time.perf_counter()
        n = len(glen)
        cs = g_row0 is not None
        futures = []
        up = self._upload
        for off in range(0, n, VEC_BATCH):
            sl = slice(off, min(off + VEC_BATCH, n))
            args = (up(gwin[sl], np.uint8), up(glen[sl], np.int32),
                    up(rwin[sl], np.uint8), up(rlen[sl], np.int32))
            if cs:
                fut = sw_vector_batch(*args, up(g_row0[sl], np.uint8),
                                      cs_mode=True, **self._vec_kw)
            else:
                fut = sw_vector_batch(*args, **self._vec_kw)
            futures.append(fut)
        cells = int((glen.astype(np.int64) * rlen.astype(np.int64)).sum())
        return (futures, n, cells, t0)

    def _vec_dispatch_idx(self, gstart, glen, owner, rtab, rlen, G):
        """Vector-SW launches against the device-resident genome: only
        window offsets + read rows cross the host boundary (see
        core/sw_vector.sw_vector_ls_from_index)."""
        t0 = _time.perf_counter()
        n = len(gstart)
        # the read table goes up once per batch; each launch ships only
        # window offsets and row indices
        rtab_dev = self._upload(rtab)
        up = self._upload
        futures = []
        for off in range(0, n, VEC_BATCH):
            sl = slice(off, min(off + VEC_BATCH, n))
            futures.append(sw_vector_ls_from_index(
                self._dev_codes(), up(gstart[sl], np.int64),
                up(glen[sl], np.int32), rtab_dev, up(owner[sl], np.int64),
                up(rlen[sl], np.int32), G=G, **self._vec_kw))
        cells = int((glen.astype(np.int64) * rlen.astype(np.int64)).sum())
        return (futures, n, cells, t0)

    def _vec_dispatch_cs_idx(self, gstart, glen, eff_rc, owner, rtab, rlen,
                             initbp, G):
        """CS vector-SW launches against the device-resident genome
        planes (core/sw_vector.sw_vector_cs_from_index): only window
        offsets, strand flags and read rows cross the host boundary."""
        t0 = _time.perf_counter()
        n = len(gstart)
        planes = self._dev_cs_planes()
        rtab_dev = self._upload(rtab)
        up = self._upload
        futures = []
        for off in range(0, n, VEC_BATCH):
            sl = slice(off, min(off + VEC_BATCH, n))
            futures.append(sw_vector_cs_from_index(
                *planes, up(gstart[sl], np.int64), up(glen[sl], np.int32),
                up(eff_rc[sl], np.int32), rtab_dev, up(owner[sl], np.int64),
                up(rlen[sl], np.int32), up(initbp[sl], np.int32), G=G,
                **self._vec_kw))
        cells = int((glen.astype(np.int64) * rlen.astype(np.int64)).sum())
        return (futures, n, cells, t0)

    def _vec_finish(self, state) -> np.ndarray:
        futures, n, cells, t0 = state
        # one copy for every chunk
        out = (torch.cat(futures).cpu().numpy().astype(np.int64) if futures
               else np.zeros(0, np.int64))
        self.tally(vec_invocs=n, vec_cells=cells,
                   vec_secs=_time.perf_counter() - t0)
        return out

    # ----------------------------------------------------------- pass1 walk
    def _make_hits(self, hl2: List[candidates.HitList]) -> List[List[Hit]]:
        """Materialize Hit objects from hit-list arrays; assigns sort_idx
        (mapping.c:1243-1246)."""
        hits2: List[List[Hit]] = [[], []]
        for st in (0, 1):
            hl = hl2[st]
            for i in range(hl.n):
                hits2[st].append(Hit(
                    st=st, gen_st=0, cn=int(hl.cn[i]),
                    g_off=int(hl.g_off[i]),
                    g_off_pos_strand=int(hl.g_off[i]),
                    w_len=int(hl.w_len[i]),
                    score_window_gen=int(hl.score_window_gen[i]),
                    kmer_matches=int(hl.matches[i]),
                    score_vector=-1, score_max=int(hl.score_max[i]),
                    ax=int(hl.ax[i]), ay=int(hl.ay[i]),
                    alen=int(hl.alen[i]), awid=int(hl.awid[i])))
        for i, h in enumerate(hits2[0]):
            h.sort_idx = i
        for i, h in enumerate(hits2[1]):
            h.sort_idx = len(hits2[0]) + i
        return hits2

    def _pass1_walk(self, re: ReadEntry, hits2: List[List[Hit]],
                    scores2: List[np.ndarray], opts) -> None:
        """Window-overlap suppression walk (read_pass1_per_strand,
        mapping.c:1261-1339). Mutates score_vector/pct_score_vector;
        scores2 holds the precomputed vector-SW values."""
        ov = int(abs_or_pct(opts.window_overlap, re.window_len))
        for st in (0, 1):
            last_good = None
            for i, h in enumerate(hits2[st]):
                if opts.only_paired and h.pair_min < 0:
                    continue
                if h.kmer_matches < opts.min_matches:
                    continue
                if h.saved == 1:
                    last_good = (h.cn, h.g_off_pos_strand)
                    continue
                if (last_good is not None and h.cn == last_good[0]
                        and h.g_off_pos_strand + ov
                        <= last_good[1] + re.window_len):
                    h.score_vector = 0
                    h.pct_score_vector = 0
                    continue
                if h.score_vector <= 0:
                    h.score_vector = int(scores2[st][i])
                    h.pct_score_vector = (1000 * 100 * h.score_vector
                                          ) // h.score_max
                    if h.score_vector >= int(abs_or_pct(opts.threshold,
                                                        h.score_max)):
                        last_good = (h.cn, h.g_off_pos_strand)

    def _get_vector_hits(self, hits2: List[List[Hit]], opts) -> List[Hit]:
        """extheap top-k over passing hits (read_get_vector_hits,
        mapping.c:1376-1411); returns the heap array in heap order."""
        heap = ExtHeap(opts.num_outputs)
        absolute = is_absolute(opts.threshold)
        for st in (0, 1):
            for h in hits2[st]:
                if h.saved == 1:
                    continue
                key = h.score_vector if absolute else h.pct_score_vector
                if h.score_vector < int(abs_or_pct(opts.threshold,
                                                   h.score_max)):
                    continue
                if heap.load < opts.num_outputs:
                    h.pass1_key = key
                    heap.insert(h)
                elif key > heap.min_key:
                    h.pass1_key = key
                    heap.replace_min(h)
        return list(heap.a)

    def _pass1_select(self, re: ReadEntry, hl2: List[candidates.HitList],
                      scores2: List[np.ndarray]) -> List[Hit]:
        opts = self._unpaired_opts[0].pass1
        hits2 = self._make_hits(hl2)
        self._pass1_walk(re, hits2, scores2, opts)
        return self._get_vector_hits(hits2, opts)

    def _pass1_select_fast(self, re: ReadEntry,
                           hl2: List[candidates.HitList],
                           scores2: List[np.ndarray]) -> List[Hit]:
        """Array-level pass1 for the single-option-set unpaired flow:
        identical selections to _pass1_select without materializing a Hit
        object per candidate window.

        Key observation: with fresh (unsaved) hits, the window-overlap
        chain (mapping.c:1287-1335) only advances at hits whose computed
        score passes the threshold, and only those hits can be selected —
        so the greedy walk need only visit threshold-passing candidates.
        """
        opts = self._unpaired_opts[0].pass1
        ov = int(abs_or_pct(opts.window_overlap, re.window_len))
        absolute = is_absolute(opts.threshold)
        heap = ExtHeap(opts.num_outputs)
        n0 = hl2[0].n
        for st in (0, 1):
            hl = hl2[st]
            if hl.n == 0:
                continue
            scores = scores2[st]
            smax = hl.score_max.astype(np.int64)
            # C truncates the threshold to int (abs_or_pct + (int) cast)
            if absolute:
                tvec = np.full(hl.n, int(-opts.threshold), np.int64)
            else:
                tvec = np.trunc(smax * (opts.threshold / 100.0)
                                ).astype(np.int64)
            passing = (scores >= tvec) & (hl.matches >= opts.min_matches)
            idxs = np.nonzero(passing)[0]
            last_cn = -1
            last_goff = 0
            for i in idxs:
                i = int(i)
                cn = int(hl.cn[i])
                goff = int(hl.g_off[i])
                if (last_cn >= 0 and cn == last_cn
                        and goff + ov <= last_goff + re.window_len):
                    continue  # suppressed
                last_cn, last_goff = cn, goff
                sv = int(scores[i])
                pct = (1000 * 100 * sv) // int(smax[i])
                key = sv if absolute else pct
                if heap.load >= opts.num_outputs and key <= heap.min_key:
                    continue
                h = Hit(st=st, gen_st=0, cn=cn, g_off=goff,
                        g_off_pos_strand=goff, w_len=int(hl.w_len[i]),
                        score_window_gen=int(hl.score_window_gen[i]),
                        kmer_matches=int(hl.matches[i]),
                        score_vector=sv, score_max=int(smax[i]),
                        ax=int(hl.ax[i]), ay=int(hl.ay[i]),
                        alen=int(hl.alen[i]), awid=int(hl.awid[i]),
                        sort_idx=(i if st == 0 else n0 + i),
                        pass1_key=key, pct_score_vector=pct)
                if heap.load < opts.num_outputs:
                    heap.insert(h)
                else:
                    heap.replace_min(h)
        return list(heap.a)

    # ---------------------------------------------------------------- pass2
    def _pass2(self, entries: List[ReadEntry],
               pass1_hits: List[List[Hit]],
               thresholds: Optional[List[float]] = None) -> None:
        """Full SW + traceback for all selected hits, batched
        (hit_run_full_sw mapping.c:331-402 + sw_full_ls).

        thresholds[i] is the pass2 threshold (percent/absolute convention)
        for read i; defaults to the unpaired sw_full_threshold.
        """
        state = self._pass2_dispatch(entries, pass1_hits, thresholds)
        if state is not None:
            self._pass2_finish(entries, state)

    def _pass2_dispatch(self, entries: List[ReadEntry],
                        pass1_hits: List[List[Hit]],
                        thresholds: Optional[List[float]] = None):
        """Host side of _pass2: build and asynchronously launch the full-SW
        batches. Returns opaque state for _pass2_finish (or None when the
        work completed inline)."""
        cfg = self.config
        if cfg.mode == C.MODE_COLOUR_SPACE:
            self._pass2_cs(entries, pass1_hits, thresholds)
            return None
        sc = cfg.scores
        idx = self.index
        cand: List[Tuple[int, Hit, int]] = []
        for ri, hits in enumerate(pass1_hits):
            thr_spec = (thresholds[ri] if thresholds is not None
                        else cfg.sw_full_threshold)
            for h in hits:
                e = entries[ri]
                self._normalize_hit(e, h)
                cand.append((ri, h, int(abs_or_pct(thr_spec, h.score_max))))
        if cfg.gapless and cand:
            # hit_run_full_sw always rescores LS hits with the full vector
            # SW (mapping.c:386); in gapless mode the pass1 scores were
            # Kadane scores, so the gate needs real vector scores
            cstarts = np.array([int(idx.contig_offsets[h.cn]) + h.g_off
                                for _, h, _ in cand], np.int64)
            c_rc = np.array([h.gen_st == 1 for _, h, _ in cand], bool)
            Gr = _round_up(max(h.w_len for _, h, _ in cand), 32)
            Rr = _round_up(max(entries[ri].read_len
                               for ri, _, _ in cand), 8)
            gwin_r = np.where(c_rc[:, None],
                              _gather_rows(idx.codes_rc, cstarts, Gr),
                              _gather_rows(idx.codes, cstarts, Gr))
            glen_r = np.array([h.w_len for _, h, _ in cand], np.int32)
            rwin_r = np.full((len(cand), Rr), 254, np.uint8)
            rlen_r = np.zeros(len(cand), np.int32)
            for b, (ri, h, _) in enumerate(cand):
                e = entries[ri]
                rwin_r[b, :e.read_len] = e.codes[e.input_strand]
                rlen_r[b] = e.read_len
            vsc = self._vec_chunked(gwin_r, glen_r, rwin_r, rlen_r)
            for b, (_, h, _) in enumerate(cand):
                h.score_vector = int(vsc[b])
        jobs: List[Tuple[int, Hit]] = []
        job_thresh: List[int] = []
        for ri, h, thresh in cand:
            # LS vector-score gate (mapping.c:386-398); in the gapped
            # default our exact pass1 score equals the rescore
            if h.score_vector >= thresh:
                jobs.append((ri, h))
                job_thresh.append(thresh)
            else:
                h.sw_score = 0
                h.score_full = 0
                h.pct_score_full = 0
        if not jobs:
            return None
        _t0 = _time.perf_counter()
        n = len(jobs)
        G = _round_up(max(max(h.w_len for _, h in jobs), 16), 32)
        R = _round_up(max(entries[ri].read_len for ri, _ in jobs), 8)
        self._check_width(G, MAX_G_LONG, lambda: [
            (entries[ri].name, h.w_len) for ri, h in jobs], "full SW")
        glen = np.ones(n, np.int32)
        rwin = np.full((n, R), 254, np.uint8)
        rlen = np.ones(n, np.int32)
        rect = np.zeros((n, 4), np.int32)
        rev = np.zeros(n, bool)
        aw = cfg.anchor_width
        starts = np.zeros(n, np.int64)
        use_rc = np.zeros(n, bool)
        for b, (ri, h) in enumerate(jobs):
            starts[b] = int(idx.contig_offsets[h.cn]) + h.g_off
            use_rc[b] = h.gen_st == 1
            glen[b] = h.w_len
            rl = entries[ri].read_len
            rwin[b, :rl] = entries[ri].codes[entries[ri].input_strand]
            rlen[b] = rl
            # anchor_widen (anchors.c:57-62)
            rect[b] = (h.ax - aw // 2, h.ay + aw // 2, h.alen, h.awid + aw)
            rev[b] = bool(h.gen_st) and cfg.rev_tiebreak
        gwin = np.where(use_rc[:, None],
                        _gather_rows(idx.codes_rc, starts, G),
                        _gather_rows(idx.codes, starts, G))
        full_kw = dict(match=sc.match, mismatch=sc.mismatch,
                       a_gap_open=sc.a_gap_open, a_gap_ext=sc.a_gap_extend,
                       b_gap_open=sc.b_gap_open, b_gap_ext=sc.b_gap_extend,
                       local_alignment=not cfg.global_alignment)
        # every chunk is queued before _pass2_finish fetches any
        futures = []
        for off in range(0, n, FULL_BATCH):
            sl = slice(off, min(off + FULL_BATCH, n))
            res = sw_full_and_traceback(
                self._upload(gwin[sl]), self._upload(glen[sl], np.int32),
                self._upload(rwin[sl]), self._upload(rlen[sl], np.int32),
                *(self._upload(rect[sl, c], np.int32) for c in range(4)),
                self._upload(rev[sl], np.int32), **full_kw)
            futures.append((off, sl.stop - off, res))
        return (jobs, job_thresh, futures, _t0)

    def _pass2_finish(self, entries: List[ReadEntry], state) -> None:
        """Fetch the full-SW results launched by _pass2_dispatch and fill
        the surviving hits (plus the rare local-band retry)."""
        cfg = self.config
        jobs, job_thresh, futures, _t0 = state
        retries: List[int] = []
        # one copy of each kind for every chunk
        packed_all = torch.cat([pk for _, _, (pk, _) in futures]).cpu()
        ops_all = torch.cat([o for _, _, (_, o) in futures]).cpu()
        packed_all, ops_all = packed_all.numpy(), ops_all.numpy()
        for off, k, _ in futures:
            p = packed_all[off:off + k]
            ops_rev = tb_unpack_ops(ops_all[off:off + k])
            score, mi, mj, nops = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
            rs, gs, m_, mm_, ins, dele = (p[:, 4], p[:, 5], p[:, 6],
                                          p[:, 7], p[:, 8], p[:, 9])
            tb = tb_from_device(ops_rev, nops, rs, gs, mi, mj, m_, mm_,
                                ins, dele)
            for b in range(k):
                ri, h = jobs[off + b]
                self._fill_hit(h, int(score[b]), tb, b)
                if (not cfg.global_alignment
                        and int(score[b]) != h.score_vector):
                    retries.append(off + b)
        if retries:
            self._pass2_local_retry(entries, jobs, job_thresh, retries)
        self.tally(full_invocs=len(jobs),
                   full_cells=sum(h.w_len * entries[ri].read_len
                                  for ri, h in jobs),
                   full_secs=_time.perf_counter() - _t0)

    def _pass2_local_retry(self, entries, jobs, job_thresh, retries
                           ) -> None:
        """Local-mode banded miss: when the banded local DP does not reach
        the vector-SW max, the reference retries with the threshold-derived
        band (sw-full-ls.c:395-398). Rare, so handled one batch at a time.
        """
        cfg = self.config
        sc = cfg.scores
        idx = self.index
        n = len(retries)
        G = _round_up(max(jobs[i][1].w_len for i in retries), 32)
        R = _round_up(max(entries[jobs[i][0]].read_len for i in retries), 8)
        self._check_width(G, MAX_G_LONG, lambda: [
            (entries[jobs[i][0]].name, jobs[i][1].w_len) for i in retries],
            "full SW (local retry)")
        gwin = np.zeros((n, G), np.uint8)
        glen = np.ones(n, np.int32)
        rwin = np.full((n, R), 254, np.uint8)
        rlen = np.ones(n, np.int32)
        rect = np.zeros((n, 4), np.int32)
        rev = np.zeros(n, bool)
        for b, ji in enumerate(retries):
            ri, h = jobs[ji]
            e = entries[ri]
            coff = int(idx.contig_offsets[h.cn])
            src = idx.codes if h.gen_st == 0 else idx.codes_rc
            gwin[b, :h.w_len] = src[coff + h.g_off:coff + h.g_off + h.w_len]
            glen[b] = h.w_len
            rwin[b, :e.read_len] = e.codes[e.input_strand]
            rlen[b] = e.read_len
            y0 = (e.read_len * sc.match - job_thresh[ji]) // sc.match
            rect[b] = _join2_rect((0, y0, 1, 1),
                                  (h.w_len - 1, e.read_len - 1 - y0, 1, 1))
            rev[b] = bool(h.gen_st) and cfg.rev_tiebreak
        packed, ops_rev = sw_full_and_traceback(
            self._upload(gwin), self._upload(glen), self._upload(rwin),
            self._upload(rlen),
            *(self._upload(rect[:, c]) for c in range(4)),
            self._upload(rev, np.int32), match=sc.match, mismatch=sc.mismatch,
            a_gap_open=sc.a_gap_open, a_gap_ext=sc.a_gap_extend,
            b_gap_open=sc.b_gap_open, b_gap_ext=sc.b_gap_extend,
            local_alignment=True)
        p = packed.cpu().numpy()
        ops_rev = tb_unpack_ops(ops_rev.cpu().numpy())
        tb = tb_from_device(ops_rev, p[:, 3], p[:, 4], p[:, 5], p[:, 1],
                            p[:, 2], p[:, 6], p[:, 7], p[:, 8], p[:, 9])
        for b, ji in enumerate(retries):
            ri, h = jobs[ji]
            self._fill_hit(h, int(p[b, 0]), tb, b)

    def _normalize_hit(self, e: ReadEntry, h: Hit) -> None:
        """Strand normalization (reverse_hit, mapping.c:254-263)."""
        if h.st != e.input_strand:
            glen_c = int(self.index.contig_lengths[h.cn])
            h.g_off = glen_c - h.g_off - h.w_len
            ax, ay = h.ax, h.ay
            h.ax = -ax + (h.w_len - 1) - (h.alen - 1) - (h.awid - 1)
            h.ay = -ay + (e.read_len - 1) - (h.alen - 1) + (h.awid - 1)
            h.gen_st = 1 - h.gen_st
            h.st = 1 - h.st

    def _pass2_cs(self, entries: List[ReadEntry],
                  pass1_hits: List[List[Hit]],
                  thresholds: Optional[List[float]] = None) -> None:
        """Colour-space pass2: batched 4-layer full SW + post-SW rescoring
        (hit_run_full_sw mapping.c:375-379, hit_run_post_sw :1609-1614)."""
        cfg = self.config
        sc = cfg.scores
        idx = self.index
        jobs: List[Tuple[int, Hit]] = []
        for ri, hits in enumerate(pass1_hits):
            e = entries[ri]
            for h in hits:
                self._normalize_hit(e, h)
                jobs.append((ri, h))
        if not jobs:
            return
        _t0 = _time.perf_counter()
        n = len(jobs)
        G = _round_up(max(max(h.w_len for _, h in jobs), 16), 32)
        R = _round_up(max(entries[ri].read_len for ri, _ in jobs), 8)
        self._check_width(G, MAX_G, lambda: [
            (entries[ri].name, h.w_len) for ri, h in jobs],
            "colour-space full SW")
        gwin = np.zeros((n, G), np.uint8)
        glen = np.ones(n, np.int32)
        cwin = np.full((n, R), C.BASE_N, np.uint8)
        rlen = np.ones(n, np.int32)
        initbp = np.zeros(n, np.int64)
        rect = np.zeros((n, 4), np.int64)
        rev = np.zeros(n, bool)
        xover_rows = np.full((n, R + 1), sc.crossover, np.int64)
        thresh = np.zeros(n, np.int64)
        aw = cfg.anchor_width
        for b, (ri, h) in enumerate(jobs):
            e = entries[ri]
            thr_spec = (thresholds[ri] if thresholds is not None
                        else cfg.sw_full_threshold)
            thresh[b] = int(abs_or_pct(thr_spec, h.score_max))
            coff = int(idx.contig_offsets[h.cn])
            src = idx.codes if h.gen_st == 0 else idx.codes_rc
            gwin[b, :h.w_len] = src[coff + h.g_off:coff + h.g_off + h.w_len]
            glen[b] = h.w_len
            cwin[b, :e.read_len] = e.codes[h.st]
            rlen[b] = e.read_len
            initbp[b] = e.initbp[h.st]
            rect[b] = (h.ax - aw // 2, h.ay + aw // 2, h.alen, h.awid + aw)
            rev[b] = bool(h.gen_st) and cfg.rev_tiebreak
            if e.crossover_score is not None:
                xover_rows[b, :e.read_len] = e.crossover_score
        cs_kw = dict(match=sc.match, mismatch=sc.mismatch,
                     a_gap_open=sc.a_gap_open, a_gap_ext=sc.a_gap_extend,
                     b_gap_open=sc.b_gap_open, b_gap_ext=sc.b_gap_extend,
                     local_alignment=not cfg.global_alignment,
                     indel_taboo_len=cfg.indel_taboo_len)
        # dispatch every chunk, then one copy of each kind for all of
        # them
        states = []
        for off in range(0, n, CS_FULL_BATCH):
            sl = slice(off, min(off + CS_FULL_BATCH, n))
            states.append((sl.stop - off, sw_full_cs_dispatch(
                gwin[sl], np.maximum(glen[sl], 1), cwin[sl],
                np.maximum(rlen[sl], 1), initbp[sl], rect[sl, 0],
                rect[sl, 1], np.maximum(rect[sl, 2], 1),
                np.maximum(rect[sl, 3], 1), rev[sl], xover_rows[sl],
                thresh[sl], device=self.device, **cs_kw)))
        packed_all = torch.cat([s[0] for _, s in states]).cpu().numpy()
        steps_all = torch.cat([s[1] for _, s in states]).cpu().numpy()
        chunks, off = [], 0
        for k, st in states:
            chunks.append((k, sw_full_cs_finish(
                st, fetched=(packed_all[off:off + k],
                             steps_all[off:off + k]))))
            off += k
        res = _concat_cs_results(chunks)
        post_jobs = []
        for b, (ri, h) in enumerate(jobs):
            e = entries[ri]
            score = int(res.score[b])
            h.sw_score = score
            h.score_full = score
            h.pct_score_full = (1000 * 100 * score) // h.score_max
            if score == 0:
                continue
            h.read_start = int(res.read_start[b])
            h.genome_start = int(res.genome_start[b]) + h.g_off
            h.rmapped = int(res.rmapped[b])
            h.gmapped = int(res.gmapped[b])
            h.matches = int(res.matches[b])
            h.mismatches = int(res.mismatches[b])
            h.insertions = int(res.insertions[b])
            h.deletions = int(res.deletions[b])
            h.crossovers = int(res.crossovers[b])
            steps = res.steps[b, :res.n_steps[b]]
            h.ops = (steps & 3).astype(np.int8)
            h.dbalign, h.qralign = _cs_strings(
                steps, gwin[b], res.qr[b], h.read_start, h.genome_start
                - h.g_off)
            if cfg.compute_mapping_qualities and h.score_full > 0:
                post_jobs.append((e, h))
        if post_jobs:
            self._post_sw_cs_batch(post_jobs)
        self.tally(full_invocs=n,
                   full_cells=sum(h.w_len * entries[ri].read_len
                                  for ri, h in jobs) * 4,
                   full_secs=_time.perf_counter() - _t0)

    def _post_sw_cs_batch(self, post_jobs) -> None:
        """Batched post-SW: per-hit column extraction, one forward-backward
        over the padded batch, per-hit finishing.  Gapless quality-less
        alignments (the vast majority) run through fully vectorized
        column extraction and finishing; gapped or quality-carrying
        hits take the faithful per-hit path."""
        cfg = self.config
        cal = self.cal
        fast_jobs = []
        slow_jobs = []
        for e, h in post_jobs:
            q = (e.qual if e.qual is not None and not cfg.ignore_qvs
                 else None)
            if q is None and "-" not in h.dbalign \
                    and "-" not in h.qralign:
                fast_jobs.append((e, h))
            else:
                slow_jobs.append((e, h))
        if fast_jobs:
            self._post_sw_cs_batch_gapless(fast_jobs)
        post_jobs = slow_jobs
        if not post_jobs:
            return
        cols = []
        for e, h in post_jobs:
            qual = ((e.qual_buf if e.qual_buf is not None else e.qual)
                    if e.qual is not None and not cfg.ignore_qvs
                    else None)
            cols.append(sw_cs_np.extract_columns(
                e.codes[h.st], e.initbp[h.st], qual, h.read_start,
                h.dbalign, h.qralign, cal.pr_xover, cfg.qual_delta))
        B = len(post_jobs)
        L = max(len(c[1]) for c in cols)
        cl = np.full((B, L), -1, np.int64)
        cc = np.zeros((B, L), np.int64)
        ce = np.full((B, L), 0.5, np.float64)
        nc = np.zeros(B, np.int64)
        ib = np.array([e.initbp[h.st] for e, h in post_jobs], np.int64)
        for b, (let, col, err, _) in enumerate(cols):
            k = len(col)
            cl[b, :k] = let
            cc[b, :k] = col
            ce[b, :k] = err
            nc[b] = k
        total, post = post_sw_forward_backward_batch(
            cl, cc, ce, nc, ib, cal.pr_mismatch)
        for b, (e, h) in enumerate(post_jobs):
            r = sw_cs_np.post_sw_finish(
                int(ib[b]), h.dbalign, h.qralign, cols[b][1], cols[b][3],
                float(total[b]), post[b], cal.pr_del_open,
                cal.pr_del_extend, cal.pr_ins_open, cal.pr_ins_extend)
            h.posterior = r.posterior
            h.qralign = r.qralign
            h.matches = r.matches
            h.mismatches = r.mismatches
            h.crossovers = r.crossovers
            h.qual_str = r.qual
            ps = int(round(cal.alpha * math.log2(h.posterior)
                           + h.rmapped * (2 * cal.alpha + cal.beta)))
            h.posterior_score = max(ps, 0)
            h.score_full = h.posterior_score
            h.pct_score_full = (1000 * 100 * h.posterior_score
                                ) // h.score_max

    def _post_sw_cs_batch_gapless(self, post_jobs) -> None:
        """Vectorized post-SW for gapless, quality-less hits: batched
        column extraction, one forward-backward, batched base-call
        rewrite — bit-identical to the per-hit path (same f64 math in
        the same order)."""
        cal = self.cal
        B = len(post_jobs)
        ncols = np.array([h.rmapped for _, h in post_jobs], np.int64)
        Lmax = int(ncols.max())
        Rmax = max(e.read_len for e, _ in post_jobs)
        colours = np.full((B, Rmax), C.BASE_N, np.uint8)
        rs = np.empty(B, np.int64)
        ib = np.empty(B, np.int64)
        db_codes = np.full((B, Lmax), C.BASE_N, np.int64)
        qr_codes = np.full((B, Lmax), C.BASE_N, np.int64)
        for b, (e, h) in enumerate(post_jobs):
            colours[b, :e.read_len] = e.codes[h.st]
            rs[b] = h.read_start
            ib[b] = e.initbp[h.st]
            n = int(ncols[b])
            dbb = np.frombuffer(h.dbalign.encode(), np.uint8)
            qrb = np.frombuffer(h.qralign.encode(), np.uint8)
            db_codes[b, :n] = sw_cs_np._C2I_LUT[
                sw_cs_np._UPPER_LUT[dbb]]
            qr_codes[b, :n] = sw_cs_np._C2I_LUT[
                sw_cs_np._UPPER_LUT[qrb]]
        cl, cc, ce, bc, _ = sw_cs_np.extract_columns_batch_gapless(
            colours, rs, ncols, db_codes, qr_codes, cal.pr_xover)
        total, post = post_sw_forward_backward_batch(
            cl, cc, ce, ncols, ib, cal.pr_mismatch)
        res = sw_cs_np.post_sw_finish_batch_gapless(
            ib, db_codes, cc, bc, ncols, total, post)
        for (e, h), r in zip(post_jobs, res):
            h.posterior = r.posterior
            h.qralign = r.qralign
            h.matches = r.matches
            h.mismatches = r.mismatches
            h.crossovers = r.crossovers
            h.qual_str = r.qual
            ps = int(round(cal.alpha * math.log2(h.posterior)
                           + h.rmapped * (2 * cal.alpha + cal.beta)))
            h.posterior_score = max(ps, 0)
            h.score_full = h.posterior_score
            h.pct_score_full = (1000 * 100 * h.posterior_score
                                ) // h.score_max

    def _post_sw_cs(self, e: ReadEntry, h: Hit) -> None:
        """post_sw + posterior_score (mapping.c:1609-1625)."""
        cfg = self.config
        cal = self.cal
        qual = ((e.qual_buf if e.qual_buf is not None else e.qual)
                if e.qual is not None and not cfg.ignore_qvs
                else None)
        res = sw_cs_np.post_sw(
            e.codes[h.st], e.initbp[h.st], qual, h.read_start,
            h.dbalign, h.qralign,
            pr_snp=cal.pr_mismatch, pr_xover=cal.pr_xover,
            pr_del_open=cal.pr_del_open, pr_del_extend=cal.pr_del_extend,
            pr_ins_open=cal.pr_ins_open, pr_ins_extend=cal.pr_ins_extend,
            qual_delta=cfg.qual_delta)
        h.posterior = res.posterior
        h.qralign = res.qralign
        h.matches = res.matches
        h.mismatches = res.mismatches
        h.crossovers = res.crossovers
        h.qual_str = res.qual
        ps = int(round(cal.alpha * math.log2(h.posterior)
                       + h.rmapped * (2 * cal.alpha + cal.beta)))
        h.posterior_score = max(ps, 0)
        h.score_full = h.posterior_score
        h.pct_score_full = (1000 * 100 * h.posterior_score) // h.score_max

    def _fill_hit(self, h: Hit, score: int, tb: TracebackResult, b: int
                  ) -> None:
        cfg = self.config
        h.sw_score = score
        h.read_start = int(tb.read_start[b])
        h.genome_start = int(tb.genome_start[b]) + h.g_off
        h.rmapped = int(tb.rmapped[b])
        h.gmapped = int(tb.gmapped[b])
        h.matches = int(tb.matches[b])
        h.mismatches = int(tb.mismatches[b])
        h.insertions = int(tb.insertions[b])
        h.deletions = int(tb.deletions[b])
        h.ops = tb.ops[b, :tb.n_ops[b]]
        h.score_full = score
        h.pct_score_full = (1000 * 100 * h.score_full) // h.score_max
        if cfg.compute_mapping_qualities and h.score_full > 0:
            self._post_sw_ls(h)

    def _post_sw_ls(self, h: Hit) -> None:
        """LS posterior shortcut (hit_run_post_sw, mapping.c:1609-1625)."""
        cal = self.cal
        h.posterior = math.pow(
            2.0, (h.sw_score - h.rmapped * (2 * cal.alpha + cal.beta))
            / cal.alpha)
        ps = int(round(cal.alpha * math.log2(h.posterior)
                       + h.rmapped * (2 * cal.alpha + cal.beta)))
        h.posterior_score = max(ps, 0)
        h.score_full = h.posterior_score
        h.pct_score_full = (1000 * 100 * h.posterior_score) // h.score_max

    # ----------------------------------------------------- pass2 filtering
    def _finalize(self, re: ReadEntry, hits_pass1: List[Hit],
                  p2: Optional[Pass2Options] = None,
                  fresh: Optional[set] = None) -> List[Hit]:
        """Threshold, duplicate removal, score sort, trims
        (read_pass2, mapping.c:1631-1750).

        p2 carries the per-option-set pass2 knobs; defaults mirror the
        single-set config. fresh, when given, is the set of id(hit) whose
        full SW ran this round — only those get a new pass2_key
        (mapping.c:1646-1659 assigns it inside the recompute branch)."""
        cfg = self.config
        threshold = cfg.sw_full_threshold if p2 is None else p2.threshold
        num_outputs = cfg.num_outputs if p2 is None else p2.num_outputs
        strata = cfg.strata if p2 is None else p2.strata
        absolute = is_absolute(threshold)
        survivors = []
        for h in hits_pass1:
            if fresh is None or id(h) in fresh:
                h.pass2_key = (h.score_full if absolute
                               else h.pct_score_full)
            if h.score_full >= abs_or_pct(threshold, h.score_max):
                survivors.append(h)

        if len(survivors) > 1:
            survivors = _dedup(survivors, lambda h: (h.cn, h.gen_st,
                                                     h.genome_start))
            survivors = _dedup(survivors, lambda h: (
                h.cn, h.gen_st, -h.genome_start - h.rmapped + h.deletions
                - h.insertions))
            # stable sort by non-increasing key (mapping.c:1678)
            survivors.sort(key=lambda h: -h.pass2_key)
        if len(survivors) > num_outputs:
            survivors = survivors[:num_outputs]
        if strata and survivors:
            i = 1
            while (i < len(survivors)
                   and survivors[0].score_full == survivors[i].score_full):
                i += 1
            survivors = survivors[:i]
        if survivors and cfg.max_alignments and \
                len(survivors) > cfg.max_alignments:
            survivors = []
        for h in survivors:
            h.saved = 1
        return survivors

    # ------------------------------------------------------------------ MQV
    def _compute_mqv(self, hits: List[Hit]) -> None:
        """compute_unpaired_mqv (output.c:777-793)."""
        z1 = sum(h.posterior for h in hits)
        for h in hits:
            h.z0 = h.posterior
            h.z1 = z1
            h.mqv = qv_from_pr_corr(h.posterior / z1)
            if h.mqv < 4:
                h.mqv = 0

    # ------------------------------------------------- batched candidate gen
    def _mp_context(self, sub: List[ReadEntry], mp_mode: int) -> dict:
        """Mate-pair region-filter inputs (read_get_mp_region_counts,
        mapping.c:545-608): each sub owner's view of its mate's
        opposite-strand region marks, rebased to this batch's owner key
        space, plus the per-(read,strand) region delta ranges."""
        cfg = self.config
        n_reg = (self.index.total_len >> cfg.region_bits) + 2
        mates = [e.mate_pair for e in sub]
        mate_marks: List[List[Optional[np.ndarray]]] = \
            [[None, None, None, None] for _ in mates]   # m1_st0,m1_st1,m2_..
        by_len: Dict[int, List[int]] = {}
        for k, e in enumerate(mates):
            by_len.setdefault(e.read_len, []).append(k)
        for L, idxs in by_len.items():
            codes = np.empty((len(idxs), 2, L), np.uint8)
            for j, k in enumerate(idxs):
                codes[j, 0] = mates[k].codes[0]
                codes[j, 1] = mates[k].codes[1]
            ids1, ids2 = bp.region_mark_keys(
                self.index, codes, L, self.cutoff,
                min_kmer_pos=mates[idxs[0]].min_kmer_pos,
                region_bits=cfg.region_bits,
                region_overlap=cfg.region_overlap)
            for j, k in enumerate(idxs):
                for st in (0, 1):
                    o = 2 * j + st
                    s1 = slice(np.searchsorted(ids1, o * n_reg),
                               np.searchsorted(ids1, (o + 1) * n_reg))
                    s2 = slice(np.searchsorted(ids2, o * n_reg),
                               np.searchsorted(ids2, (o + 1) * n_reg))
                    mate_marks[k][st] = ids1[s1] - o * n_reg
                    mate_marks[k][2 + st] = ids2[s2] - o * n_reg
        n_owners = 2 * len(sub)
        m1_chunks, m2_chunks = [], []
        drmin = np.zeros(n_owners, np.int64)
        drmax = np.zeros(n_owners, np.int64)
        for k, e in enumerate(sub):
            for st in (0, 1):
                o = 2 * k + st
                m1_chunks.append(o * n_reg + mate_marks[k][1 - st])
                m2_chunks.append(o * n_reg + mate_marks[k][2 + 1 - st])
                drmin[o] = e.delta_region_min[st]
                drmax[o] = e.delta_region_max[st]
        return dict(mp_mode=mp_mode,
                    mp_mate_m1=np.concatenate(m1_chunks),
                    mp_mate_m2=np.concatenate(m2_chunks),
                    mp_drmin=drmin, mp_drmax=drmax)

    def _flat_hits(self, sub: List[ReadEntry], rl: int, opts):
        """Flat cross-read candidate generation for reads of one length."""
        cfg = self.config
        codes = np.empty((len(sub), 2, rl), np.uint8)
        for k, e in enumerate(sub):
            codes[k, 0] = e.codes[0]
            codes[k, 1] = e.codes[1]
        kw = dict(
            min_kmer_pos=sub[0].min_kmer_pos,
            use_region_counts=opts.anchor_list.use_region_counts,
            region_bits=cfg.region_bits,
            region_overlap=cfg.region_overlap,
            collapse=opts.anchor_list.collapse,
            gapless=opts.hit_list.gapless,
            search_strands=(cfg.search_forward, cfg.search_reverse))
        args = (self.index, codes, rl, sub[0].window_len,
                self.cutoff, opts.hit_list.match_mode,
                opts.hit_list.threshold, cfg.scores.match,
                cfg.scores.b_gap_open, cfg.scores.b_gap_extend)
        mp_mode = opts.anchor_list.use_mp_region_counts
        if (mp_mode and opts.anchor_list.use_region_counts
                and all(e.mate_pair is not None for e in sub)):
            # mate-pair region filter: native when the batch is
            # interleaved same-length pairs, else python pipeline
            if (len(sub) % 2 == 0
                    and all(sub[i].mate_pair is sub[i ^ 1]
                            for i in range(len(sub)))):
                drmin = np.empty(2 * len(sub), np.int64)
                drmax = np.empty(2 * len(sub), np.int64)
                for k, e in enumerate(sub):
                    for st in (0, 1):
                        drmin[2 * k + st] = e.delta_region_min[st]
                        drmax[2 * k + st] = e.delta_region_max[st]
                fh = generate_candidates_native(
                    *args, mp_mode=mp_mode, mp_drmin=drmin,
                    mp_drmax=drmax, threads=self.f1_threads, **kw)
                if fh is not None:
                    return fh
            kw.update(self._mp_context(sub, mp_mode))
            return bp.generate_candidates(*args, **kw)
        # the numpy filter 1 takes the shapes the native one refuses
        fh = generate_candidates_native(*args, threads=self.f1_threads,
                                        **kw)
        if fh is None:
            fh = bp.generate_candidates(*args, **kw)
        return fh

    def hit_lists_batched(self, entries: List[ReadEntry], opts=None
                          ) -> List[List[candidates.HitList]]:
        """Cross-read flat-array candidate generation; same results as
        hit_lists() per read (see core/batch_pipeline.py)."""
        if opts is None:
            opts = self._unpaired_opts[0]
        out: List[Optional[List[candidates.HitList]]] = [None] * len(entries)
        by_len: Dict[int, List[int]] = {}
        for i, e in enumerate(entries):
            by_len.setdefault(e.read_len, []).append(i)
        for rl, idxs in by_len.items():
            fh = self._flat_hits([entries[i] for i in idxs], rl, opts)
            for k, i in enumerate(idxs):
                pair = []
                for st in (0, 1):
                    a, b = fh.seg_start[2 * k + st], fh.seg_start[2 * k
                                                                  + st + 1]
                    pair.append(candidates.HitList(
                        st=st, cn=fh.cn[a:b], g_off=fh.g_off[a:b],
                        w_len=fh.w_len[a:b],
                        score_window_gen=fh.score_window_gen[a:b],
                        matches=fh.matches[a:b], score_max=fh.score_max[a:b],
                        ax=fh.ax[a:b], ay=fh.ay[a:b],
                        alen=fh.alen[a:b].astype(np.int32),
                        awid=fh.awid[a:b].astype(np.int32),
                        aweight=fh.matches[a:b]))
                out[i] = pair
        return out  # type: ignore[return-value]

    def _score_windows_fh(self, sub: List[ReadEntry], fh, defer=False):
        """Vector-SW scores for a FlatHits batch (same values as
        _score_windows, without per-read slicing). With defer=True the
        device launches are dispatched now and a thunk returning the
        scores is returned, so the fetch can overlap later host work."""
        idx = self.index
        n = fh.n
        if n == 0:
            z = np.zeros(0, np.int64)
            return (lambda: z) if defer else z
        ri_a = (fh.owner >> 1).astype(np.int64)
        st_a = (fh.owner & 1).astype(np.int64)
        goff_a = idx.contig_offsets[fh.cn].astype(np.int64) + fh.g_off
        wl_a = fh.w_len.astype(np.int64)
        G = _round_up(max(int(wl_a.max()), 16), 32)
        R = _round_up(max(e.read_len for e in sub), 8)
        glen = wl_a.astype(np.int32)
        rlens = np.array([e.read_len for e in sub], np.int32)
        rlen = rlens[ri_a]
        if self._unpaired_opts[0].pass1.gapless:
            g = self._gapless_scores(sub, ri_a, st_a, goff_a,
                                     fh.ax, fh.ay, rlens)
            return (lambda: g) if defer else g
        self._check_width(G, MAX_G_LONG, lambda: _named(sub, ri_a, wl_a),
                          "vector SW")
        if self.config.mode == C.MODE_LETTER_SPACE:
            rtab = np.full((len(sub) * 2, R), 254, np.uint8)
            for ri, e in enumerate(sub):
                rtab[2 * ri, :e.read_len] = e.codes[0]
                rtab[2 * ri + 1, :e.read_len] = e.codes[1]
            st = self._vec_dispatch_idx(goff_a, glen, fh.owner, rtab, rlen,
                                        G)
            return (lambda: self._vec_finish(st)) if defer \
                else self._vec_finish(st)
        # colour space (see _score_windows for the coordinate notes):
        # strand-normalized window starts + initbp ship to the device,
        # colour/letter windows and g_row0 are gathered there
        inp = np.array([e.input_strand for e in sub], np.int64)
        eff_rc = st_a != inp[ri_a]
        cn_a = idx.contig_of(goff_a)
        coff2 = idx.contig_offsets[cn_a].astype(np.int64)
        clen2 = idx.contig_lengths[cn_a].astype(np.int64)
        local = goff_a - coff2
        local_rc = clen2 - local - wl_a
        starts = coff2 + np.where(eff_rc, local_rc, local)
        initbp = np.array([e.initbp[0] for e in sub], np.int64)
        rtab = np.full((len(sub) * 2, R), 254, np.uint8)
        for ri, e in enumerate(sub):
            rtab[2 * ri, :e.read_len] = e.codes[e.input_strand]
            rtab[2 * ri + 1, :e.read_len] = e.codes[e.input_strand]
        st2 = self._vec_dispatch_cs_idx(starts, glen,
                                        eff_rc.astype(np.int32), fh.owner,
                                        rtab, rlen, initbp[ri_a], G)
        return (lambda: self._vec_finish(st2)) if defer \
            else self._vec_finish(st2)

    def _pass1_select_flat(self, sub: List[ReadEntry], fh,
                           scores: np.ndarray) -> List[List[Hit]]:
        """Batch-vectorized _pass1_select_fast: one threshold/percent
        computation over the whole FlatHits batch, then a Python walk over
        only the passing candidates (few per read)."""
        opts = self._unpaired_opts[0].pass1
        out: List[List[Hit]] = [[] for _ in sub]
        if fh.n == 0:
            return out
        wlen = sub[0].window_len
        ov = int(abs_or_pct(opts.window_overlap, wlen))
        absolute = is_absolute(opts.threshold)
        smax = fh.score_max.astype(np.int64)
        if absolute:
            passing = scores >= int(-opts.threshold)
        else:
            tvec = np.trunc(smax * (opts.threshold / 100.0)
                            ).astype(np.int64)
            passing = scores >= tvec
        if opts.min_matches > 1:
            passing &= fh.matches >= opts.min_matches
        idxs = np.nonzero(passing)[0]
        if len(idxs) == 0:
            return out
        sv_p = scores[idxs]
        smax_p = smax[idxs]
        pct_p = (1000 * 100 * sv_p) // smax_p
        key_p = sv_p if absolute else pct_p
        owner_p = fh.owner[idxs].tolist()
        cn_p = fh.cn[idxs].tolist()
        goff_p = fh.g_off[idxs].tolist()
        sv_l = sv_p.tolist()
        pct_l = pct_p.tolist()
        key_l = key_p.tolist()
        gi_l = idxs.tolist()
        seg = fh.seg_start
        num = opts.num_outputs
        heap: Optional[ExtHeap] = None
        cur_read = -1
        cur_owner = -1
        last_cn = -1
        last_goff = 0
        for k in range(len(gi_l)):
            ow = owner_p[k]
            if ow != cur_owner:
                ri = ow >> 1
                if ri != cur_read:
                    if heap is not None and heap.load:
                        out[cur_read] = list(heap.a)
                        heap = None
                    cur_read = ri
                cur_owner = ow
                last_cn = -1
            cn = cn_p[k]
            goff = goff_p[k]
            if (last_cn >= 0 and cn == last_cn
                    and goff + ov <= last_goff + wlen):
                continue  # window-overlap suppressed (mapping.c:1287-1335)
            last_cn, last_goff = cn, goff
            key = key_l[k]
            if heap is not None and heap.load >= num and key <= heap.min_key:
                continue
            gi = gi_l[k]
            st = ow & 1
            h = Hit(st=st, gen_st=0, cn=cn, g_off=goff,
                    g_off_pos_strand=goff, w_len=int(fh.w_len[gi]),
                    score_window_gen=int(fh.score_window_gen[gi]),
                    kmer_matches=int(fh.matches[gi]),
                    score_vector=sv_l[k], score_max=int(smax[gi]),
                    ax=int(fh.ax[gi]), ay=int(fh.ay[gi]),
                    alen=int(fh.alen[gi]), awid=int(fh.awid[gi]),
                    sort_idx=gi - int(seg[2 * (ow >> 1)]),
                    pass1_key=key, pct_score_vector=pct_l[k])
            if heap is None:
                heap = ExtHeap(num)
            if heap.load < num:
                heap.insert(h)
            else:
                heap.replace_min(h)
        if heap is not None and heap.load:
            out[cur_read] = list(heap.a)
        return out

    # ------------------------------------------------------------- pipeline
    # The unpaired flow is split into three stages so a streaming caller
    # can software-pipeline batches: while one batch's device launches are
    # in flight, the next batch's host-side filter 1 runs (the reference's
    # fill/parse overlap, mergesam.c:694-701, recast for the device queue).
    def _prepare_batch_ls(self, records: Sequence[SeqRecord]
                          ) -> Optional[List[ReadEntry]]:
        """Batch-encode uniform-length letter-space reads: one LUT pass
        over a [B, L] byte matrix instead of B per-read encodes. Returns
        None (caller falls back to prepare_read) on mixed lengths or
        invalid characters."""
        cfg = self.config
        if cfg.mode != C.MODE_LETTER_SPACE or not records:
            return None
        if cfg.trim_front or cfg.trim_end or cfg.trim_illumina:
            return None  # raw-string trims: per-read prepare_read path
        if (not cfg.ignore_qvs
                and (cfg.min_avg_qv >= 0 or not cfg.no_qv_check)
                and any(r.qual is not None for r in records)):
            return None  # qv gating runs in prepare_read
        L = len(records[0].seq)
        if L == 0 or L > cfg.longest_read_len:
            return None
        try:
            buf = "".join(r.seq for r in records).encode("ascii")
        except UnicodeEncodeError:
            return None
        if len(buf) != len(records) * L:
            return None
        raw = np.frombuffer(buf, np.uint8).reshape(len(records), L)
        codes = C.CHAR_TO_INT[raw]
        if (codes < 0).any():
            return None
        codes = codes.astype(np.uint8)
        rc = C.COMPLEMENT[codes[:, ::-1]]
        wlen = int(abs_or_pct(cfg.window_len, L))
        return [ReadEntry(name=r.name, seq=r.seq, qual=r.qual, read_len=L,
                          codes=(codes[i], rc[i]), window_len=wlen,
                          min_kmer_pos=0, initbp=(-1, -1))
                for i, r in enumerate(records)]

    def _stage_candidates(self, records: Sequence[SeqRecord]):
        """Stage A: read prep + filter 1 + async vector-SW dispatch."""
        t0 = _time.perf_counter()
        entries = self._prepare_batch_ls(records)
        if entries is None:
            entries = []
            for rec in records:
                re = self.prepare_read(rec)
                if re is not None:
                    entries.append(re)
        t1 = _time.perf_counter()
        self.tally("read prep", t1 - t0)
        by_len: Dict[int, List[int]] = {}
        for i, e in enumerate(entries):
            by_len.setdefault(e.read_len, []).append(i)
        opts0 = self._unpaired_opts[0]
        buckets = []
        for rl, idxs in by_len.items():
            sub = [entries[i] for i in idxs]
            fh = self._flat_hits(sub, rl, opts0)
            thunk = self._score_windows_fh(sub, fh, defer=True)
            buckets.append((idxs, sub, fh, thunk))
        self.tally("filter1 + dispatch", _time.perf_counter() - t1)
        return entries, buckets

    def _stage_pass1(self, ctx):
        """Stage B: fetch vector scores, select pass1 hits, dispatch the
        full-SW batches."""
        t0 = _time.perf_counter()
        entries, buckets = ctx
        pass1: List[List[Hit]] = [[] for _ in entries]
        for idxs, sub, fh, thunk in buckets:
            p1 = self._pass1_select_flat(sub, fh, thunk())
            for k, i in enumerate(idxs):
                pass1[i] = p1[k]
        self.tally("pass1 select", _time.perf_counter() - t0)
        state = self._pass2_dispatch(entries, pass1)
        return entries, pass1, state

    def _stage_finish(self, ctx2) -> List[Tuple[ReadEntry, List[Hit]]]:
        """Stage C: fetch full-SW results, finalize, MQVs."""
        entries, pass1, state = ctx2
        if state is not None:
            self._pass2_finish(entries, state)
        t0 = _time.perf_counter()
        results = []
        for re, hits in zip(entries, pass1):
            final = self._finalize(re, hits)
            if final:
                re.mapped = True
                if (self.config.pair_mode == C.PAIR_NONE
                        and self.config.compute_mapping_qualities):
                    self._compute_mqv(final)
                    if self.config.single_best_mapping:
                        best = max(range(len(final)),
                                   key=lambda i: (final[i].mqv, -i))
                        final = [final[best]]
            results.append((re, final))
        self.tally("finalize + mqv", _time.perf_counter() - t0,
                   reads=len(entries),
                   reads_mapped=sum(1 for _, f in results if f),
                   alignments=sum(len(f) for _, f in results))
        return results

    # ------------------------------------------- multi-round option sets
    @property
    def multi_round(self) -> bool:
        """True when the unpaired option sets need the full handle_read
        fallthrough loop rather than the single-set fast pipeline."""
        if self.config.pair_mode != C.PAIR_NONE:
            return False
        o = self._unpaired_opts
        return (len(o) > 1 or o[0].pass2.stop_count > 0
                or o[0].pass2.save_outputs
                or not (o[0].anchor_list.recompute
                        and o[0].hit_list.recompute
                        and o[0].pass1.recompute))

    @staticmethod
    def _new_cache() -> dict:
        """Per-read cross-round state (the read_entry fields handle_read
        carries between option sets: region map, anchor/hit lists and
        their vector scores)."""
        return {"regions_valid": False, "anchor_opts": None,
                "hits2": None, "hl2": None, "scores": {}}

    def _round_candidates(self, entries: List[ReadEntry], idxs: List[int],
                          caches: List[dict], opts) -> None:
        """(Re)build hit lists for this round's reads, honouring cached
        stage options for stages with recompute=False (handle_read,
        mapping.c:1792-1808). A stage that was never computed behaves
        like the reference's NULL list: no candidates."""
        from dataclasses import replace as _replace
        groups: Dict[tuple, List[int]] = {}
        for i in idxs:
            c = caches[i]
            if opts.regions.recompute:
                c["regions_valid"] = True
            if opts.anchor_list.recompute:
                c["anchor_opts"] = opts.anchor_list
            if not opts.hit_list.recompute:
                if c["hits2"] is None:
                    c["hits2"] = [[], []]
                    c["hl2"] = None
                    c["scores"] = {}
                continue
            al = c["anchor_opts"]
            if al is None or (al.use_region_counts
                              and not c["regions_valid"]):
                c["hits2"] = [[], []]
                c["hl2"] = None
                c["scores"] = {}
                continue
            groups.setdefault((al.collapse, al.use_region_counts,
                               al.use_mp_region_counts), []).append(i)
        for (collapse, use_rc, use_mp), g in groups.items():
            eff = ReadMappingOptions(
                anchor_list=_replace(opts.anchor_list, collapse=collapse,
                                     use_region_counts=use_rc,
                                     use_mp_region_counts=use_mp),
                hit_list=opts.hit_list, pass1=opts.pass1,
                pass2=opts.pass2)
            sub = [entries[i] for i in g]
            hls = self.hit_lists_batched(sub, eff)
            for k, i in enumerate(g):
                caches[i]["hits2"] = self._make_hits(hls[k])
                caches[i]["hl2"] = hls[k]
                caches[i]["scores"] = {}

    def _round_scores(self, entries: List[ReadEntry], idxs: List[int],
                      caches: List[dict], gapless: bool) -> None:
        """Vector-SW scores for this round's hit lists, cached per
        gapless flag (read_pass1 scores with options->gapless)."""
        empty = [np.zeros(0, np.int64), np.zeros(0, np.int64)]
        need = []
        for i in idxs:
            c = caches[i]
            if gapless in c["scores"]:
                continue
            if c["hl2"] is None:
                c["scores"][gapless] = empty
            else:
                need.append(i)
        if need:
            sub = [entries[i] for i in need]
            raw = self._score_windows(sub, [caches[i]["hl2"]
                                            for i in need],
                                      gapless=gapless)
            for k, i in enumerate(need):
                caches[i]["scores"][gapless] = raw[k]

    def _run_option_sets(self, entries: List[ReadEntry], opts_list,
                         caches: Optional[List[dict]] = None
                         ) -> Tuple[List[List[List[Hit]]], List[int]]:
        """handle_read's option-set fallthrough loop (mapping.c:1773-1850)
        batched over reads.

        Returns (emitted, fell_through): emitted[i] is the per-round list
        of final hit lists output for read i (rounds with
        pass2.save_outputs instead accumulate on
        entries[i].final_unpaired_hits); fell_through lists the reads
        that were not stopped by any option set. caches may be
        pre-seeded (the half-paired fallback reuses the paired round's
        hit lists, mapping.c:2607-2611)."""
        cfg = self.config
        if caches is None:
            caches = [self._new_cache() for _ in entries]
        emitted: List[List[List[Hit]]] = [[] for _ in entries]
        active = list(range(len(entries)))
        for opts in opts_list:
            if not active:
                break
            self._round_candidates(entries, active, caches, opts)
            if opts.pass1.recompute:
                self._round_scores(entries, active, caches,
                                   opts.pass1.gapless)
                for i in active:
                    c = caches[i]
                    self._pass1_walk(entries[i], c["hits2"],
                                     c["scores"][opts.pass1.gapless],
                                     opts.pass1)
            sels = [self._get_vector_hits(caches[i]["hits2"], opts.pass1)
                    for i in active]
            # full SW only for hits never run: score_full < 0 is exactly
            # the reference's sfrp == NULL (hit_run_full_sw always
            # allocates sfrp and sets score_full >= 0, mapping.c:364-402)
            jobs = [[h for h in sel if h.score_full < 0] for sel in sels]
            fresh = {id(h) for js in jobs for h in js}
            if any(jobs):
                self._pass2([entries[i] for i in active], jobs,
                            [opts.pass2.threshold] * len(jobs))
            still = []
            for k, i in enumerate(active):
                e = entries[i]
                final = self._finalize(e, sels[k], p2=opts.pass2,
                                       fresh=fresh)
                if final:
                    e.mapped = True
                    if opts.pass2.save_outputs:
                        e.final_unpaired_hits.extend(final)
                    else:
                        if (cfg.compute_mapping_qualities
                                and cfg.pair_mode == C.PAIR_NONE):
                            self._compute_mqv(final)
                            if cfg.single_best_mapping:
                                best = max(range(len(final)),
                                           key=lambda j: (final[j].mqv,
                                                          -j))
                                final = [final[best]]
                        emitted[i].append(final)
                # stop condition (read_pass2, mapping.c:1736-1749)
                if opts.pass2.stop_count == 0:
                    done = True
                else:
                    cnt = sum(1 for h in final if h.score_full >= int(
                        abs_or_pct(opts.pass2.stop_threshold,
                                   h.score_max)))
                    done = cnt >= opts.pass2.stop_count
                if not done:
                    still.append(i)
            active = still
        return emitted, active

    def _map_unpaired_multi(self, records: Sequence[SeqRecord]
                            ) -> List[Tuple[ReadEntry, List[Hit]]]:
        entries = self._prepare_batch_ls(records)
        if entries is None:
            entries = []
            for rec in records:
                re = self.prepare_read(rec)
                if re is not None:
                    entries.append(re)
        emitted, _ = self._run_option_sets(entries, self._unpaired_opts)
        results = []
        for e, rounds in zip(entries, emitted):
            results.append((e, [h for r in rounds for h in r]))
        self.tally(reads=len(entries),
                   reads_mapped=sum(1 for _, f in results if f),
                   alignments=sum(len(f) for _, f in results))
        return results

    def map_unpaired(self, records: Sequence[SeqRecord]
                     ) -> List[Tuple[ReadEntry, List[Hit]]]:
        if self.multi_round:
            return self._map_unpaired_multi(records)
        return self._stage_finish(self._stage_pass1(
            self._stage_candidates(records)))

    def map_unpaired_stream(self, records: Sequence[SeqRecord],
                            batch_size: int = 8192):
        """Pipelined unpaired mapping: yields per-read results in input
        order while overlapping host filter work with in-flight device
        batches (stage A of batch i runs before the fetches of batches
        i-1/i-2)."""
        if self.multi_round:
            for off in range(0, len(records), batch_size):
                yield from self._map_unpaired_multi(
                    records[off:off + batch_size])
            return
        pend_a = None   # stage-A ctx awaiting stage B
        pend_b = None   # stage-B ctx awaiting stage C
        for off in range(0, len(records), batch_size):
            a = self._stage_candidates(records[off:off + batch_size])
            if pend_b is not None:
                yield from self._stage_finish(pend_b)
            pend_b = self._stage_pass1(pend_a) if pend_a is not None \
                else None
            pend_a = a
        if pend_a is not None:
            b = self._stage_pass1(pend_a)
            if pend_b is not None:
                yield from self._stage_finish(pend_b)
            yield from self._stage_finish(b)
        elif pend_b is not None:
            yield from self._stage_finish(pend_b)


_LS_CHARS = "ACGTUMRWSYKVHDBN"


def _cs_strings(steps: np.ndarray, gwin: np.ndarray, qr: np.ndarray,
                read_start: int, genome_start: int) -> Tuple[str, str]:
    """Alignment strings from packed CS backtrace steps
    (pretty_print, sw-full-cs.c:945-1060)."""
    d_chars, q_chars = [], []
    ii, jj = read_start, genome_start
    for s in steps:
        op = s & 3
        lay = (s >> 2) & 3
        xov = (s >> 4) & 1
        if op == 2:        # read-consuming
            d_chars.append("-")
            ch = _LS_CHARS[qr[lay, ii]]
            q_chars.append(ch.lower() if xov else ch)
            ii += 1
        elif op == 1:      # genome-consuming
            d_chars.append(_LS_CHARS[gwin[jj]])
            q_chars.append("-")
            jj += 1
        else:
            dc = _LS_CHARS[gwin[jj]]
            d_chars.append(dc)
            ch = _LS_CHARS[qr[lay, ii]]
            ch = ch.lower() if xov else ch
            if ch in "nN":
                ch = dc.lower() if xov else dc
            q_chars.append(ch)
            ii += 1
            jj += 1
    return "".join(d_chars), "".join(q_chars)


def _named(entries: List[ReadEntry], ri, w_len):
    """(read name, window length) of each window of a launch."""
    return [(entries[int(r)].name, int(w)) for r, w in zip(ri, w_len)]


def _dedup(hits: List[Hit], keyfunc) -> List[Hit]:
    """Grouped duplicate removal keeping the first maximum pass2_key
    (read_remove_duplicate_hits, mapping.c:1520-1606)."""
    order = sorted(range(len(hits)), key=lambda i: keyfunc(hits[i]))
    out = []
    i = 0
    while i < len(order):
        j = i
        best = order[i]
        while (j + 1 < len(order)
               and keyfunc(hits[order[j + 1]]) == keyfunc(hits[order[i]])):
            j += 1
            if hits[order[j]].pass2_key > hits[best].pass2_key:
                best = order[j]
        out.append(hits[best])
        i = j + 1
    return out


def _empty_hitlist(st: int) -> candidates.HitList:
    z = np.zeros(0, np.int64)
    zi = np.zeros(0, np.int32)
    return candidates.HitList(st, zi, z, zi, zi, zi, zi, z, z, zi, zi, zi)
