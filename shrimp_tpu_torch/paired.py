"""Paired-end mapping: pairing filter, paired passes, paired MQVs.

Re-implements SHRiMP2's handle_readpair pipeline
(gmapper/mapping.c:2502-2636) on top of the batched unpaired machinery:

- mp range algebra:          readpair_compute_mp_ranges mapping.c:2317-2442
- pairing filter:            readpair_pair_up_hits mapping.c:266-325
- paired pass1 heap:         readpair_get_vector_hits mapping.c:1877-1932
- paired pass2 + dedup:      readpair_pass2 mapping.c:2181-2314,2084-2175
- insert size:               get_insert_size mapping.c:405-456
- paired MQV classes:        compute_paired_mqv gmapper/output.c:811-942
- output selection:          readpair_output gmapper/output.c:1070-1291

Copied from `shrimp_tpu/paired.py`, on top of the port's `Mapper`: the
paired passes have no device code of their own (the legs' vector and
full SW run through the Mapper's torch twins), so everything else is
the reference's. The flat paired streams (`fastpath.FastPaired`,
`fastpath_cs.FastPairedCS`) read `_paired_opts`, `_hp_opts`,
`total_genome_size` and `_compute_mp_ranges` from here.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import constants as C
from .config import MapperConfig, abs_or_pct, is_absolute
from .index.build import GenomeIndex
from .io.fasta import SeqRecord
from .mapper import (ExtHeap, Hit, Mapper, ReadEntry, qv_from_pr_corr)


@dataclass
class PairHit:
    """struct read_hit_pair."""
    rh: List[Hit]
    score: int = 0
    score_max: int = 0
    pct_score: int = 0
    pass1_key: int = 0
    insert_size: int = 0
    improper_mapping: bool = False


@dataclass
class PairEntry:
    re: List[ReadEntry]
    final_paired_hits: List[PairHit] = field(default_factory=list)
    mapped: bool = False


def normal_cdf(x: float, mean: float, stddev: float) -> float:
    """util.h:310-326 (Abramowitz-Stegun approximation, kept bit-for-bit
    for Z-field parity)."""
    y = abs((x - mean) / stddev)
    b0, b1, b2 = 0.2316419, 0.319381530, -0.356563782
    b3, b4, b5 = 1.781477937, -1.821255978, 1.330274429
    pi = 3.141592653589
    t = 1.0 / (1.0 + b0 * y)
    res = (math.exp(-y * y / 2) / math.sqrt(2.0 * pi)) * (
        (((b5 * t + b4) * t + b3) * t + b2) * t + b1) * t
    if x > mean:
        res = 1 - res
    return res


def log_nchoosek(n: int, k: int) -> float:
    """util.c:1305-1313."""
    res = 0.0
    for i in range(k):
        res += math.log(n - i) - math.log(i + 1)
    return res


class PairedMapper(Mapper):
    """PairedMapper(index, config, device="cuda"): a port `Mapper` for a
    paired config (`config.pair_mode` other than "none")."""

    def __init__(self, index: GenomeIndex,
                 config: Optional[MapperConfig] = None,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__(index, config, device)
        cfg = self.config
        if cfg.pair_mode == C.PAIR_NONE:
            raise ValueError("PairedMapper needs a paired config "
                             "(pair_mode other than 'none')")
        self._paired_opts = cfg.paired_options()
        # per-leg unpaired fallback option sets (gmapper.c:2607-2611)
        self._hp_opts = (cfg.half_paired_unpaired_options(0),
                         cfg.half_paired_unpaired_options(1))
        self.total_genome_size = int(index.contig_lengths.astype(
            np.int64).sum())

    # ------------------------------------------------------------ priors
    def _pr_random_mapping_given_score(self, read_len: int, score: int
                                       ) -> float:
        """mapping.h:39-60."""
        sc = self.config.scores
        if score > read_len * sc.match:
            return 1e-200
        if self.config.mode == C.MODE_COLOUR_SPACE:
            n = -(-max(read_len * sc.match - score, 0) // abs(sc.crossover)) \
                if read_len * sc.match != score else 0
        else:
            n = -(-max(read_len * sc.match - score, 0)
                  // abs(sc.mismatch - sc.match)) \
                if read_len * sc.match != score else 0
        tmp = (-log_nchoosek(read_len, n) - n * math.log(3)
               + read_len * math.log(4))
        return math.exp(-tmp)

    @staticmethod
    def _get_pr_missed(read_len: int) -> float:
        """mapping.h:28-37 (keyed on the *other* read's length)."""
        if read_len < 40:
            return 1e-10
        if read_len < 60:
            return 1e-14
        return 1e-16

    def _get_pr_insert_size(self, insert_size: float) -> float:
        """output.c:796-808."""
        cfg = self.config
        res = (normal_cdf(insert_size + 10, cfg.insert_size_mean,
                          cfg.insert_size_stddev)
               - normal_cdf(insert_size - 10, cfg.insert_size_mean,
                            cfg.insert_size_stddev))
        return max(res, 1e-200)

    # ------------------------------------------------------------ pairing
    def _compute_mp_ranges(self, re1: ReadEntry, re2: ReadEntry,
                           popts=None) -> None:
        """readpair_compute_mp_ranges (mapping.c:2317-2430)."""
        p = popts if popts is not None else self._paired_opts[0].pairing
        mode = p.pair_mode
        mn, mx = p.min_insert_size, p.max_insert_size
        w1, w2 = re1.window_len, re2.window_len
        l1, l2 = re1.read_len, re2.read_len
        if mode == C.PAIR_OPP_IN:
            d0mn = mn - w2
            d0mx = mx + (w1 - l1) - l2
            d1mn = -mx + l1 + (l2 - w2)
            d1mx = -mn + w1
        elif mode == C.PAIR_OPP_OUT:
            d0mn = mn - w2 + l1 + l2
            d0mx = mx + (w1 - l1) - l2 + l1 + l2
            d1mn = -mx + l1 + (l2 - w2) - l1 - l2
            d1mx = -mn + w1 - l1 - l2
        elif mode == C.PAIR_COL_FW:
            d0mn = mn - w2 + l2
            d0mx = mx + (w1 - l1) - l2 + l2
            d1mn = -mx + l1 + (l2 - w2) - l2
            d1mx = -mn + w1 - l2
        elif mode == C.PAIR_COL_BW:
            d0mn = mn - w2 + l1
            d0mx = mx + (w1 - l1) - l2 + l1
            d1mn = -mx + l1 + (l2 - w2) - l1
            d1mx = -mn + w1 - l1
        else:
            raise ValueError(mode)
        re1.delta_g_off_min = (d0mn, d1mn)
        re1.delta_g_off_max = (d0mx, d1mx)
        if mode in (C.PAIR_OPP_IN, C.PAIR_OPP_OUT):
            re2.delta_g_off_min = (-d1mx, -d0mx)
            re2.delta_g_off_max = (-d1mn, -d0mn)
        else:
            re2.delta_g_off_min = (-d0mx, -d1mx)
            re2.delta_g_off_max = (-d0mn, -d1mn)
        # region deltas for the mate-pair region filter
        # (mapping.c:2424-2436; C truncating division)
        R = 1 << self.config.region_bits

        def _rmin(dg):
            return dg // R if dg >= 0 else -1 - ((-dg - 1) // R)

        def _rmax(dg):
            return 1 + (dg - 1) // R if dg > 0 else -((-dg) // R)

        for re in (re1, re2):
            re.delta_region_min = (_rmin(re.delta_g_off_min[0]),
                                   _rmin(re.delta_g_off_min[1]))
            re.delta_region_max = (_rmax(re.delta_g_off_max[0]),
                                   _rmax(re.delta_g_off_max[1]))

    @staticmethod
    def _pair_up_hits(re1: ReadEntry, hits1, hits2) -> None:
        """readpair_pair_up_hits (mapping.c:266-325)."""
        for st1 in (0, 1):
            st2 = 1 - st1
            a = hits1[st1]
            b = hits2[st2]
            j = 0
            for i, h in enumerate(a):
                dmin = re1.delta_g_off_min[st1]
                dmax = re1.delta_g_off_max[st1]
                while j < len(b) and (
                        b[j].cn < h.cn
                        or (b[j].cn == h.cn
                            and b[j].g_off < h.g_off + dmin)):
                    j += 1
                k = j
                while k < len(b) and b[k].cn == h.cn \
                        and b[k].g_off <= h.g_off + dmax:
                    k += 1
                if j == k:
                    continue
                h.pair_min = j
                h.pair_max = k - 1
                for l in range(j, k):
                    if b[l].pair_min < 0:
                        b[l].pair_min = i
                    b[l].pair_max = i

    def _readpair_get_vector_hits(self, re1, re2, hits1, hits2, popts
                                  ) -> List[PairHit]:
        """mapping.c:1877-1932."""
        heap = ExtHeap(popts.pass1_num_outputs)
        absolute = is_absolute(popts.pass1_threshold)
        for st1 in (0, 1):
            st2 = 1 - st1
            for i, h in enumerate(hits1[st1]):
                if h.saved == 1 or h.pair_min < 0:
                    continue
                for j in range(h.pair_min, h.pair_max + 1):
                    g = hits2[st2][j]
                    if g.saved == 1:
                        continue
                    score = h.score_vector + g.score_vector
                    score_max = h.score_max + g.score_max
                    pct = (1000 * 100 * score) // score_max
                    key = score if absolute else pct
                    if score < int(abs_or_pct(popts.pass1_threshold,
                                              score_max)):
                        continue
                    if heap.load < popts.pass1_num_outputs or \
                            key > heap.min_key:
                        ph = PairHit(rh=[h, g], score=score,
                                     score_max=score_max, pct_score=pct,
                                     pass1_key=key)
                        ph.insert_size = int(
                            g.g_off - (h.g_off + h.w_len) if st1 == 0
                            else h.g_off - (g.g_off + g.w_len))
                        if heap.load < popts.pass1_num_outputs:
                            heap.insert(ph)
                        else:
                            heap.replace_min(ph)
        return list(heap.a)

    # ------------------------------------------------------- insert sizes
    @staticmethod
    def _sam_coords(index, h: Hit) -> Tuple[int, int]:
        """1-based forward-strand genome start/end of an aligned hit
        (output.c:391-404 / mapping.c:405-440)."""
        glen = int(index.contig_lengths[h.cn])
        read_start1 = h.read_start + 1
        read_end1 = read_start1 + h.rmapped - 1
        if h.gen_st == 0:
            gs = h.genome_start + 1
        else:
            right = glen - h.genome_start
            gs = right - (read_end1 - read_start1 - h.deletions
                          + h.insertions)
        return gs, gs + h.gmapped - 1

    def _insert_size(self, rh: Hit, rh_mp: Hit) -> int:
        """get_insert_size (mapping.c:405-456): 5' to 5' distance."""
        if rh is None or rh_mp is None or rh.cn != rh_mp.cn:
            return 0
        gs, ge = self._sam_coords(self.index, rh)
        gs_mp, ge_mp = self._sam_coords(self.index, rh_mp)
        fivep = ge if rh.gen_st == 1 else gs - 1
        fivep_mp = ge_mp if rh_mp.gen_st == 1 else gs_mp - 1
        return fivep_mp - fivep

    def _compute_paired_hit(self, rh1: Hit, rh2: Hit, absolute: bool
                            ) -> PairHit:
        """readpair_compute_paired_hit (mapping.c:2053-2080)."""
        ph = PairHit(rh=[rh1, rh2])
        ph.score_max = rh1.score_max + rh2.score_max
        ph.score = rh1.score_full + rh2.score_full
        ph.pct_score = (1000 * 100 * ph.score) // ph.score_max
        ph.pass1_key = ph.score if absolute else ph.pct_score
        ins = self._insert_size(rh1, rh2)
        mode = self.config.pair_mode
        if mode in (C.PAIR_OPP_IN, C.PAIR_COL_FW):
            sign = 1 if rh1.gen_st == 0 else -1
        else:
            sign = 1 if rh1.gen_st == 1 else -1
        ph.insert_size = sign * ins
        ph.improper_mapping = False
        return ph

    # -------------------------------------------------------- pass2 dedup
    def _push_dominant(self, pairs: List[PairHit], nip: int, keyfunc,
                       absolute: bool) -> None:
        """readpair_push_dominant_single_hits (mapping.c:2084-2110)."""
        pairs.sort(key=lambda p: keyfunc(p.rh[nip]))
        i = 0
        n = len(pairs)
        while i < n:
            j = i
            best = i
            while j + 1 < n and keyfunc(pairs[j + 1].rh[nip]) == \
                    keyfunc(pairs[i].rh[nip]):
                j += 1
                if pairs[j].rh[nip].score_full > pairs[best].rh[nip].score_full:
                    best = j
            for k in range(i, j + 1):
                if k != best:
                    pairs[k].rh[nip] = pairs[best].rh[nip]
                    newp = self._compute_paired_hit(pairs[k].rh[0],
                                                    pairs[k].rh[1], absolute)
                    pairs[k] = newp
            i = j + 1

    def _remove_duplicate_pairs(self, pairs: List[PairHit], absolute: bool
                                ) -> List[PairHit]:
        """readpair_remove_duplicate_hits (mapping.c:2114-2175)."""
        gs_key = lambda h: (h.cn, h.gen_st, h.genome_start)
        ge_key = lambda h: (h.cn, h.gen_st,
                            -h.genome_start - h.rmapped + h.deletions
                            - h.insertions)
        self._push_dominant(pairs, 0, gs_key, absolute)
        self._push_dominant(pairs, 0, ge_key, absolute)
        self._push_dominant(pairs, 1, gs_key, absolute)
        self._push_dominant(pairs, 1, ge_key, absolute)
        pairs.sort(key=lambda p: (p.rh[0].sort_idx, p.rh[1].sort_idx))
        out = []
        for p in pairs:
            if out and out[-1].rh[0] is p.rh[0] and out[-1].rh[1] is p.rh[1]:
                continue
            out.append(p)
        return out

    # ------------------------------------------------- the pair pipeline
    def prepare_pair(self, rec1: SeqRecord, rec2: SeqRecord
                     ) -> Optional[PairEntry]:
        # Reference quirk (gmapper.c:412-492): in paired mode the trim
        # of the FIRST mate runs one loop iteration after it was
        # encoded, so mate 1 maps (and renders SEQ) untrimmed; only its
        # quality STRING reflects the trim. Mate 2 trims normally.
        cfg = self.config
        e1 = self.prepare_read(rec1, trim=False)
        e2 = self.prepare_read(rec2, trim=cfg.trim_second)
        if e1 is not None and cfg.trim_first \
                and (cfg.trim_front or cfg.trim_end):
            tf, te = cfg.trim_front, cfg.trim_end
            e1.trimmed_seq = e1.seq[tf:len(e1.seq) - te or None]
            if e1.qual is not None:
                # trim_read (gmapper.c:262-281) computes the cut from
                # strlen(seq); in colour space qual is one char shorter
                # than seq, so the trimmed C string keeps one extra qv
                # and mate 1's post_sw (running on the untrimmed
                # encoding) reads the planted NUL and the untouched
                # original bytes beyond it. Reproduce the raw buffer.
                orig = e1.qual
                nq = len(orig)
                cut = len(e1.seq) - te - tf
                buf = [orig[i + tf] if i + tf < nq else "\0"
                       for i in range(min(cut, nq))]
                if cut < nq:
                    buf.append("\0")
                    buf += list(orig[cut + 1:])
                e1.qual_buf = "".join(buf[:nq])
                e1.qual = e1.qual_buf.split("\0", 1)[0]
        if e1 is None or e2 is None:
            return None
        flip1, flip2 = C.PAIR_REVERSE[self.config.pair_mode]
        for e, flip in ((e1, flip1), (e2, flip2)):
            if flip:
                # read_reverse (gmapper.c:175-186)
                e.codes = (e.codes[1], e.codes[0])
                e.initbp = (e.initbp[1], e.initbp[0])
                e.input_strand = 1 - e.input_strand
        e1.paired = e2.paired = True
        e1.first_in_pair = True
        e1.mate_pair = e2
        e2.mate_pair = e1
        return PairEntry(re=[e1, e2])

    def _readpair_pass2_filter(self, pe: PairEntry,
                               ph_sel: List[PairHit], popts) -> bool:
        """readpair_pass2 tail (mapping.c:2221-2314): pair threshold,
        duplicate removal, sort, trims, saved marks, stop condition.
        Returns the pair's done flag."""
        cfg = self.config
        absolute = is_absolute(popts.pass2_threshold)
        hits_pass2: List[PairHit] = []
        for ph in ph_sel:
            if ph.rh[0].score_full == 0 or ph.rh[1].score_full == 0:
                continue
            if ph.rh[0].score_full + ph.rh[1].score_full >= int(
                    abs_or_pct(popts.pass2_threshold, ph.score_max)):
                hits_pass2.append(self._compute_paired_hit(
                    ph.rh[0], ph.rh[1], absolute))
        hits_pass2 = self._remove_duplicate_pairs(hits_pass2, absolute)
        hits_pass2.sort(key=lambda p: -p.pass1_key)
        if len(hits_pass2) > popts.pass2_num_outputs:
            hits_pass2 = hits_pass2[:popts.pass2_num_outputs]
        if popts.strata and hits_pass2:
            i = 1
            while i < len(hits_pass2) and \
                    hits_pass2[0].score == hits_pass2[i].score:
                i += 1
            hits_pass2 = hits_pass2[:i]
        if hits_pass2 and cfg.max_alignments and \
                len(hits_pass2) > cfg.max_alignments:
            hits_pass2 = []
        for p in hits_pass2:
            p.rh[0].saved = 1
            p.rh[1].saved = 1
        if hits_pass2:
            pe.mapped = True
        # rounds accumulate (readpair_save_final_hits /
        # readpair_output_no_mqv both append in round order)
        pe.final_paired_hits.extend(hits_pass2)
        if popts.stop_count == 0:
            return True
        cnt = sum(1 for p in hits_pass2 if p.score >= int(
            abs_or_pct(popts.stop_threshold, p.score_max)))
        return cnt >= popts.stop_count

    def map_paired(self, records: Sequence[SeqRecord]
                   ) -> List[PairEntry]:
        """handle_readpair's option-set loop (mapping.c:2502-2636),
        batched over pairs, with the half-paired unpaired fallback for
        pairs that fall through every option set."""
        assert len(records) % 2 == 0
        cfg = self.config
        pairs: List[PairEntry] = []
        for i in range(0, len(records), 2):
            pe = self.prepare_pair(records[i], records[i + 1])
            if pe is not None:
                pairs.append(pe)

        entries: List[ReadEntry] = []
        for pe in pairs:
            entries.extend(pe.re)
        caches = [self._new_cache() for _ in entries]
        active = list(range(len(pairs)))
        for ropts in self._paired_opts:
            if not active:
                break
            popts = ropts.pairing
            # mp ranges, recomputed every round (mapping.c:2522)
            for pi in active:
                self._compute_mp_ranges(pairs[pi].re[0], pairs[pi].re[1],
                                        popts)
            # candidate stages per leg with that leg's options
            for nip in (0, 1):
                self._round_candidates(entries,
                                       [2 * pi + nip for pi in active],
                                       caches, ropts.read[nip])
            # pair-up on the current hit lists (mapping.c:2561)
            for pi in active:
                self._pair_up_hits(pairs[pi].re[0],
                                   caches[2 * pi]["hits2"],
                                   caches[2 * pi + 1]["hits2"])
            # pass1 per leg
            for nip in (0, 1):
                p1 = ropts.read[nip].pass1
                if not p1.recompute:
                    continue
                idxs = [2 * pi + nip for pi in active]
                self._round_scores(entries, idxs, caches, p1.gapless)
                for i in idxs:
                    self._pass1_walk(entries[i], caches[i]["hits2"],
                                     caches[i]["scores"][p1.gapless], p1)
            ph_sel = [self._readpair_get_vector_hits(
                pairs[pi].re[0], pairs[pi].re[1],
                caches[2 * pi]["hits2"], caches[2 * pi + 1]["hits2"],
                popts) for pi in active]

            # full SW for selected feet not yet run (score_full < 0 is
            # the reference's sfrp == NULL, see Mapper._run_option_sets)
            feet_entries: List[ReadEntry] = []
            feet_hits: List[List[Hit]] = []
            feet_thresh: List[float] = []
            seen = set()
            for k, pi in enumerate(active):
                for ph in ph_sel[k]:
                    for nip in (0, 1):
                        h = ph.rh[nip]
                        if id(h) in seen or h.score_full >= 0:
                            continue
                        seen.add(id(h))
                        feet_entries.append(pairs[pi].re[nip])
                        feet_hits.append([h])
                        feet_thresh.append(ropts.read[nip].pass2.threshold)
            if feet_hits:
                self._pass2(feet_entries, feet_hits, feet_thresh)

            still = []
            for k, pi in enumerate(active):
                done = self._readpair_pass2_filter(pairs[pi], ph_sel[k],
                                                   popts)
                if not done:
                    still.append(pi)
            active = still

        # ---- half-paired unpaired fallback for pairs that fell through
        # all option sets (handle_readpair, mapping.c:2607-2611); reuses
        # the last paired round's hit lists via the caches
        if cfg.half_paired and active:
            for nip in (0, 1):
                idxs = [2 * pi + nip for pi in active]
                sub_entries = [entries[i] for i in idxs]
                emitted, _ = self._run_option_sets(
                    sub_entries, self._hp_opts[nip],
                    caches=[caches[i] for i in idxs])
                for e, rounds in zip(sub_entries, emitted):
                    for r in rounds:
                        e.final_unpaired_hits.extend(r)

        # ---- mapping qualities
        if cfg.compute_mapping_qualities:
            for pe in pairs:
                self._compute_paired_mqv(pe)
        return pairs

    # ----------------------------------------------------------- paired MQV
    def _compute_paired_mqv(self, pe: PairEntry) -> None:
        """compute_paired_mqv (output.c:811-942)."""
        res = pe.re
        # unpaired z0/z1
        for nip in (0, 1):
            z1 = sum(h.posterior for h in res[nip].final_unpaired_hits)
            for h in res[nip].final_unpaired_hits:
                h.z0 = h.posterior
                h.z1 = z1

        # insert size denominator
        ins_denom = 0.0
        for ph in pe.final_paired_hits:
            ins_denom += self._get_pr_insert_size(ph.insert_size)
        feet = [{}, {}]   # id(hit) -> (hit, [pairs containing it])
        for ph in pe.final_paired_hits:
            for nip in (0, 1):
                feet[nip].setdefault(id(ph.rh[nip]),
                                     (ph.rh[nip], []))[1].append(ph)
        for nip in (0, 1):
            for h, _ in feet[nip].values():
                h.insert_size_denom = ins_denom

        # paired posteriors z2/z3
        z3 = 0.0
        for nip in (0, 1):
            for h, phs in feet[nip].values():
                tmp = 0.0
                for ph in phs:
                    mate = ph.rh[1 - nip]
                    tmp += self._get_pr_insert_size(ph.insert_size) \
                        * mate.posterior
                tmp *= h.posterior
                tmp = max(tmp, 1e-200)
                h.z2 = tmp
                if nip == 0:
                    z3 += tmp
        for nip in (0, 1):
            for h, _ in feet[nip].values():
                h.z3 = z3

        # class priors
        pr_top_random = [1.0, 1.0, 1.0]
        for nip in (0, 1):
            hits = res[nip].final_unpaired_hits
            if not hits:
                continue
            max_idx = 0
            for i in range(1, len(hits)):
                if hits[i].z0 > hits[max_idx].z0:
                    max_idx = i
            pr = self._pr_random_mapping_given_score(
                res[nip].read_len, hits[max_idx].posterior_score)
            pr_top_random[nip] = pr
            for h in hits:
                h.pr_top_random_at_location = pr
            pr_top_random[nip] = min(pr * self.total_genome_size, 1.0)

        for ph in pe.final_paired_hits:
            tmp = self._pr_random_mapping_given_score(
                res[0].read_len, ph.rh[0].posterior_score)
            tmp *= self._pr_random_mapping_given_score(
                res[1].read_len, ph.rh[1].posterior_score)
            tmp *= 1000
            if tmp < pr_top_random[2]:
                pr_top_random[2] = tmp
        for ph in pe.final_paired_hits:
            ph.rh[0].pr_top_random_at_location = pr_top_random[2]
            ph.rh[1].pr_top_random_at_location = pr_top_random[2]
        pr_top_random[2] = min(pr_top_random[2] * self.total_genome_size,
                               1.0)

        pr_missed = [self._get_pr_missed(res[1].read_len),
                     self._get_pr_missed(res[0].read_len)]
        for nip in (0, 1):
            for h in res[nip].final_unpaired_hits:
                h.pr_missed_mp = pr_missed[nip]

        denom = 0.0
        if res[0].final_unpaired_hits:
            denom += pr_top_random[1] * pr_top_random[2] * pr_missed[0]
        if res[1].final_unpaired_hits:
            denom += pr_top_random[0] * pr_top_random[2] * pr_missed[1]
        if pe.final_paired_hits:
            denom += pr_top_random[0] * pr_top_random[1]

        for nip in (0, 1):
            for h in res[nip].final_unpaired_hits:
                p_corr = (pr_top_random[1 - nip] * pr_top_random[2]
                          * pr_missed[nip] / denom) * (h.z0 / h.z1)
                h.mqv = qv_from_pr_corr(p_corr)
                if h.mqv < 4:
                    h.mqv = 0
        for ph in pe.final_paired_hits:
            for nip in (0, 1):
                h = ph.rh[nip]
                p_corr = (pr_top_random[0] * pr_top_random[1] / denom) \
                    * (h.z2 / h.z3)
                h.mqv = qv_from_pr_corr(p_corr)
                if h.mqv < 4:
                    h.mqv = 0

    # ------------------------------------------------------ output selection
    def select_output(self, pe: PairEntry):
        """readpair_output selection (output.c:1070-1234).

        Returns (paired_list, unpaired_lists[2]) of what to emit.
        """
        cfg = self.config
        first = [0, 0, 0]
        last = [len(pe.re[0].final_unpaired_hits),
                len(pe.re[1].final_unpaired_hits),
                len(pe.final_paired_hits)]
        if cfg.compute_mapping_qualities and cfg.single_best_mapping and (
                pe.final_paired_hits or pe.re[0].final_unpaired_hits
                or pe.re[1].final_unpaired_hits):
            mqv_u = [-1, -1]
            idx_u = [-1, -1]
            mqv_p = [-1, -1]
            idx_p = [None, None]
            pool = [{}, {}]
            for ph in pe.final_paired_hits:
                for nip in (0, 1):
                    pool[nip].setdefault(id(ph.rh[nip]), ph.rh[nip])
            for nip in (0, 1):
                for i, h in enumerate(pe.re[nip].final_unpaired_hits):
                    if h.mqv > mqv_u[nip]:
                        mqv_u[nip] = h.mqv
                        idx_u[nip] = i
                for h in pool[nip].values():
                    if h.mqv > mqv_p[nip]:
                        mqv_p[nip] = h.mqv
                        idx_p[nip] = h
            if not cfg.all_contigs:
                for nip in (0, 1):
                    if idx_u[nip] >= 0:
                        first[nip] = idx_u[nip]
                        last[nip] = idx_u[nip] + 1
                best_nip = 0 if mqv_p[0] > mqv_p[1] else 1
                if mqv_p[best_nip] >= 0:
                    # pair containing max foot with max-mqv mate
                    best_pair = None
                    best_other = -1
                    for i, ph in enumerate(pe.final_paired_hits):
                        if ph.rh[best_nip] is idx_p[best_nip]:
                            if ph.rh[1 - best_nip].mqv > best_other:
                                best_other = ph.rh[1 - best_nip].mqv
                                best_pair = i
                    first[2] = best_pair
                    last[2] = best_pair + 1
            else:
                # all-contigs: single best mapping across classes
                max_mqv = [0, 0]
                max_is_paired = [0, 0]
                for nip in (0, 1):
                    if mqv_u[nip] > mqv_p[nip]:
                        max_mqv[nip] = mqv_u[nip]
                        max_is_paired[nip] = 0
                    else:
                        max_mqv[nip] = mqv_p[nip]
                        max_is_paired[nip] = 1
                best_nip = 0 if max_mqv[0] >= max_mqv[1] else 1
                if max_is_paired[best_nip]:
                    best_pair = None
                    best_other = -1
                    for i, ph in enumerate(pe.final_paired_hits):
                        if ph.rh[best_nip] is idx_p[best_nip]:
                            if ph.rh[1 - best_nip].mqv > best_other:
                                best_other = ph.rh[1 - best_nip].mqv
                                best_pair = i
                    last[0] = last[1] = 0
                    first[2] = best_pair
                    last[2] = best_pair + 1
                else:
                    # improper pairing rescue (output.c:1186-1230)
                    other = pe.re[1 - best_nip].final_unpaired_hits
                    idx_best_other = -1
                    max_other_z0 = 0.0
                    for i, h in enumerate(other):
                        if h.z0 > max_other_z0:
                            max_other_z0 = h.z0
                            idx_best_other = i
                    best_other_mqv = -1
                    if idx_best_other >= 0:
                        best_other_mqv = qv_from_pr_corr(
                            max_other_z0 / other[idx_best_other].z1)
                    if (not cfg.improper_mappings
                            or mqv_u[best_nip] < 10 or best_other_mqv < 10):
                        last[2] = 0
                        last[1 - best_nip] = 0
                        first[best_nip] = idx_u[best_nip]
                        last[best_nip] = idx_u[best_nip] + 1
                    else:
                        rh = [None, None]
                        rh[best_nip] = pe.re[best_nip].final_unpaired_hits[
                            idx_u[best_nip]]
                        rh[1 - best_nip] = other[idx_best_other]
                        ph = PairHit(rh=rh)
                        ph.score_max = rh[0].score_max + rh[1].score_max
                        ph.insert_size = self._insert_size(rh[best_nip],
                                                           rh[1 - best_nip])
                        ph.improper_mapping = True
                        pe.final_paired_hits.append(ph)
                        last[0] = last[1] = 0
                        first[2] = len(pe.final_paired_hits) - 1
                        last[2] = len(pe.final_paired_hits)
        paired_out = pe.final_paired_hits[first[2]:last[2]]
        unpaired_out = [pe.re[0].final_unpaired_hits[first[0]:last[0]],
                        pe.re[1].final_unpaired_hits[first[1]:last[1]]]
        return paired_out, unpaired_out
