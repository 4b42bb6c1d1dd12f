"""The reference's colour-space paired mapping, with gmapper-cs's default
paired options (match mode 4, half-paired, opp-in and the insert range
the traffic sets): per mate filter 1, the mate-pair ranges and the
pairing of windows (readpair_pair_up_hits), pass 1 over the pairable
windows, the top-30 heap of pairs, the full SW of their feet, the paired
pass 2, then each mate's unpaired fall-back round on the same windows,
the paired MAPQ (compute_paired_mqv, output.c:811-942) and the SAM
records in readpair_output's order (output.c:1236-1282). After SHRiMP2's
mapping.c:2502-2636 and the JAX package's `paired.py`."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np

from mapbench.reference import common as K
from mapbench.reference import cs, ls

INSERT_MEAN = 200.0       # gmapper-defaults.h
INSERT_STDDEV = 100.0
PAIR_THRESHOLD_FEET = K.SW_FULL_THRESHOLD * 0.5   # gmapper.c:2636-2718


@dataclass
class PairHit:
    rh: list
    score: int = 0
    score_max: int = 0
    pct_score: int = 0
    pass1_key: int = 0
    insert_size: int = 0
    improper_mapping: bool = False


def normal_cdf(x: float, mean: float, stddev: float) -> float:
    """util.h:310-326."""
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


def pr_random_mapping(read_len: int, score: int) -> float:
    """mapping.h:39-60, colour space."""
    sc = K.CS_SCORES
    if score > read_len * sc["match"]:
        return 1e-200
    n = (-(-max(read_len * sc["match"] - score, 0) // abs(sc["crossover"]))
         if read_len * sc["match"] != score else 0)
    tmp = (-log_nchoosek(read_len, n) - n * math.log(3)
           + read_len * math.log(4))
    return math.exp(-tmp)


def pr_missed(read_len: int) -> float:
    """mapping.h:28-37."""
    if read_len < 40:
        return 1e-10
    if read_len < 60:
        return 1e-14
    return 1e-16


def pr_insert_size(x: float) -> float:
    """output.c:796-808."""
    return max(normal_cdf(x + 10, INSERT_MEAN, INSERT_STDDEV)
               - normal_cdf(x - 10, INSERT_MEAN, INSERT_STDDEV), 1e-200)


def mp_ranges(r1: K.Read, r2: K.Read, mn: int, mx: int) -> None:
    """readpair_compute_mp_ranges, opp-in (mapping.c:2317-2430)."""
    w1, w2, l1, l2 = r1.window_len, r2.window_len, r1.read_len, r2.read_len
    d0mn, d0mx = mn - w2, mx + (w1 - l1) - l2
    d1mn, d1mx = -mx + l1 + (l2 - w2), -mn + w1
    r1.delta_g_off_min, r1.delta_g_off_max = (d0mn, d1mn), (d0mx, d1mx)
    r2.delta_g_off_min, r2.delta_g_off_max = (-d1mx, -d0mx), (-d1mn, -d0mn)


def pair_up(r1: K.Read, hits1, hits2) -> None:
    """readpair_pair_up_hits (mapping.c:266-325)."""
    for st1 in (0, 1):
        a, b = hits1[st1], hits2[1 - st1]
        j = 0
        for i, h in enumerate(a):
            dmin, dmax = r1.delta_g_off_min[st1], r1.delta_g_off_max[st1]
            while j < len(b) and (b[j].cn < h.cn or (
                    b[j].cn == h.cn and b[j].g_off < h.g_off + dmin)):
                j += 1
            k = j
            while k < len(b) and b[k].cn == h.cn and \
                    b[k].g_off <= h.g_off + dmax:
                k += 1
            if j == k:
                continue
            h.pair_min, h.pair_max = j, k - 1
            for m in range(j, k):
                if b[m].pair_min < 0:
                    b[m].pair_min = i
                b[m].pair_max = i


def pair_vector_hits(hits1, hits2) -> List[PairHit]:
    """readpair_get_vector_hits (mapping.c:1877-1932)."""
    heap = K.ExtHeap(K.NUM_TMP_OUTPUTS)
    for st1 in (0, 1):
        for h in hits1[st1]:
            if h.saved == 1 or h.pair_min < 0:
                continue
            for j in range(h.pair_min, h.pair_max + 1):
                g = hits2[1 - st1][j]
                if g.saved == 1:
                    continue
                score = h.score_vector + g.score_vector
                smax = h.score_max + g.score_max
                pct = (1000 * 100 * score) // smax
                if score < int(K.abs_or_pct(K.CS_SW_VECT_THRESHOLD, smax)):
                    continue
                if len(heap.a) < heap.capacity or pct > heap.a[0].pass1_key:
                    ph = PairHit(rh=[h, g], score=score, score_max=smax,
                                 pct_score=pct, pass1_key=pct)
                    if len(heap.a) < heap.capacity:
                        heap.insert(ph)
                    else:
                        heap.replace_min(ph)
    return list(heap.a)


def sam_coords(h: K.Hit, contig_len: int):
    """1-based forward-strand start and end of an alignment
    (output.c:391-404)."""
    rs1 = h.read_start + 1
    re1 = rs1 + h.rmapped - 1
    if h.gen_st == 0:
        gs = h.genome_start + 1
    else:
        gs = (contig_len - h.genome_start) - (re1 - rs1 - h.deletions
                                              + h.insertions)
    return gs, gs + h.gmapped - 1, h.gen_st == 1


def insert_size(a: K.Hit, b: K.Hit, L: int) -> int:
    """get_insert_size (mapping.c:405-456): 5' to 5'."""
    if a.cn != b.cn:
        return 0
    gs, ge, _ = sam_coords(a, L)
    gs2, ge2, _ = sam_coords(b, L)
    return (ge2 if b.gen_st == 1 else gs2 - 1) - (ge if a.gen_st == 1
                                                  else gs - 1)


def paired_hit(h1: K.Hit, h2: K.Hit, L: int) -> PairHit:
    """readpair_compute_paired_hit (mapping.c:2053-2080), opp-in."""
    ph = PairHit(rh=[h1, h2], score_max=h1.score_max + h2.score_max,
                 score=h1.score_full + h2.score_full)
    ph.pct_score = (1000 * 100 * ph.score) // ph.score_max
    ph.pass1_key = ph.pct_score
    ph.insert_size = (1 if h1.gen_st == 0 else -1) * insert_size(h1, h2, L)
    return ph


def push_dominant(pairs: List[PairHit], nip: int, key, L: int) -> None:
    """readpair_push_dominant_single_hits (mapping.c:2084-2110)."""
    pairs.sort(key=lambda p: key(p.rh[nip]))
    i, n = 0, len(pairs)
    while i < n:
        j = best = i
        while j + 1 < n and key(pairs[j + 1].rh[nip]) == key(pairs[i].rh[nip]):
            j += 1
            if pairs[j].rh[nip].score_full > pairs[best].rh[nip].score_full:
                best = j
        for k in range(i, j + 1):
            if k != best:
                pairs[k].rh[nip] = pairs[best].rh[nip]
                pairs[k] = paired_hit(pairs[k].rh[0], pairs[k].rh[1], L)
        i = j + 1


def pair_pass2(ph_sel: List[PairHit], L: int) -> List[PairHit]:
    """readpair_pass2 (mapping.c:2181-2314) with the default options."""
    out = []
    for ph in ph_sel:
        a, b = ph.rh
        if a.score_full == 0 or b.score_full == 0:
            continue
        if a.score_full + b.score_full >= int(
                K.abs_or_pct(K.SW_FULL_THRESHOLD, ph.score_max)):
            out.append(paired_hit(a, b, L))
    gs = lambda h: (h.cn, h.gen_st, h.genome_start)
    ge = lambda h: (h.cn, h.gen_st, -h.genome_start - h.rmapped
                    + h.deletions - h.insertions)
    for nip in (0, 1):
        push_dominant(out, nip, gs, L)
        push_dominant(out, nip, ge, L)
    out.sort(key=lambda p: (p.rh[0].sort_idx, p.rh[1].sort_idx))
    dedup = []
    for p in out:
        if dedup and dedup[-1].rh[0] is p.rh[0] and dedup[-1].rh[1] is p.rh[1]:
            continue
        dedup.append(p)
    dedup.sort(key=lambda p: -p.pass1_key)
    dedup = dedup[:K.NUM_OUTPUTS]
    for p in dedup:
        p.rh[0].saved = p.rh[1].saved = 1
    return dedup


def paired_mqv(r: List[K.Read], pairs: List[PairHit], genome_len: int):
    """compute_paired_mqv (output.c:811-942)."""
    for nip in (0, 1):
        z1 = K.plain_sum(h.posterior for h in r[nip].final_unpaired_hits)
        for h in r[nip].final_unpaired_hits:
            h.z0, h.z1 = h.posterior, z1
    ins_denom = 0.0
    for ph in pairs:
        ins_denom += pr_insert_size(ph.insert_size)
    feet = [{}, {}]
    for ph in pairs:
        for nip in (0, 1):
            feet[nip].setdefault(id(ph.rh[nip]), (ph.rh[nip], []))[1].append(
                ph)
    for nip in (0, 1):
        for h, _ in feet[nip].values():
            h.insert_size_denom = ins_denom
    z3 = 0.0
    for nip in (0, 1):
        for h, phs in feet[nip].values():
            tmp = 0.0
            for ph in phs:
                tmp += pr_insert_size(ph.insert_size) * ph.rh[1 - nip].posterior
            tmp *= h.posterior
            tmp = max(tmp, 1e-200)
            h.z2 = tmp
            if nip == 0:
                z3 += tmp
    for nip in (0, 1):
        for h, _ in feet[nip].values():
            h.z3 = z3
    top = [1.0, 1.0, 1.0]
    for nip in (0, 1):
        hits = r[nip].final_unpaired_hits
        if not hits:
            continue
        mi = 0
        for i in range(1, len(hits)):
            if hits[i].z0 > hits[mi].z0:
                mi = i
        pr = pr_random_mapping(r[nip].read_len, hits[mi].posterior_score)
        for h in hits:
            h.pr_top_random_at_location = pr
        top[nip] = min(pr * genome_len, 1.0)
    for ph in pairs:
        tmp = pr_random_mapping(r[0].read_len, ph.rh[0].posterior_score)
        tmp *= pr_random_mapping(r[1].read_len, ph.rh[1].posterior_score)
        tmp *= 1000
        if tmp < top[2]:
            top[2] = tmp
    for ph in pairs:
        ph.rh[0].pr_top_random_at_location = top[2]
        ph.rh[1].pr_top_random_at_location = top[2]
    top[2] = min(top[2] * genome_len, 1.0)
    missed = [pr_missed(r[1].read_len), pr_missed(r[0].read_len)]
    for nip in (0, 1):
        for h in r[nip].final_unpaired_hits:
            h.pr_missed_mp = missed[nip]
    denom = 0.0
    if r[0].final_unpaired_hits:
        denom += top[1] * top[2] * missed[0]
    if r[1].final_unpaired_hits:
        denom += top[0] * top[2] * missed[1]
    if pairs:
        denom += top[0] * top[1]
    for nip in (0, 1):
        for h in r[nip].final_unpaired_hits:
            p = (top[1 - nip] * top[2] * missed[nip] / denom) * (h.z0 / h.z1)
            h.mqv = K.qv_from_pr_corr(p)
            if h.mqv < 4:
                h.mqv = 0
    for ph in pairs:
        for nip in (0, 1):
            h = ph.rh[nip]
            p = (top[0] * top[1] / denom) * (h.z2 / h.z3)
            h.mqv = K.qv_from_pr_corr(p)
            if h.mqv < 4:
                h.mqv = 0


def render_hit(r: K.Read, rh, rh_mp, first: bool, contig: str, L: int,
               improper: bool = False) -> str:
    """One record of a pair's mate, without its QNAME (hit_output,
    output.c:227-774, colour space, reads without qualities)."""
    mrnm, mpos, isize = "*", 0, 0
    rev_mp = False
    gs_mp = ge_mp = 0
    mate_unmapped = rh_mp is None
    if not mate_unmapped:
        gs_mp, ge_mp, rev_mp = sam_coords(rh_mp, L)
        mpos, mrnm = gs_mp, contig
    paired_aln = rh is not None and rh_mp is not None and not improper

    def flags(rev: bool) -> int:
        return (0x1 | (0x2 if paired_aln else 0)
                | (0x4 if rh is None else 0) | (0x8 if mate_unmapped else 0)
                | (0x10 if rev else 0) | (0x20 if rev_mp else 0)
                | (0x40 if first else 0x80))
    if rh is None:
        return "\t".join([str(flags(False)), "*", "0", "0", "*", mrnm,
                          str(mpos), "0", "*", "*"]) + \
            f"\tCQ:Z:*\tCS:Z:{r.seq}"
    rev = rh.gen_st == 1
    seq = "".join(c for c in (rh.qralign or "") if c != "-").translate(
        K._CLEAN)
    if rev:
        seq = K._revcomp(seq)
    cig = [(n, "H" if op == "S" else op) for n, op in K.cigar(rh, r.read_len)]
    if rev:
        cig = cig[::-1]
    pos, end, _ = sam_coords(rh, L)
    if not mate_unmapped:
        mrnm = "="
        isize = ((ge_mp if rev_mp else gs_mp - 1)
                 - (end if rev else pos - 1))
    line = "\t".join([str(flags(rev)), contig, str(pos), str(rh.mqv),
                      "".join(f"{n}{op}" for n, op in cig), mrnm, str(mpos),
                      str(isize), seq, "*"])
    line += f"\tAS:i:{rh.score_full}"
    if paired_aln:
        line += (f"\tZ2:i:{K.neglog(rh.z2)}\tZ3:i:{K.neglog(rh.z3)}"
                 f"\tZ4:i:{K.neglog(rh.pr_top_random_at_location)}"
                 f"\tZ6:i:{K.neglog(rh.insert_size_denom)}")
    else:
        line += (f"\tZ0:i:{K.neglog(rh.z0)}\tZ1:i:{K.neglog(rh.z1)}"
                 f"\tZ4:i:{K.neglog(rh.pr_top_random_at_location)}"
                 f"\tZ5:i:{K.neglog(rh.pr_missed_mp)}")
    line += f"\tNM:i:{rh.mismatches + rh.deletions + rh.insertions}"
    line += f"\tCS:Z:{r.seq}\tCM:i:{rh.crossovers}\tXX:Z:{rh.qralign}"
    return line


def map_pairs(idx, pairs: List[tuple], insert: tuple, sat=None
              ) -> List[List[str]]:
    """SAM records (without QNAME) of each pair (mate 1, mate 2)."""
    L = idx.length
    cutoff = K.list_cutoff(L)
    calib = K.calibration("cs")
    reads = []
    for r1, r2 in pairs:
        r1.paired = r2.paired = True
        r1.first_in_pair = True
        r1.mate, r2.mate = r2, r1
        mp_ranges(r1, r2, insert[0], insert[1])
        reads += [r1, r2]
    hl_all = [ls.hit_lists(idx, r, cutoff, K.CS_SCORES) for r in reads]
    hits_all = [ls.make_hits(hl2) for hl2 in hl_all]
    for p in range(len(pairs)):
        pair_up(reads[2 * p], hits_all[2 * p], hits_all[2 * p + 1])
    scores = cs.vector_scores(idx, reads, hl_all, sat)
    scores2 = [[np.array([scores[(k, st, i)] for i in range(hl2[st].n)],
                         np.int64) for st in (0, 1)]
               for k, hl2 in enumerate(hl_all)]
    for k, r in enumerate(reads):
        ls.walk(r, hits_all[k], scores2[k], K.CS_SW_VECT_THRESHOLD,
                only_paired=True)
    # the paired round: the pairs' heap, the full SW of their feet
    ph_sel = [pair_vector_hits(hits_all[2 * p], hits_all[2 * p + 1])
              for p in range(len(pairs))]
    jobs, seen = [], set()
    for p, sel in enumerate(ph_sel):
        for ph in sel:
            for nip in (0, 1):
                h = ph.rh[nip]
                if id(h) in seen or h.score_full >= 0:
                    continue
                seen.add(id(h))
                ls.normalize(reads[2 * p + nip], h, L)
                jobs.append((reads[2 * p + nip], h))
    cs.full_sw(idx, jobs, calib, [PAIR_THRESHOLD_FEET] * len(jobs))
    final_pairs = [pair_pass2(sel, L) for sel in ph_sel]
    # each mate's unpaired round on the same windows (half-paired)
    sels = []
    for k, r in enumerate(reads):
        ls.walk(r, hits_all[k], scores2[k], K.CS_SW_VECT_THRESHOLD)
        sels.append(ls.vector_hits(hits_all[k], K.CS_SW_VECT_THRESHOLD))
    jobs = []
    for k, sel in enumerate(sels):
        for h in sel:
            if h.score_full < 0:
                ls.normalize(reads[k], h, L)
                jobs.append((reads[k], h))
    fresh = {id(h) for _, h in jobs}
    cs.full_sw(idx, jobs, calib)
    for k, r in enumerate(reads):
        r.final_unpaired_hits = K.pass2(sels[k], fresh)
    out = []
    for p in range(len(pairs)):
        r = reads[2 * p:2 * p + 2]
        paired_mqv(r, final_pairs[p], L)
        lines = []
        for ph in final_pairs[p]:
            lines.append(render_hit(r[0], ph.rh[0], ph.rh[1], True,
                                    idx.contig_name, L))
            lines.append(render_hit(r[1], ph.rh[1], ph.rh[0], False,
                                    idx.contig_name, L))
        for nip in (0, 1):
            for h in r[nip].final_unpaired_hits:
                if nip == 0:
                    lines.append(render_hit(r[0], h, None, True,
                                            idx.contig_name, L))
                    lines.append(render_hit(r[1], None, h, False,
                                            idx.contig_name, L))
                else:
                    lines.append(render_hit(r[0], None, h, True,
                                            idx.contig_name, L))
                    lines.append(render_hit(r[1], h, None, False,
                                            idx.contig_name, L))
        out.append(lines)
    return out
