"""The reference's letter-space unpaired mapping of one read, with
gmapper-ls's default options (one option set, match mode 2, regions on):
filter 1, the vector SW of every window (filter 2), pass 1's window
overlap walk and top-30 heap, the full SW with traceback of the windows
whose vector score passes (filter 3), pass 2's threshold, duplicate
removal and top 10, the posteriors and MAPQ, and the SAM records."""
from __future__ import annotations

import math
from typing import List

import numpy as np

from mapbench.reference import common as K
from mapbench.reference import filter1, sw


def prepare(name: str, seq: str) -> K.Read:
    codes = K.CHAR_TO_INT[np.frombuffer(seq.encode(), np.uint8)].astype(
        np.uint8)
    rc = K.COMPLEMENT[codes[::-1]]
    L = len(codes)
    return K.Read(name, seq, L, (codes, rc),
                  int(K.abs_or_pct(K.WINDOW_LEN, L)))


def hit_lists(idx, r: K.Read, cutoff: int, scores=K.LS_SCORES) -> list:
    """Filter 1 of both strands (Mapper.hit_lists of the JAX package)."""
    out = []
    for st in (0, 1):
        kmers = filter1.read_kmers(idx, r.codes[st], r.min_kmer_pos)
        has2 = filter1._region_marks(idx, kmers, cutoff, K.REGION_BITS,
                                     K.REGION_OVERLAP)
        anchors = filter1.get_anchor_list(idx, kmers, cutoff, r.read_len,
                                          collapse=True, has2_regions=has2)
        out.append(filter1.get_hit_list(
            idx, anchors, st, r.read_len, r.window_len, 2,
            K.WINDOW_GEN_THRESHOLD, scores["match"], scores["b_gap_open"],
            scores["b_gap_ext"]))
    return out


def make_hits(hl2) -> List[List[K.Hit]]:
    """Hit records of the windows; sort_idx numbers both strands
    (mapping.c:1243-1246)."""
    hits2 = [[], []]
    for st in (0, 1):
        hl = hl2[st]
        for i in range(hl.n):
            hits2[st].append(K.Hit(
                st=st, gen_st=0, cn=int(hl.cn[i]), g_off=int(hl.g_off[i]),
                w_len=int(hl.w_len[i]),
                score_window_gen=int(hl.score_window_gen[i]),
                kmer_matches=int(hl.matches[i]), score_vector=-1,
                score_max=int(hl.score_max[i]), ax=int(hl.ax[i]),
                ay=int(hl.ay[i]), alen=int(hl.alen[i]),
                awid=int(hl.awid[i]), g_off_pos_strand=int(hl.g_off[i])))
    for i, h in enumerate(hits2[0] + hits2[1]):
        h.sort_idx = i
    return hits2


def walk(r: K.Read, hits2, scores2, threshold: float,
         only_paired: bool = False) -> None:
    """The window-overlap walk of pass 1 (read_pass1_per_strand,
    mapping.c:1261-1339): a window within the overlap of the last one
    that passed scores 0; hits saved by an earlier round keep theirs."""
    ov = int(K.abs_or_pct(K.WINDOW_OVERLAP, r.window_len))
    for st in (0, 1):
        last_good = None
        for i, h in enumerate(hits2[st]):
            if only_paired and h.pair_min < 0:
                continue
            if h.kmer_matches < 2:
                continue
            if h.saved == 1:
                last_good = (h.cn, h.g_off_pos_strand)
                continue
            if (last_good is not None and h.cn == last_good[0]
                    and h.g_off_pos_strand + ov <= last_good[1]
                    + r.window_len):
                h.score_vector = 0
                h.pct_score_vector = 0
                continue
            if h.score_vector <= 0:
                h.score_vector = int(scores2[st][i])
                h.pct_score_vector = (1000 * 100 * h.score_vector
                                      ) // h.score_max
                if h.score_vector >= int(K.abs_or_pct(threshold,
                                                      h.score_max)):
                    last_good = (h.cn, h.g_off_pos_strand)


def vector_hits(hits2, threshold: float) -> List[K.Hit]:
    """The top-30 heap of the passing, unsaved windows
    (read_get_vector_hits, mapping.c:1376-1411); the heap's array."""
    heap = K.ExtHeap(K.NUM_TMP_OUTPUTS)
    for st in (0, 1):
        for h in hits2[st]:
            if h.saved == 1 or h.score_vector < int(
                    K.abs_or_pct(threshold, h.score_max)):
                continue
            key = h.pct_score_vector
            if len(heap.a) < heap.capacity:
                h.pass1_key = key
                heap.insert(h)
            elif key > heap.a[0].pass1_key:
                h.pass1_key = key
                heap.replace_min(h)
    return list(heap.a)


def pass1(r: K.Read, hits2, scores2, threshold: float) -> List[K.Hit]:
    walk(r, hits2, scores2, threshold)
    return vector_hits(hits2, threshold)


def normalize(r: K.Read, h: K.Hit, contig_len: int) -> None:
    """Strand normalisation (reverse_hit, mapping.c:254-263)."""
    if h.st != r.input_strand:
        h.g_off = contig_len - h.g_off - h.w_len
        ax, ay = h.ax, h.ay
        h.ax = -ax + (h.w_len - 1) - (h.alen - 1) - (h.awid - 1)
        h.ay = -ay + (r.read_len - 1) - (h.alen - 1) + (h.awid - 1)
        h.gen_st = 1 - h.gen_st
        h.st = 1 - h.st


def full_sw(idx, r: K.Read, h: K.Hit, codes_rc: np.ndarray,
            calib: K.Calibration) -> None:
    """Filter 3 of one hit (hit_run_full_sw, mapping.c:331-402, global
    alignment) and the letter-space posterior (hit_run_post_sw,
    mapping.c:1609-1625)."""
    sc = K.LS_SCORES
    src = idx.codes if h.gen_st == 0 else codes_rc
    g = src[h.g_off:h.g_off + h.w_len]
    res = sw.sw_full_ls(g, r.codes[r.input_strand], sc["match"],
                        sc["mismatch"], sc["a_gap_open"], sc["a_gap_ext"],
                        sc["b_gap_open"], sc["b_gap_ext"], 0, 0,
                        revcmpl=bool(h.gen_st),
                        anchor=(h.ax, h.ay, h.alen, h.awid),
                        anchor_width=K.ANCHOR_WIDTH, local_alignment=False)
    h.sw_score = res.score
    h.read_start, h.genome_start = res.read_start, res.genome_start + h.g_off
    h.rmapped, h.gmapped = res.rmapped, res.gmapped
    h.matches, h.mismatches = res.matches, res.mismatches
    h.insertions, h.deletions = res.insertions, res.deletions
    h.ops = list(res.ops)
    h.score_full = res.score
    h.pct_score_full = (1000 * 100 * h.score_full) // h.score_max
    if h.score_full > 0:
        a, b = calib.alpha, calib.beta
        h.posterior = math.pow(2.0, (h.sw_score - h.rmapped * (2 * a + b))
                               / a)
        ps = int(round(a * math.log2(h.posterior) + h.rmapped * (2 * a + b)))
        h.posterior_score = max(ps, 0)
        h.score_full = h.posterior_score
        h.pct_score_full = (1000 * 100 * h.posterior_score) // h.score_max


def map_reads(idx, reads: List[K.Read], sat=None) -> List[List[str]]:
    """SAM records (without QNAME) of each read."""
    sc = K.LS_SCORES
    cutoff = K.list_cutoff(idx.length)
    calib = K.calibration("ls")
    codes_rc = K.COMPLEMENT[idx.codes[::-1]]
    L = idx.length
    hl_all = [hit_lists(idx, r, cutoff) for r in reads]
    # filter 2 over every window of every read at once
    rows = [(k, st, i) for k, hl2 in enumerate(hl_all) for st in (0, 1)
            for i in range(hl2[st].n)]
    scores = {}
    if rows:
        G = max(int(hl_all[k][st].w_len[i]) for k, st, i in rows)
        R = max(r.read_len for r in reads)
        gw = np.full((len(rows), G), 254, np.uint8)
        rw = np.full((len(rows), R), 254, np.uint8)
        glen = np.zeros(len(rows), np.int64)
        rlen = np.zeros(len(rows), np.int64)
        for b, (k, st, i) in enumerate(rows):
            hl = hl_all[k][st]
            s = int(hl.g_off[i])
            w = int(hl.w_len[i])
            gw[b, :w] = idx.codes[s:s + w]
            glen[b] = w
            rw[b, :reads[k].read_len] = reads[k].codes[st]
            rlen[b] = reads[k].read_len
        v = sw.vector_scores(gw, glen, rw, rlen, sc["match"], sc["mismatch"],
                             sc["a_gap_open"], sc["a_gap_ext"],
                             sc["b_gap_open"], sc["b_gap_ext"], sat=sat)
        for b, key in enumerate(rows):
            scores[key] = int(v[b])
    out = []
    for k, r in enumerate(reads):
        hl2 = hl_all[k]
        scores2 = [np.array([scores[(k, st, i)] for i in range(hl2[st].n)],
                            np.int64) for st in (0, 1)]
        hits = pass1(r, make_hits(hl2), scores2, K.SW_FULL_THRESHOLD)
        for h in hits:
            normalize(r, h, L)
            if h.score_vector >= int(K.abs_or_pct(K.SW_FULL_THRESHOLD,
                                                  h.score_max)):
                full_sw(idx, r, h, codes_rc, calib)
            else:
                h.sw_score = h.score_full = h.pct_score_full = 0
        final = K.finalize(hits)
        out.append([K.render(r, h, idx.contig_name, L, "ls")
                    for h in final])
    return out
