"""Filter 1: spaced k-mer lookup, anchor lists and candidate windows,
per read and strand, after SHRiMP2's scalar code (the NumPy form of the
JAX package's `core/candidates.py`):

- read_get_mapidxs            gmapper/mapping.c:37-115
- read_get_region_counts      gmapper/mapping.c:459-542
- read_get_anchor_list        gmapper/mapping.c:861-1022
- read_get_hit_list           gmapper/mapping.c:1025-1258
- anchor geometry             common/anchors.c

The reference walks index lists through a K-way heap merge; the CSR
lists are sorted, so a stable sort of their concatenation gives the same
genome-ordered anchor stream.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from mapbench.reference.common import REGION_BITS, REGION_OVERLAP
from mapbench.reference.index import keys_at


def is_absolute(x: float) -> bool:
    return x < 0


@dataclass
class Anchors:
    """Genome-ordered anchor list for one (read, strand)."""
    x: np.ndarray
    y: np.ndarray
    length: np.ndarray
    weight: np.ndarray
    cn: np.ndarray

    @property
    def n(self) -> int:
        return len(self.x)


@dataclass
class HitList:
    """Candidate mapping windows for one (read, strand)."""
    st: int
    cn: np.ndarray
    g_off: np.ndarray
    w_len: np.ndarray
    score_window_gen: np.ndarray
    matches: np.ndarray
    score_max: np.ndarray
    ax: np.ndarray
    ay: np.ndarray
    alen: np.ndarray
    awid: np.ndarray
    aweight: np.ndarray

    @property
    def n(self) -> int:
        return len(self.g_off)


def read_kmers(index, read_codes: np.ndarray, min_kmer_pos: int
               ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Per seed: (k-mer start positions y, keys) of one strand
    (read_get_mapidxs_per_strand, mapping.c:37-70)."""
    out = []
    rlen = len(read_codes)
    for si in index.seeds:
        last = rlen - si.seed.span
        if last < min_kmer_pos:
            out.append((np.zeros(0, np.int64), np.zeros(0, np.uint32)))
            continue
        starts = np.arange(min_kmer_pos, last + 1, dtype=np.int64)
        out.append((starts, keys_at(read_codes[None, :], starts,
                                    si.seed)[0]))
    return out


def _region_marks(index, kmers, cutoff: int, region_bits: int,
                  region_overlap: int) -> np.ndarray:
    """Region ids marked >=2 times (HAS_2), for the region prefilter
    (read_get_region_counts, mapping.c:459-542).

    Every index position of every (seed, kmer) contributes one mark to its
    region and, when within region_overlap of the region start, one to the
    previous region. Returns the sorted array of region ids with >=2 marks.
    """
    mark_chunks = []
    mask = (1 << region_bits) - 1
    for si, (ys, keys) in zip(index.seeds, kmers):
        if len(keys) == 0:
            continue
        lo = si.offsets[keys]
        hi = si.offsets[keys + 1]
        ln = hi - lo
        ok = ln <= cutoff
        if not ok.any():
            continue
        lo, hi = lo[ok], hi[ok]
        idx = _ranges_to_flat(lo, hi)
        pos = si.positions[idx].astype(np.int64)
        r = pos >> region_bits
        mark_chunks.append(r)
        ov = (pos & mask) < region_overlap
        rext = r[ov] - 1
        mark_chunks.append(rext[rext >= 0])
    if not mark_chunks:
        return np.zeros(0, np.int64)
    marks = np.concatenate(mark_chunks)
    ids, counts = np.unique(marks, return_counts=True)
    return ids[counts >= 2]


def _ranges_to_flat(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Concatenate ranges [lo_i, hi_i) into one index array."""
    ln = (hi - lo).astype(np.int64)
    total = int(ln.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    starts = np.zeros(len(lo), dtype=np.int64)
    np.cumsum(ln[:-1], out=starts[1:])
    idx = np.repeat(lo - starts, ln)
    return idx + np.arange(total, dtype=np.int64)


def get_anchor_list(index, kmers, cutoff: int,
                    read_len: int, collapse: bool = True,
                    has2_regions: Optional[np.ndarray] = None,
                    region_bits: int = REGION_BITS,
                    region_overlap: int = REGION_OVERLAP,
                    ) -> Anchors:
    """Build the genome-ordered, collapsed anchor list for one strand
    (read_get_anchor_list_per_strand, mapping.c:861-1006)."""
    xs_chunks, ys_chunks, order_chunks = [], [], []
    for sn, (si, (ys, keys)) in enumerate(zip(index.seeds, kmers)):
        if len(keys) == 0:
            continue
        lo = si.offsets[keys]
        hi = si.offsets[keys + 1]
        ln = hi - lo
        ok = ln <= cutoff
        if not ok.any():
            continue
        lo2, hi2 = lo[ok], hi[ok]
        idx = _ranges_to_flat(lo2, hi2)
        pos = si.positions[idx].astype(np.int64)
        y = np.repeat(ys[ok], (hi2 - lo2).astype(np.int64))
        xs_chunks.append(pos)
        ys_chunks.append(y)
        # heap tie-break proxy: (sn, kmer index) stream id
        order_chunks.append(np.repeat(sn * read_len + ys[ok],
                                      (hi2 - lo2).astype(np.int64)))
    if not xs_chunks:
        z = np.zeros(0, np.int64)
        return Anchors(z, z.astype(np.int32), z.astype(np.int32),
                       z.astype(np.int32), z.astype(np.int32))

    x = np.concatenate(xs_chunks)
    y = np.concatenate(ys_chunks).astype(np.int64)
    stream = np.concatenate(order_chunks)

    # region prefilter (advance_index_in_genomemap, mapping.c:646-805)
    if has2_regions is not None:
        r = x >> region_bits
        keep = np.isin(r, has2_regions)
        mask = (1 << region_bits) - 1
        ov = ((x & mask) < region_overlap) & (r > 0)
        keep |= ov & np.isin(r - 1, has2_regions)
        x, y, stream = x[keep], y[keep], stream[keep]

    span_per_stream = np.zeros(len(index.seeds) * read_len, np.int32)
    for sn, si in enumerate(index.seeds):
        span_per_stream[sn * read_len:(sn + 1) * read_len] = si.seed.span
    length = span_per_stream[stream]

    order = np.lexsort((stream, x))
    x, y, length = x[order], y[order], length[order]
    cn = index.contig_of(x).astype(np.int32)

    if not collapse:
        return Anchors(x, y.astype(np.int32), length,
                       np.ones(len(x), np.int32), cn)
    return _collapse_anchors(x, y, length, cn, read_len)


def _collapse_anchors(x, y, length, cn, read_len: int) -> Anchors:
    """Join colinear anchors via the per-diagonal cache
    (mapping.c:957-971 + anchor_uw_join, anchors.c).

    The cache is keyed by (x - y) mod read_len and holds the index of the
    last emitted anchor with that key; a new anchor joins it iff truly
    colinear (same x - y) and same contig.
    """
    n = len(x)
    if n == 0:
        return Anchors(x, y.astype(np.int32), length,
                       np.ones(0, np.int32), cn)
    diag = x - y
    key = ((x + read_len - y) % read_len).astype(np.int64)

    # scalar loop (n is per-read-small); mirrors the reference exactly
    cache = {}
    out_x, out_y, out_len, out_w, out_cn = [], [], [], [], []
    for i in range(n):
        k = int(key[i])
        j = cache.get(k, -1)
        if (j >= 0 and out_cn[j] == cn[i]
                and (out_x[j] - out_y[j]) == diag[i]):
            # anchor_uw_join: src.x >= dest.x since stream is x-ascending
            if x[i] + length[i] > out_x[j] + out_len[j]:
                out_len[j] = int(x[i] - out_x[j] + length[i])
            out_w[j] += 1
        else:
            cache[k] = len(out_x)
            out_x.append(int(x[i]))
            out_y.append(int(y[i]))
            out_len.append(int(length[i]))
            out_w.append(1)
            out_cn.append(int(cn[i]))
    return Anchors(np.array(out_x, np.int64), np.array(out_y, np.int32),
                   np.array(out_len, np.int32), np.array(out_w, np.int32),
                   np.array(out_cn, np.int32))


def _anchor_join2(ax0, ay0, al0, aw0, ax1, ay1, al1, aw1, weight_sum):
    """anchor_join for two width-1 anchors (anchors.c:10-54), vectorized.
    Returns (x, y, length, width, weight)."""
    nw0, sw0 = ax0 + ay0, ax0 - ay0
    ne0, se0 = sw0 + 2 * (aw0 - 1), nw0 + 2 * (al0 - 1)
    nw1, sw1 = ax1 + ay1, ax1 - ay1
    ne1, se1 = sw1 + 2 * (aw1 - 1), nw1 + 2 * (al1 - 1)
    nw = np.minimum(nw0, nw1)
    sw = np.minimum(sw0, sw1)
    ne = np.maximum(ne0, ne1)
    se = np.maximum(se0, se1)
    nw = nw - ((nw + sw) % 2 != 0)
    jx = (nw + sw) // 2
    jy = nw - jx
    ne = ne + ((ne - sw) % 2 != 0)
    jw = (ne - sw) // 2 + 1
    se = se + ((se - nw) % 2 != 0)
    jl = (se - nw) // 2 + 1
    return jx, jy, jl, jw, weight_sum


def get_hit_list(index, anchors: Anchors, st: int,
                 read_len: int, window_len: int, match_mode: int,
                 threshold: float, match_score: int,
                 b_gap_open: int, b_gap_extend: int,
                 gapless: bool = False,
                 heavy_mp: Optional[np.ndarray] = None,
                 ) -> HitList:
    """Window generation (read_get_hit_list_per_strand, mapping.c:1025-1229).

    For every anchor, find the best upstream pairing anchor inside the
    window and keep the window if the optimistic score passes the
    window-generation threshold.
    """
    n = anchors.n
    empty = lambda dt: np.zeros(0, dt)
    if n == 0:
        return HitList(st, empty(np.int32), empty(np.int64), empty(np.int32),
                       empty(np.int32), empty(np.int32), empty(np.int32),
                       empty(np.int64), empty(np.int64), empty(np.int32),
                       empty(np.int32), empty(np.int32))

    x, y = anchors.x, anchors.y.astype(np.int64)
    alen = anchors.length.astype(np.int64)
    aweight = anchors.weight
    cn = anchors.cn
    coff = index.contig_offsets[cn].astype(np.int64)
    clen = index.contig_lengths[cn].astype(np.int64)

    w_len = np.minimum(window_len, clen).astype(np.int64)
    gend = (x - coff) + read_len - 1 - y
    gend = np.minimum(gend, clen - 1)
    gstart = np.where(gend >= window_len, gend - window_len, 0)

    # best pairing anchor (mapping.c:1095-1151)
    max_score = alen * match_score
    if not gapless and match_mode in (2, 3):
        single = aweight == 1
        if match_mode == 3 and heavy_mp is not None:
            single = single & ~heavy_mp
        max_score = np.where(single, -1, max_score)
    max_idx = np.arange(n, dtype=np.int64)

    if not gapless:
        # j-range per i: first j with x_j >= coff + gstart
        lo = np.searchsorted(x, coff + gstart, side="left")
        dmax = int(np.max(np.arange(n) - lo)) if n else 0
        for d in range(1, dmax + 1):
            i = np.arange(d, n, dtype=np.int64)
            j = i - d
            valid = (j >= lo[i]) & (y[j] < y[i])
            if not valid.any():
                continue
            dx = x[i] - x[j]
            dy = y[i] - y[j]
            deletion = dx > dy  # genome span longer (mapping.c:1115)
            short_len = np.where(deletion, dy, dx) + alen[i]
            long_len = np.where(deletion, dx, dy) + alen[i]
            gap = long_len > short_len
            tmp = short_len * match_score + np.where(
                gap, b_gap_open + (long_len - short_len) * b_gap_extend, 0)
            better = valid & (tmp > max_score[i])
            max_score[i] = np.where(better, tmp, max_score[i])
            max_idx[i] = np.where(better, j, max_idx[i])

    # threshold (mapping.c:1154-1158)
    cap = np.minimum(read_len, w_len) * match_score
    if gapless or match_mode == 1:
        keep = np.ones(n, bool)
    else:
        thr = (np.full(n, -threshold)
               if is_absolute(threshold) else cap * (threshold / 100.0))
        keep = max_score.astype(np.float64) >= thr
        if match_mode == 3 and heavy_mp is not None:
            keep |= heavy_mp

    i = np.nonzero(keep)[0]
    j = max_idx[i]
    # goff placement (mapping.c:1160-1170)
    x_len = (x[i] - x[j]) + alen[i]
    goff = np.where((window_len - x_len) // 2 < x[j] - coff[i],
                    (x[j] - coff[i]) - (window_len - x_len) // 2, 0)
    goff = np.where(goff + w_len[i] > clen[i], clen[i] - w_len[i], goff)

    # hit anchor rectangle (mapping.c:1172-1182), relative to goff
    rel_xi = x[i] - (coff[i] + goff)
    rel_xj = x[j] - (coff[i] + goff)
    ones = np.ones(len(i), np.int64)
    jx, jy, jl, jw, jwt = _anchor_join2(
        rel_xi, y[i], alen[i], ones, rel_xj, y[j], alen[j], ones,
        aweight[i].astype(np.int64) + aweight[j])
    same = j == i
    jx = np.where(same, rel_xi, jx)
    jy = np.where(same, y[i], jy)
    jl = np.where(same, alen[i], jl)
    jw = np.where(same, 1, jw)
    jwt = np.where(same, aweight[i], jwt)

    matches = np.where(same | gapless, aweight[i], aweight[i] + aweight[j])

    hl = HitList(
        st=st, cn=cn[i].astype(np.int32), g_off=goff.astype(np.int64),
        w_len=w_len[i].astype(np.int32),
        score_window_gen=max_score[i].astype(np.int32),
        matches=matches.astype(np.int32),
        score_max=cap[i].astype(np.int32),
        ax=jx.astype(np.int64), ay=jy.astype(np.int64),
        alen=jl.astype(np.int32), awid=jw.astype(np.int32),
        aweight=jwt.astype(np.int32))

    # stable sort by (cn, g_off) (insertion-sort fixup, mapping.c:1210-1223)
    order = np.lexsort((np.arange(hl.n), hl.g_off, hl.cn))
    return HitList(st, hl.cn[order], hl.g_off[order], hl.w_len[order],
                   hl.score_window_gen[order], hl.matches[order],
                   hl.score_max[order], hl.ax[order], hl.ay[order],
                   hl.alen[order], hl.awid[order], hl.aweight[order])
