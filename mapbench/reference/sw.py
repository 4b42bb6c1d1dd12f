"""Smith-Waterman, as SHRiMP2's kernels define it cell for cell:

- vector_scores: common/sw-vector.c:68-377, the score-only local affine
  SW of filter 2, as a row-major DP vectorised over windows (NumPy);
- sw_full_ls: common/sw-full-ls.c:154-516, the banded three-plane full
  SW with its traceback (filter 3, letter space), scalar (the JAX
  package's `core/sw_np.py`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

NEG_INF = -(2 ** 30)

FROM_NORTH_NORTH = 0x1
FROM_NORTH_NORTHWEST = 0x2
FROM_WEST_NORTHWEST = 0x3
FROM_WEST_WEST = 0x4
FROM_NORTHWEST_NORTH = 0x5
FROM_NORTHWEST_NORTHWEST = 0x6
FROM_NORTHWEST_WEST = 0x7

BACK_INSERTION = 1   # genome only: CIGAR D
BACK_DELETION = 2    # read only: CIGAR I
BACK_MATCH_MISMATCH = 3


def vector_scores(gw: np.ndarray, glen: np.ndarray, rw: np.ndarray,
                  rlen: np.ndarray, match: int, mismatch: int,
                  a_gap_open: int, a_gap_ext: int, b_gap_open: int,
                  b_gap_ext: int, sat: Optional[int] = None,
                  g_row0: Optional[np.ndarray] = None) -> np.ndarray:
    """Best local affine score of each window row gw[b, :glen[b]] against
    rw[b, :rlen[b]]: H = max(0, diag + s, E, F), E along the genome (a),
    F along the read (b), an open costing open + extend (sw-vector.c:
    172-178). `sat` saturates every cell at that value (the control's
    narrower scores); None is the configuration's int32. In colour space
    `g_row0` replaces the window in row 0: the first colour re-derived
    from the genome letter and the read's initial base (sw-vector.c:
    108-146)."""
    B, G = gw.shape
    R = rw.shape[1]
    oa, ea = -a_gap_open - a_gap_ext, -a_gap_ext
    ob, eb = -b_gap_open - b_gap_ext, -b_gap_ext
    H_prev = np.zeros((B, G + 1), np.int64)
    F_prev = np.full((B, G + 1), NEG_INF, np.int64)
    best = np.zeros(B, np.int64)
    colmask = np.arange(G)[None, :] < glen[:, None]
    H = np.zeros((B, G + 1), np.int64)
    for i in range(R):
        g = g_row0 if (i == 0 and g_row0 is not None) else gw
        s = np.where(g == rw[:, i:i + 1], match, mismatch)
        F = np.maximum(H_prev[:, 1:] - ob, F_prev[:, 1:] - eb)
        base = np.maximum(np.maximum(H_prev[:, :-1] + s, F), 0)
        E = np.full(B, NEG_INF, np.int64)
        H[:, 0] = 0
        for j in range(G):
            E = np.maximum(H[:, j] - oa, E - ea)
            H[:, j + 1] = np.maximum(base[:, j], E)
        if sat is not None:
            np.minimum(H, sat, out=H)
        live = colmask & (i < rlen)[:, None]
        best = np.maximum(best, np.where(live, H[:, 1:], 0).max(1))
        H_prev, H = H, H_prev
        F_prev = np.concatenate([np.full((B, 1), NEG_INF, np.int64), F], 1)
    return best


@dataclass
class SWFullResult:
    score: int
    read_start: int     # 0-based
    genome_start: int   # 0-based, window-relative
    rmapped: int
    gmapped: int
    matches: int
    mismatches: int
    insertions: int     # genome-only steps (CIGAR D count)
    deletions: int      # read-only steps (CIGAR I count)
    ops: np.ndarray     # BACK_* codes in alignment order
    dbalign: str
    qralign: str


def _anchor_x_range(ax: int, ay: int, alen: int, awid: int,
                    x_len: int, y: int) -> Tuple[int, int]:
    """anchor_get_x_range (common/anchors.c:66-95)."""
    if y < ay:
        x_min = 0
    elif y <= ay + (alen - 1):
        x_min = ax + (y - ay)
    else:
        x_min = ax + alen
    x_min = min(max(x_min, 0), x_len - 1)
    if y < ay - (awid - 1):
        x_max = ax + (awid - 1) - 1
    elif y <= ay - (awid - 1) + (alen - 1):
        x_max = ax + (awid - 1) + (y - (ay - (awid - 1)))
    else:
        x_max = x_len - 1
    x_max = min(max(x_max, 0), x_len - 1)
    return x_min, x_max


def _join_widen(ax, ay, alen, awid, width):
    """anchor_widen (anchors.c:57-62)."""
    return ax - width // 2, ay + width // 2, alen, awid + width


LS_CHARS = "ACGTUMRWSYKVHDBN"


def sw_full_ls(genome: np.ndarray, read: np.ndarray,
               match: int, mismatch: int,
               a_gap_open: int, a_gap_ext: int,
               b_gap_open: int, b_gap_ext: int,
               threshscore: int, maxscore: int,
               revcmpl: bool = False,
               anchor: Optional[Tuple[int, int, int, int]] = None,
               anchor_width: int = 8,
               local_alignment: bool = False) -> SWFullResult:
    """Full banded 3-plane SW with traceback (sw-full-ls.c:154-516).

    `anchor` is the (x, y, length, width) rectangle relative to the window;
    None means the threshold-derived default band (sw-full-ls.c:179-192).
    """
    go_a, ge_a = -a_gap_open, -a_gap_ext
    go_b, ge_b = -b_gap_open, -b_gap_ext
    G, R = len(genome), len(read)

    if anchor is not None and anchor_width >= 0:
        ax, ay, alen, awid = _join_widen(*anchor, anchor_width)
    else:
        y0 = (R * match - threshscore) // match
        a0 = (0, y0, 1, 1)
        a1 = (G - 1, R - 1 - y0, 1, 1)
        ax, ay, alen, awid = _join2_rect(a0, a1)

    # plane arrays, storage (R+1) x (G+1); row 0 = virtual row -1
    nw = np.zeros((R + 1, G + 1), np.int64)
    n = np.zeros((R + 1, G + 1), np.int64)
    w = np.zeros((R + 1, G + 1), np.int64)
    bnw = np.zeros((R + 1, G + 1), np.int8)
    bn = np.zeros((R + 1, G + 1), np.int8)
    bw = np.zeros((R + 1, G + 1), np.int8)

    def init_cell(r, c, local):
        if local:
            nw[r, c] = 0
            n[r, c] = -(-b_gap_open)
            w[r, c] = -(-a_gap_open)
        else:
            nw[r, c] = n[r, c] = w[r, c] = NEG_INF
        bnw[r, c] = bn[r, c] = bw[r, c] = 0

    # top boundary: init_cell(j, 1) for all j (sw-full-ls.c:194-196)
    for j in range(G + 1):
        init_cell(0, j, True)

    score = 0
    max_i = max_j = 0
    done = False
    for i in range(R):
        x_min, x_max = _anchor_x_range(ax, ay, alen, awid, G, i)
        init_cell(i + 1, x_min - 1 + 1, local_alignment)
        for j in range(x_min, x_max + 1):
            s = match if genome[j] == read[i] else mismatch
            # northwest plane
            cands = [(nw[i, j], FROM_NORTHWEST_NORTHWEST),
                     (n[i, j], FROM_NORTHWEST_NORTH),
                     (w[i, j], FROM_NORTHWEST_WEST)]
            if revcmpl:
                order = [2, 1, 0]
            else:
                order = [0, 1, 2]
            tmp, tmp2 = cands[order[0]]
            for k in order[1:]:
                if cands[k][0] > tmp:
                    tmp, tmp2 = cands[k]
            tmp += s
            if tmp <= 0 and local_alignment:
                tmp, tmp2 = 0, 0
            nw[i + 1, j + 1] = tmp
            bnw[i + 1, j + 1] = tmp2
            # north plane
            c_open = (nw[i, j + 1] - go_b - ge_b, FROM_NORTH_NORTHWEST)
            c_ext = (n[i, j + 1] - ge_b, FROM_NORTH_NORTH)
            first, second = ((c_open, c_ext) if not revcmpl
                             else (c_ext, c_open))
            tmp, tmp2 = first
            if second[0] > tmp:
                tmp, tmp2 = second
            if tmp <= 0 and local_alignment:
                tmp, tmp2 = 0, 0
            n[i + 1, j + 1] = tmp
            bn[i + 1, j + 1] = tmp2
            # west plane
            c_open = (nw[i + 1, j] - go_a - ge_a, FROM_WEST_NORTHWEST)
            c_ext = (w[i + 1, j] - ge_a, FROM_WEST_WEST)
            first, second = ((c_open, c_ext) if not revcmpl
                             else (c_ext, c_open))
            tmp, tmp2 = first
            if second[0] > tmp:
                tmp, tmp2 = second
            if tmp <= 0 and local_alignment:
                tmp, tmp2 = 0, 0
            w[i + 1, j + 1] = tmp
            bw[i + 1, j + 1] = tmp2
            # max score (sw-full-ls.c:359-368)
            if local_alignment or i == R - 1:
                t = max(n[i + 1, j + 1], nw[i + 1, j + 1], w[i + 1, j + 1])
                if t > score:
                    score = t
                    max_i, max_j = i, j
            if score == maxscore and local_alignment:
                done = True
                break
        if done:
            break
        if i + 1 < R:
            nx_min, nx_max = _anchor_x_range(ax, ay, alen, awid, G, i + 1)
            for j in range(x_max + 1, nx_max + 1):
                init_cell(i + 1, j + 1, local_alignment)

    if local_alignment and score != maxscore and anchor is not None:
        # retry unbanded (sw-full-ls.c:395-398)
        return sw_full_ls(genome, read, match, mismatch, a_gap_open,
                          a_gap_ext, b_gap_open, b_gap_ext, threshscore,
                          maxscore, revcmpl, None, -1, True)

    res = _backtrace(genome, read, nw, n, w, bnw, bn, bw,
                     int(score), max_i, max_j)
    if local_alignment and score != maxscore:
        # unbanded local miss: NDEBUG reference returns score 0 while
        # keeping the max-cell backtrace (sw-full-ls.c:394-401)
        res.score = 0
    return res


def _join2_rect(a0, a1):
    """anchor_join for two (x,y,len,wid) rectangles (anchors.c:10-54)."""
    nwm = swm = 1 << 60
    nem = sem = -(1 << 60)
    for (x, y, ln, wd) in (a0, a1):
        b_nw, b_sw = x + y, x - y
        b_ne, b_se = b_sw + 2 * (wd - 1), b_nw + 2 * (ln - 1)
        nwm, swm = min(nwm, b_nw), min(swm, b_sw)
        nem, sem = max(nem, b_ne), max(sem, b_se)
    if (nwm + swm) % 2 != 0:
        nwm -= 1
    x = (nwm + swm) // 2
    y = nwm - x
    if (nem - swm) % 2 != 0:
        nem += 1
    wd = (nem - swm) // 2 + 1
    if (sem - nwm) % 2 != 0:
        sem += 1
    ln = (sem - nwm) // 2 + 1
    return x, y, ln, wd


def _backtrace(genome, read, nw, n, w, bnw, bn, bw, score, i, j
               ) -> SWFullResult:
    """do_backtrace + pretty_print (sw-full-ls.c:413-560)."""
    res = SWFullResult(score, 0, 0, 0, 0, 0, 0, 0, 0,
                       np.zeros(0, np.int8), "", "")
    frm = bnw[i + 1, j + 1]
    fs = nw[i + 1, j + 1]
    if w[i + 1, j + 1] > fs:
        frm, fs = bw[i + 1, j + 1], w[i + 1, j + 1]
    if n[i + 1, j + 1] > fs:
        frm = bn[i + 1, j + 1]
    ops = []
    db_chars, qr_chars = [], []
    while i >= 0 and j >= 0:
        if frm in (FROM_NORTH_NORTH, FROM_NORTH_NORTHWEST):
            ops.append(BACK_DELETION)
            db_chars.append("-")
            qr_chars.append(LS_CHARS[read[i]])
            res.deletions += 1
            res.read_start = i
            i -= 1
        elif frm in (FROM_WEST_WEST, FROM_WEST_NORTHWEST):
            ops.append(BACK_INSERTION)
            db_chars.append(LS_CHARS[genome[j]])
            qr_chars.append("-")
            res.insertions += 1
            res.genome_start = j
            j -= 1
        else:
            ops.append(BACK_MATCH_MISMATCH)
            db_chars.append(LS_CHARS[genome[j]])
            qr_chars.append(LS_CHARS[read[i]])
            if genome[j] == read[i]:
                res.matches += 1
            else:
                res.mismatches += 1
            res.read_start = i
            res.genome_start = j
            i -= 1
            j -= 1
        if frm == FROM_NORTH_NORTH:
            frm = bn[i + 1, j + 1]
        elif frm in (FROM_NORTH_NORTHWEST, FROM_WEST_NORTHWEST,
                     FROM_NORTHWEST_NORTHWEST):
            frm = bnw[i + 1, j + 1]
        elif frm == FROM_WEST_WEST:
            frm = bw[i + 1, j + 1]
        elif frm == FROM_NORTHWEST_NORTH:
            frm = bn[i + 1, j + 1]
        elif frm == FROM_NORTHWEST_WEST:
            frm = bw[i + 1, j + 1]
        if frm == 0:
            break
    res.ops = np.array(ops[::-1], np.int8)
    res.dbalign = "".join(db_chars[::-1])
    res.qralign = "".join(qr_chars[::-1])
    # rmapped/gmapped computed from the backtrace extent (sw-full-ls.c:673-675)
    last_i = res.read_start + sum(1 for o in res.ops
                                  if o != BACK_INSERTION) - 1
    last_j = res.genome_start + sum(1 for o in res.ops
                                    if o != BACK_DELETION) - 1
    res.rmapped = last_i - res.read_start + 1
    res.gmapped = last_j - res.genome_start + 1
    return res
