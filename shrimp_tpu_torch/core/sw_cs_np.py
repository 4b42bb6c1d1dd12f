"""Exact numpy oracle for the colour-space 4-layer full SW
(common/sw-full-cs.c) and the post-SW forward-backward rescoring
(common/sw-post.c).

Slow scalar reference implementations: the semantic spec for the batched
JAX kernels and the correctness path while those are built.

Copied from `shrimp_tpu/core/sw_cs_np.py` unchanged: the port keeps its own
copy of the JAX package's host modules and imports none of them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from .. import constants as C
from .sw_np import NEG_INF, _anchor_x_range, _join2_rect, _join_widen

# op codes for the CS backtrace (sw-full-cs.c:85-95 collapsed):
CS_INS = 1        # genome-only step (CIGAR D)
CS_DEL = 2        # read-only step (CIGAR I)
CS_MM = 3         # match/mismatch
# packed per-step value: op | layer << 2 | xover << 4

_DIR_NW, _DIR_N, _DIR_W = 0, 1, 2   # plane ids


def cs_read_layers(colours: np.ndarray, initbp: int) -> np.ndarray:
    """The 4 letter-space translations of a CS read
    (sw_full_cs, sw-full-cs.c:1181-1195). Layer i starts from letter
    (i+initbp)%4; N colours emit BASE_N and reset the chain."""
    rlen = len(colours)
    qr = np.zeros((4, rlen), np.uint8)
    for i in range(4):
        letter = (i + initbp) % 4
        for j in range(rlen):
            base = int(colours[j])
            if base == C.BASE_N:
                qr[i, j] = C.BASE_N
                letter = (i + initbp) % 4
            else:
                nxt = _cstols(letter, base)
                qr[i, j] = nxt
                letter = nxt
    return qr


def _cstols(first_letter: int, colour: int) -> int:
    if first_letter == C.BASE_N or not (0 <= colour <= 3):
        return C.BASE_N
    if first_letter % 2 == 0:
        return (4 + first_letter + colour) % 4
    return (4 + first_letter - colour) % 4


@dataclass
class CSFullResult:
    score: int
    read_start: int = 0
    genome_start: int = 0
    rmapped: int = 0
    gmapped: int = 0
    matches: int = 0
    mismatches: int = 0
    insertions: int = 0
    deletions: int = 0
    crossovers: int = 0
    steps: np.ndarray = None     # packed op|layer<<2|xover<<4, align order
    dbalign: str = ""
    qralign: str = ""


def sw_full_cs(genome_ls: np.ndarray, colours: np.ndarray, initbp: int,
               match: int, mismatch: int,
               a_gap_open: int, a_gap_ext: int,
               b_gap_open: int, b_gap_ext: int,
               threshscore: int, global_xover: int,
               revcmpl: bool = False,
               anchor: Optional[Tuple[int, int, int, int]] = None,
               anchor_width: int = 8,
               local_alignment: bool = False,
               crossover_score: Optional[np.ndarray] = None,
               indel_taboo_len: int = 0) -> CSFullResult:
    """4-layer banded DP with crossovers (sw-full-cs.c:249-623)."""
    go_a, ge_a = -a_gap_open, -a_gap_ext
    go_b, ge_b = -b_gap_open, -b_gap_ext
    G, R = len(genome_ls), len(colours)
    qr = cs_read_layers(colours, initbp)
    db = genome_ls

    if anchor is not None and anchor_width >= 0:
        ax, ay, alen, awid = _join_widen(*anchor, anchor_width)
    else:
        y0 = (R * match - threshscore) // match
        ax, ay, alen, awid = _join2_rect((0, y0, 1, 1),
                                         (G - 1, R - 1 - y0, 1, 1))

    # planes[k][plane] value arrays (R+1, G+1); back arrays hold
    # (layer, dir) tuples, 0 meaning stop
    val = np.zeros((4, 3, R + 1, G + 1), np.int64)
    bk = np.zeros((4, 3, R + 1, G + 1), np.int16)  # packed ref FROM codes

    def init_cell(r, c, local, xover):
        for k in range(4):
            off = 0 if k == 0 else xover
            if local:
                val[k, _DIR_NW, r, c] = off
                val[k, _DIR_N, r, c] = b_gap_open + off
                val[k, _DIR_W, r, c] = a_gap_open + off
            else:
                val[k, :, r, c] = NEG_INF
            bk[k, :, r, c] = 0

    for j in range(G + 1):
        init_cell(0, j, True, global_xover)

    score = 0
    max_i = max_j = max_k = 0
    plane_order = ([_DIR_NW, _DIR_N, _DIR_W] if not revcmpl
                   else [_DIR_W, _DIR_N, _DIR_NW])
    for i in range(R):
        xover = (global_xover if crossover_score is None
                 else int(crossover_score[i]))
        x_min, x_max = _anchor_x_range(ax, ay, alen, awid, G, i)
        init_cell(i + 1, x_min - 1 + 1, local_alignment, xover)
        no_taboo = i < R - indel_taboo_len
        for j in range(x_min, x_max + 1):
            for k in range(4):
                resetval = 0 if k == 0 else xover
                # ---- northwest plane
                if db[j] == C.BASE_N or qr[k, i] == C.BASE_N:
                    ms = 0
                else:
                    ms = match if db[j] == qr[k, i] else mismatch

                def nw_cands():
                    # own layer first, dir order per revcmpl; then other
                    # layers 0..3 with xover penalty
                    dirs = ([_DIR_NW, _DIR_N, _DIR_W] if not revcmpl
                            else [_DIR_W, _DIR_N, _DIR_NW])
                    for d in dirs:
                        if d == _DIR_N and not no_taboo:
                            continue
                        yield (val[k, d, i, j] + ms, (k, d))
                    for l in range(4):
                        if l == k:
                            continue
                        for d in dirs:
                            if d == _DIR_N and not no_taboo:
                                continue
                            yield (val[l, d, i, j] + ms + xover, (l, d))

                it = nw_cands()
                tmp, tmp2 = next(it)
                for v, src in it:
                    if v > tmp:
                        tmp, tmp2 = v, src
                if tmp <= resetval and local_alignment:
                    tmp, tmp2 = resetval, None
                val[k, _DIR_NW, i + 1, j + 1] = tmp
                bk[k, _DIR_NW, i + 1, j + 1] = _pack_src(tmp2, _DIR_NW)

                # ---- north plane (read-consuming gap)
                def n_cands():
                    own = [(val[k, _DIR_NW, i, j + 1] - go_b - ge_b,
                            (k, _DIR_NW), no_taboo),
                           (val[k, _DIR_N, i, j + 1] - ge_b,
                            (k, _DIR_N), True)]
                    if revcmpl:
                        own = own[::-1]
                    # reference quirk (sw-full-cs.c:456): when in the taboo
                    # zone, extension is taken unconditionally
                    if not revcmpl and not no_taboo:
                        own = [own[1]]
                    elif revcmpl and not no_taboo:
                        own = [own[0]]
                    for v, src, ok in own:
                        if ok:
                            yield v, src
                    others = []
                    for l in range(4):
                        if l == k:
                            continue
                        cand = [(val[l, _DIR_NW, i, j + 1] - go_b - ge_b
                                 + xover, (l, _DIR_NW), no_taboo),
                                (val[l, _DIR_N, i, j + 1] - ge_b + xover,
                                 (l, _DIR_N), True)]
                        if revcmpl:
                            cand = cand[::-1]
                        others.extend(cand)
                    for v, src, ok in others:
                        if ok:
                            yield v, src

                it = n_cands()
                tmp, tmp2 = next(it)
                for v, src in it:
                    if v > tmp:
                        tmp, tmp2 = v, src
                if tmp <= resetval and local_alignment:
                    tmp, tmp2 = resetval, None
                val[k, _DIR_N, i + 1, j + 1] = tmp
                bk[k, _DIR_N, i + 1, j + 1] = _pack_src(tmp2, _DIR_N)

                # ---- west plane (genome-consuming gap; no crossovers)
                own = [(val[k, _DIR_NW, i + 1, j] - go_a - ge_a,
                        (k, _DIR_NW), no_taboo),
                       (val[k, _DIR_W, i + 1, j] - ge_a, (k, _DIR_W), True)]
                if revcmpl:
                    own = own[::-1]
                if not revcmpl and not no_taboo:
                    own = [own[1]]
                elif revcmpl and not no_taboo:
                    own = [own[0]]
                cands = [(v, src) for v, src, ok in own if ok]
                tmp, tmp2 = cands[0]
                for v, src in cands[1:]:
                    if v > tmp:
                        tmp, tmp2 = v, src
                if tmp <= resetval and local_alignment:
                    tmp, tmp2 = resetval, None
                val[k, _DIR_W, i + 1, j + 1] = tmp
                bk[k, _DIR_W, i + 1, j + 1] = _pack_src(tmp2, _DIR_W)

                # ---- score tracking (sw-full-cs.c:552-580)
                if local_alignment or i == R - 1:
                    for d in plane_order:
                        if val[k, d, i + 1, j + 1] > score:
                            score = int(val[k, d, i + 1, j + 1])
                            max_i, max_j, max_k = i, j, k
        if i + 1 < R:
            nx_min, nx_max = _anchor_x_range(ax, ay, alen, awid, G, i + 1)
            for j in range(x_max + 1, nx_max + 1):
                init_cell(i + 1, j + 1, local_alignment, xover)

    res = CSFullResult(score=int(score))
    if score < threshscore:
        res.score = 0
        return res
    _cs_backtrace(db, qr, val, bk, max_i, max_j, max_k, res, revcmpl)
    return res


def _pack_src(src, plane) -> int:
    """Encode (layer, dir) in the reference FROM_x form
    (sw-full-cs.c:51): (dir_code << 2) | layer, 0 = stop."""
    if src is None:
        return 0
    l, d = src
    if plane == _DIR_NW:
        code = {_DIR_N: 5, _DIR_NW: 6, _DIR_W: 7}[d]
    elif plane == _DIR_N:
        code = {_DIR_N: 1, _DIR_NW: 2}[d]
    else:
        code = {_DIR_NW: 3, _DIR_W: 4}[d]
    return (code << 2) | l


def _unpack_src(v: int) -> Tuple[int, int, int]:
    """-> (layer, dir_plane, came_from_plane) per reference codes."""
    l = v & 3
    code = v >> 2
    # code: 1 N_N, 2 N_NW, 3 W_NW, 4 W_W, 5 NW_N, 6 NW_NW, 7 NW_W
    next_plane = {1: _DIR_N, 2: _DIR_NW, 3: _DIR_NW, 4: _DIR_W,
                  5: _DIR_N, 6: _DIR_NW, 7: _DIR_W}[code]
    this_plane = (_DIR_N if code in (1, 2) else
                  _DIR_W if code in (3, 4) else _DIR_NW)
    return l, next_plane, this_plane


def _cs_backtrace(db, qr, val, bk, i, j, k, res: CSFullResult,
                  revcmpl: bool) -> None:
    """do_backtrace (sw-full-cs.c:633-937)."""
    frm = bk[k, _DIR_NW, i + 1, j + 1]
    fs = val[k, _DIR_NW, i + 1, j + 1]
    if val[k, _DIR_W, i + 1, j + 1] > fs:
        frm = bk[k, _DIR_W, i + 1, j + 1]
        fs = val[k, _DIR_W, i + 1, j + 1]
    if val[k, _DIR_N, i + 1, j + 1] > fs:
        frm = bk[k, _DIR_N, i + 1, j + 1]
    assert frm != 0
    steps = []
    res.read_start = i
    res.genome_start = j
    while i >= 0 and j >= 0:
        l, next_plane, this_plane = _unpack_src(int(frm))
        if this_plane == _DIR_N:
            op = CS_DEL
            res.deletions += 1
            res.read_start = i
            i -= 1
        elif this_plane == _DIR_W:
            op = CS_INS
            res.insertions += 1
            res.genome_start = j
            j -= 1
        else:
            op = CS_MM
            if db[j] == qr[k, i] or db[j] == C.BASE_N \
                    or qr[k, i] == C.BASE_N:
                res.matches += 1
            else:
                res.mismatches += 1
            res.read_start = i
            res.genome_start = j
            i -= 1
            j -= 1
        # the op byte records the CELL's layer (do_backtrace writes
        # BACK_k_* before the `set k` switch, sw-full-cs.c:722-797)
        cell_k = k
        xover = 0
        if l != k:
            xover = 1
            res.crossovers += 1
            k = l
        steps.append(op | (cell_k << 2) | (xover << 4))
        frm = bk[k, next_plane, i + 1, j + 1]
        if frm == 0:
            break
    # leading crossover if the alignment starts in layer != 0
    if k != 0:
        steps[-1] |= 1 << 4
        res.crossovers += 1
    res.steps = np.array(steps[::-1], np.int16)
    res.rmapped = sum(1 for s in res.steps if (s & 3) != CS_INS)
    res.gmapped = sum(1 for s in res.steps if (s & 3) != CS_DEL)
    # alignment strings (pretty_print, sw-full-cs.c:945-1060)
    d_chars, q_chars = [], []
    ii, jj = res.read_start, res.genome_start
    for s in res.steps:
        op = s & 3
        lay = (s >> 2) & 3
        xo = (s >> 4) & 1
        if op == CS_DEL:
            d_chars.append("-")
            ch = "ACGTUMRWSYKVHDBN"[qr[lay, ii]]
            q_chars.append(ch.lower() if xo else ch)
            ii += 1
        elif op == CS_INS:
            d_chars.append("ACGTUMRWSYKVHDBN"[db[jj]])
            q_chars.append("-")
            jj += 1
        else:
            dc = "ACGTUMRWSYKVHDBN"[db[jj]]
            d_chars.append(dc)
            ch = "ACGTUMRWSYKVHDBN"[qr[lay, ii]]
            ch = ch.lower() if xo else ch
            # N base calls replaced by the genome letter (sw-full-cs.c:1049)
            if ch in "nN":
                ch = dc.lower() if xo else dc
            q_chars.append(ch)
            ii += 1
            jj += 1
    res.dbalign = "".join(d_chars)
    res.qralign = "".join(q_chars)


# ------------------------------------------------------------------ post-SW
def pr_err_from_qv(qv: int) -> float:
    if qv <= 0:
        return .99999999
    if qv >= 250:
        return 1e-25
    return math.pow(10.0, -qv / 10.0)


@dataclass
class PostSWResult:
    posterior: float
    qralign: str
    matches: int
    mismatches: int
    crossovers: int
    qual: str


def extract_columns(colours: np.ndarray, initbp: int, qual: Optional[str],
                    read_start: int, dbalign: str, qralign: str,
                    pr_xover: float, qual_delta: int = 33,
                    use_sanger_qvs: bool = True,
                    qual_vector_offset: int = 0):
    """load_local_vectors (sw-post.c:472-551): per-column letter/colour
    emissions and error rates. Returns (cols_let (-1=none), cols_col,
    cols_colerr, base_call) lists."""
    use_read_qvs = qual is not None
    start_run = 0
    min_qv = 10000
    for j in range(read_start):
        col = int(colours[j])
        if col == C.BASE_N:
            start_run = C.BASE_N
            min_qv = 0
            break
        start_run ^= col
        if use_read_qvs:
            min_qv = min(min_qv, ord(qual[qual_vector_offset + j]))

    cols_let: List[int] = []
    cols_col: List[int] = []
    cols_colerr: List[float] = []
    base_call: List[int] = []
    jj = read_start
    for i in range(len(dbalign)):
        if qralign[i] == "-":
            continue
        if dbalign[i] != "-":
            cols_let.append(int(C.CHAR_TO_INT[ord(dbalign[i].upper())]))
        else:
            cols_let.append(-1)
        col = int(colours[jj])
        ln = len(cols_col)
        if (ln == 0 and start_run == C.BASE_N) or col == C.BASE_N:
            cols_col.append(0)
            cols_colerr.append(.75)
        else:
            cols_col.append(col ^ (start_run if ln == 0 else 0))
            if use_read_qvs:
                q = ord(qual[qual_vector_offset + jj])
                if ln == 0:
                    q = min(min_qv, q)
                err = pr_err_from_qv(q - qual_delta)
                if not use_sanger_qvs:
                    err = err / (1 + err)
                cols_colerr.append(min(err, .75))
            else:
                cols_colerr.append(pr_xover)
        base_call.append(int(C.CHAR_TO_INT[ord(qralign[i].upper())]))
        jj += 1
    return cols_let, cols_col, cols_colerr, base_call


def post_sw_finish(initbp: int, dbalign: str, qralign: str,
                   cols_col, base_call, total: float, post: np.ndarray,
                   pr_del_open: float, pr_del_extend: float,
                   pr_ins_open: float, pr_ins_extend: float
                   ) -> "PostSWResult":
    """fix_base_calls + get_base_qualities + get_posterior
    (sw-post.c:554-633) given forward-backward results."""
    L = len(cols_col)
    maxpost = np.zeros(L, int)
    for i in range(L):
        mv = 0
        for j in range(1, 4):
            if post[i, j] > post[i, mv]:
                mv = j
        maxpost[i] = mv

    out = list(qralign)
    matches = mismatches = crossovers = 0
    prev = initbp
    j = 0
    for i in range(len(out)):
        if out[i] == "-":
            continue
        crt = int(maxpost[j])
        ch = "ACGT"[crt]
        if (prev ^ crt) == cols_col[j]:
            out[i] = ch
        else:
            out[i] = ch.lower()
            crossovers += 1
        if dbalign[i] != "-":
            if dbalign[i].upper() == out[i].upper():
                matches += 1
            else:
                mismatches += 1
        prev = crt
        j += 1

    quals = []
    for kq in range(L):
        bc = base_call[kq]
        if bc != C.BASE_N and bc <= 3:
            pr = post[kq, bc]
            pr_err = 1 - pr
            if pr_err > .99999999:
                tmp = 0
            elif pr_err < 1e-25:
                tmp = 250
            else:
                tmp = int(-10.0 * math.log(pr_err) / math.log(10.0))
        else:
            tmp = 0
        quals.append(chr(33 + min(tmp, 40)))

    res = math.exp(-total)
    for i in range(len(dbalign)):
        if dbalign[i] == "-":
            res *= pr_ins_extend
            if i == 0 or dbalign[i - 1] != "-":
                res *= pr_ins_open
        elif qralign[i] == "-":
            res *= pr_del_extend
            if i == 0 or qralign[i - 1] != "-":
                res *= pr_del_open
    return PostSWResult(posterior=res, qralign="".join(out),
                        matches=matches, mismatches=mismatches,
                        crossovers=crossovers, qual="".join(quals))


def post_sw(colours: np.ndarray, initbp: int, qual: Optional[str],
            read_start: int, dbalign: str, qralign: str,
            pr_snp: float, pr_xover: float,
            pr_del_open: float, pr_del_extend: float,
            pr_ins_open: float, pr_ins_extend: float,
            qual_delta: int = 33, use_sanger_qvs: bool = True,
            qual_vector_offset: int = 0) -> PostSWResult:
    """16-state forward-backward over the alignment columns
    (common/sw-post.c:469-758)."""
    cols_let, cols_col, cols_colerr, base_call = extract_columns(
        colours, initbp, qual, read_start, dbalign, qralign, pr_xover,
        qual_delta, use_sanger_qvs, qual_vector_offset)
    cols_let_a = np.array([cols_let], np.int64)
    cols_col_a = np.array([cols_col], np.int64)
    cols_err_a = np.array([cols_colerr], np.float64)
    from .sw_cs_batch import post_sw_forward_backward_batch
    total, post = post_sw_forward_backward_batch(
        cols_let_a, cols_col_a, cols_err_a,
        np.array([len(cols_col)], np.int64), np.array([initbp], np.int64),
        pr_snp)
    return post_sw_finish(initbp, dbalign, qralign, cols_col, base_call,
                          float(total[0]), post[0], pr_del_open,
                          pr_del_extend, pr_ins_open, pr_ins_extend)


# ------------------------------------------------- batched gapless post

_UPPER_LUT = np.arange(256, dtype=np.uint8)
for _c in range(ord("a"), ord("z") + 1):
    _UPPER_LUT[_c] = _c - 32
_C2I_LUT = np.full(256, C.BASE_N, np.int64)
for _i, _ch in enumerate("ACGT"):
    _C2I_LUT[ord(_ch)] = _i
_I2C_LUT = np.frombuffer(b"ACGT", np.uint8)
_I2C_LOW = np.frombuffer(b"acgt", np.uint8)


def extract_columns_batch_gapless(colours: np.ndarray, read_start,
                                  ncols, dbalign_codes: np.ndarray,
                                  qralign_codes: np.ndarray,
                                  pr_xover: float):
    """extract_columns for a batch of GAPLESS, quality-less alignments
    (columns map 1:1 to read positions read_start..read_start+n-1).

    colours [B, R] int; read_start/ncols [B]; dbalign_codes /
    qralign_codes [B, Lmax] letter codes (BASE_N for N).  Returns
    (cols_let, cols_col, cols_err, base_call) shaped [B, Lmax] plus the
    valid mask.
    """
    B, Lmax = dbalign_codes.shape
    R = colours.shape[1]
    jj = np.arange(Lmax)[None, :]
    valid = jj < ncols[:, None]
    pos = np.clip(read_start[:, None] + jj, 0, R - 1)
    col = np.take_along_axis(colours.astype(np.int64), pos, axis=1)
    # start_run: XOR of the colours before read_start; N anywhere in the
    # prefix forces the (0, .75) first-column branch
    ridx = np.arange(R)[None, :]
    pre = ridx < read_start[:, None]
    pre_n = ((colours == C.BASE_N) & pre).any(axis=1)
    xr = np.bitwise_xor.reduce(
        np.where(pre, colours.astype(np.int64), 0), axis=1)
    cols_col = col.copy()
    cols_col[:, 0] ^= np.where(pre_n, 0, xr)
    n_first = pre_n[:, None] & (jj == 0)
    is_n = (col == C.BASE_N) | n_first
    cols_col = np.where(is_n, 0, cols_col)
    cols_err = np.where(is_n, 0.75, pr_xover)
    cols_let = dbalign_codes.astype(np.int64)
    base_call = qralign_codes.astype(np.int64)
    return cols_let, cols_col, cols_err, base_call, valid


def post_sw_finish_batch_gapless(initbp, dbalign_codes, cols_col,
                                 base_call, ncols, total: np.ndarray,
                                 post: np.ndarray) -> List[PostSWResult]:
    """post_sw_finish for a batch of gapless alignments (no indel
    posterior factors; fix_base_calls walks columns 1:1)."""
    B, Lmax = dbalign_codes.shape
    jj = np.arange(Lmax)[None, :]
    valid = jj < ncols[:, None]
    maxpost = np.argmax(post[:, :Lmax, :4], axis=2)       # first max
    prev = np.concatenate([initbp[:, None], maxpost[:, :-1]], axis=1)
    xov = (prev ^ maxpost) != cols_col
    dbl = dbalign_codes.astype(np.int64)
    match = (dbl == maxpost) & valid
    mism = (dbl != maxpost) & valid
    matches = match.sum(axis=1)
    mismatches = mism.sum(axis=1)
    crossovers = (xov & valid).sum(axis=1)
    chars = np.where(xov, _I2C_LOW[maxpost], _I2C_LUT[maxpost])
    # base qualities from the pre-post calls
    pr = np.take_along_axis(post[:, :Lmax], np.clip(base_call, 0, 3
                                                    )[:, :, None],
                            axis=2)[:, :, 0]
    pr_err = 1.0 - pr
    with np.errstate(divide="ignore"):
        tmp = np.where(pr_err > .99999999, 0,
                       np.where(pr_err < 1e-25, 250,
                                (-10.0 * np.log(np.maximum(pr_err, 1e-300))
                                 / math.log(10.0)).astype(np.int64)))
    bad = (base_call == C.BASE_N) | (base_call > 3)
    tmp = np.where(bad, 0, tmp)
    quals = (33 + np.minimum(tmp, 40)).astype(np.uint8)
    # scalar libm exp: numpy's SIMD exp differs from the reference's
    # exp() by ~1 ulp, which flips MQVs at exact-ratio boundaries
    res = np.array([math.exp(-t) for t in total], np.float64)
    out = []
    for b in range(B):
        n = int(ncols[b])
        out.append(PostSWResult(
            posterior=float(res[b]),
            qralign=bytes(chars[b, :n]).decode(),
            matches=int(matches[b]), mismatches=int(mismatches[b]),
            crossovers=int(crossovers[b]),
            qual=bytes(quals[b, :n]).decode()))
    return out
