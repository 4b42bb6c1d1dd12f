"""The colour-space full SW of filter 3: the four-layer DP with its
traceback (common/sw-full-cs.c), vectorised over a batch of (window,
read) pairs: value planes [B, 4, G], rows scanned in turn, the west
chain of a row by a doubling max-plus scan, the reference's tie-break
order by strict-greater updates in priority order. The JAX package's
`core/sw_cs_batch.py` (held equal there to the scalar oracle), copied.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from mapbench.reference.common import BASE_N

NEG = -(2 ** 30)
_DIR_NW, _DIR_N, _DIR_W = 0, 1, 2
# reference dir-pair codes
_NN, _NNW, _WNW, _WW, _NWN, _NWNW, _NWW = 1, 2, 3, 4, 5, 6, 7
_NW_CODE = {_DIR_N: _NWN, _DIR_NW: _NWNW, _DIR_W: _NWW}


def cs_layers_batch(colours: np.ndarray, initbp: np.ndarray) -> np.ndarray:
    """[B, R] colour codes -> [B, 4, R] letter translations
    (sw-full-cs.c:1181-1195)."""
    B, R = colours.shape
    qr = np.zeros((B, 4, R), np.uint8)
    start = ((np.arange(4)[None, :] + initbp[:, None]) % 4).astype(np.int64)
    letter = start.copy()
    for j in range(R):
        col = colours[:, j].astype(np.int64)[:, None]
        isn = col == BASE_N
        even = letter % 2 == 0
        nxt = np.where(even, (4 + letter + col) % 4, (4 + letter - col) % 4)
        qr[:, :, j] = np.where(isn, BASE_N, nxt)
        letter = np.where(isn, start, nxt)
    return qr


def _band(ax, ay, alen, awid, glen, i):
    x_min = np.where(i < ay, 0,
                     np.where(i <= ay + alen - 1, ax + (i - ay), ax + alen))
    x_min = np.clip(x_min, 0, glen - 1)
    x_max = np.where(i < ay - (awid - 1), ax + awid - 2,
                     np.where(i <= ay - (awid - 1) + alen - 1,
                              ax + (awid - 1) + (i - (ay - (awid - 1))),
                              glen - 1))
    x_max = np.clip(x_max, 0, glen - 1)
    return x_min, x_max


@dataclass
class CSBatchResult:
    score: np.ndarray          # [B]
    steps: np.ndarray          # [B, R+G] packed op|layer<<2|xover<<4
    n_steps: np.ndarray
    read_start: np.ndarray
    genome_start: np.ndarray
    rmapped: np.ndarray
    gmapped: np.ndarray
    matches: np.ndarray
    mismatches: np.ndarray
    insertions: np.ndarray
    deletions: np.ndarray
    crossovers: np.ndarray
    qr: np.ndarray             # [B, 4, R] letter layers


def sw_full_cs_batch(genome_ls: np.ndarray, glen: np.ndarray,
                     colours: np.ndarray, rlen: np.ndarray,
                     initbp: np.ndarray,
                     ax: np.ndarray, ay: np.ndarray,
                     alen: np.ndarray, awid: np.ndarray,
                     revcmpl: np.ndarray,
                     xover_rows: np.ndarray,    # [B, R] per-row penalties
                     thresh: np.ndarray,        # [B] score < thresh -> 0
                     *, match: int, mismatch: int,
                     a_gap_open: int, a_gap_ext: int,
                     b_gap_open: int, b_gap_ext: int,
                     local_alignment: bool = False,
                     indel_taboo_len: int = 0) -> CSBatchResult:
    B, G = genome_ls.shape
    R = colours.shape[1]
    go_a, ge_a = -(a_gap_open), -(a_gap_ext)
    go_b, ge_b = -(b_gap_open), -(b_gap_ext)
    qr = cs_layers_batch(colours, initbp)
    db = genome_ls.astype(np.int16)
    ax64, ay64 = ax.astype(np.int64), ay.astype(np.int64)
    alen64, awid64 = alen.astype(np.int64), awid.astype(np.int64)
    glen64 = glen.astype(np.int64)
    rvG = revcmpl[:, None]                       # [B,1] broadcast over G
    layer_off = np.array([0, 1, 1, 1], np.int64)[None, :, None]  # [1,4,1]
    jvec = np.arange(G, dtype=np.int64)[None, :]

    def inits(xover_b):
        if local_alignment:
            nw0 = layer_off * xover_b
            return nw0, nw0 + b_gap_open, nw0 + a_gap_open
        z = np.full((B, 4, 1), NEG, np.int64)
        return z, z, z

    # virtual row -1: always local-style init with GLOBAL xover — the
    # caller encodes the global penalty as xover_rows fallback; reference
    # uses global_xover here (sw-full-cs.c:269-271); we pass it via
    # xover_rows[:, R:] convention: use column 0's global? Caller supplies
    # `xover_global` as the last column; simplest: the caller passes
    # xover_rows of width R and a separate global via xover_rows[:, 0]
    # when crossover_score is None. For exactness we take the explicit
    # global from the first element of xover_rows when uniform; the
    # reference init uses global_xover regardless of per-row scores.
    gx_b = xover_rows[:, -1][:, None, None]  # see wrapper: column R-1+1
    nw0 = layer_off * gx_b
    nw_p = np.concatenate([nw0 + np.zeros((B, 4, G + 1), np.int64)], axis=2)
    nw_p = np.broadcast_to(nw0, (B, 4, G + 1)).copy()
    n_p = nw_p + b_gap_open
    w_p = nw_p + a_gap_open

    bp_nw = np.zeros((B, R, 4, G), np.uint8)
    bp_n = np.zeros((B, R, 4, G), np.uint8)
    bp_w = np.zeros((B, R, 4, G), np.uint8)

    best = np.zeros(B, np.int64)
    best_i = np.zeros(B, np.int64)
    best_j = np.zeros(B, np.int64)
    best_k = np.zeros(B, np.int64)
    best_frm = np.zeros(B, np.uint8)

    for i in range(R):
        xover_b = xover_rows[:, min(i, R - 1)][:, None, None]
        xG = xover_b[:, :, 0]                    # [B,1] over G
        no_taboo = (i < rlen - indel_taboo_len)[:, None]   # [B,1]
        x_min, x_max = _band(ax64, ay64, alen64, awid64, glen64, i)
        inb = (jvec >= x_min[:, None]) & (jvec <= x_max[:, None])
        inb4 = inb[:, None, :]

        dbn = (db == BASE_N)[:, None, :]
        qrn = (qr[:, :, i] == BASE_N)[:, :, None]
        eq = db[:, None, :] == qr[:, :, i][:, :, None]
        ms = np.where(dbn | qrn, 0,
                      np.where(eq, match, mismatch)).astype(np.int64)

        nw_d, n_d, w_d = nw_p[:, :, :-1], n_p[:, :, :-1], w_p[:, :, :-1]
        nw_u, n_u = nw_p[:, :, 1:], n_p[:, :, 1:]

        # ----- NW and N planes: stacked candidate reductions with a
        # rank-encoded tie-break (key = value*16 - rank; ties prefer the
        # lower rank = earlier candidate in the reference scan order:
        # own layer first, then layers 0..3, plane order per revcmpl).
        planes3 = np.stack([nw_d, n_d, w_d], axis=1)        # [B,3dir,4,G]
        nw_val = np.empty((B, 4, G), np.int64)
        nw_bk = np.zeros((B, 4, G), np.uint8)
        n_val = np.empty((B, 4, G), np.int64)
        n_bk = np.zeros((B, 4, G), np.uint8)
        xpen3 = xG[:, :, None]                              # [B,1,1]
        gi2 = np.arange(G)[None, :]
        bi2 = np.arange(B)[:, None]
        if indel_taboo_len:
            taboo_b = (~no_taboo)[:, :, None]               # [B,1,1]

        for k in range(4):
            lorder = [k] + [ll for ll in range(4) if ll != k]
            # --- NW plane: 12 candidates [B, 12, G], dir-major within layer
            cand = np.concatenate(
                [planes3[:, :, l, :] for l in lorder], axis=1)
            cand[:, 3:, :] = cand[:, 3:, :] + xpen3
            dircodes = np.array([_NWNW, _NWN, _NWW] * 4, np.uint8)
            layers_arr = np.repeat(lorder, 3).astype(np.uint8)
            rank_f = np.arange(12, dtype=np.int64)
            rank_r = rank_f.reshape(4, 3)[:, ::-1].reshape(12)
            rank = np.where(revcmpl[:, None], rank_r[None, :],
                            rank_f[None, :])                # [B,12]
            if indel_taboo_len:
                is_n = (dircodes == _NWN)[None, :, None]
                cand = np.where(is_n & taboo_b, np.int64(NEG * 2), cand)
            amax = (cand * 16 - rank[:, :, None]).argmax(axis=1)
            val = cand[bi2, amax, gi2] + ms[:, k, :]
            bk = ((dircodes[amax] << 2) | layers_arr[amax]).astype(np.uint8)
            resetval = (0 if k == 0 else 1) * xG
            if local_alignment:
                clamp = val <= resetval
                val = np.where(clamp, resetval, val)
                bk = np.where(clamp, 0, bk)
            nw_val[:, k, :] = val
            nw_bk[:, k, :] = bk

            # --- N plane: 8 candidates (open, ext) per layer
            copen = nw_u[:, lorder, :] - go_b - ge_b
            cext = n_u[:, lorder, :] - ge_b
            cand = np.empty((B, 8, G), np.int64)
            cand[:, 0::2, :] = copen
            cand[:, 1::2, :] = cext
            cand[:, 2:, :] = cand[:, 2:, :] + xpen3
            dirc = np.array([_NNW, _NN] * 4, np.uint8)
            layn = np.repeat(lorder, 2).astype(np.uint8)
            rank_f = np.arange(8, dtype=np.int64)
            rank_r = rank_f.reshape(4, 2)[:, ::-1].reshape(8)
            rank = np.where(revcmpl[:, None], rank_r[None, :],
                            rank_f[None, :])
            if indel_taboo_len:
                is_open = (dirc == _NNW)[None, :, None]
                cand = np.where(is_open & taboo_b, np.int64(NEG * 2), cand)
            amax = (cand * 16 - rank[:, :, None]).argmax(axis=1)
            val = cand[bi2, amax, gi2]
            bk = ((dirc[amax] << 2) | layn[amax]).astype(np.uint8)
            resetval = (0 if k == 0 else 1) * xG
            if local_alignment:
                clamp = val <= resetval
                val = np.where(clamp, resetval, val)
                bk = np.where(clamp, 0, bk)
            n_val[:, k, :] = val
            n_bk[:, k, :] = bk

        init_nw_b, init_n_b, init_w_b = inits(xover_b)
        nw_val = np.where(inb4, nw_val, init_nw_b)
        nw_bk = np.where(inb4, nw_bk, 0)
        n_val = np.where(inb4, n_val, init_n_b)
        n_bk = np.where(inb4, n_bk, 0)

        # ----- W plane (own layer only): doubling max-plus scan
        nw_shift = np.concatenate([init_nw_b, nw_val[:, :, :-1]], axis=2)
        c_open_w = nw_shift - go_a - ge_a
        if indel_taboo_len:
            c_open_w = np.where(no_taboo[:, :, None], c_open_w, NEG * 2)
        a_elem = c_open_w
        if local_alignment:
            a_elem = np.maximum(a_elem, layer_off * xover_b)
        BIGB = np.int64(1) << 40
        a_elem = np.where(inb4, a_elem, init_w_b)
        b_elem = np.where(inb4, np.int64(ge_a), BIGB)
        b_elem = np.broadcast_to(b_elem, (B, 4, G)).copy()
        aa = np.concatenate([np.broadcast_to(init_w_b, (B, 4, 1)), a_elem],
                            axis=2)
        bb = np.concatenate([np.full((B, 4, 1), BIGB, np.int64), b_elem],
                            axis=2)
        sa, sb = aa.astype(np.int64).copy(), bb.copy()
        step = 1
        while step < G + 1:
            pad_a = np.full((B, 4, step), NEG, np.int64)
            pad_b = np.full((B, 4, step), BIGB, np.int64)
            sh_a = np.concatenate([pad_a, sa[:, :, :-step]], axis=2)
            sh_b = np.concatenate([pad_b, sb[:, :, :-step]], axis=2)
            sa = np.maximum(sa, np.maximum(sh_a - sb, NEG))
            sb = np.minimum(sh_b + sb, BIGB)
            step *= 2
        w_val = sa[:, :, 1:]
        w_prev = sa[:, :, :-1]
        c_ext_w = w_prev - ge_a
        take_ext = np.where(rvG[:, None, :], ~(c_open_w > c_ext_w),
                            c_ext_w > c_open_w)
        kk4 = np.arange(4, dtype=np.uint8)[None, :, None]
        w_bk = np.where(take_ext, (_WW << 2), (_WNW << 2)).astype(np.uint8) \
            | kk4
        if local_alignment:
            resetv = layer_off * xover_b
            clamp = w_val <= resetv
            w_val = np.where(clamp, resetv, w_val)
            w_bk = np.where(clamp, 0, w_bk)
        w_bk = np.where(inb4, w_bk, 0)
        w_val = np.where(inb4, w_val, init_w_b)

        bp_nw[:, i] = nw_bk
        bp_n[:, i] = n_bk
        bp_w[:, i] = w_bk

        # ----- score tracking (priority j, k, plane-order)
        if local_alignment:
            rowvalid = (i < rlen)[:, None] & inb
        else:
            rowvalid = (i == rlen - 1)[:, None] & inb
        p1 = np.where(rvG[:, None, :], w_val, nw_val)
        p2 = n_val
        p3 = np.where(rvG[:, None, :], nw_val, w_val)
        cand = np.stack([p1, p2, p3], axis=3)       # [B,4,G,3]
        cand = np.transpose(cand, (0, 2, 1, 3)).reshape(B, G * 12)
        cand = np.where(np.repeat(rowvalid, 12, axis=1), cand, NEG)
        rowmax = cand.max(axis=1)
        rowarg = cand.argmax(axis=1)
        upd = rowmax > best
        jj = rowarg // 12
        kk = (rowarg % 12) // 3
        # start-of-backtrace code (do_backtrace head, sw-full-cs.c:641-651):
        # nw plane preferred, then w strictly, then n strictly
        bi = np.arange(B)
        nw_c = nw_val[bi, kk, jj]
        w_c = w_val[bi, kk, jj]
        n_c = n_val[bi, kk, jj]
        frm = bp_nw[bi, i, kk, jj]
        fs = nw_c
        m2 = w_c > fs
        frm = np.where(m2, bp_w[bi, i, kk, jj], frm)
        fs = np.maximum(fs, w_c)
        frm = np.where(n_c > fs, bp_n[bi, i, kk, jj], frm)
        best_i = np.where(upd, i, best_i)
        best_j = np.where(upd, jj, best_j)
        best_k = np.where(upd, kk, best_k)
        best_frm = np.where(upd, frm, best_frm)
        best = np.maximum(best, rowmax)

        nw_p = np.concatenate([init_nw_b, nw_val], axis=2)
        n_p = np.concatenate([init_n_b, n_val], axis=2)
        w_p = np.concatenate([init_w_b, w_val], axis=2)

    # threshold zero-out (sw-full-cs.c:1216-1226)
    score = np.where(best >= thresh, best, 0)
    tb = _traceback(db, qr, bp_nw, bp_n, bp_w, best_i, best_j, best_k,
                    best_frm, score)
    tb.qr = qr
    tb.score = score
    return tb


_NEXT_PLANE = np.array([0, _DIR_N, _DIR_NW, _DIR_NW, _DIR_W, _DIR_N,
                        _DIR_NW, _DIR_W], np.int8)


def _traceback(db, qr, bp_nw, bp_n, bp_w, bi, bj, bk, bfrm, score
               ) -> CSBatchResult:
    """do_backtrace (sw-full-cs.c:633-937), vectorized over the batch."""
    B, R, _, G = bp_nw.shape
    maxsteps = R + G
    bidx = np.arange(B)
    i = bi.astype(np.int64).copy()
    j = bj.astype(np.int64).copy()
    k = bk.astype(np.int64).copy()
    frm = bfrm.astype(np.int16).copy()
    active = (frm != 0) & (score > 0)

    ops_rev = np.zeros((B, maxsteps), np.int16)
    rs = np.zeros(B, np.int64)
    gs = np.zeros(B, np.int64)
    m_ = np.zeros(B, np.int64)
    mm_ = np.zeros(B, np.int64)
    ins = np.zeros(B, np.int64)
    dele = np.zeros(B, np.int64)
    xo = np.zeros(B, np.int64)
    n_ops = np.zeros(B, np.int64)

    for stepi in range(maxsteps):
        if not active.any():
            break
        code = (frm >> 2).astype(np.int16)
        lyr = (frm & 3).astype(np.int64)
        is_n = active & ((code == _NN) | (code == _NNW))
        is_w = active & ((code == _WNW) | (code == _WW))
        is_nw = active & (code >= _NWN)
        dele += is_n
        ins += is_w
        jj = np.clip(j, 0, G - 1)
        ii = np.clip(i, 0, R - 1)
        gch = db[bidx, jj]
        rch = qr[bidx, np.clip(k, 0, 3), ii]
        okm = (gch == rch) | (gch == BASE_N) | (rch == BASE_N)
        m_ += is_nw & okm
        mm_ += is_nw & ~okm
        rs = np.where(is_n | is_nw, i, rs)
        gs = np.where(is_w | is_nw, j, gs)
        # op with the CELL layer (pre-switch)
        op = np.where(is_n, 2, np.where(is_w, 1, np.where(is_nw, 3, 0)))
        xover = active & (lyr != k)
        xo += xover
        ops_rev[:, stepi] = np.where(
            active, op | (k << 2) | (np.where(xover, 1, 0) << 4), 0)
        k = np.where(active, lyr, k)
        n_ops += active
        i2 = i - (is_n | is_nw)
        j2 = j - (is_w | is_nw)
        nxt = _NEXT_PLANE[np.clip(code, 0, 7)]
        inbounds = active & (i2 >= 0) & (j2 >= 0)
        ii2 = np.clip(i2, 0, R - 1)
        jj2 = np.clip(j2, 0, G - 1)
        kidx = np.clip(k, 0, 3)
        v_nw = bp_nw[bidx, ii2, kidx, jj2]
        v_n = bp_n[bidx, ii2, kidx, jj2]
        v_w = bp_w[bidx, ii2, kidx, jj2]
        frm_new = np.where(nxt == _DIR_NW, v_nw,
                           np.where(nxt == _DIR_N, v_n, v_w))
        frm = np.where(inbounds, frm_new, 0).astype(np.int16)
        active = inbounds & (frm != 0)
        i, j = i2, j2

    # leading crossover when the alignment starts in layer != 0
    lead = (score > 0) & (k != 0) & (n_ops > 0)
    last = np.clip(n_ops - 1, 0, maxsteps - 1)
    ops_rev[bidx[lead], last[lead]] |= 1 << 4
    xo += lead

    # reverse into alignment order
    kcnt = n_ops[:, None]
    idxm = np.arange(maxsteps)[None, :]
    src = np.clip(kcnt - 1 - idxm, 0, maxsteps - 1)
    steps = np.where(idxm < kcnt, ops_rev[bidx[:, None], src], 0
                     ).astype(np.int16)
    opss = steps & 3
    rmapped = (opss != 0).astype(np.int64) * 0
    rmapped = ((opss != 0) & (opss != 1)).sum(axis=1)   # != CS_INS
    gmapped = ((opss != 0) & (opss != 2)).sum(axis=1)   # != CS_DEL
    return CSBatchResult(score=score, steps=steps, n_steps=n_ops,
                         read_start=rs, genome_start=gs, rmapped=rmapped,
                         gmapped=gmapped, matches=m_, mismatches=mm_,
                         insertions=ins, deletions=dele, crossovers=xo,
                         qr=qr)
