"""Colour-space full Smith-Waterman: the 4-layer DP and its traceback,
their plain PyTorch versions and the wrappers of the CUDA kernels
`csrc/sw_cs_full.cu` and `csrc/cs_traceback.cu`.

The DP is the port of the Pallas kernel `shrimp_tpu/core/
sw_cs_full_pallas.py::_kernel` (through `sw_full_cs_dp_pallas`): four
letter-space layers of the colour read (`cs_layers_batch`), each a
banded (NW, N, W) affine DP against the letter window, with the row's
crossover penalty charged for moving between layers. It follows the
Pallas kernel's arithmetic: strict-`>` candidate scans in the order
(own layer, then the others ascending) x (nw, n, w), reversed within a
group under revcmpl; the taboo near the read end; per-row local inits;
the W chain's FILL floor; and the first best cell in (j, k) order.

The traceback is the port of `sw_cs_jax._cs_traceback`: a walk from the
best cell through the packed backpointers (nw | n << 5 | w << 10) that
yields the [B, 12] packed alignment fields and the reversed step codes.

Backpointers travel between the two as int16 in the reference's own
layout [B, R, 4, G] on every device (every packed value fits 15 bits;
the CUDA kernel, a warp per pair, stores a row's 4 x G values as one
contiguous run). Each wrapper takes the plain version for CPU tensors
only; for CUDA tensors it launches its kernel or raises.
"""
from __future__ import annotations

import torch

from .. import _build
from ..constants import BASE_N
from ._args import check_cuda_shape, check_tensor

NEG = -(2 ** 25)
FILL = -(2 ** 28)
# direction-pair codes of sw-full-cs.c; a backpointer is code << 2 | layer
_NN, _NNW, _WNW, _WW, _NWN, _NWNW, _NWW = 1, 2, 3, 4, 5, 6, 7
# the plane (0 nw, 1 n, 2 w) each direction-pair code continues in
_NEXT_PLANE = (0, 1, 0, 0, 2, 1, 0, 2)
# candidate groups of layer k: its own layer, then the others ascending
_LORDER = tuple((k,) + tuple(ll for ll in range(4) if ll != k)
                for k in range(4))

# launches of the CUDA kernels (the plain versions are not counted)
DP_LAUNCHES = _build.LaunchCount()
TB_LAUNCHES = _build.LaunchCount()


def _band(i, ax, ay, alen, awid, glen):
    """anchor_get_x_range for row i, clipped to [0, glen - 1]."""
    x_min = torch.where(i < ay, 0, torch.where(i <= ay + alen - 1,
                                               ax + (i - ay), ax + alen))
    x_min = torch.minimum(x_min.clamp(min=0), glen - 1)
    ay2 = ay - (awid - 1)
    x_max = torch.where(i < ay2, ax + awid - 2,
                        torch.where(i <= ay2 + alen - 1,
                                    ax + (awid - 1) + (i - ay2), glen - 1))
    x_max = torch.minimum(x_max.clamp(min=0), glen - 1)
    return x_min, x_max


def _scan(cands):
    """The strict-`>` scan over (value, code) candidates in order: the
    first is taken, a later one only when greater."""
    val, bkv = cands[0]
    bkv = bkv.expand(val.shape)
    for c, code in cands[1:]:
        bkv = torch.where(c > val, code, bkv)
        val = torch.maximum(val, c)
    return val, bkv


def sw_full_cs_dp_ref(genome_ls: torch.Tensor, glen: torch.Tensor,
                      qr: torch.Tensor, rlen: torch.Tensor,
                      ax: torch.Tensor, ay: torch.Tensor, alen: torch.Tensor,
                      awid: torch.Tensor, revcmpl: torch.Tensor,
                      xover_rows: torch.Tensor, gx_col: torch.Tensor, *,
                      match: int, mismatch: int, a_gap_open: int,
                      a_gap_ext: int, b_gap_open: int, b_gap_ext: int,
                      local_alignment: bool = False,
                      indel_taboo_len: int = 0):
    """Plain int32 version, on any device: genome_ls [B, G] letters, qr
    [B, 4, R] letter layers, xover_rows [B, R], gx_col [B] and the band
    geometry -> (best, bi, bj, bk, bfrm [B] int32, bp [B, R, 4, G] int32),
    the outputs of sw_full_cs_dp_pallas. A row loop over i with [B, 4, G]
    planes; the W chain along j is a cummax."""
    goa, gea, gob, geb = -a_gap_open, -a_gap_ext, -b_gap_open, -b_gap_ext
    local = bool(local_alignment)
    taboo = int(indel_taboo_len)
    B, G = genome_ls.shape
    R = qr.shape[2]
    dev = genome_ls.device
    i32 = torch.int32
    g = genome_ls.to(i32)[:, None, :]                          # [B, 1, G]
    q = qr.to(i32)
    glen, rlen, ax, ay, alen, awid, gx = (
        t.to(i32)[:, None, None]
        for t in (glen, rlen, ax, ay, alen, awid, gx_col))
    xov = xover_rows.to(i32)
    rv = (revcmpl != 0)[:, None]                               # [B, 1]
    jidx = torch.arange(G, dtype=i32, device=dev)
    kidx = torch.arange(4, dtype=i32, device=dev)[None, :, None]

    def full(shape, v):
        return torch.full(shape, v, dtype=i32, device=dev)

    m, mm = full((1, 1, 1), match), full((1, 1, 1), mismatch)

    # previous row with its j = -1 pad column first; row -1 starts layer
    # 0 at 0 and layers 1..3 at the global crossover
    off = torch.where(kidx == 0, 0, gx)                        # [B, 4, 1]
    nwp = off.expand(B, 4, G + 1).clone()
    np_ = nwp - gob
    wp = nwp - goa
    zero = full((B,), 0)
    best, bi, bj, bk, bfrm = zero, zero, zero, zero, zero
    bps = []
    rv3 = rv[:, :, None]                                       # [B, 1, 1]
    # candidate codes in scan order: (nw, n, w) and (open, extend), both
    # reversed under revcmpl
    nw_first = torch.where(rv3, _NWW, _NWNW).to(i32) << 2
    nw_last = torch.where(rv3, _NWNW, _NWW).to(i32) << 2
    n_first = torch.where(rv3, _NN, _NNW).to(i32) << 2
    n_last = torch.where(rv3, _NNW, _NN).to(i32) << 2
    # group gi of layer k reads layer _LORDER[k][gi]; as a layer index
    # per k, so that one op serves all four layers
    lsel = [torch.tensor([_LORDER[k][gi] for k in range(4)], device=dev)
            for gi in range(4)]
    for i in range(R):
        x_min, x_max = _band(i, ax, ay, alen, awid, glen)      # [B, 1, 1]
        inb = (jidx >= x_min) & (jidx <= x_max)                # [B, 1, G]
        xc = xov[:, i:i + 1, None]                             # [B, 1, 1]
        no_taboo = (i < rlen - taboo) if taboo else None       # [B, 1, 1]
        if local:
            init_nw = torch.where(kidx == 0, 0, xc)            # [B, 4, 1]
            init_n, init_w = init_nw - gob, init_nw - goa
        else:
            init_nw = init_n = init_w = full((B, 4, 1), NEG)
        nw_d, n_d, w_d, nw_u, n_u = (
            t.contiguous() for t in (nwp[..., :-1], np_[..., :-1],
                                     wp[..., :-1], nwp[..., 1:], np_[..., 1:]))
        # the first and last candidate of each NW trio and N duo
        nw_f, nw_l = torch.where(rv3, w_d, nw_d), torch.where(rv3, nw_d, w_d)
        n_open, n_ext = nw_u - gob - geb, n_u - geb
        n_f, n_l = torch.where(rv3, n_ext, n_open), torch.where(rv3, n_open,
                                                                n_ext)
        nw_c, n_c = [], []
        for gi in range(4):
            lk = kidx if gi == 0 else lsel[gi][None, :, None].to(i32)

            def grp(t):
                # group gi's layer for every k; later groups pay the
                # crossover
                return t if gi == 0 else t[:, lsel[gi]] + xc
            mid = grp(n_d)
            if taboo:
                mid = torch.where(no_taboo, mid, 2 * NEG)
            nw_c += [(grp(nw_f), nw_first | lk), (mid, _NWN << 2 | lk),
                     (grp(nw_l), nw_last | lk)]
            first, last = grp(n_f), grp(n_l)
            if taboo:        # the open candidate: first, or last under rv
                first = torch.where(rv3 | no_taboo, first, 2 * NEG)
                last = torch.where(~rv3 | no_taboo, last, 2 * NEG)
            n_c += [(first, n_first | lk), (last, n_last | lk)]

        # NW: 12 candidates per layer, then the substitution score
        val, bkv = _scan(nw_c)
        qi = q[:, :, i:i + 1]                                  # [B, 4, 1]
        s = torch.where((g == BASE_N) | (qi == BASE_N), 0,
                        torch.where(g == qi, m, mm))
        val = val + s
        if local:
            clamp = val <= init_nw
            val = torch.where(clamp, init_nw, val)
            bkv = torch.where(clamp, 0, bkv)
        nw_val = torch.where(inb, val, init_nw)
        nw_bk = torch.where(inb, bkv, 0)

        # N: 8 candidates per layer
        val, bkv = _scan(n_c)
        if local:
            clamp = val <= init_nw
            val = torch.where(clamp, init_nw, val)
            bkv = torch.where(clamp, 0, bkv)
        n_val = torch.where(inb, val, init_n)
        n_bk = torch.where(inb, bkv, 0)

        # W: one chain per layer along j, floored at FILL; the band's
        # left edge injects init_w
        nw_shift = torch.cat([init_nw, nw_val[..., :-1]], dim=2)
        c_open_w = nw_shift - goa - gea
        if taboo:
            c_open_w = torch.where(no_taboo, c_open_w, 2 * NEG)
        a = c_open_w
        if local:
            a = torch.maximum(a, init_nw)
        a = torch.where(jidx == x_min, torch.maximum(a, init_w - gea), a)
        c = torch.where(inb, a + jidx * gea, FILL)
        c = torch.cummax(c, dim=2).values.clamp(min=FILL)
        w_val = torch.where(inb, c - jidx * gea, init_w)
        w_prev = torch.cat([init_w, w_val[..., :-1]], dim=2)
        c_ext_w = w_prev - gea
        take_ext = torch.where(rv3, ~(c_open_w > c_ext_w),
                               c_ext_w > c_open_w)
        w_bk = torch.where(take_ext, _WW << 2, _WNW << 2).to(i32) | kidx
        if local:
            clamp = w_val <= init_nw
            w_val = torch.where(clamp, init_nw, w_val)
            w_bk = torch.where(clamp, 0, w_bk)
        w_bk = torch.where(inb, w_bk, 0)
        bps.append(nw_bk | n_bk << 5 | w_bk << 10)

        # best cell: the smallest j holding the row's maximum in any
        # layer, then the smallest k there
        rec = (i < rlen) if local else (i == rlen - 1)         # [B, 1, 1]
        cm = torch.maximum(torch.maximum(nw_val, n_val), w_val)
        cm = torch.where(rec & inb, cm, NEG)
        rowbest = cm.amax(dim=(1, 2))
        hit = cm == rowbest[:, None, None]
        jsel = torch.where(hit.any(1), jidx, G).amin(1)
        ksel = torch.where(hit[torch.arange(B, device=dev), :, jsel.long()],
                           kidx[0, :, 0], 4).amin(1)
        sel = (ksel * G + jsel).long()[:, None]

        def pick(v):
            return v.reshape(B, 4 * G).gather(1, sel)[:, 0].clamp(min=NEG)

        nw_c, n_c, w_c = pick(nw_val), pick(n_val), pick(w_val)
        frm = pick(nw_bk)
        frm = torch.where(w_c > nw_c, pick(w_bk), frm)
        frm = torch.where(n_c > torch.maximum(nw_c, w_c), pick(n_bk), frm)
        upd = rowbest > best
        best = torch.where(upd, rowbest, best)
        bi = torch.where(upd, i, bi)
        bj = torch.where(upd, jsel, bj)
        bk = torch.where(upd, ksel, bk)
        bfrm = torch.where(upd, frm, bfrm)

        nwp = torch.cat([init_nw, nw_val], dim=2)
        np_ = torch.cat([init_n, n_val], dim=2)
        wp = torch.cat([init_w, w_val], dim=2)
    bp = torch.stack(bps, 1)                                   # [B, R, 4, G]
    return best, bi, bj, bk, bfrm, bp


def _launch_dp(genome_ls, glen, qr, rlen, ax, ay, alen, awid, revcmpl,
               xover_rows, gx_col, *, match, mismatch, a_gap_open,
               a_gap_ext, b_gap_open, b_gap_ext, local_alignment,
               indel_taboo_len):
    check_cuda_shape(genome_ls, "sw_full_cs_dp")
    B, G = genome_ls.shape
    R = qr.shape[2] if qr.dim() == 3 else -1
    dev = genome_ls.device
    check_tensor("genome_ls", genome_ls, torch.uint8, (B, G), dev)
    check_tensor("qr", qr, torch.uint8, (B, 4, R), dev)
    check_tensor("xover_rows", xover_rows, torch.int32, (B, R), dev)
    for name, t in (("gx_col", gx_col), ("glen", glen), ("rlen", rlen),
                    ("ax", ax), ("ay", ay), ("alen", alen), ("awid", awid),
                    ("revcmpl", revcmpl)):
        check_tensor(name, t, torch.int32, (B,), dev)
    lib = _build.load().lib
    bp = torch.empty((B, R, 4, G), dtype=torch.int16, device=dev)
    stats = torch.empty((5, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = _build.scratch("sw_cs_full", B, G, R, dev)
        rc = lib.sw_cs_full_launch(
            genome_ls.data_ptr(), qr.data_ptr(), xover_rows.data_ptr(),
            gx_col.data_ptr(), glen.data_ptr(), rlen.data_ptr(),
            ax.data_ptr(), ay.data_ptr(), alen.data_ptr(), awid.data_ptr(),
            revcmpl.data_ptr(), bp.data_ptr(), stats.data_ptr(), B, G, R,
            match, mismatch, -a_gap_open, -a_gap_ext, -b_gap_open,
            -b_gap_ext, int(bool(local_alignment)), int(indel_taboo_len),
            stream, _build.ptr(scratch))
    _build.check(rc, "sw_cs_full_launch")
    DP_LAUNCHES.add()
    return (*stats.unbind(0), bp)


def sw_full_cs_dp(genome_ls: torch.Tensor, glen: torch.Tensor,
                  qr: torch.Tensor, rlen: torch.Tensor, ax: torch.Tensor,
                  ay: torch.Tensor, alen: torch.Tensor, awid: torch.Tensor,
                  revcmpl: torch.Tensor, xover_rows: torch.Tensor,
                  gx_col: torch.Tensor, *, match: int, mismatch: int,
                  a_gap_open: int, a_gap_ext: int, b_gap_open: int,
                  b_gap_ext: int, local_alignment: bool = False,
                  indel_taboo_len: int = 0):
    """(best, bi, bj, bk, bfrm [B] int32, bp [B, R, 4, G] int16). CPU
    tensors take the plain version; CUDA tensors launch the kernel
    (uint8 windows and layers, int32 crossovers and per-pair arguments
    incl. revcmpl, contiguous) or raise."""
    kw = dict(match=match, mismatch=mismatch, a_gap_open=a_gap_open,
              a_gap_ext=a_gap_ext, b_gap_open=b_gap_open,
              b_gap_ext=b_gap_ext, local_alignment=local_alignment,
              indel_taboo_len=indel_taboo_len)
    args = (genome_ls, glen, qr, rlen, ax, ay, alen, awid, revcmpl,
            xover_rows, gx_col)
    if genome_ls.device.type == "cpu":
        *stats, bp = sw_full_cs_dp_ref(*args, **kw)
        return (*stats, bp.to(torch.int16))
    return _launch_dp(*args, **kw)


def cs_traceback_ref(genome_ls: torch.Tensor, qr: torch.Tensor,
                     best: torch.Tensor, bi: torch.Tensor, bj: torch.Tensor,
                     bk: torch.Tensor, bfrm: torch.Tensor, bp: torch.Tensor,
                     thresh: torch.Tensor):
    """Plain version, on any device: up to R + G lock-step walk steps
    over all pairs, as _cs_traceback scans them (the steps after every
    walk has stopped change nothing, so they are not run). bp is
    [B, R, 4, G] int16. Returns (packed [B, 12] int16, steps_rev
    [B, R + G] int8)."""
    B, G = genome_ls.shape
    R = qr.shape[2]
    dev = genome_ls.device
    i32 = torch.int32
    db = genome_ls.to(i32)
    q = qr.to(i32)
    bpf = bp.reshape(-1)
    nextp = torch.tensor(_NEXT_PLANE, dtype=i32, device=dev)
    bidx = torch.arange(B, device=dev)
    best, bi, bj, bk, bfrm, thresh = (
        t.to(i32) for t in (best, bi, bj, bk, bfrm, thresh))
    zero = torch.zeros(B, dtype=i32, device=dev)
    score = torch.where(best >= thresh, best, 0)
    i, j, k, frm = bi, bj, bk, bfrm
    rs = gs = m_ = mm_ = ins = dele = xo = nops = zero
    act = (bfrm != 0) & (score > 0)
    steps = []
    for t in range(R + G):
        if t % 64 == 0 and not bool(act.any()):
            break
        code = frm >> 2
        lyr = frm & 3
        is_n = act & ((code == _NN) | (code == _NNW))
        is_w = act & ((code == _WNW) | (code == _WW))
        is_nw = act & (code >= _NWN)
        dele = dele + is_n
        ins = ins + is_w
        gch = db[bidx, j.clamp(0, G - 1)]
        rch = q[bidx, k.clamp(0, 3), i.clamp(0, R - 1)]
        okm = (gch == rch) | (gch == BASE_N) | (rch == BASE_N)
        m_ = m_ + (is_nw & okm)
        mm_ = mm_ + (is_nw & ~okm)
        rs = torch.where(is_n | is_nw, i, rs)
        gs = torch.where(is_w | is_nw, j, gs)
        op = torch.where(is_n, 2, torch.where(is_w, 1,
                                              torch.where(is_nw, 3, 0)))
        xov = act & (lyr != k)
        xo = xo + xov
        steps.append(torch.where(act, op | k << 2 | xov.to(i32) << 4, 0))
        k2 = torch.where(act, lyr, k)
        nops = nops + act
        i2 = i - (is_n | is_nw).to(i32)
        j2 = j - (is_w | is_nw).to(i32)
        nxt = nextp[code.clamp(0, 7)]
        inb = act & (i2 >= 0) & (j2 >= 0)
        flat = (((bidx * R + i2.clamp(0, R - 1)) * 4 + k2.clamp(0, 3)) * G
                + j2.clamp(0, G - 1))
        frm2 = (bpf[flat].to(i32) >> (5 * nxt)) & 31
        frm = torch.where(inb, frm2, 0)
        act = inb & (frm != 0)
        i, j, k = i2, j2, k2
    steps_rev = torch.zeros((B, R + G), dtype=i32, device=dev)
    if steps:
        steps_rev[:, :len(steps)] = torch.stack(steps, 1)
    # leading crossover when the alignment starts in a layer other than 0
    lead = (score > 0) & (k != 0) & (nops > 0)
    last = (nops - 1).clamp(0, R + G - 1).long()[:, None]
    cur = steps_rev.gather(1, last)
    steps_rev = steps_rev.scatter(1, last,
                                  torch.where(lead[:, None], cur | 16, cur))
    xo = xo + lead
    packed = torch.stack([score, bi, bj, bk, nops, rs, gs, m_, mm_, ins,
                          dele, xo], dim=1)
    return packed.to(torch.int16), steps_rev.to(torch.int8)


def _launch_tb(genome_ls, qr, best, bi, bj, bk, bfrm, bp, thresh):
    check_cuda_shape(genome_ls, "cs_traceback")
    B, G = genome_ls.shape
    R = qr.shape[2] if qr.dim() == 3 else -1
    dev = genome_ls.device
    check_tensor("genome_ls", genome_ls, torch.uint8, (B, G), dev)
    check_tensor("qr", qr, torch.uint8, (B, 4, R), dev)
    check_tensor("bp", bp, torch.int16, (B, R, 4, G), dev)
    for name, t in (("best", best), ("bi", bi), ("bj", bj), ("bk", bk),
                    ("bfrm", bfrm), ("thresh", thresh)):
        check_tensor(name, t, torch.int32, (B,), dev)
    if (G % 8 or bp.data_ptr() % 16 or genome_ls.data_ptr() % 4
            or qr.data_ptr() % 4):
        raise NotImplementedError(
            f"cs_traceback: the CUDA kernel loads the backpointers in "
            f"16-byte pieces and the windows and read layers in 4-byte "
            f"ones: G = {G} must be a multiple of 8, bp 16-byte aligned "
            f"and genome_ls and qr 4-byte aligned")
    lib = _build.load().lib
    packed = torch.empty((B, 12), dtype=torch.int16, device=dev)
    steps = torch.empty((B, R + G), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.cs_traceback_launch(
            genome_ls.data_ptr(), qr.data_ptr(), best.data_ptr(),
            bi.data_ptr(), bj.data_ptr(), bk.data_ptr(), bfrm.data_ptr(),
            bp.data_ptr(), thresh.data_ptr(), packed.data_ptr(),
            steps.data_ptr(), B, G, R, stream)
    _build.check(rc, "cs_traceback_launch")
    TB_LAUNCHES.add()
    return packed, steps


def cs_traceback(genome_ls: torch.Tensor, qr: torch.Tensor,
                 best: torch.Tensor, bi: torch.Tensor, bj: torch.Tensor,
                 bk: torch.Tensor, bfrm: torch.Tensor, bp: torch.Tensor,
                 thresh: torch.Tensor):
    """(packed [B, 12] int16, steps_rev [B, R + G] int8) from the DP's
    best cells and [B, R, 4, G] int16 backpointers. CPU tensors take the
    plain version; CUDA tensors launch the kernel (uint8 windows and
    layers, int32 per-pair values, contiguous; G a multiple of 8, as the
    flows' windows are) or raise."""
    args = (genome_ls, qr, best, bi, bj, bk, bfrm, bp, thresh)
    if genome_ls.device.type == "cpu":
        return cs_traceback_ref(*args)
    return _launch_tb(*args)
