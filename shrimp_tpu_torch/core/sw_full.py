"""Traceback-free full Smith-Waterman (filter 3 stats): the plain
PyTorch version and the wrapper of the CUDA kernel `csrc/sw_full.cu`.

Port of the Pallas kernel `shrimp_tpu/core/sw_full_pallas.py::_kernel`
with emit_bp=False, through `sw_full_stats_pallas` and
`_plane_from_stats`: the banded 3-plane (NW, N, W) affine DP, global or
local, bit-faithful to sw-full-ls.c including the `revcmpl` tie-break
flip; out-of-band cells are reset to the mode's init values on every
row. Returns [B, 8] int32 rows: score, max_i, max_j, plane, run, term,
deq, base. When plane == 0 and term == 0 the best path is one diagonal
chain: nops = run, matches = deq - base.

`sw_full_stats` takes the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from .. import _build
from ._args import check_cuda_shape, check_tensor

NEG = -(2 ** 30)
FILL = -(2 ** 28)
# NW-plane from-codes (shrimp_tpu/core/sw_full_pallas.py)
NW_FROM_NW, NW_FROM_N, NW_FROM_W = 1, 2, 3

# launches of the CUDA kernel (the plain version is not counted)
LAUNCHES = _build.LaunchCount()


def _plane_from_stats(best, bi, bj, nw_c, n_c, w_c):
    score = best.clamp(min=0)
    has = best > 0
    max_i = torch.where(has, bi, 0)
    max_j = torch.where(has, bj, 0)
    plane = (w_c > nw_c).to(torch.int32)
    plane = torch.where(n_c > torch.maximum(nw_c, w_c), 2, plane)
    plane = torch.where(has, plane, 0)
    return score, max_i, max_j, plane


def sw_full_stats_ref(genome: torch.Tensor, glen: torch.Tensor,
                      read: torch.Tensor, rlen: torch.Tensor,
                      ax: torch.Tensor, ay: torch.Tensor,
                      alen: torch.Tensor, awid: torch.Tensor,
                      revcmpl: torch.Tensor, *, match: int, mismatch: int,
                      a_gap_open: int, a_gap_ext: int, b_gap_open: int,
                      b_gap_ext: int,
                      local_alignment: bool = False) -> torch.Tensor:
    """Plain int32 version, on any device: a row loop over i with the
    W-gap chain along j as a cummax, exactly the reference's row
    update. Returns [B, 8] int32."""
    goa, gea, gob, geb = -a_gap_open, -a_gap_ext, -b_gap_open, -b_gap_ext
    local = bool(local_alignment)
    B, G = genome.shape
    R = read.shape[1]
    dev = genome.device
    i32 = torch.int32
    g = genome.to(i32)
    r = read.to(i32)
    glen, rlen, ax, ay, alen, awid = (
        t.to(i32) for t in (glen, rlen, ax, ay, alen, awid))
    rv = (revcmpl != 0)[:, None]
    jidx = torch.arange(G, dtype=i32, device=dev)[None, :]

    def full(shape, v):
        return torch.full(shape, v, dtype=i32, device=dev)

    init_nw = 0 if local else NEG
    init_n = b_gap_open if local else NEG
    init_w = a_gap_open if local else NEG
    # previous row with its j = -1 pad column first; row -1 holds
    # nw = 0, n = b_gap_open, w = a_gap_open in both modes
    nwp = full((B, G + 1), 0)
    np_ = full((B, G + 1), b_gap_open)
    wp = full((B, G + 1), a_gap_open)
    runp, termp, deqp, basep = (full((B, G + 1), 0) for _ in range(4))
    pad = {v: full((B, 1), v) for v in {init_nw, init_n, init_w, 0}}
    from_nw, from_w = full((1, 1), NW_FROM_NW), full((1, 1), NW_FROM_W)
    m, mm = full((1, 1), match), full((1, 1), mismatch)
    best = full((B,), NEG)
    bi = full((B,), 0)
    bj = full((B,), 0)
    picks = [full((B,), NEG) for _ in range(7)]
    for i in range(R):
        # band for this row (anchor_get_x_range), clipped to [0, glen-1]
        x_min = torch.where(i < ay, 0, torch.where(i <= ay + alen - 1,
                                                   ax + (i - ay), ax + alen))
        x_min = torch.minimum(x_min.clamp(min=0), glen - 1)
        ay2 = ay - (awid - 1)
        x_max = torch.where(i < ay2, ax + awid - 2,
                            torch.where(i <= ay2 + alen - 1,
                                        ax + (awid - 1) + (i - ay2),
                                        glen - 1))
        x_max = torch.minimum(x_max.clamp(min=0), glen - 1)
        inb = (jidx >= x_min[:, None]) & (jidx <= x_max[:, None])
        same = g == r[:, i:i + 1]
        s = torch.where(same, m, mm)
        c_nw, c_n, c_w = nwp[:, :-1], np_[:, :-1], wp[:, :-1]

        # NW plane: tie preference nw > n > w, flipped under revcmpl
        v = torch.where(rv, c_w, c_nw)
        frm = torch.where(rv, from_w, from_nw)
        frm = torch.where(c_n > v, NW_FROM_N, frm)
        v = torch.maximum(v, c_n)
        last = torch.where(rv, c_nw, c_w)
        frm = torch.where(last > v, torch.where(rv, from_nw, from_w), frm)
        v = torch.maximum(v, last)
        nw_val = v + s
        nw_from = frm
        if local:
            clamp = nw_val <= 0
            nw_val = torch.where(clamp, 0, nw_val)
            nw_from = torch.where(clamp, 0, nw_from)

        # N plane (previous row, same column)
        c_open = nwp[:, 1:] - gob - geb
        c_ext = np_[:, 1:] - geb
        take_ext = torch.where(rv, c_ext >= c_open, c_ext > c_open)
        n_val = torch.where(take_ext, c_ext, c_open)
        if local:
            n_val = n_val.clamp(min=0)

        nw_val = torch.where(inb, nw_val, init_nw)
        nw_from = torch.where(inb, nw_from, 0)
        n_val = torch.where(inb, n_val, init_n)

        # W plane: cummax chain along j, with the band-left injection
        nw_shift = torch.cat([pad[init_nw], nw_val[:, :-1]], dim=1)
        a = nw_shift - goa - gea
        if local:
            a = a.clamp(min=0)
        a = torch.where(jidx == x_min[:, None],
                        torch.maximum(a, full((1, 1), init_w - gea)), a)
        c = torch.where(inb, a + jidx * gea, FILL)
        c = torch.cummax(c, dim=1).values.clamp(min=FILL)
        w_val = torch.where(inb, c - jidx * gea, init_w)

        # diagonal-chain bookkeeping (carries from row i-1, column j-1)
        deq = deqp[:, :-1] + same.to(i32)
        chain = nw_from == NW_FROM_NW
        run = torch.where(chain, runp[:, :-1] + 1, 0)
        term = torch.where(chain, termp[:, :-1], nw_from)
        base = torch.where(chain, basep[:, :-1], deq)

        # best cell: strict > across rows, smallest j within the row
        cell = torch.maximum(torch.maximum(n_val, nw_val), w_val)
        rec = (rlen > i) if local else (rlen - 1 == i)
        cand = torch.where(rec[:, None] & inb, cell, NEG)
        rowbest = cand.max(dim=1).values
        jsel = torch.where(cand == rowbest[:, None], jidx, G).min(dim=1)
        jsel = jsel.values
        upd = rowbest > best
        best = torch.where(upd, rowbest, best)
        bi = torch.where(upd, i, bi)
        bj = torch.where(upd, jsel, bj)
        sel = jsel[:, None].long()
        for k, vals in enumerate((nw_val, n_val, w_val, run, term, deq,
                                  base)):
            pk = vals.gather(1, sel)[:, 0].clamp(min=NEG)
            picks[k] = torch.where(upd, pk, picks[k])

        nwp = torch.cat([pad[init_nw], nw_val], dim=1)
        np_ = torch.cat([pad[init_n], n_val], dim=1)
        wp = torch.cat([pad[init_w], w_val], dim=1)
        runp, termp, deqp, basep = (torch.cat([pad[0], x], dim=1)
                                    for x in (run, term, deq, base))
    score, max_i, max_j, plane = _plane_from_stats(best, bi, bj, *picks[:3])
    return torch.stack([score, max_i, max_j, plane, *picks[3:]], dim=1)


def _launch(genome, glen, read, rlen, ax, ay, alen, awid, revcmpl, *,
            match, mismatch, a_gap_open, a_gap_ext, b_gap_open, b_gap_ext,
            local_alignment) -> torch.Tensor:
    check_cuda_shape(genome, "sw_full_stats")
    B, G = genome.shape
    R = read.shape[1]
    dev = genome.device
    check_tensor("genome", genome, torch.uint8, (B, G), dev)
    check_tensor("read", read, torch.uint8, (B, R), dev)
    for name, t in (("glen", glen), ("rlen", rlen), ("ax", ax), ("ay", ay),
                    ("alen", alen), ("awid", awid), ("revcmpl", revcmpl)):
        check_tensor(name, t, torch.int32, (B,), dev)
    lib = _build.load().lib
    out = torch.empty((B, 8), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sw_full_stats_launch(
            genome.data_ptr(), glen.data_ptr(), read.data_ptr(),
            rlen.data_ptr(), ax.data_ptr(), ay.data_ptr(), alen.data_ptr(),
            awid.data_ptr(), revcmpl.data_ptr(), out.data_ptr(), B, G, R,
            match, mismatch, -a_gap_open, -a_gap_ext, -b_gap_open,
            -b_gap_ext, int(bool(local_alignment)), stream)
    _build.check(rc, "sw_full_stats_launch")
    LAUNCHES.add()
    return out


def sw_full_stats(genome: torch.Tensor, glen: torch.Tensor,
                  read: torch.Tensor, rlen: torch.Tensor, ax: torch.Tensor,
                  ay: torch.Tensor, alen: torch.Tensor, awid: torch.Tensor,
                  revcmpl: torch.Tensor, *, match: int, mismatch: int,
                  a_gap_open: int, a_gap_ext: int, b_gap_open: int,
                  b_gap_ext: int,
                  local_alignment: bool = False) -> torch.Tensor:
    """[B, 8] int32 full-SW stats rows. CPU tensors take the plain
    version; CUDA tensors launch the kernel (uint8 windows and reads,
    int32 per-pair arguments incl. revcmpl, contiguous, G <= 256) or
    raise."""
    kw = dict(match=match, mismatch=mismatch, a_gap_open=a_gap_open,
              a_gap_ext=a_gap_ext, b_gap_open=b_gap_open,
              b_gap_ext=b_gap_ext, local_alignment=local_alignment)
    if genome.device.type == "cpu":
        return sw_full_stats_ref(genome, glen, read, rlen, ax, ay, alen,
                                 awid, revcmpl, **kw)
    return _launch(genome, glen, read, rlen, ax, ay, alen, awid, revcmpl,
                   **kw)
