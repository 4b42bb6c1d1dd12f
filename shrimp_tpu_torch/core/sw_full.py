"""Full Smith-Waterman (filter 3): the plain PyTorch versions and the
wrappers of three CUDA kernels.

Port of the Pallas kernel `shrimp_tpu/core/sw_full_pallas.py::_kernel`:
the banded 3-plane (NW, N, W) affine DP, global or local, bit-faithful
to sw-full-ls.c including the `revcmpl` tie-break flip; out-of-band
cells are reset to the mode's init values on every row.

- `sw_full_stats` (`csrc/sw_full.cu`): emit_bp=False, through
  `sw_full_stats_pallas` and `_plane_from_stats`. [B, 8] int32 rows:
  score, max_i, max_j, plane, run, term, deq, base. When plane == 0 and
  term == 0 the best path is one diagonal chain: nops = run, matches =
  deq - base. The stats flow takes it for windows of G <= 256; wider
  windows go to the traceback flow below.
- `sw_full_bp` (`csrc/sw_full_bp.cu`): emit_bp=True, through
  `sw_full_batch_pallas`: (score, max_i, max_j, plane) int32 [B] and
  the backpointers `nw | n << 2 | w << 4` as uint8 [B, R, G], for every
  G up to 4095.
- `traceback_pack` (`csrc/ls_traceback.cu`): the on-device traceback
  `shrimp_tpu/core/sw_jax.py::_traceback_pack` (device code, not
  Pallas): walks the backpointers from the best cell and packs [B, 10]
  int32 (score, max_i, max_j, nops, rs, gs, matches, mismatches, ins,
  dels) and the 2-bit walk-order ops, 4 per byte, [B, (R+G+3)//4].

- `sw_full_and_traceback`: the two above in a row, the twin of
  `shrimp_tpu/core/sw_jax.py::sw_full_and_traceback` that the generic
  mapper calls; the backpointers never leave the device.

Each wrapper takes the plain version for CPU tensors only; for CUDA
tensors it launches its kernel or raises.
"""
from __future__ import annotations

import torch

from .. import _build
from ._args import MAX_G_LONG, check_cuda_shape, check_tensor

NEG = -(2 ** 30)
FILL = -(2 ** 28)
# plane from-codes (shrimp_tpu/core/sw_full_pallas.py)
NW_FROM_NW, NW_FROM_N, NW_FROM_W = 1, 2, 3
N_FROM_N, N_FROM_NW = 1, 2
W_FROM_W, W_FROM_NW = 1, 2

# launches of each CUDA kernel (the plain versions are not counted)
LAUNCHES = _build.LaunchCount()
BP_LAUNCHES = _build.LaunchCount()
TB_LAUNCHES = _build.LaunchCount()


def _plane_from_stats(best, bi, bj, nw_c, n_c, w_c):
    score = best.clamp(min=0)
    has = best > 0
    max_i = torch.where(has, bi, 0)
    max_j = torch.where(has, bj, 0)
    plane = (w_c > nw_c).to(torch.int32)
    plane = torch.where(n_c > torch.maximum(nw_c, w_c), 2, plane)
    plane = torch.where(has, plane, 0)
    return score, max_i, max_j, plane


def _sw_full_ref(genome, glen, read, rlen, ax, ay, alen, awid, revcmpl, *,
                 match, mismatch, a_gap_open, a_gap_ext, b_gap_open,
                 b_gap_ext, local_alignment, emit_bp):
    """The plain DP of both wrappers: a row loop over all R rows with the
    W-gap chain along j as a cummax, exactly the reference's row update.
    Returns ([B, 8] int32 stats, [B, R, G] uint8 backpointers or
    None)."""
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
    bp = (torch.empty((B, R, G), dtype=torch.uint8, device=dev)
          if emit_bp else None)
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
        n_from = torch.where(take_ext, N_FROM_N, N_FROM_NW)
        if local:
            n_from = torch.where(n_val <= 0, 0, n_from)
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
        if emit_bp:
            # backpointers nw | n << 2 | w << 4; W's from the raw open
            # candidate against the previous column's W
            c_ext_w = torch.cat([pad[init_w], w_val[:, :-1]], dim=1) - gea
            c_open_w = nw_shift - goa - gea
            w_from = torch.where(
                torch.where(rv, c_ext_w >= c_open_w, c_ext_w > c_open_w),
                W_FROM_W, W_FROM_NW)
            if local:
                w_from = torch.where(w_val <= 0, 0, w_from)
            w_from = torch.where(inb, w_from, 0)
            n_from = torch.where(inb, n_from, 0)
            bp[:, i] = (nw_from | (n_from << 2) | (w_from << 4)).to(
                torch.uint8)

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
    return (torch.stack([score, max_i, max_j, plane, *picks[3:]], dim=1),
            bp)


def sw_full_stats_ref(genome: torch.Tensor, glen: torch.Tensor,
                      read: torch.Tensor, rlen: torch.Tensor,
                      ax: torch.Tensor, ay: torch.Tensor,
                      alen: torch.Tensor, awid: torch.Tensor,
                      revcmpl: torch.Tensor, *, match: int, mismatch: int,
                      a_gap_open: int, a_gap_ext: int, b_gap_open: int,
                      b_gap_ext: int,
                      local_alignment: bool = False) -> torch.Tensor:
    """Plain int32 version of the stats kernel, on any device. Returns
    [B, 8] int32."""
    return _sw_full_ref(genome, glen, read, rlen, ax, ay, alen, awid,
                        revcmpl, match=match, mismatch=mismatch,
                        a_gap_open=a_gap_open, a_gap_ext=a_gap_ext,
                        b_gap_open=b_gap_open, b_gap_ext=b_gap_ext,
                        local_alignment=local_alignment, emit_bp=False)[0]


def sw_full_bp_ref(genome: torch.Tensor, glen: torch.Tensor,
                   read: torch.Tensor, rlen: torch.Tensor, ax: torch.Tensor,
                   ay: torch.Tensor, alen: torch.Tensor, awid: torch.Tensor,
                   revcmpl: torch.Tensor, *, match: int, mismatch: int,
                   a_gap_open: int, a_gap_ext: int, b_gap_open: int,
                   b_gap_ext: int, local_alignment: bool = False):
    """Plain version of the backpointer kernel, on any device: (score,
    max_i, max_j, plane) int32 [B] and bp uint8 [B, R, G], cell for cell
    the Pallas kernel's `nw | n << 2 | w << 4` (out-of-band cells 0)."""
    st, bp = _sw_full_ref(genome, glen, read, rlen, ax, ay, alen, awid,
                          revcmpl, match=match, mismatch=mismatch,
                          a_gap_open=a_gap_open, a_gap_ext=a_gap_ext,
                          b_gap_open=b_gap_open, b_gap_ext=b_gap_ext,
                          local_alignment=local_alignment, emit_bp=True)
    return (*st[:, :4].t().contiguous().unbind(0), bp)


def _check_dp_args(what, genome, glen, read, rlen, ax, ay, alen, awid,
                   revcmpl, max_g):
    check_cuda_shape(genome, what, max_g)
    B, G = genome.shape
    R = read.shape[1]
    dev = genome.device
    check_tensor("genome", genome, torch.uint8, (B, G), dev)
    check_tensor("read", read, torch.uint8, (B, R), dev)
    for name, t in (("glen", glen), ("rlen", rlen), ("ax", ax), ("ay", ay),
                    ("alen", alen), ("awid", awid), ("revcmpl", revcmpl)):
        check_tensor(name, t, torch.int32, (B,), dev)
    return B, G, R, dev


def _launch(genome, glen, read, rlen, ax, ay, alen, awid, revcmpl, *,
            match, mismatch, a_gap_open, a_gap_ext, b_gap_open, b_gap_ext,
            local_alignment) -> torch.Tensor:
    B, G, R, dev = _check_dp_args("sw_full_stats", genome, glen, read, rlen,
                                  ax, ay, alen, awid, revcmpl, None)
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
    raise. The fast path sends windows of G <= 256 to this stats flow
    and wider ones to the traceback flow (`sw_full_bp`,
    `traceback_pack`)."""
    kw = dict(match=match, mismatch=mismatch, a_gap_open=a_gap_open,
              a_gap_ext=a_gap_ext, b_gap_open=b_gap_open,
              b_gap_ext=b_gap_ext, local_alignment=local_alignment)
    if genome.device.type == "cpu":
        return sw_full_stats_ref(genome, glen, read, rlen, ax, ay, alen,
                                 awid, revcmpl, **kw)
    return _launch(genome, glen, read, rlen, ax, ay, alen, awid, revcmpl,
                   **kw)


def _launch_bp(genome, glen, read, rlen, ax, ay, alen, awid, revcmpl, *,
               match, mismatch, a_gap_open, a_gap_ext, b_gap_open,
               b_gap_ext, local_alignment):
    B, G, R, dev = _check_dp_args("sw_full_bp", genome, glen, read, rlen, ax,
                                  ay, alen, awid, revcmpl, MAX_G_LONG)
    lib = _build.load().lib
    st = torch.empty((4, B), dtype=torch.int32, device=dev)
    bp = torch.empty((B, R, G), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sw_full_bp_launch(
            genome.data_ptr(), glen.data_ptr(), read.data_ptr(),
            rlen.data_ptr(), ax.data_ptr(), ay.data_ptr(), alen.data_ptr(),
            awid.data_ptr(), revcmpl.data_ptr(), st.data_ptr(),
            bp.data_ptr(), B, G, R, match, mismatch, -a_gap_open,
            -a_gap_ext, -b_gap_open, -b_gap_ext, int(bool(local_alignment)),
            stream)
    _build.check(rc, "sw_full_bp_launch")
    BP_LAUNCHES.add()
    return (*st.unbind(0), bp)


def sw_full_bp(genome: torch.Tensor, glen: torch.Tensor, read: torch.Tensor,
               rlen: torch.Tensor, ax: torch.Tensor, ay: torch.Tensor,
               alen: torch.Tensor, awid: torch.Tensor, revcmpl: torch.Tensor,
               *, match: int, mismatch: int, a_gap_open: int,
               a_gap_ext: int, b_gap_open: int, b_gap_ext: int,
               local_alignment: bool = False):
    """(score, max_i, max_j, plane) int32 [B] and backpointers uint8
    [B, R, G]. CPU tensors take the plain version; CUDA tensors launch
    the kernel (uint8 windows and reads, int32 per-pair arguments incl.
    revcmpl, contiguous, G <= 4095) or raise."""
    kw = dict(match=match, mismatch=mismatch, a_gap_open=a_gap_open,
              a_gap_ext=a_gap_ext, b_gap_open=b_gap_open,
              b_gap_ext=b_gap_ext, local_alignment=local_alignment)
    if genome.device.type == "cpu":
        return sw_full_bp_ref(genome, glen, read, rlen, ax, ay, alen, awid,
                              revcmpl, **kw)
    return _launch_bp(genome, glen, read, rlen, ax, ay, alen, awid, revcmpl,
                      **kw)


# traceback codes (shrimp_tpu/core/sw_jax.py): reference FROM_* codes
# (sw-full-ls.c:36-42), the plane each continues in (0 nw, 1 w, 2 n),
# the decode of each plane's 2-bit field, and the emitted ops
F_NN, F_NNW, F_WNW, F_WW, F_NWN, F_NWNW, F_NWW = 1, 2, 3, 4, 5, 6, 7
NEXT_PLANE = (0, 2, 0, 0, 1, 2, 0, 1)
NW_DEC = (0, F_NWNW, F_NWN, F_NWW)
N_DEC = (0, F_NN, F_NNW, 0)
W_DEC = (0, F_WW, F_WNW, 0)
BACK_INS, BACK_DEL, BACK_MM = 1, 2, 3


def _tb_decode(v, plane, tabs):
    nw_dec, n_dec, w_dec = tabs
    return torch.where(plane == 0, nw_dec[v & 3],
                       torch.where(plane == 1, w_dec[(v >> 4) & 3],
                                   n_dec[(v >> 2) & 3]))


def traceback_pack_ref(genome: torch.Tensor, read: torch.Tensor,
                       score: torch.Tensor, max_i: torch.Tensor,
                       max_j: torch.Tensor, plane: torch.Tensor,
                       bp: torch.Tensor):
    """Plain version of the traceback, on any device: one walk step of
    every pair per loop iteration, until no pair is active. Like the
    reference, a pair starts from its best cell even when its score is
    0 (max_i = max_j = 0). Returns (packed [B, 10] int32, ops [B, W]
    uint8)."""
    B, R, G = bp.shape
    L = R + G
    dev = bp.device
    i64 = torch.int64
    tabs = tuple(torch.tensor(t, dtype=i64, device=dev)
                 for t in (NW_DEC, N_DEC, W_DEC))
    nxt_tab = torch.tensor(NEXT_PLANE, dtype=i64, device=dev)
    flat = bp.reshape(-1)
    rows = torch.arange(B, device=dev)
    base = rows.to(i64) * (R * G)
    i0, j0 = max_i.to(i64), max_j.to(i64)
    i, j = i0, j0
    frm = _tb_decode(flat[base + i.clamp(min=0) * G + j.clamp(min=0)].to(i64),
                     plane.to(i64), tabs)
    ops = torch.zeros((B, L + (-L) % 4), dtype=torch.uint8, device=dev)
    z = torch.zeros(B, dtype=i64, device=dev)
    n_match, n_mis, n_ins, n_del, cr, cg, nops = (z.clone()
                                                  for _ in range(7))
    t = 0
    while t < L and bool((frm != 0).any()):
        act = frm != 0
        is_n = (frm == F_NN) | (frm == F_NNW)
        is_w = (frm == F_WW) | (frm == F_WNW)
        is_nw = frm >= F_NWN
        ops[:, t] = torch.where(is_n, BACK_DEL, torch.where(
            is_w, BACK_INS, torch.where(is_nw, BACK_MM, 0))).to(torch.uint8)
        eq = genome[rows, j.clamp(0, G - 1)] == read[rows, i.clamp(0, R - 1)]
        n_match += is_nw & eq
        n_mis += is_nw & ~eq
        n_ins += is_w
        n_del += is_n
        cr += is_n | is_nw
        cg += is_w | is_nw
        nops += act
        i2 = i - (is_n | is_nw).to(i64)
        j2 = j - (is_w | is_nw).to(i64)
        nxt = nxt_tab[frm.clamp(0, 7)]
        go = act & (i2 >= 0) & (j2 >= 0)
        v = flat[base + i2.clamp(0, R - 1) * G + j2.clamp(0, G - 1)]
        frm = torch.where(go, _tb_decode(v.to(i64), nxt, tabs), 0)
        i, j = i2, j2
        t += 1
    rs = torch.where(cr > 0, i0 - cr + 1, 0)
    gs = torch.where(cg > 0, j0 - cg + 1, 0)
    packed = torch.stack([score.to(i64), i0, j0, nops, rs, gs, n_match,
                          n_mis, n_ins, n_del], dim=1).to(torch.int32)
    o = ops.reshape(B, -1, 4)
    ops_pk = o[..., 0] | (o[..., 1] << 2) | (o[..., 2] << 4) | (o[..., 3] << 6)
    return packed, ops_pk


def _launch_tb(genome, read, score, max_i, max_j, plane, bp):
    B, R, G = bp.shape
    dev = bp.device
    check_cuda_shape(genome, "traceback_pack", MAX_G_LONG)
    check_tensor("bp", bp, torch.uint8, (B, R, G), dev)
    check_tensor("genome", genome, torch.uint8, (B, G), dev)
    check_tensor("read", read, torch.uint8, (B, R), dev)
    for name, t in (("score", score), ("max_i", max_i), ("max_j", max_j),
                    ("plane", plane)):
        check_tensor(name, t, torch.int32, (B,), dev)
    if G % 16 or bp.data_ptr() % 16:
        raise NotImplementedError(
            f"traceback_pack: the CUDA kernel loads the backpointers in "
            f"16-byte pieces: G = {G} must be a multiple of 16 and bp "
            f"16-byte aligned")
    lib = _build.load().lib
    W = (R + G + 3) // 4
    packed = torch.empty((B, 10), dtype=torch.int32, device=dev)
    ops = torch.empty((B, W), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ls_traceback_launch(
            genome.data_ptr(), read.data_ptr(), score.data_ptr(),
            max_i.data_ptr(), max_j.data_ptr(), plane.data_ptr(),
            bp.data_ptr(), packed.data_ptr(), ops.data_ptr(), B, G, R,
            stream)
    _build.check(rc, "ls_traceback_launch")
    TB_LAUNCHES.add()
    return packed, ops


def traceback_pack(genome: torch.Tensor, read: torch.Tensor,
                   score: torch.Tensor, max_i: torch.Tensor,
                   max_j: torch.Tensor, plane: torch.Tensor,
                   bp: torch.Tensor):
    """(packed [B, 10] int32, ops [B, (R+G+3)//4] uint8) of the walk from
    each pair's best cell. CPU tensors take the plain version; CUDA
    tensors launch the kernel (uint8 windows, reads and backpointers,
    int32 best cells, contiguous; G a multiple of 16, as the flows'
    windows are) or raise."""
    if bp.device.type == "cpu":
        return traceback_pack_ref(genome, read, score, max_i, max_j, plane,
                                  bp)
    return _launch_tb(genome, read, score, max_i, max_j, plane, bp)


def sw_full_and_traceback(genome: torch.Tensor, glen: torch.Tensor,
                          read: torch.Tensor, rlen: torch.Tensor,
                          ax: torch.Tensor, ay: torch.Tensor,
                          alen: torch.Tensor, awid: torch.Tensor,
                          revcmpl: torch.Tensor, *, match: int,
                          mismatch: int, a_gap_open: int, a_gap_ext: int,
                          b_gap_open: int, b_gap_ext: int,
                          local_alignment: bool = False):
    """The full SW with backpointers, then the traceback from each pair's
    best cell (do_backtrace, sw-full-ls.c:413-516): (packed [B, 10]
    int32, ops [B, (R+G+3)//4] uint8), as `sw_jax.sw_full_and_traceback`
    returns them. Arguments and devices as `sw_full_bp`."""
    score, max_i, max_j, plane, bp = sw_full_bp(
        genome, glen, read, rlen, ax, ay, alen, awid, revcmpl, match=match,
        mismatch=mismatch, a_gap_open=a_gap_open, a_gap_ext=a_gap_ext,
        b_gap_open=b_gap_open, b_gap_ext=b_gap_ext,
        local_alignment=local_alignment)
    return traceback_pack(genome, read, score, max_i, max_j, plane, bp)
