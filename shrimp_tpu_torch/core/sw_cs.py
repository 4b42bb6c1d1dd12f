"""The device step of the colour-space fused flow, on torch tensors.

Port of the device half of `shrimp_tpu/core/sw_cs_jax.py`:
`sw_full_cs_tpu_pallas` (the 4-layer DP followed by the traceback) and
the three phases of `sw_vec_cs_full_from_index` (fused; vec and full,
of the two-phase dispatch), and the generic mapper's chunk launch and
fetch (`sw_full_cs_dispatch` / `sw_full_cs_finish`). Per chunk, [B, 12] int32
argument rows go up; colour and letter windows are gathered from the
two device-resident cat-word planes; the CS vector SW scores every
window and the 4-layer DP plus traceback align it; [B] int32 vector
scores, [B, 12] int16 packed alignments and [B, R + G] int8 reversed
step codes come back in the reference's layout, which the native
`cs_finalize_render` reads unchanged. The kernels are
`sw_vector.sw_vector_batch` (colour-space mode), `sw_cs_full.
sw_full_cs_dp` and `sw_cs_full.cs_traceback`: CUDA kernels for CUDA
tensors, plain versions for CPU tensors.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .sw import _check_phase, fast_window_gather, window_gather_bytes
from .sw_cs_batch import CSBatchResult, cs_layers_batch
from .sw_cs_full import cs_traceback, sw_full_cs_dp
from .sw_vector import _colour_lut, sw_vector_batch


def sw_full_cs(genome_ls: torch.Tensor, glen: torch.Tensor,
               qr: torch.Tensor, rlen: torch.Tensor, ax: torch.Tensor,
               ay: torch.Tensor, alen: torch.Tensor, awid: torch.Tensor,
               revcmpl: torch.Tensor, xover_rows: torch.Tensor,
               gx_col: torch.Tensor, thresh: torch.Tensor, *, match: int,
               mismatch: int, a_gap_open: int, a_gap_ext: int,
               b_gap_open: int, b_gap_ext: int,
               local_alignment: bool = False, indel_taboo_len: int = 0):
    """The 4-layer DP, then the traceback from its best cells: (packed
    [B, 12] int16, steps_rev [B, R + G] int8), as sw_full_cs_tpu_pallas
    returns them. `thresh` zeroes the scores below it."""
    best, bi, bj, bk, bfrm, bp = sw_full_cs_dp(
        genome_ls, glen, qr, rlen, ax, ay, alen, awid, revcmpl, xover_rows,
        gx_col, match=match, mismatch=mismatch, a_gap_open=a_gap_open,
        a_gap_ext=a_gap_ext, b_gap_open=b_gap_open, b_gap_ext=b_gap_ext,
        local_alignment=local_alignment, indel_taboo_len=indel_taboo_len)
    return cs_traceback(genome_ls, qr, best, bi, bj, bk, bfrm, bp, thresh)


def sw_vec_cs_full_from_index(cs_codes: torch.Tensor,
                              cs_codes_rc: torch.Tensor,
                              ls_codes: torch.Tensor,
                              ls_codes_rc: torch.Tensor, args: torch.Tensor,
                              rtab: torch.Tensor, qr_tab: torch.Tensor,
                              xover_tab: torch.Tensor,
                              cs_cat: Optional[torch.Tensor] = None,
                              ls_cat: Optional[torch.Tensor] = None, *,
                              G: int, xover: int, match: int, mismatch: int,
                              a_gap_open: int, a_gap_ext: int,
                              b_gap_open: int, b_gap_ext: int,
                              local_alignment: bool = False,
                              indel_taboo_len: int = 0,
                              phase: str = "fused"):
    """Fused colour-space filter 2 + speculative filter 3 against the
    device-resident genome planes, on the device of `args`.

    args: [B, 12] int32 rows: 0 gstart (absolute, strand-normalized),
    1 glen, 2 owner (read row), 3 eff_rc, 4 rlen, 5 rx, 6 ry, 7 rl, 8 rw
    (widened anchor rectangle), 9 rev tie-break, 10 thresh, 11 initbp.
    rtab [n, R] uint8 colour rows, qr_tab [n, 4, R] uint8 letter layers,
    xover_tab [n, R] int32 crossover penalties; `xover` is also the row
    -1 global crossover. cs_cat and ls_cat are the colour and letter
    planes as cat words (core.sw.cat_word_plane); `cs_codes` and
    `ls_codes` give their plane lengths. Where either is None (planes
    over ~1 Gbp) both windows are gathered byte by byte from the four
    planes, each position clipped to the colour plane's length, as the
    reference's fallback does. Returns (vec [B] int32, packed
    [B, 12] int16, steps_rev [B, R + G] int8). `phase` "vec" runs only
    the CS vector SW and returns (vec,) (the letter window is still
    gathered: g_row0 needs it); "full" runs only the 4-layer DP and the
    traceback and returns (packed, steps_rev)."""
    _check_phase(phase)
    B = args.shape[0]
    (gstart, glen, owner, eff_rc, rlen, rx, ry, rl, rw, rev, thresh,
     initbp) = args.t().contiguous().unbind(0)
    owner = owner.clamp(0, rtab.shape[0] - 1).long()
    by_byte = cs_cat is None or ls_cat is None
    if by_byte and ls_codes.shape[0] != cs_codes.shape[0]:
        raise ValueError("colour and letter planes differ in length")

    def gather(cat, fwd, rc):
        if by_byte:
            return window_gather_bytes(fwd, rc, gstart, eff_rc, G)
        return fast_window_gather(cat, fwd.shape[0], gstart, eff_rc, G)
    lswin = gather(ls_cat, ls_codes, ls_codes_rc)
    if phase != "full":
        gwin_cs = gather(cs_cat, cs_codes, cs_codes_rc)
        # the flat index clips as the reference's gather does (254 pad
        # bytes)
        g_row0 = _colour_lut(lswin.device)[
            (lswin.to(torch.int32) * 16 + initbp[:, None]).clamp(0, 255)]
        # the vector filter's mismatch is match + crossover (gmapper.c
        # f1_setup): a colour mismatch there is one crossover, so reads
        # with dot colours still clear pass 1
        vec = sw_vector_batch(gwin_cs, glen, rtab[owner], rlen, g_row0,
                              cs_mode=True, match=match,
                              mismatch=match + xover, a_gap_open=a_gap_open,
                              a_gap_ext=a_gap_ext, b_gap_open=b_gap_open,
                              b_gap_ext=b_gap_ext)
        del gwin_cs, g_row0
        if phase == "vec":
            return (vec,)
    gx_col = torch.full((B,), xover, dtype=torch.int32, device=args.device)
    packed, steps_rev = sw_full_cs(
        lswin, glen, qr_tab[owner], rlen, rx, ry, rl.clamp(min=1),
        rw.clamp(min=1), (rev != 0).to(torch.int32),
        xover_tab[owner].to(torch.int32), gx_col, thresh, match=match,
        mismatch=mismatch, a_gap_open=a_gap_open, a_gap_ext=a_gap_ext,
        b_gap_open=b_gap_open, b_gap_ext=b_gap_ext,
        local_alignment=local_alignment, indel_taboo_len=indel_taboo_len)
    if phase == "full":
        return packed, steps_rev
    return vec, packed, steps_rev


def sw_full_cs_dispatch(genome_ls, glen, colours, rlen, initbp, ax, ay, alen,
                        awid, revcmpl, xover_rows, thresh, *, device,
                        match: int, mismatch: int, a_gap_open: int,
                        a_gap_ext: int, b_gap_open: int, b_gap_ext: int,
                        local_alignment: bool = False,
                        indel_taboo_len: int = 0):
    """Launch one chunk of the generic mapper's colour-space full SW on
    `device` and return its state for sw_full_cs_finish: twin of
    `shrimp_tpu/core/sw_cs_jax.py::sw_full_cs_dispatch`. Host numpy
    inputs: letter windows [B, G], colour reads [B, R], per-pair lengths,
    initbp, anchor rectangles, revcmpl, crossover rows [B, R + 1] (the
    last column is the row -1 crossover, `gx_col`) and thresholds. The
    read layers are built on the host (cs_layers_batch) and uploaded
    with the rest; (packed [B, 12] int16, steps_rev [B, R + G] int8) stay
    on the device."""
    R = colours.shape[1]
    qr = cs_layers_batch(np.asarray(colours, np.uint8),
                         np.asarray(initbp, np.int64))
    xo = np.asarray(xover_rows)

    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)
    i32 = np.int32
    packed, steps_rev = sw_full_cs(
        up(genome_ls, np.uint8), up(glen, i32), up(qr, np.uint8),
        up(rlen, i32), up(ax, i32), up(ay, i32), up(alen, i32),
        up(awid, i32), up(np.asarray(revcmpl, bool), i32),
        up(xo[:, :R], i32), up(xo[:, -1], i32), up(thresh, i32),
        match=match, mismatch=mismatch, a_gap_open=a_gap_open,
        a_gap_ext=a_gap_ext, b_gap_open=b_gap_open, b_gap_ext=b_gap_ext,
        local_alignment=bool(local_alignment),
        indel_taboo_len=int(indel_taboo_len))
    return packed, steps_rev, qr


def sw_full_cs_finish(state, fetched=None) -> CSBatchResult:
    """Unpack one dispatched chunk into a CSBatchResult (walk-order
    steps, counts): twin of `shrimp_tpu/core/sw_cs_jax.py::
    sw_full_cs_finish`. `fetched` carries the chunk's (packed,
    steps_rev) already copied to the host (one copy for every chunk);
    without it they are copied here."""
    packed_d, steps_d, qr = state
    if fetched is not None:
        packed, steps_rev = fetched
    else:
        packed, steps_rev = packed_d.cpu().numpy(), steps_d.cpu().numpy()
    B = packed.shape[0]
    (score, _bi, _bj, _bk, nops, rs, gs, m_, mm_, ins, dele, xo
     ) = [packed[:, c].astype(np.int64) for c in range(12)]
    maxsteps = steps_rev.shape[1]
    bidx = np.arange(B)[:, None]
    idxm = np.arange(maxsteps)[None, :]
    src = np.clip(nops[:, None] - 1 - idxm, 0, maxsteps - 1)
    steps = np.where(idxm < nops[:, None], steps_rev[bidx, src], 0
                     ).astype(np.int16)
    return CSBatchResult(
        score=score, steps=steps, n_steps=nops, read_start=rs,
        genome_start=gs, rmapped=nops - ins, gmapped=nops - dele,
        matches=m_, mismatches=mm_, insertions=ins, deletions=dele,
        crossovers=xo, qr=qr)
