"""The device steps of the letter-space fused flows, on torch tensors.

Port of `shrimp_tpu/core/sw_jax.py`: `_unpack_rtab_nib`, `_unpack_args4`,
`fast_window_gather`, `_vec_full_gather_packed`, `_vec_full_gather`,
`_pack_stats3` and the three phases (fused; vec and full, of the
two-phase dispatch) of `sw_vec_full_stats_packed` (the stats flow) and
`sw_vec_full_tb_packed` (the traceback flow), and of their unpacked
twins `sw_vec_full_stats_from_index` and `sw_vec_full_tb_from_index`.
On packed IO arguments go up at 16 B per window with 4-bit reads; the
unpacked steps take [B, 10] int32 rows and a byte read table, for
batches whose read rows or windows outgrow the packed bit fields. The
kernels run on windows gathered from the device-resident genome planes:
word by word from the concatenated word plane, or byte by byte
(`window_gather_bytes`) where that plane does not exist (planes over
~1 Gbp) and in the unpacked steps. The packed stats flow returns [B, 3]
int32 rows in the reference's bit layout, so the host's
`_unpack_stats3` reads them unchanged; the traceback flow returns the
vector scores, the [B, 10] traceback rows and the packed ops that the
host's `finalize_render` reads. The gathers are plain tensor indexing;
the DP kernels are `sw_vector.sw_vector_batch`, `sw_full.sw_full_stats`,
`sw_full.sw_full_bp` and `sw_full.traceback_pack` (CUDA kernels for
CUDA tensors, plain versions for CPU tensors).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .sw_full import sw_full_bp, sw_full_stats, traceback_pack
from .sw_vector import sw_vector_batch

# bytes between the forward and reverse-complement planes of the
# concatenated word plane
PAD = 96
# window bytes gathered per block by the byte gather: bounds its
# transients (int64 positions and two byte gathers, about 10 B a cell)
GATHER_BLOCK_CELLS = 1 << 24


def cat_word_plane(fp: np.ndarray, rp: np.ndarray) -> Optional[np.ndarray]:
    """The concatenated (fwd, pad, rc, pad2) plane of two equal-length
    uint8 genome planes, as int32 words, for fast_window_gather. The pads
    repeat each plane's last byte. None when its offsets would overflow
    int32 (planes over ~1 Gbp)."""
    n = len(fp)
    if len(rp) != n:
        raise ValueError("forward and reverse-complement planes differ "
                         "in length")
    pad2 = PAD + (-(2 * n + PAD) % 4)
    if 2 * n + PAD + pad2 >= 2 ** 31:
        return None
    cat = np.empty(2 * n + PAD + pad2, np.uint8)
    cat[:n] = fp
    cat[n:n + PAD] = fp[-1]
    cat[n + PAD:2 * n + PAD] = rp
    cat[2 * n + PAD:] = rp[-1]
    return cat.view(np.int32)


def _unpack_rtab_nib(rtab_pk: torch.Tensor) -> torch.Tensor:
    """[B, W] uint8 nibble-packed read codes -> [B, 2W] uint8 codes.
    Byte k holds code[2k] in the low nibble, code[2k+1] in the high."""
    B, W = rtab_pk.shape
    return torch.stack([rtab_pk & 0x0F, rtab_pk >> 4], dim=2).reshape(B,
                                                                     2 * W)


def _unpack_args4(args4: torch.Tensor):
    """Decode the [B, 4] int32 packed argument rows
    (fastpath._pack_args4):

    w0 = gstart (absolute genome offset)
    w1 = ri | rc<<16 | rev<<17 | glen<<18    (ri < 2^16, glen < 2^14)
    w2 = (rx & 0xffff) | ry<<16              (both signed int16)
    w3 = (rl & 0xffff) | rw<<16
    """
    w0, w1, w2, w3 = args4.unbind(1)
    ri = w1 & 0xFFFF
    rc = (w1 >> 16) & 1
    rev = (w1 >> 17) & 1
    glen = (w1 >> 18) & 0x3FFF
    rx = ((w2 & 0xFFFF) ^ 0x8000) - 0x8000    # sign-extend the low half
    ry = w2 >> 16
    rl_ = w3 & 0xFFFF
    rw_ = (w3 >> 16) & 0xFFFF
    return w0, glen, ri, rc, rx, ry, rl_, rw_, rev


def fast_window_gather(cat_words: torch.Tensor, n_gen: int,
                       gstart: torch.Tensor, rc: torch.Tensor,
                       G: int) -> torch.Tensor:
    """[B, G] uint8 genome windows from the concatenated (fwd, pad, rc,
    pad2) plane of `n_gen`-byte planes (cat_word_plane). gstart is
    clipped to [0, n_gen-1] first; the pads repeat each plane's last
    byte, which reproduces a per-element clip for the tails of windows
    that overrun a plane (those cells are glen-masked in both kernels).
    Words past the end of the word plane read as INT32_MIN, the fill of
    the reference's out-of-range word gather; only windows wider than
    the pad reach them.

    The gather runs at word granularity, as the reference's does: G/4 + 1
    words a row (int64 indices), then each row's 4-byte phase picks its
    G bytes. Its transients are about 17 bytes a window byte less than a
    byte gather's, which matters at the vec-only phase's millions of
    rows."""
    if G % 4:
        raise ValueError(f"fast_window_gather: G={G} is not a multiple "
                         "of 4 (the packed flow pads G to 32)")
    nw = cat_words.numel()
    eff = (gstart.clamp(0, n_gen - 1).long()
           + torch.where(rc != 0, n_gen + PAD, 0))
    W = G // 4 + 1
    widx = (eff >> 2)[:, None] + torch.arange(W, device=eff.device)[None, :]
    words = torch.where(widx < nw, cat_words[widx.clamp(max=nw - 1)],
                        torch.iinfo(torch.int32).min)
    del widx
    by = words.view(torch.uint8)      # [B, 4W], little-endian bytes
    sh = (eff & 3)[:, None]
    out = by[:, 3:3 + G]
    for k in (2, 1, 0):
        out = torch.where(sh == k, by[:, k:k + G], out)
    return out


def window_gather_bytes(codes_fwd: torch.Tensor, codes_rc: torch.Tensor,
                        gstart: torch.Tensor, rc: torch.Tensor,
                        G: int) -> torch.Tensor:
    """[B, G] uint8 genome windows gathered byte by byte, as the
    reference's `_vec_full_gather` does: position gstart + j is clipped
    to [0, n_gen - 1] (a window that overruns a plane repeats its edge
    byte) and read from `codes_rc` where rc != 0, else from `codes_fwd`.
    The rows go in blocks of at most GATHER_BLOCK_CELLS window bytes, so
    the transients stay bounded at the vec-only launch's millions of
    rows; a row's window does not depend on its block."""
    n_gen = codes_fwd.shape[0]
    if codes_rc.shape[0] != n_gen:
        raise ValueError("forward and reverse-complement planes differ "
                         "in length")
    B = gstart.shape[0]
    dev = gstart.device
    out = torch.empty((B, G), dtype=torch.uint8, device=dev)
    jidx = torch.arange(G, dtype=torch.int64, device=dev)[None, :]
    step = max(1, GATHER_BLOCK_CELLS // max(G, 1))
    for r0 in range(0, B, step):
        r1 = min(B, r0 + step)
        pos = (gstart[r0:r1, None].long() + jidx).clamp_(0, n_gen - 1)
        out[r0:r1] = torch.where(rc[r0:r1, None] != 0, codes_rc[pos],
                                 codes_fwd[pos])
        del pos
    return out


def _vec_full_gather_packed(codes_fwd, codes_rc, args4, rtab_pk, G: int,
                            L: int, cat_words):
    """Windows, read rows and per-pair arguments for both kernels. rlen
    is the uniform batch read length L (pad rows score a 1-cell window
    whose result the host discards). Without a word plane (`cat_words`
    None: planes over ~1 Gbp) the windows are gathered byte by byte."""
    gstart, glen, ri, rc, rx, ry, rl_, rw_, rev = _unpack_args4(args4)
    if cat_words is None:
        gwin = window_gather_bytes(codes_fwd, codes_rc, gstart, rc, G)
    else:
        gwin = fast_window_gather(cat_words, codes_fwd.shape[0], gstart,
                                  rc, G)
    rB = rtab_pk.shape[0]
    rwin = _unpack_rtab_nib(rtab_pk[ri.clamp(0, rB - 1).long()])
    rlen = torch.full_like(glen, L)
    return gwin, rwin, glen, rlen, rx, ry, rl_, rw_, rev


def _vec_full_gather(codes_fwd, codes_rc, args, rtab, G: int):
    """The unpacked steps' windows, read rows and per-pair arguments.
    args: [B, 10] int32 rows (gstart, glen, ri, rc, rlen, ax, ay, alen,
    awid, rev); rtab: [n_reads, R] uint8 read rows. Strand-1 rows hold
    the reverse_hit coordinates and gather from the revcomp plane."""
    (gstart, glen, ri, rc, rlen, ax, ay, alen, awid,
     rev) = args.t().contiguous().unbind(0)
    gwin = window_gather_bytes(codes_fwd, codes_rc, gstart, rc, G)
    rwin = rtab[ri.clamp(0, rtab.shape[0] - 1).long()]
    return gwin, rwin, glen, rlen, ax, ay, alen, awid, rev


def _pack_stats3(vec: torch.Tensor, stats: torch.Tensor) -> torch.Tensor:
    """Pack (vec score, full-SW stats [B, 8]) into [B, 3] int32:

    w0 = vec | score<<16       (both >= 0 and < 2^15: sw-vector.c:393)
    w1 = mi | mj<<12 | plane<<24 | (term!=0)<<26    (mi, mj < 4096)
    w2 = matches | run<<16     (matches = deq - base along the chain)

    Fields of rows with score == 0 are junk the host never reads."""
    score, mi, mj, plane, run, term = stats[:, :6].unbind(1)
    matches = stats[:, 6] - stats[:, 7]
    w0 = (score << 16) | (vec & 0xFFFF)
    w1 = ((mi & 4095) | ((mj & 4095) << 12) | ((plane & 3) << 24)
          | ((term != 0).to(torch.int32) << 26))
    w2 = (matches & 0xFFFF) | ((run & 0x7FFF) << 16)
    return torch.stack([w0, w1, w2], dim=1).to(torch.int32)


def _check_phase(phase: str) -> None:
    if phase not in ("fused", "vec", "full"):
        raise ValueError(f"phase must be 'fused', 'vec' or 'full', not "
                         f"{phase!r}")


def _stats_kernels(gathered, phase: str, local_alignment: bool, kw):
    """The stats flow's kernels on gathered inputs: (vec int32 [B], None
    for phase "full"; full-SW stats [B, 8] int32, None for phase
    "vec")."""
    gwin, rwin, glen, rlen, rx, ry, rl_, rw_, rev = gathered
    vec = stats = None
    if phase != "full":
        vec = sw_vector_batch(gwin, glen, rwin, rlen, **kw)
    if phase != "vec":
        stats = sw_full_stats(gwin, glen, rwin, rlen, rx, ry, rl_, rw_, rev,
                              local_alignment=local_alignment, **kw)
    return vec, stats


def _tb_kernels(gathered, phase: str, local_alignment: bool, kw):
    """The traceback flow's kernels on gathered inputs: (vec int16,)
    for phase "vec", (packed [B, 10] int32, ops [B, (R+G+3)//4] uint8)
    for "full", (vec, packed, ops) for "fused"."""
    gwin, rwin, glen, rlen, rx, ry, rl_, rw_, rev = gathered
    if phase != "full":
        vec = sw_vector_batch(gwin, glen, rwin, rlen, **kw).to(torch.int16)
        if phase == "vec":
            return (vec,)
    score, max_i, max_j, plane, bp = sw_full_bp(
        gwin, glen, rwin, rlen, rx, ry, rl_, rw_, rev,
        local_alignment=local_alignment, **kw)
    packed, ops = traceback_pack(gwin, rwin, score, max_i, max_j, plane, bp)
    if phase == "full":
        return packed, ops
    return vec, packed, ops


def sw_vec_full_stats_packed(codes_fwd: torch.Tensor,
                             codes_rc: torch.Tensor, args4: torch.Tensor,
                             rtab_pk: torch.Tensor,
                             cat_words: Optional[torch.Tensor], *, G: int,
                             L: int, match: int, mismatch: int,
                             a_gap_open: int, a_gap_ext: int,
                             b_gap_open: int, b_gap_ext: int,
                             local_alignment: bool = False,
                             phase: str = "fused"):
    """Fused filter 2 + speculative filter 3 on packed IO: [B, 4] int32
    args and the nibble-packed read table in, [B, 3] int32
    `_pack_stats3` rows out, all on the device of `args4`. The windows
    come from the word plane `cat_words` (which holds both strands;
    `codes_fwd` gives its plane length), or byte by byte from `codes_fwd`
    and `codes_rc` where it is None.

    `phase` splits the step for the two-phase dispatch: "vec" runs only
    the vector SW and returns (int16 vec scores [B],); "full" runs only
    the stats kernel and returns the [B, 3] rows with the vec field
    zero; "fused" runs both."""
    _check_phase(phase)
    gathered = _vec_full_gather_packed(codes_fwd, codes_rc, args4, rtab_pk,
                                       G, L, cat_words)
    vec, stats = _stats_kernels(gathered, phase, local_alignment, dict(
        match=match, mismatch=mismatch, a_gap_open=a_gap_open,
        a_gap_ext=a_gap_ext, b_gap_open=b_gap_open, b_gap_ext=b_gap_ext))
    if phase == "vec":
        return (vec.to(torch.int16),)
    return _pack_stats3(torch.zeros_like(gathered[2]) if vec is None
                        else vec, stats)


def sw_vec_full_tb_packed(codes_fwd: torch.Tensor, codes_rc: torch.Tensor,
                          args4: torch.Tensor, rtab_pk: torch.Tensor,
                          cat_words: Optional[torch.Tensor], *, G: int,
                          L: int, match: int, mismatch: int,
                          a_gap_open: int, a_gap_ext: int, b_gap_open: int,
                          b_gap_ext: int, local_alignment: bool = False,
                          phase: str = "fused"):
    """Fused filter 2 + speculative filter 3 with the traceback on the
    device, on packed input: (vec int16 [B], packed [B, 10] int32, ops
    [B, (R+G+3)//4] uint8), all on the device of `args4`. The [B, R, G]
    backpointers live only inside this call. The windows come as in
    `sw_vec_full_stats_packed`. `phase` "vec" returns (vec,) and
    launches only the vector SW; "full" returns (packed, ops) and
    launches only the full SW and the traceback."""
    _check_phase(phase)
    return _tb_kernels(
        _vec_full_gather_packed(codes_fwd, codes_rc, args4, rtab_pk, G, L,
                                cat_words), phase, local_alignment,
        dict(match=match, mismatch=mismatch, a_gap_open=a_gap_open,
             a_gap_ext=a_gap_ext, b_gap_open=b_gap_open,
             b_gap_ext=b_gap_ext))


def sw_vec_full_stats_from_index(codes_fwd: torch.Tensor,
                                 codes_rc: torch.Tensor, args: torch.Tensor,
                                 rtab: torch.Tensor, *, G: int, match: int,
                                 mismatch: int, a_gap_open: int,
                                 a_gap_ext: int, b_gap_open: int,
                                 b_gap_ext: int,
                                 local_alignment: bool = False,
                                 phase: str = "fused"):
    """The stats flow on unpacked IO: [B, 10] int32 args
    (`_vec_full_gather`) and the [n_reads, R] uint8 read table in,
    windows gathered byte by byte. Returns, as the reference does, (vec
    int16 [B], stats int16 [B, 8]) for phase "fused", (vec,) for "vec"
    and (stats,) for "full"."""
    _check_phase(phase)
    vec, stats = _stats_kernels(
        _vec_full_gather(codes_fwd, codes_rc, args, rtab, G), phase,
        local_alignment, dict(match=match, mismatch=mismatch,
                              a_gap_open=a_gap_open, a_gap_ext=a_gap_ext,
                              b_gap_open=b_gap_open, b_gap_ext=b_gap_ext))
    return tuple(x.to(torch.int16) for x in (vec, stats) if x is not None)


def sw_vec_full_tb_from_index(codes_fwd: torch.Tensor,
                              codes_rc: torch.Tensor, args: torch.Tensor,
                              rtab: torch.Tensor, *, G: int, match: int,
                              mismatch: int, a_gap_open: int,
                              a_gap_ext: int, b_gap_open: int,
                              b_gap_ext: int,
                              local_alignment: bool = False,
                              phase: str = "fused"):
    """The traceback flow on unpacked IO (args and read table as in
    `sw_vec_full_stats_from_index`): the outputs and phases of
    `sw_vec_full_tb_packed`."""
    _check_phase(phase)
    return _tb_kernels(
        _vec_full_gather(codes_fwd, codes_rc, args, rtab, G), phase,
        local_alignment, dict(match=match, mismatch=mismatch,
                              a_gap_open=a_gap_open, a_gap_ext=a_gap_ext,
                              b_gap_open=b_gap_open, b_gap_ext=b_gap_ext))
