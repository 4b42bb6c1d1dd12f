"""Vector Smith-Waterman (filter 2): the plain PyTorch version and the
wrapper of the CUDA kernel `csrc/sw_vector.cu`.

Port of the Pallas kernel `shrimp_tpu/core/sw_pallas.py::
sw_vector_batch_pallas`, whose scores equal the XLA formulation
`sw_jax.sw_vector_batch`: score-only local affine SW per (window, read)
pair, gap open charged as open + extend, H clamped at 0, cells with
i >= rlen or j >= glen contribute 0. In colour-space mode (`cs_mode`)
read row 0 is scored against `g_row0` = COLOUR_MAT[genome letter,
initbp] and every other row against the colour window.

`sw_vector_batch` takes the plain version for CPU tensors only; for
CUDA tensors it launches the kernel or raises. `sw_vector_ls_from_index`
and `sw_vector_cs_from_index` (the generic mapper's launches) gather
their windows from the mapper's device-resident genome planes first.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional

import torch

from .. import _build
from .. import constants as C
from ._args import MAX_G_LONG, check_cuda_shape, check_tensor

NEG = -(2 ** 30)
FILL = -(2 ** 28)

# launches of the CUDA kernel in letter-space and in colour-space mode
# (the plain version is not counted)
LAUNCHES = _build.LaunchCount()
CS_LAUNCHES = _build.LaunchCount()


def _costs(a_gap_open, a_gap_ext, b_gap_open, b_gap_ext):
    """Positive penalties: (open + extend, extend) per gap direction."""
    return (-a_gap_open - a_gap_ext, -a_gap_ext,
            -b_gap_open - b_gap_ext, -b_gap_ext)


def _row0(g_row0, cs_mode: bool):
    if cs_mode and g_row0 is None:
        raise ValueError("cs_mode needs g_row0")
    return g_row0 if cs_mode else None


def sw_vector_batch_ref(genome: torch.Tensor, glen: torch.Tensor,
                        read: torch.Tensor, rlen: torch.Tensor,
                        g_row0: Optional[torch.Tensor] = None, *,
                        match: int, mismatch: int, a_gap_open: int,
                        a_gap_ext: int, b_gap_open: int, b_gap_ext: int,
                        cs_mode: bool = False) -> torch.Tensor:
    """Plain int32 version, on any device: genome [B, G] uint8, glen [B],
    read [B, R] uint8, rlen [B] (and g_row0 [B, G] uint8 in colour-space
    mode) -> [B] int32 best local scores. A row loop over i; the E-gap
    chain along j is a cummax of h0[k] + k*ext (h0 is the row value
    without E, which is exact because a gap re-opened from an E cell
    never beats extending it)."""
    g0 = _row0(g_row0, cs_mode)
    goa, gea, gob, geb = _costs(a_gap_open, a_gap_ext, b_gap_open,
                                b_gap_ext)
    B, G = genome.shape
    R = read.shape[1]
    dev = genome.device
    g = genome.to(torch.int32)
    g0 = g if g0 is None else g0.to(torch.int32)
    r = read.to(torch.int32)
    glen = glen.to(torch.int32)
    rlen = rlen.to(torch.int32)
    jidx = torch.arange(G, dtype=torch.int32, device=dev)
    jvalid = jidx[None, :] < glen[:, None]
    jg = jidx * gea
    h = torch.zeros((B, G + 1), dtype=torch.int32, device=dev)
    f = torch.full((B, G), NEG, dtype=torch.int32, device=dev)
    best = torch.zeros(B, dtype=torch.int32, device=dev)
    fill = torch.full((B, 1), FILL, dtype=torch.int32, device=dev)
    m, mm = (torch.tensor(v, dtype=torch.int32, device=dev)
             for v in (match, mismatch))
    for i in range(R):
        valid = (rlen > i)[:, None] & jvalid
        s = torch.where((g0 if i == 0 else g) == r[:, i:i + 1], m, mm)
        f = torch.maximum(h[:, 1:] - gob, f - geb)
        h0 = torch.maximum((h[:, :-1] + s).clamp(min=0), f)
        h0 = torch.where(valid, h0, 0)
        f = torch.where(valid, f, NEG)
        # max over k <= j of h0[k] + k*ext (h0 >= 0, so the FILL floor
        # of the reference's shifted cummax never wins)
        c = torch.cummax(h0 + jg, dim=1).values
        e = torch.cat([fill, c[:, :-1]], dim=1) - (goa - gea) - jg
        hn = torch.maximum(h0, torch.where(valid, e, NEG))
        best = torch.maximum(best, hn.max(dim=1).values)
        h = torch.cat([h[:, :1], hn], dim=1)
    return best


def _launch(genome, glen, read, rlen, g_row0, *, match, mismatch,
            a_gap_open, a_gap_ext, b_gap_open, b_gap_ext) -> torch.Tensor:
    check_cuda_shape(genome, "sw_vector_batch", MAX_G_LONG)
    B, G = genome.shape
    R = read.shape[1]
    dev = genome.device
    check_tensor("genome", genome, torch.uint8, (B, G), dev)
    if g_row0 is not None:
        check_tensor("g_row0", g_row0, torch.uint8, (B, G), dev)
    check_tensor("glen", glen, torch.int32, (B,), dev)
    check_tensor("read", read, torch.uint8, (B, R), dev)
    check_tensor("rlen", rlen, torch.int32, (B,), dev)
    lib = _build.load().lib
    out = torch.empty(B, dtype=torch.int32, device=dev)
    goa, gea, gob, geb = _costs(a_gap_open, a_gap_ext, b_gap_open,
                                b_gap_ext)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sw_vector_launch(
            genome.data_ptr(),
            None if g_row0 is None else g_row0.data_ptr(), glen.data_ptr(),
            read.data_ptr(), rlen.data_ptr(), out.data_ptr(), B, G, R,
            match, mismatch, goa, gea, gob, geb, stream)
    _build.check(rc, "sw_vector_launch")
    (LAUNCHES if g_row0 is None else CS_LAUNCHES).add()
    return out


def sw_vector_batch(genome: torch.Tensor, glen: torch.Tensor,
                    read: torch.Tensor, rlen: torch.Tensor,
                    g_row0: Optional[torch.Tensor] = None, *, match: int,
                    mismatch: int, a_gap_open: int, a_gap_ext: int,
                    b_gap_open: int, b_gap_ext: int,
                    cs_mode: bool = False) -> torch.Tensor:
    """[B] int32 vector-SW scores. CPU tensors take the plain version;
    CUDA tensors launch the kernel (uint8 windows, g_row0 and reads,
    int32 lengths, contiguous, G <= 4095) or raise."""
    kw = dict(match=match, mismatch=mismatch, a_gap_open=a_gap_open,
              a_gap_ext=a_gap_ext, b_gap_open=b_gap_open,
              b_gap_ext=b_gap_ext)
    if genome.device.type == "cpu":
        return sw_vector_batch_ref(genome, glen, read, rlen, g_row0,
                                   cs_mode=cs_mode, **kw)
    return _launch(genome, glen, read, rlen, _row0(g_row0, cs_mode), **kw)


@lru_cache(maxsize=None)
def _colour_lut(dev: torch.device) -> torch.Tensor:
    """lstocs as a flat [256] uint8 table on `dev` (COLOUR_MAT[a, b] at
    a * 16 + b)."""
    return torch.from_numpy(C.COLOUR_MAT.reshape(-1).copy()).to(dev)


def _plane_positions(gstart: torch.Tensor, G: int, n: int) -> torch.Tensor:
    """[B, G] positions gstart + j, clipped to a plane of n bytes (windows
    past the genome end clip to its last byte; glen masks them)."""
    j = torch.arange(G, dtype=torch.int64, device=gstart.device)
    return (gstart.to(torch.int64)[:, None] + j[None, :]).clamp(0, n - 1)


def sw_vector_ls_from_index(codes: torch.Tensor, gstart: torch.Tensor,
                            glen: torch.Tensor, rtab: torch.Tensor,
                            owner: torch.Tensor, rlen: torch.Tensor, *,
                            G: int, match: int, mismatch: int,
                            a_gap_open: int, a_gap_ext: int,
                            b_gap_open: int,
                            b_gap_ext: int) -> torch.Tensor:
    """Letter-space vector SW against the device-resident genome plane:
    twin of `shrimp_tpu/core/sw_pallas.py::sw_vector_ls_from_index`.
    `codes` is the padded forward plane, `gstart` [B] the absolute window
    starts, `rtab` [n, R] uint8 the batch's read rows and `owner` [B] each
    window's row in it (clipped to the table). Returns [B] int32."""
    gwin = codes[_plane_positions(gstart, G, codes.shape[0])]
    rwin = rtab[owner.to(torch.int64).clamp(0, rtab.shape[0] - 1)]
    return sw_vector_batch(gwin, glen, rwin, rlen, match=match,
                           mismatch=mismatch, a_gap_open=a_gap_open,
                           a_gap_ext=a_gap_ext, b_gap_open=b_gap_open,
                           b_gap_ext=b_gap_ext)


def sw_vector_cs_from_index(cs_codes: torch.Tensor, cs_codes_rc: torch.Tensor,
                            ls_codes: torch.Tensor, ls_codes_rc: torch.Tensor,
                            gstart: torch.Tensor, glen: torch.Tensor,
                            eff_rc: torch.Tensor, rtab: torch.Tensor,
                            owner: torch.Tensor, rlen: torch.Tensor,
                            initbp: torch.Tensor, *, G: int, match: int,
                            mismatch: int, a_gap_open: int, a_gap_ext: int,
                            b_gap_open: int,
                            b_gap_ext: int) -> torch.Tensor:
    """Colour-space vector SW against the device-resident planes: twin of
    `shrimp_tpu/core/sw_pallas.py::sw_vector_cs_from_index`. `gstart` is
    strand-normalized on the host (reverse_hit, mapping.c:254-263);
    `eff_rc` picks the rc planes; the colour window is scored against the
    colour read, row 0 against g_row0 = COLOUR_MAT[genome letter,
    initbp] (sw-vector.c:108-146). Returns [B] int32."""
    pos = _plane_positions(gstart, G, cs_codes.shape[0])
    rc = (eff_rc != 0)[:, None]
    gwin = torch.where(rc, cs_codes_rc[pos], cs_codes[pos])
    lswin = torch.where(rc, ls_codes_rc[pos], ls_codes[pos])
    g_row0 = _colour_lut(lswin.device)[
        (lswin.to(torch.int32) * 16
         + initbp.to(torch.int32)[:, None]).clamp(0, 255)]
    rwin = rtab[owner.to(torch.int64).clamp(0, rtab.shape[0] - 1)]
    return sw_vector_batch(gwin, glen, rwin, rlen, g_row0, cs_mode=True,
                           match=match, mismatch=mismatch,
                           a_gap_open=a_gap_open, a_gap_ext=a_gap_ext,
                           b_gap_open=b_gap_open, b_gap_ext=b_gap_ext)
