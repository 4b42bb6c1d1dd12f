"""The work of one kernel launch, counted from the real windows it was
given: DP cells times the stage's operations per cell (`peaks`), and the
bytes of the stage's inputs read once and outputs written once. Works on
the launch's own tensors, on their device, with no sync: it returns an
int64 tensor [ops, bytes]."""
from __future__ import annotations

import torch

from mapbench.peaks import OPS_PER_CELL


def band_cells(glen, rlen, ax, ay, alen, awid, R: int) -> torch.Tensor:
    """In-band DP cells per pair over its rows i < rlen, with the band of
    anchor_get_x_range (SHRiMP2 common/anchors.c:66-95) clipped to
    [0, glen - 1]."""
    i = torch.arange(R, device=glen.device, dtype=torch.int64)[None, :]
    gl, rl = glen.long()[:, None], rlen.long()[:, None]
    ax, ay = ax.long()[:, None], ay.long()[:, None]
    alen, awid = alen.long()[:, None], awid.long()[:, None]
    top = gl - 1
    x_min = torch.where(i < ay, torch.zeros_like(i),
                        torch.where(i <= ay + alen - 1, ax + (i - ay),
                                    ax + alen))
    x_min = torch.minimum(torch.clamp(x_min, min=0), top)
    y0 = ay - (awid - 1)
    x_max = torch.where(i < y0, ax + (awid - 1) - 1,
                        torch.where(i <= y0 + alen - 1,
                                    ax + (awid - 1) + (i - y0), top))
    x_max = torch.minimum(torch.clamp(x_max, min=0), top)
    live = (i < rl) & (gl > 0)
    return torch.where(live, torch.clamp(x_max - x_min + 1, min=0),
                       0).sum(1)


def launch_work(kind: str, args) -> torch.Tensor:
    ops = OPS_PER_CELL[kind]
    if kind == "vector":
        genome, glen, read, rlen = args[:4]
        g, r = glen.long().clamp(min=0), rlen.long().clamp(min=0)
        cells = (g * r).sum()
        extra = g.sum() if args[4] is not None else 0   # CS letter row
        nbytes = (g + r).sum() + extra + 4 * genome.shape[0]
        return torch.stack([ops * cells, nbytes])
    if kind in ("ls_stats", "ls_bp"):
        genome, glen, read, rlen, ax, ay, alen, awid, _ = args[:9]
        cells = band_cells(glen, rlen, ax, ay, alen, awid,
                           read.shape[1]).sum()
        g, r = glen.long().clamp(min=0), rlen.long().clamp(min=0)
        out = 32 if kind == "ls_stats" else 16
        nbytes = (g + r).sum() + (20 + out) * genome.shape[0]
        return torch.stack([ops * cells, nbytes])
    if kind == "cs_dp":
        genome, glen, qr, rlen, ax, ay, alen, awid = args[:8]
        R = qr.shape[2]
        cells = band_cells(glen, rlen, ax, ay, alen, awid, R).sum()
        g, r = glen.long().clamp(min=0), rlen.long().clamp(min=0)
        nbytes = (g + 8 * r).sum() + (36 + 20) * genome.shape[0]
        return torch.stack([ops * cells, nbytes])
    # tracebacks: the packed result and the walk written out
    if kind == "ls_tb":
        genome, read = args[:2]
        B, G = genome.shape
        R = read.shape[1]
        nbytes = B * (40 + (R + G + 3) // 4)
    else:
        genome, qr = args[:2]
        B, G = genome.shape
        R = qr.shape[2]
        nbytes = B * (24 + R + G)
    return torch.tensor([0, nbytes], dtype=torch.int64,
                        device=genome.device)
