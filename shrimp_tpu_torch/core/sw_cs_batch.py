"""Colour-space read layers: the four letter translations of a colour
read.

Copied from `shrimp_tpu/core/sw_cs_batch.py`: `cs_layers_batch` only,
the host step the colour-space fast path runs in read prep. The batched
numpy DP of that module is not copied: the port's DP is
`core/sw_cs_full.py`.
"""
from __future__ import annotations

import numpy as np

from .. import constants as C


def cs_layers_batch(colours: np.ndarray, initbp: np.ndarray) -> np.ndarray:
    """[B, R] colour codes -> [B, 4, R] letter translations
    (sw-full-cs.c:1181-1195)."""
    B, R = colours.shape
    qr = np.zeros((B, 4, R), np.uint8)
    start = ((np.arange(4)[None, :] + initbp[:, None]) % 4).astype(np.int64)
    letter = start.copy()
    for j in range(R):
        col = colours[:, j].astype(np.int64)[:, None]
        isn = col == C.BASE_N
        even = letter % 2 == 0
        nxt = np.where(even, (4 + letter + col) % 4, (4 + letter - col) % 4)
        qr[:, :, j] = np.where(isn, C.BASE_N, nxt)
        letter = np.where(isn, start, nxt)
    return qr
