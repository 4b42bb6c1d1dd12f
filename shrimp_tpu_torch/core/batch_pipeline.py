"""The flat candidate-window record that filter 1 returns.

Copied from `shrimp_tpu/core/batch_pipeline.py`: `FlatHits` and
`_empty_flat`, the parts the native filter 1 wrapper
(`native/filter1_py.py`) needs. The numpy filter 1 of that module is
not copied: the port runs the native one only.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class FlatHits:
    """Candidate windows for a read batch, owner-segment ordered.

    owner = read_index * 2 + strand; hits within an owner are sorted by
    (cn, g_off) exactly like the per-read hit lists.
    """
    owner: np.ndarray            # int64 [H]
    cn: np.ndarray               # int32 [H]
    g_off: np.ndarray            # int64 [H] contig-local window start
    w_len: np.ndarray            # int32 [H]
    score_window_gen: np.ndarray  # int64 [H]
    matches: np.ndarray          # int32 [H]
    score_max: np.ndarray        # int64 [H]
    ax: np.ndarray               # int64 [H] anchor rect relative to g_off
    ay: np.ndarray
    alen: np.ndarray
    awid: np.ndarray
    seg_start: np.ndarray        # int64 [n_reads*2 + 1] owner segment bounds

    @property
    def n(self) -> int:
        return len(self.owner)


def _empty_flat(n_owners: int) -> FlatHits:
    z64 = np.zeros(0, np.int64)
    z32 = np.zeros(0, np.int32)
    return FlatHits(z64, z32, z64, z32, z64, z32, z64, z64, z64, z64, z64,
                    np.zeros(n_owners + 1, np.int64))
