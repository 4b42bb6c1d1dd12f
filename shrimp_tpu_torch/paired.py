"""The mapper state the paired stream reads.

Port of the parts of `shrimp_tpu/paired.py::PairedMapper` that the flat
paired fast path (`fastpath.FastPaired`) reads: the paired option set
(`_paired_opts`), the per-leg unpaired fallback option sets
(`_hp_opts`), the genome size of the paired MQV prior
(`total_genome_size`) and the mate-pair range algebra
(`_compute_mp_ranges`, mapping.c:2317-2430), copied unchanged. The
paired passes, MQVs and SAM text are the native `paired_finalize_render`
(`native/pairedpipe.cpp`); the generic object pipeline of the reference
is not ported.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from . import constants as C
from .config import MapperConfig
from .index.build import GenomeIndex
from .mapper import Mapper


class PairedMapper(Mapper):
    """PairedMapper(index, config, device="cuda"): a port `Mapper` for a
    paired config (`config.pair_mode` other than "none")."""

    def __init__(self, index: GenomeIndex,
                 config: Optional[MapperConfig] = None,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__(index, config, device)
        cfg = self.config
        if cfg.pair_mode == C.PAIR_NONE:
            raise ValueError("PairedMapper needs a paired config "
                             "(pair_mode other than 'none')")
        self._paired_opts = cfg.paired_options()
        # per-leg unpaired fallback option sets (gmapper.c:2607-2611)
        self._hp_opts = (cfg.half_paired_unpaired_options(0),
                         cfg.half_paired_unpaired_options(1))
        self.total_genome_size = int(index.contig_lengths.astype(
            np.int64).sum())

    def _compute_mp_ranges(self, re1, re2, popts=None) -> None:
        """readpair_compute_mp_ranges (mapping.c:2317-2430): the mate's
        window-offset and region deltas of both legs, set on `re1` and
        `re2` (objects with window_len and read_len)."""
        p = popts if popts is not None else self._paired_opts[0].pairing
        mode = p.pair_mode
        mn, mx = p.min_insert_size, p.max_insert_size
        w1, w2 = re1.window_len, re2.window_len
        l1, l2 = re1.read_len, re2.read_len
        if mode == C.PAIR_OPP_IN:
            d0mn = mn - w2
            d0mx = mx + (w1 - l1) - l2
            d1mn = -mx + l1 + (l2 - w2)
            d1mx = -mn + w1
        elif mode == C.PAIR_OPP_OUT:
            d0mn = mn - w2 + l1 + l2
            d0mx = mx + (w1 - l1) - l2 + l1 + l2
            d1mn = -mx + l1 + (l2 - w2) - l1 - l2
            d1mx = -mn + w1 - l1 - l2
        elif mode == C.PAIR_COL_FW:
            d0mn = mn - w2 + l2
            d0mx = mx + (w1 - l1) - l2 + l2
            d1mn = -mx + l1 + (l2 - w2) - l2
            d1mx = -mn + w1 - l2
        elif mode == C.PAIR_COL_BW:
            d0mn = mn - w2 + l1
            d0mx = mx + (w1 - l1) - l2 + l1
            d1mn = -mx + l1 + (l2 - w2) - l1
            d1mx = -mn + w1 - l1
        else:
            raise ValueError(mode)
        re1.delta_g_off_min = (d0mn, d1mn)
        re1.delta_g_off_max = (d0mx, d1mx)
        if mode in (C.PAIR_OPP_IN, C.PAIR_OPP_OUT):
            re2.delta_g_off_min = (-d1mx, -d0mx)
            re2.delta_g_off_max = (-d1mn, -d0mn)
        else:
            re2.delta_g_off_min = (-d0mx, -d1mx)
            re2.delta_g_off_max = (-d0mn, -d1mn)
        # region deltas for the mate-pair region filter
        # (mapping.c:2424-2436; C truncating division)
        R = 1 << self.config.region_bits

        def _rmin(dg):
            return dg // R if dg >= 0 else -1 - ((-dg - 1) // R)

        def _rmax(dg):
            return 1 + (dg - 1) // R if dg > 0 else -((-dg) // R)

        for re in (re1, re2):
            re.delta_region_min = (_rmin(re.delta_g_off_min[0]),
                                   _rmin(re.delta_g_off_min[1]))
            re.delta_region_max = (_rmax(re.delta_g_off_max[0]),
                                   _rmax(re.delta_g_off_max[1]))
