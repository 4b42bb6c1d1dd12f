"""The mapper state the fast path reads, with its genome planes resident
on a torch device.

Port of the device-bound parts of `shrimp_tpu/mapper.py::Mapper`: the
fields the fast path reads (config, index, cutoff, calibration, the
unpaired option set, run statistics) and the device-resident genome
planes (`_pad_plane`, `_dev_codes`, `_dev_codes_rc`, `_dev_cat_words`,
and for a colour-space config `_dev_cs_planes`, `_dev_cs_cat_words`).
The planes are built once, when the Mapper is made, from the numpy
arrays of the port's own `index.build.GenomeIndex` (a copy of the
reference's), with the reference's padding and word layout, so both
packages compute on identical bytes.
"""
from __future__ import annotations

import threading
from typing import Optional, Union

import numpy as np
import torch

from . import constants as C
from .config import MapperConfig
from .core.sw import cat_word_plane
from .device import get_device
from .index.build import GenomeIndex
from .utils.stats import MapperStats

# window rows per fused launch, and the launch row buckets
FULL_BATCH = 8192
FULL_BUCKETS = (2048, 4096, 8192, 16384, 32768)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pow2_bucket(n: int, lo: int = 256) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class Mapper:
    """Mapper(index, config, device="cuda"): `index` is the port's
    GenomeIndex; `device` is a torch.device or a name ("cuda", "cuda:0",
    "cpu"). The mapper runs on the card unless the caller asks for the
    CPU, and CUDA is never swapped for the CPU."""

    def __init__(self, index: GenomeIndex,
                 config: Optional[MapperConfig] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.index = index
        self.config = config or MapperConfig()
        cfg = self.config
        self.cutoff = (cfg.list_cutoff if cfg.list_cutoff is not None
                       else index.auto_list_cutoff())
        self.cal = cfg.calibration
        self._unpaired_opts = cfg.unpaired_options()
        self.stats = MapperStats()
        self._stats_lock = threading.Lock()
        self.device = get_device(device)
        fp = self._pad_plane(index.codes)
        rp = self._pad_plane(index.codes_rc)
        self._codes_dev = self._upload(fp)
        self._codes_rc_dev = self._upload(rp)
        cat = cat_word_plane(fp, rp)
        self._cat_words_dev = None if cat is None else self._upload(cat)
        self._cs_planes_dev = self._cs_cat_words_dev = None
        if cfg.mode == C.MODE_COLOUR_SPACE:
            cfp = self._pad_plane(index.cs_codes)
            crp = self._pad_plane(index.cs_codes_rc)
            self._cs_planes_dev = (self._upload(cfp), self._upload(crp),
                                   self._codes_dev, self._codes_rc_dev)
            ccat = cat_word_plane(cfp, crp)
            # the letter cat plane is _cat_words_dev: the same bytes
            if ccat is not None and cat is not None:
                self._cs_cat_words_dev = (self._upload(ccat),
                                          self._cat_words_dev)

    def tally(self, stage: Optional[str] = None, secs: float = 0.0,
              **counts) -> None:
        """Add `counts` to the named MapperStats fields and `secs` to a
        stage. The lanes pipeline's threads share one Mapper, so every
        update takes the lock (a bare `+=` loses updates)."""
        with self._stats_lock:
            for name, v in counts.items():
                setattr(self.stats, name, getattr(self.stats, name) + v)
            if stage is not None:
                self.stats.add_stage(stage, secs)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @staticmethod
    def _pad_plane(a: np.ndarray) -> np.ndarray:
        """Pad a genome plane to a bucketed length: power of two up to
        256M, then multiples of 16M (pow2 padding of a 750M plane would
        push the concatenated word plane past int32 offsets). Pad cells
        are the 254 sentinel, which never matches; filter 1 clips
        windows at the contig end, so the pad is unreachable data."""
        if len(a) <= (1 << 28):
            n = _pow2_bucket(len(a), lo=1 << 22)
        else:
            n = -(-len(a) // (1 << 24)) * (1 << 24)
        if n == len(a):
            return a
        out = np.full(n, 254, np.uint8)
        out[:len(a)] = a
        return out

    def _dev_codes(self) -> torch.Tensor:
        """Padded forward genome plane on the device."""
        return self._codes_dev

    def _dev_codes_rc(self) -> torch.Tensor:
        """Padded reverse-complement genome plane on the device."""
        return self._codes_rc_dev

    def _dev_cat_words(self) -> Optional[torch.Tensor]:
        """The concatenated word plane (core.sw.cat_word_plane) on the
        device, or None when its offsets would overflow int32."""
        return self._cat_words_dev

    def _dev_cs_planes(self):
        """(colour, colour rc, letter, letter rc) padded planes on the
        device for a colour-space config, else None."""
        return self._cs_planes_dev

    def _dev_cs_cat_words(self):
        """(colour cat words, letter cat words) on the device for a
        colour-space config, or None (letter-space config, or offsets
        that would overflow int32)."""
        return self._cs_cat_words_dev
