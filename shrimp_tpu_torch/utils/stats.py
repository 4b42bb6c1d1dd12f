"""Run statistics: the print_statistics analogue (gmapper.c:693-1006).

Same headline metrics: per-kernel invocations / cells / cells-per-second,
per-stage wall clock, reads per hour.

Copied from `shrimp_tpu/utils/stats.py`, with named counters beside the
stage seconds (`counts`, `add_count`; the port's filter 1 counts its
owners there), which the detailed report prints.
"""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Dict, TextIO


@dataclass
class MapperStats:
    reads: int = 0
    reads_mapped: int = 0
    alignments: int = 0
    vec_invocs: int = 0
    vec_cells: int = 0
    vec_secs: float = 0.0
    full_invocs: int = 0
    full_cells: int = 0
    full_secs: float = 0.0
    full_host_tb: int = 0   # stats-flow jobs re-run by the host DP
    post_invocs: int = 0
    stage_secs: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)
    started: float = field(default_factory=time.time)

    def add_stage(self, name: str, secs: float) -> None:
        self.stage_secs[name] = self.stage_secs.get(name, 0.0) + secs

    def add_count(self, name: str, n: int) -> None:
        self.counts[name] = self.counts.get(name, 0) + n

    def report(self, out: TextIO = sys.stderr, detailed: bool = False
               ) -> None:
        """detailed=True adds the per-stage table (-D, gmapper.c:693-1006
        thread/stage breakdown)."""
        wall = time.time() - self.started
        p = lambda *a: print(*a, file=out)
        p("Statistics:")
        p("    Overall:")
        p(f"        Reads Handled:          {self.reads:,}")
        p(f"        Reads Matched:          {self.reads_mapped:,}")
        p(f"        Total Alignments:       {self.alignments:,}")
        p(f"        Mapping Wall Clock:     {wall:.2f} seconds")
        if wall > 0:
            p(f"        Reads per hour:         "
              f"{self.reads / wall * 3600:,.0f}")
            p(f"        Reads per second:       {self.reads / wall:,.0f}")
        p("")
        p("    Vector Smith-Waterman (filter 2):")
        p(f"        Invocations:            {self.vec_invocs:,}")
        p(f"        Cells Computed:         {self.vec_cells / 1e6:.2f} "
          "million")
        if self.vec_secs > 0:
            p(f"        Cells per Second:       "
              f"{self.vec_cells / self.vec_secs / 1e6:.2f} million")
        p("")
        p("    Full Smith-Waterman (filter 3):")
        p(f"        Invocations:            {self.full_invocs:,}")
        p(f"        Cells Computed:         {self.full_cells / 1e6:.2f} "
          "million")
        if self.full_secs > 0:
            p(f"        Cells per Second:       "
              f"{self.full_cells / self.full_secs / 1e6:.2f} million")
        if detailed and self.stage_secs:
            p("")
            p("    Per-stage wall clock:")
            for name, secs in sorted(self.stage_secs.items()):
                p(f"        {name + ':':<24}{secs:.2f} seconds")
        if detailed and self.counts:
            p("")
            p("    Counters:")
            for name, n in sorted(self.counts.items()):
                p(f"        {name + ':':<24}{n:,}")
