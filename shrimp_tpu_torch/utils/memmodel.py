"""Memory accounting and RAM planning (the my-alloc analogue).

SHRiMP2 wraps every allocation in my_malloc/my_free with a global cap
and warn thresholds (common/my-alloc.h:26-58: MYALLOC_WARN_MAX at
`max_mem`, a per-allocation alert at `alert_mem`, per-category
`count_t` counters) initialised to 64 GB at startup
(gmapper/gmapper.c:1740).  Its README documents the RAM model that
makes hg18-scale runs plannable (README:128-150) and split-db sizes
chunks with the same model.

Here the analogue is a process-wide byte tracker: the index builder and
the host pipeline register their large numpy arrays against a
configurable cap, a predicted-footprint pre-check fails *before* an
over-budget build starts allocating, and `plan_index_ram` is the single
RAM model shared with `split-db --ram-size` (tools/split.py imports it
from here).

Copied from `shrimp_tpu/utils/memmodel.py` unchanged: the port keeps its own
copy of the JAX package's host modules and imports none of them.
"""
from __future__ import annotations

import sys
import threading
from typing import Dict, Optional

_GB = 1 << 30

DEFAULT_MAX_MEM = 64 * _GB      # my_alloc_init(64GB, 64GB), gmapper.c:1740
DEFAULT_ALERT_MEM = 64 * _GB


def plan_index_ram(genome_len: int, n_seeds: int, weight: int,
                   colour_space: bool = False) -> int:
    """RAM model for a genome index (README:128-150): the reference
    documents L*K*4 bytes of postings + the per-seed key table +
    ~50MB fixed overhead; colour space roughly doubles the genome
    planes (forward + revcomp + CS projections of both).

    This is the ONE model used by both the memory cap pre-check
    (`MemTracker.precheck_index`) and `split-db --ram-size`.
    """
    planes = 4 if colour_space else 2          # codes, codes_rc (+ CS pair)
    return (genome_len * n_seeds * 4           # postings (uint32)
            + genome_len * planes              # packed genome planes (uint8)
            + n_seeds * (4 ** min(weight, 12)) * 12   # CSR offsets/key table
            + 50_000_000)                      # fixed overhead


class MemCapError(MemoryError):
    """Raised in strict mode when an allocation would exceed the cap
    (MYALLOC_ERR_MAX analogue, my-alloc.h:30)."""


class MemTracker:
    """Process-wide byte counter with cap + alert thresholds.

    Mirrors my-alloc's behaviour: crossing `max_mem` warns once
    (MYALLOC_WARN_MAX) or raises (`strict`, MYALLOC_ERR_MAX); any
    single allocation above `alert_mem` prints an alert
    (MYALLOC_ENABLE_ALERT, my-alloc.h:115-127).  Per-category counters
    match the reference's count_t stats (mem_genomemap, mem_mapping...).
    """

    def __init__(self, max_mem: int = DEFAULT_MAX_MEM,
                 alert_mem: int = DEFAULT_ALERT_MEM,
                 strict: bool = False):
        self.max_mem = int(max_mem)
        self.alert_mem = int(alert_mem)
        self.strict = strict
        self.crt_mem = 0
        self.peak_mem = 0
        # separate once-flags: a predicted-footprint warning must not
        # suppress a later actual over-cap warning (or vice versa)
        self.warned_actual = False
        self.warned_predicted = False
        self.by_category: Dict[str, int] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------ core
    def add(self, nbytes: int, category: str = "misc",
            name: str = "") -> None:
        nbytes = int(nbytes)
        if nbytes > self.alert_mem:
            print(f"my_malloc alert: size={nbytes}: {category} {name}",
                  file=sys.stderr)
        with self._lock:
            over = self.crt_mem + nbytes > self.max_mem
            if over and self.strict:
                raise MemCapError(
                    f"memory cap exceeded: in-use {self.crt_mem} + "
                    f"{nbytes} ({category} {name}) > cap {self.max_mem}")
            if over and not self.warned_actual:
                self.warned_actual = True
                print("my_malloc warning: exceeding maximum memory: "
                      f"{category} {name}", file=sys.stderr)
            self.crt_mem += nbytes
            self.peak_mem = max(self.peak_mem, self.crt_mem)
            self.by_category[category] = \
                self.by_category.get(category, 0) + nbytes

    def sub(self, nbytes: int, category: str = "misc") -> None:
        with self._lock:
            self.crt_mem -= int(nbytes)
            self.by_category[category] = \
                self.by_category.get(category, 0) - int(nbytes)

    def track(self, arr, category: str = "misc", name: str = "") -> None:
        """Register a numpy array's footprint (mmap-backed arrays are
        OS-paged, not heap — counted as 0 like the reference's
        block-allocated load path, genome.c:1201 'block-allocated')."""
        import numpy as np
        if isinstance(arr, np.memmap):
            return
        self.add(getattr(arr, "nbytes", 0), category, name)

    def untrack(self, arr, category: str = "misc") -> None:
        """my_free analogue for track(): release an array's accounted
        bytes when its owner is dropped (e.g. per-chunk index builds,
        tools/split.py project-db loop)."""
        import numpy as np
        if isinstance(arr, np.memmap):
            return
        self.sub(getattr(arr, "nbytes", 0), category)

    # ----------------------------------------------------- planning
    def precheck_index(self, genome_len: int, n_seeds: int, weight: int,
                       colour_space: bool = False) -> int:
        """Fail BEFORE an over-budget index build allocates: predicted
        footprint from the shared RAM model vs the remaining budget.
        Returns the prediction. Under the cap → no-op; over → warn, or
        MemCapError in strict mode with split-db advice (README:128-150:
        'use split-db to break the genome into RAM-sized chunks')."""
        need = plan_index_ram(genome_len, n_seeds, weight, colour_space)
        with self._lock:
            room = self.max_mem - self.crt_mem
            over = need > room
            warn = over and not self.warned_predicted
            if warn:
                self.warned_predicted = True
        if over:
            msg = (f"predicted index footprint {need / _GB:.1f}GB exceeds "
                   f"the memory cap ({room / _GB:.1f}GB free of "
                   f"{self.max_mem / _GB:.1f}GB); split the genome with "
                   f"`shrimp_tpu split-db --ram-size "
                   f"{max(1, int(room / _GB))}`")
            if self.strict:
                raise MemCapError(msg)
            if warn:
                print("my_malloc warning: " + msg, file=sys.stderr)
        return need

    def report(self, out=None) -> None:
        """print_mem_stats analogue (-D dump): per-category counters."""
        out = out or sys.stderr
        print(f"memory: in-use {self.crt_mem / _GB:.3f}GB  "
              f"peak {self.peak_mem / _GB:.3f}GB  "
              f"cap {self.max_mem / _GB:.1f}GB", file=out)
        for cat in sorted(self.by_category):
            print(f"  {cat:<16} {self.by_category[cat] / _GB:.3f}GB",
                  file=out)


_tracker: Optional[MemTracker] = None
_tracker_lock = threading.Lock()


def init(max_mem: int = DEFAULT_MAX_MEM,
         alert_mem: Optional[int] = None,
         strict: bool = False) -> MemTracker:
    """my_alloc_init analogue; called by the CLI with --max-mem."""
    global _tracker
    with _tracker_lock:
        _tracker = MemTracker(max_mem, alert_mem if alert_mem is not None
                              else max_mem, strict)
        return _tracker


def tracker() -> MemTracker:
    global _tracker
    with _tracker_lock:
        if _tracker is None:
            _tracker = MemTracker()
        return _tracker
