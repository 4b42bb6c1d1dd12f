"""Hugepage-backed numpy arrays for the index hot tables.

Copied from `shrimp_tpu/utils/hostmem.py`: `to_hugepages`, which
`index/build.py` calls on the CSR tables and genome planes. Their
random per-kmer access makes every filter 1 lookup a dTLB miss on 4 KB
pages; on 2 MB pages (MADV_HUGEPAGE, `native/hostmem.cpp`) the whole
table needs a few hundred TLB entries. Buffers are kept alive by a
module registry for the life of the process, as the index is.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Tuple

import numpy as np

_REGISTRY: Dict[int, Tuple[int, int]] = {}   # base ptr -> (ptr, nbytes)
_LOCK = threading.Lock()


def to_hugepages(arr: np.ndarray) -> np.ndarray:
    """Copy `arr` into a hugepage-backed buffer; returns the copy (or
    `arr` unchanged when the array is under 2 MB or the mapping
    fails)."""
    from ..native import get_lib
    nbytes = int(arr.nbytes)
    if nbytes < (1 << 21):
        return arr
    ptr = get_lib().hp_alloc(nbytes)
    if not ptr:
        return arr
    buf = (ctypes.c_char * nbytes).from_address(ptr)
    out = np.frombuffer(buf, dtype=arr.dtype).reshape(arr.shape)
    out[...] = arr
    out.flags.writeable = False
    with _LOCK:
        _REGISTRY[ptr] = (ptr, nbytes)
    return out
