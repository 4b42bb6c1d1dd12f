"""Hugepage-backed numpy arrays for the index hot tables.

Copied from `shrimp_tpu/utils/hostmem.py`: `to_hugepages`, which
`index/build.py` calls on the CSR tables and genome planes. Their
random per-kmer access makes every filter 1 lookup a dTLB miss on 4 KB
pages; on 2 MB pages (MADV_HUGEPAGE, `native/hostmem.cpp`) the whole
table needs a few hundred TLB entries. Buffers are kept alive by a
module registry keyed by the buffer's address; `release(arr)` unmaps one
early (`GenomeIndex.release`, `GenomeIndex.trim`), otherwise they live
for the process, as the index does.
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


def release(arr: np.ndarray) -> bool:
    """Unmap the hugepage buffer behind a `to_hugepages` result (the
    array it returned, not a view of it); False for any other array.
    Nothing may touch `arr` afterwards."""
    from ..native import get_lib
    ptr = int(arr.__array_interface__["data"][0])
    with _LOCK:
        ent = _REGISTRY.pop(ptr, None)
    if ent is None:
        return False
    get_lib().hp_free(ctypes.c_void_p(ent[0]), ent[1])
    return True
