"""The port's native host library: filter 1, pass-1 selection, the
renderers (unpaired, paired, colour space) and the index build's sort,
in C++ through ctypes.

Copied from `shrimp_tpu/native/__init__.py`, with its C++ sources beside
it (byte for byte). The library is built at first use with g++ and the reference's flags
into `build/shrimp_tpu_torch/` beside the package (next to the CUDA
kernels of `_build.py`), keyed by a hash of the sources and the flags,
so an unchanged tree reuses it. A failed build raises: the port has no
numpy host path behind it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

from .._build import BUILD_DIR

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

SRC_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("filter1.cpp", "hostpipe.cpp", "pairedpipe.cpp", "cspost.cpp",
           "cspipe.cpp", "csrsort.cpp", "hostmem.cpp")
HEADERS = ("cs_eval.h",)
# -ffp-contract=off: no FMA contraction, so double arithmetic rounds
# exactly like Python/numpy (the MQV math compares posterior ratios
# against 1.0 at ulp precision)
CXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-shared",
             "-fPIC", "-std=c++17")


def lib_path() -> str:
    """Where the library of the current sources and flags lives."""
    h = hashlib.sha256(" ".join(("g++",) + CXX_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(SRC_DIR, name), "rb") as f:
            h.update(name.encode() + f.read())
    return os.path.join(BUILD_DIR, f"native_{h.hexdigest()[:16]}.so")


def _build() -> str:
    so = lib_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    cmd = (["g++", *CXX_FLAGS]
           + [os.path.join(SRC_DIR, s) for s in SOURCES] + ["-o", tmp])
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed ({res.returncode}) building the "
                           f"native host library:\n{res.stderr[-4000:]}")
    os.replace(tmp, so)
    return so


def get_lib() -> ctypes.CDLL:
    """The native library, built at first use; raises if it does not
    build."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(_build())
        for name in ("filter1_batch", "filter1_survivors", "pass1_select",
                     "finalize_render",
                     "sw_full_tb_host", "paired_finalize_render",
                     "cs_post_fb_batch",
                     "cs_finalize_render", "csr_counting_sort",
                     "spaced_keys"):
            getattr(lib, name).restype = ctypes.c_int64
        lib.hp_alloc.restype = ctypes.c_void_p
        lib.hp_alloc.argtypes = [ctypes.c_int64]
        lib.hp_free.restype = ctypes.c_int32
        lib.hp_free.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        _LIB = lib
        return lib
