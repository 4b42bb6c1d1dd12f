"""Build and load the hand-written CUDA kernels (`csrc/*.cu`).

nvcc compiles every source under `csrc/` for Hopper (`sm_90a`) into one
shared library with a plain C interface, loaded with ctypes: no PyTorch
headers, so a build takes seconds, not minutes. The library is built at
first use into `build/shrimp_tpu_torch/` beside the package, keyed by a
hash of the sources and flags, so an unchanged tree reuses it. A failed
build raises; nothing falls back to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from dataclasses import dataclass
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "shrimp_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points: (name, argtypes). Every pointer and the stream are
# c_void_p (a plain int would be cut to 32 bits); sizes and scores int.
_SIGNATURES = (
    ("sw_vector_launch", [_P] * 5 + [_I] * 9 + [_P]),
    ("sw_full_stats_launch", [_P] * 10 + [_I] * 10 + [_P]),
)


@dataclass
class Built:
    lib: ctypes.CDLL
    path: str
    seconds: float      # nvcc wall time; 0.0 when a cached build was reused
    log: str            # nvcc/ptxas output (registers, spills)


class LaunchCount:
    """Thread-safe launch counter: kernel wrappers add one per launch of
    their kernel, so a run can show which kernels its path went
    through."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.n = 0

    def add(self) -> None:
        with self._lock:
            self.n += 1

    def reset(self) -> None:
        with self._lock:
            self.n = 0


_LOCK = threading.Lock()
_BUILT: Optional[Built] = None


def _sources():
    return sorted(os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit to build shrimp_tpu_torch's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def load() -> Built:
    """Build (or reuse) and load the kernel library; raises on failure."""
    global _BUILT
    with _LOCK:
        if _BUILT is not None:
            return _BUILT
        srcs = _sources()
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for s in srcs:
            with open(s, "rb") as f:
                h.update(os.path.basename(s).encode() + f.read())
        os.makedirs(BUILD_DIR, exist_ok=True)
        so = os.path.join(BUILD_DIR, f"kernels_{h.hexdigest()[:16]}.so")
        secs, log = 0.0, ""
        if not os.path.exists(so):
            tmp = f"{so}.tmp{os.getpid()}"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                   *[s for s in srcs if s.endswith(".cu")]]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True)
            secs = time.perf_counter() - t0
            log = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        for name, argtypes in _SIGNATURES:
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _BUILT = Built(lib, so, secs, log)
        return _BUILT


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch function."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError "
                           f"{rc}")
