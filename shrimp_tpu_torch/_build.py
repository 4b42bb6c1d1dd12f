"""Build and load the hand-written CUDA kernels (`csrc/*.cu`).

nvcc compiles each source under `csrc/` for Hopper (`sm_90a`) into its
own shared library with a plain C interface, loaded with ctypes: no
PyTorch headers, so a build takes seconds, not minutes, and the sources
build in parallel (one nvcc each, all started together). The libraries
are built at first use into `build/shrimp_tpu_torch/` beside the
package, each keyed by a hash of its source, the headers and the flags,
so an unchanged source reuses its library. A failed build raises;
nothing falls back to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Optional

import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "shrimp_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points: (name, argtypes). Every pointer and the stream are
# c_void_p (a plain int would be cut to 32 bits); sizes and scores int.
# A launch whose kernel can need device memory beside its outputs takes
# it last, after the stream (`scratch`).
_SIGNATURES = {
    "sw_vector_launch": [_P] * 6 + [_I] * 9 + [_P, _P],
    "sw_vector_config": [_I, _I, _I, _P],
    "sw_vector_scratch": [_I, _I, _I, _P],
    "sw_full_stats_launch": [_P] * 10 + [_I] * 10 + [_P],
    "sw_full_stats_config": [_I, _I, _I, _P],
    "sw_cs_full_launch": [_P] * 13 + [_I] * 11 + [_P, _P],
    "sw_cs_full_config": [_I, _I, _I, _P],
    "sw_cs_full_scratch": [_I, _I, _I, _P],
    "cs_traceback_launch": [_P] * 11 + [_I] * 3 + [_P],
    "cs_traceback_config": [_I, _I, _I, _P],
    "sw_full_bp_launch": [_P] * 11 + [_I] * 10 + [_P, _P],
    "sw_full_bp_config": [_I, _I, _I, _P],
    "sw_full_bp_scratch": [_I, _I, _I, _P],
    "ls_traceback_launch": [_P] * 9 + [_I] * 3 + [_P, _P],
    "ls_traceback_config": [_I, _I, _I, _P],
    "ls_traceback_scratch": [_I, _I, _I, _P],
    "filter1_front_launch": [_P] * 4 + [ctypes.c_longlong] + [_I] * 9
    + [_P],
    "filter1_front_config": [_I, _I, _I, _P],
}


@dataclass
class Built:
    lib: SimpleNamespace    # the C entry points of every source, by name
    paths: list             # one shared library per source
    seconds: float      # nvcc wall time; 0.0 when cached builds were reused
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


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit to build shrimp_tpu_torch's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _so_path(src: str, headers, out_dir: str) -> str:
    """The library of one source, keyed by its bytes, the headers' and
    the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in (src, *headers):
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + f.read())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(out_dir, f"{stem}_{h.hexdigest()[:16]}.so")


def build(src_dir: str, out_dir: str, names=None) -> Built:
    """Build (or reuse) the libraries of the `.cu` sources in `src_dir`
    (those named in `names`, every one when None) into `out_dir`, one
    nvcc process per source, all started together, and bind the entry
    points of _SIGNATURES that they export. Raises on failure."""
    srcs = sorted(os.path.join(src_dir, f) for f in os.listdir(src_dir)
                  if f.endswith((".cu", ".cuh")))
    headers = [s for s in srcs if s.endswith(".cuh")]
    sos = [(s, _so_path(s, headers, out_dir)) for s in srcs
           if s.endswith(".cu")
           and (names is None or os.path.basename(s) in names)]
    os.makedirs(out_dir, exist_ok=True)
    todo = [(s, so) for s, so in sos if not os.path.exists(so)]
    t0 = time.perf_counter()
    procs = [(so, subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", f"{so}.tmp{os.getpid()}", s],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for s, so in todo]
    logs, failed = [], []
    for so, p in procs:
        out = p.communicate()[0]
        logs.append(out)
        if p.returncode != 0:
            failed.append(f"{os.path.basename(so)} ({p.returncode})")
    secs = time.perf_counter() - t0 if todo else 0.0
    log = "".join(logs)
    if failed:
        for so, _ in procs:
            if os.path.exists(f"{so}.tmp{os.getpid()}"):
                os.remove(f"{so}.tmp{os.getpid()}")
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{log}")
    for so, _ in procs:
        os.replace(f"{so}.tmp{os.getpid()}", so)
    lib = SimpleNamespace()
    for _, so in sos:
        dll = ctypes.CDLL(so)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(dll, name, None)
            if fn is not None:
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                setattr(lib, name, fn)
    return Built(lib, [so for _, so in sos], secs, log)


def load() -> Built:
    """Build (or reuse) and load the package's kernel libraries; raises
    on failure."""
    global _BUILT
    with _LOCK:
        if _BUILT is None:
            built = build(SRC_DIR, BUILD_DIR)
            missing = sorted(set(_SIGNATURES) - set(vars(built.lib)))
            if missing:
                raise RuntimeError(f"kernel entry points not built: "
                                   f"{missing}")
            _BUILT = built
        return _BUILT


CONFIG_KEYS = ("pairs_per_block", "threads_per_pair", "smem_bytes",
               "blocks_per_sm", "registers", "local_bytes")


def launch_config(name: str, *args: int) -> dict:
    """The launch configuration that a kernel's C entry point `name`
    (`<kernel>_config`) reports for the sizes `args`: CONFIG_KEYS, with
    the resident blocks per SM from the CUDA occupancy calculator and the
    registers and local (spill) bytes of each thread."""
    out = (ctypes.c_int * len(CONFIG_KEYS))()
    check(getattr(load().lib, name)(*args, ctypes.addressof(out)), name)
    return dict(zip(CONFIG_KEYS, out))


def scratch(kernel: str, B: int, G: int, R: int,
            device: torch.device) -> Optional[torch.Tensor]:
    """The device memory that a launch of `kernel` (B pairs, G columns, R
    rows) needs beside its outputs, as its C entry point
    `<kernel>_scratch` sizes it: a uint8 tensor on `device`, or None
    where the launch's working set fits shared memory. Call it under
    `torch.cuda.device(device)`: the size depends on the card."""
    out = ctypes.c_longlong(0)
    name = f"{kernel}_scratch"
    check(getattr(load().lib, name)(B, G, R, ctypes.addressof(out)), name)
    if out.value == 0:
        return None
    return torch.empty(out.value, dtype=torch.uint8, device=device)


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's device address for a C entry point, None (null) for
    None."""
    return None if t is None else t.data_ptr()


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch function."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError "
                           f"{rc}")
