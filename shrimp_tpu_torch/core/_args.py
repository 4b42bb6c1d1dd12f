"""Argument checks shared by the kernel wrappers: a CUDA kernel takes
exactly the device, dtype, shape and layout it was written for, and
anything else raises before a pointer reaches it."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

# the widest windows of the stats kernel (sw_full.cu's G buckets): the
# stats flow takes G <= MAX_G, wider windows the traceback flow. The
# other kernels take any G.
MAX_G = 256


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape: Tuple[int, ...], device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def check_cuda_shape(genome: torch.Tensor, what: str,
                     max_g: Optional[int] = None) -> None:
    """The kernels run on CUDA tensors of windows [B, G], G <= max_g
    where the kernel has a limit (the stats kernel: MAX_G); other devices
    have no kernel."""
    if genome.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {genome.device}")
    if genome.dim() != 2 or (max_g is not None and genome.shape[1] > max_g):
        limit = "" if max_g is None else f" with G <= {max_g}"
        raise NotImplementedError(
            f"{what}: genome windows of shape {tuple(genome.shape)}; the "
            f"CUDA kernel takes [B, G]{limit}")
