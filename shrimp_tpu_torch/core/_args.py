"""Argument checks shared by the kernel wrappers: a CUDA kernel takes
exactly the device, dtype, shape and layout it was written for, and
anything else raises before a pointer reaches it."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

# the widest windows of the short-read kernels (sw_full.cu's and
# sw_cs_full.cu's G buckets), and of the long-read kernels: the packed
# flow's 14-bit window length caps G at 4095
MAX_G = 256
MAX_G_LONG = 4095


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
    """The kernels run on CUDA tensors with G <= max_g (MAX_G unless
    given); other devices have no kernel, and windows wider than MAX_G
    belong to the long-read flow."""
    max_g = MAX_G if max_g is None else max_g
    if genome.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {genome.device}")
    if genome.dim() != 2 or genome.shape[1] > max_g:
        raise NotImplementedError(
            f"{what}: genome windows of shape {tuple(genome.shape)}; the "
            f"CUDA kernel takes [B, G] with G <= {max_g}")
