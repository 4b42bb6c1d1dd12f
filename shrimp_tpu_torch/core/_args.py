"""Argument checks shared by the kernel wrappers: a CUDA kernel takes
exactly the device, dtype, shape and layout it was written for, and
anything else raises before a pointer reaches it."""
from __future__ import annotations

from typing import Tuple

import torch

# the largest G bucket the CUDA kernels are instantiated for
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


def check_cuda_shape(genome: torch.Tensor, what: str) -> None:
    """The kernels run on CUDA tensors with G <= MAX_G; other devices
    have no kernel, and wider windows belong to the long-read flow."""
    if genome.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {genome.device}")
    if genome.dim() != 2 or genome.shape[1] > MAX_G:
        raise NotImplementedError(
            f"{what}: genome windows of shape {tuple(genome.shape)}; the "
            f"CUDA kernel takes [B, G] with G <= {MAX_G}")
