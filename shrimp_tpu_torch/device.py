"""Device selection. The caller names the device; nothing here reads a
global default, and asking for CUDA where there is none raises instead
of quietly running on the CPU."""
from __future__ import annotations

from typing import Union

import torch


def get_device(name: Union[str, torch.device]) -> torch.device:
    """`"cuda"`/`"cuda:0"` -> cuda:0 (raises when CUDA is unavailable);
    `"cpu"` -> the CPU, used only when asked for explicitly."""
    dev = torch.device(name)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {name!r}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but CUDA is not "
                           "available")
    return torch.device("cuda", 0 if dev.index is None else dev.index)
