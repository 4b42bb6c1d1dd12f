"""A genome of i.i.d. uniform bases (the genome of `bench.py` and of
`shrimp_tpu_torch/dataset.py`'s E. coli workloads, at the length the
configuration states)."""
from __future__ import annotations

import numpy as np


def make(params: dict, rng: np.random.Generator) -> np.ndarray:
    """uint8 base codes (0-3) of `params["length"]` bases."""
    return rng.integers(0, 4, int(params["length"]), dtype=np.uint8)
