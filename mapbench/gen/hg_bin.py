"""One bin of a human-like genome: `bench_hg.py`'s repeat-structured
sequence (copied from `shrimp_tpu_torch/dataset.py::hg_bin`, made from
the run's seed). A random sequence carrying SINE-like 300 bp copies on
`sine_share` of it (5-25 % divergence), 5'-truncated LINE-like fragments
of 0.5-6 kb on `line_share` (5-20 %), alpha-satellite-like tandem arrays
of 10-200 kb on `sat_share` (1-3 %) and N gaps on `n_share` in 20
blocks."""
from __future__ import annotations

import numpy as np

BASE_N = 15


def _mutate(rng, copies: np.ndarray, div: np.ndarray) -> None:
    n, L = copies.shape
    for off in range(0, n, 100_000):      # bound the float mask's memory
        end = min(off + 100_000, n)
        mask = rng.random((end - off, L)) < div[off:end, None]
        copies[off:end][mask] = rng.integers(0, 4, int(mask.sum()),
                                             dtype=np.uint8)


def make(params: dict, rng: np.random.Generator) -> np.ndarray:
    slen = int(params["length"])
    sine = rng.integers(0, 4, 300, dtype=np.uint8)
    line = rng.integers(0, 4, 6000, dtype=np.uint8)
    sat = rng.integers(0, 4, 171, dtype=np.uint8)
    codes = rng.integers(0, 4, slen, dtype=np.uint8)
    n_sine = int(params["sine_share"] * slen) // 300
    starts = rng.integers(0, slen - 300, n_sine)
    copies = np.tile(sine, (n_sine, 1))
    _mutate(rng, copies, rng.uniform(0.05, 0.25, n_sine))
    for off in range(0, n_sine, 100_000):
        s = starts[off:off + 100_000]
        codes[(s[:, None] + np.arange(300)).ravel()] = \
            copies[off:off + 100_000].ravel()
    del copies
    budget = int(params["line_share"] * slen)
    while budget > 0:
        L = int(rng.integers(500, 6001))
        s = int(rng.integers(0, slen - L))
        frag = line[-L:].copy()
        m = rng.random(L) < rng.uniform(0.05, 0.20)
        frag[m] = rng.integers(0, 4, int(m.sum()), dtype=np.uint8)
        codes[s:s + L] = frag
        budget -= L
    budget = int(params["sat_share"] * slen)
    while budget > 0:
        L = min(int(rng.integers(10_000, 200_001)), slen // 2)
        s = int(rng.integers(0, slen - L))
        arr = np.tile(sat, -(-L // len(sat)))[:L].copy()
        m = rng.random(L) < rng.uniform(0.01, 0.03)
        arr[m] = rng.integers(0, 4, int(m.sum()), dtype=np.uint8)
        codes[s:s + L] = arr
        budget -= L
    gap = int(params["n_share"] * slen) // 20
    for _ in range(20):
        s = int(rng.integers(0, slen - gap))
        codes[s:s + gap] = BASE_N
    return codes
