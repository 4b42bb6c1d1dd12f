"""Spaced seeds: parsing, defaults, vectorized kmer -> mapidx projection.

Behavioral reference: gmapper/seeds.c:9-141, gmapper/gmapper.h:344-368
(kmer_to_mapidx_orig).

mapidx layout (derived from kmer_to_mapidx_orig + the prepend-window
construction): for included seed offsets o_0 < o_1 < ... < o_{w-1}
(0-based from the kmer start), mapidx = sum_j (base[o_j] & 3) << (2*j),
i.e. the kmer START base lands in the least-significant two bits.

Copied from `shrimp_tpu/index/seeds.py` unchanged: the port keeps its
own copy of the JAX package's host modules and imports none of them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from .. import constants as C


@dataclass(frozen=True)
class Seed:
    mask_string: str

    @property
    def span(self) -> int:
        return len(self.mask_string)

    @property
    def weight(self) -> int:
        return self.mask_string.count("1")

    @property
    def offsets(self) -> np.ndarray:
        return np.array([i for i, c in enumerate(self.mask_string)
                         if c == "1"], dtype=np.int64)

    def validate(self, hashed: bool = False) -> None:
        if not (1 <= self.span <= C.MAX_SEED_SPAN):
            raise ValueError(f"seed span out of range: {self.mask_string}")
        if self.weight < 1:
            raise ValueError(f"seed weight < 1: {self.mask_string}")
        if any(c not in "01" for c in self.mask_string):
            raise ValueError(f"bad seed string: {self.mask_string}")
        if not hashed and self.weight > C.MAX_SEED_WEIGHT:
            raise ValueError(
                f"seed weight {self.weight} > {C.MAX_SEED_WEIGHT}; "
                "use hashed mapidx mode (-H)")

    @property
    def n_mapidx(self) -> int:
        return 4 ** self.weight


def default_seeds(mode: str = C.MODE_LETTER_SPACE, weight: int = 0
                  ) -> List[Seed]:
    """gmapper/seeds.c:53-81; the 2.2.3 LS and CS sets are identical."""
    del mode
    if weight == 0:
        weight = C.DEFAULT_SEED_WEIGHT
    if weight not in C.DEFAULT_SEEDS or not C.DEFAULT_SEEDS[weight]:
        raise ValueError(f"no default seeds of weight {weight}")
    return [Seed(s) for s in C.DEFAULT_SEEDS[weight]]


def mirna_seeds() -> List[Seed]:
    return [Seed(s) for s in C.MIRNA_SEEDS]


def parse_seeds(spec: str, hashed: bool = False) -> List[Seed]:
    """Parse a comma-separated `-s` seed list, or `w<N>` for a default set
    (gmapper.c seed option handling)."""
    if spec.startswith("w"):
        return default_seeds(weight=int(spec[1:]))
    seeds = [Seed(s.strip()) for s in spec.split(",") if s.strip()]
    for s in seeds:
        s.validate(hashed=hashed)
    return seeds


def kmer_mapidx(codes: np.ndarray, starts: np.ndarray, seed: Seed
                ) -> np.ndarray:
    """Vectorized mapidx for kmers starting at `starts` within `codes`.

    Equivalent to kmer_to_mapidx_orig (gmapper.h:344-368): only the low 2
    bits of each 4-bit base code participate, so N/X alias to T etc.
    """
    m = np.zeros(len(starts), dtype=np.uint32)
    for j, o in enumerate(seed.offsets):
        m |= (codes[starts + o].astype(np.uint32) & 3) << np.uint32(2 * j)
    return m


def _hash_u32(a: np.ndarray) -> np.ndarray:
    """gmapper.h:309-319 (uint32 wrapping)."""
    a = a.astype(np.uint32)
    with np.errstate(over="ignore"):
        a = (a + np.uint32(0x7ed55d16)) + (a << np.uint32(12))
        a = (a ^ np.uint32(0xc761c23c)) ^ (a >> np.uint32(19))
        a = (a + np.uint32(0x165667b1)) + (a << np.uint32(5))
        a = (a + np.uint32(0xd3a2646c)) ^ (a << np.uint32(9))
        a = (a + np.uint32(0xfd7046c5)) + (a << np.uint32(3))
        a = (a ^ np.uint32(0xb55a4f09)) ^ (a >> np.uint32(16))
    return a


def sliding_mapidx_hash(codes: np.ndarray, seed: Seed, max_seed_span: int
                        ) -> np.ndarray:
    """Hashed mapidx for every window start (kmer_to_mapidx_hash,
    gmapper.h:323-338): the masked 4-bit kmer window words are chained
    through the mixing hash, truncated to 24 bits.

    Window field j holds the base at kmer start + (span-1-j); fields
    >= span are zeroed by the seed hash mask.
    """
    n = len(codes) - seed.span + 1
    if n <= 0:
        return np.zeros(0, np.uint32)
    span = seed.span
    maskbit = np.zeros(max_seed_span, bool)
    for j in range(span):
        maskbit[j] = seed.mask_string[span - 1 - j] == "1"
    n_words = (max_seed_span + 7) // 8
    mapidx = np.zeros(n, np.uint32)
    base = np.arange(n, dtype=np.int64)
    for w in range(n_words):
        word = np.zeros(n, np.uint32)
        for f in range(8):
            j = 8 * w + f
            if j >= max_seed_span or not maskbit[j]:
                continue
            word |= (codes[base + (span - 1 - j)].astype(np.uint32)
                     << np.uint32(4 * f))
        mapidx = _hash_u32(word ^ mapidx)
    return mapidx & np.uint32((1 << (2 * C.HASH_TABLE_POWER)) - 1)


def kmer_mapidx_hash(codes: np.ndarray, starts: np.ndarray, seed: Seed,
                     max_seed_span: int) -> np.ndarray:
    """Hashed mapidx at explicit start positions."""
    span = seed.span
    maskbit = [seed.mask_string[span - 1 - j] == "1" if j < span else False
               for j in range(max_seed_span)]
    n_words = (max_seed_span + 7) // 8
    mapidx = np.zeros(len(starts), np.uint32)
    for w in range(n_words):
        word = np.zeros(len(starts), np.uint32)
        for f in range(8):
            j = 8 * w + f
            if j >= max_seed_span or not maskbit[j]:
                continue
            word |= (codes[starts + (span - 1 - j)].astype(np.uint32)
                     << np.uint32(4 * f))
        mapidx = _hash_u32(word ^ mapidx)
    return mapidx & np.uint32((1 << (2 * C.HASH_TABLE_POWER)) - 1)


def mapidx_matrix(flat_codes: np.ndarray, starts: np.ndarray, seed: Seed,
                  hashed: bool, max_seed_span: int) -> np.ndarray:
    """mapidx for kmers at `starts` in every row of [N, L] `flat_codes`."""
    N = flat_codes.shape[0]
    K = len(starts)
    if not hashed:
        keys = np.zeros((N, K), np.uint32)
        for j, o in enumerate(seed.offsets):
            keys |= ((flat_codes[:, starts + o].astype(np.uint32) & 3)
                     << np.uint32(2 * j))
        return keys
    span = seed.span
    maskbit = [seed.mask_string[span - 1 - j] == "1" if j < span else False
               for j in range(max_seed_span)]
    n_words = (max_seed_span + 7) // 8
    mapidx = np.zeros((N, K), np.uint32)
    for w in range(n_words):
        word = np.zeros((N, K), np.uint32)
        for f in range(8):
            j = 8 * w + f
            if j >= max_seed_span or not maskbit[j]:
                continue
            word |= (flat_codes[:, starts + (span - 1 - j)]
                     .astype(np.uint32) << np.uint32(4 * f))
        mapidx = _hash_u32(word ^ mapidx)
    return mapidx & np.uint32((1 << (2 * C.HASH_TABLE_POWER)) - 1)


def sliding_mapidx(codes: np.ndarray, seed: Seed) -> np.ndarray:
    """mapidx for every window start 0..len-span of `codes` (vectorized)."""
    n = len(codes) - seed.span + 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint32)
    m = np.zeros(n, dtype=np.uint32)
    for j, o in enumerate(seed.offsets):
        m |= (codes[o:o + n].astype(np.uint32) & 3) << np.uint32(2 * j)
    return m
