"""The spaced-seed index the reference needs, worked out again from the
genome: for each default seed, the genome positions of the k-mers that
the reads to be judged contain (the k-mer lists of the full index,
restricted to those keys), in the CSR layout SHRiMP2's genome map has
(genome.c:1012-1182: a window holding an N is not indexed; colour space
indexes the colour projection of the forward genome, from an implicit T,
fasta.c:591)."""
from __future__ import annotations

import numpy as np

from mapbench.reference.common import BASE_N, COLOUR_MAT, SEEDS


class Seed:
    def __init__(self, mask: str):
        self.mask = mask
        self.span = len(mask)
        self.offsets = [i for i, c in enumerate(mask) if c == "1"]
        self.weight = len(self.offsets)


def keys_at(codes: np.ndarray, starts: np.ndarray, seed: Seed) -> np.ndarray:
    """k-mer keys at `starts` of each row of [N, L] `codes`: base o_j's low
    two bits at bits 2j (kmer_to_mapidx_orig, gmapper.h:344-368)."""
    k = np.zeros((codes.shape[0], len(starts)), np.uint32)
    for j, o in enumerate(seed.offsets):
        k |= (codes[:, starts + o].astype(np.uint32) & 3) << np.uint32(2 * j)
    return k


class SeedLists:
    """One seed's CSR lists over the keys wanted: `offsets` indexed by key
    (4^weight + 1 entries), `positions` ascending within a key."""

    def __init__(self, seed: Seed, pos: np.ndarray, keys: np.ndarray):
        self.seed = seed
        order = np.argsort(keys, kind="stable")
        self.positions = pos[order].astype(np.int64)
        counts = np.bincount(keys, minlength=4 ** seed.weight)
        self.offsets = np.zeros(4 ** seed.weight + 1, np.int64)
        np.cumsum(counts, out=self.offsets[1:])


def seed_lists(seeds, indexed: np.ndarray, wanted, chunk: int = 1 << 21,
               threads: int = 8) -> list:
    """The lists of every seed, the genome scanned once in chunks on a few
    threads (NumPy releases the GIL): the positions whose k-mer key is
    wanted and whose window holds no N."""
    from concurrent.futures import ThreadPoolExecutor
    span = max(s.span for s in seeds)
    tables = []
    for s, w in zip(seeds, wanted):
        t = np.zeros(4 ** s.weight, bool)
        t[w] = True
        tables.append(t)
    n_all = len(indexed)

    def scan(a):
        b = min(a + chunk, n_all)
        c = indexed[a:min(b + span, n_all)]
        c32 = (c & 3).astype(np.uint32)
        bad = np.flatnonzero(c == BASE_N)
        out = []
        for s, t in zip(seeds, tables):
            n = min(b, n_all - s.span + 1) - a
            if n <= 0:
                out.append((np.zeros(0, np.int64), np.zeros(0, np.uint32)))
                continue
            k = np.zeros(n, np.uint32)
            for j, o in enumerate(s.offsets):
                k |= c32[o:o + n] << np.uint32(2 * j)
            hit = t[k]
            if len(bad):
                # windows [p, p + span) holding an N are not indexed
                lo = np.clip(bad - s.span + 1, 0, n)
                hi = np.clip(bad + 1, 0, n)
                d = np.zeros(n + 1, np.int32)
                np.add.at(d, lo, 1)
                np.add.at(d, hi, -1)
                hit &= np.cumsum(d[:n]) == 0
            p = np.flatnonzero(hit)
            out.append((p + a, k[p]))
        return out

    with ThreadPoolExecutor(threads) as ex:
        parts = list(ex.map(scan, range(0, n_all, chunk)))
    return [SeedLists(s, np.concatenate([p[i][0] for p in parts]),
                      np.concatenate([p[i][1] for p in parts]))
            for i, s in enumerate(seeds)]


class Index:
    """The reference's index of one contig."""

    def __init__(self, genome: np.ndarray, mode: str, reads_codes: list,
                 min_kmer_pos: int):
        self.mode = mode
        self.codes = genome
        self.length = len(genome)
        self.contig_offsets = np.zeros(1, np.int64)
        self.contig_lengths = np.array([len(genome)], np.int64)
        if mode == "cs":
            prev = np.empty_like(genome)
            prev[0] = 3
            prev[1:] = genome[:-1]
            indexed = COLOUR_MAT[prev, genome]
        else:
            indexed = genome
        seeds = [Seed(mask) for mask in SEEDS]
        wanted = []
        for seed in seeds:
            w = [np.zeros(0, np.uint32)]
            for codes in reads_codes:
                last = codes.shape[1] - seed.span
                if last >= min_kmer_pos:
                    w.append(keys_at(codes, np.arange(min_kmer_pos, last + 1),
                                     seed).ravel())
            wanted.append(np.unique(np.concatenate(w)))
        self.seeds = seed_lists(seeds, indexed, wanted)
        self.max_seed_span = max(s.seed.span for s in self.seeds)

    def contig_of(self, pos):
        return np.searchsorted(self.contig_offsets, pos, side="right") - 1
