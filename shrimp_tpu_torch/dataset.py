"""The E. coli-scale letter-space workload of `bench.py`, made from a seed.

A 4.6 Mbp random genome and 36 bp reads sampled from it with 0-2
substitutions each, every odd read reverse-complemented; the same
generator as `bench.py::get_dataset`, without its on-disk cache. The
index is built with the shared `shrimp_tpu.index.build.build_index`.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from shrimp_tpu.index.build import GenomeIndex, build_index
from shrimp_tpu.index.seeds import default_seeds
from shrimp_tpu.io.fasta import SeqRecord

SEED = 20260816
GENOME_LEN = 4_600_000
READ_LEN = 36


def ecoli_unpaired_ls(n_reads: int, seed: int = SEED
                      ) -> Tuple[GenomeIndex, List[SeqRecord]]:
    """(index, reads) of bench.py's workload with `n_reads` reads."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, GENOME_LEN).astype(np.uint8)
    idx = build_index([("ecoli_synth", codes)], default_seeds())
    comp = np.array([3, 2, 1, 0], np.uint8)
    pos = rng.integers(0, GENOME_LEN - READ_LEN, n_reads)
    mat = codes[pos[:, None] + np.arange(READ_LEN)[None, :]].copy()
    nmut = rng.integers(0, 3, n_reads)
    for j in range(2):
        rows = np.nonzero(nmut > j)[0]
        mat[rows, rng.integers(0, READ_LEN, len(rows))] = \
            rng.integers(0, 4, len(rows)).astype(np.uint8)
    odd = np.arange(n_reads) % 2 == 1
    mat[odd] = comp[mat[odd, ::-1]]
    seqs = np.frombuffer(b"ACGT", np.uint8)[mat].tobytes().decode()
    reads = [SeqRecord(f"r{k}", seqs[k * READ_LEN:(k + 1) * READ_LEN])
             for k in range(n_reads)]
    return idx, reads
