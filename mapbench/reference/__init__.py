"""The plain reference that decides `correct`: SHRiMP2's mapping with a
configuration's default options, in NumPy and Python, worked out from
the genome and the reads the harness made. It imports nothing of the
program and nothing of JAX.

`expected_records` gives each read's (or pair's) SAM records without
their QNAME field, in output order. `control=True` runs filter 2 in
saturating 8-bit scores: the narrower vector SW a later kernel might be
tempted by, which the comparison has to refuse.
"""
from __future__ import annotations

from typing import List

import numpy as np

CONTROL_SAT = 127


def expected_records(config: dict, traffic: dict, genome: np.ndarray,
                     items: list, control: bool = False) -> List[List[str]]:
    from mapbench.reference import cs, index, ls, pairs
    sat = CONTROL_SAT if control else None
    mode = config["mode"]
    if mode == "ls" and "insert" not in traffic:
        reads = [ls.prepare("", s.decode()) for s in items]
        codes = [np.stack([r.codes[0] for r in reads]),
                 np.stack([r.codes[1] for r in reads])]
        idx = index.Index(genome, "ls", codes, 0)
        idx.contig_name = config["contig"]
        return ls.map_reads(idx, reads, sat=sat)
    if mode == "cs" and "insert" not in traffic:
        reads = [cs.prepare("", s.decode()) for s in items]
        codes = [np.stack([r.codes[0] for r in reads]),
                 np.stack([r.codes[1] for r in reads])]
        idx = index.Index(genome, "cs", codes, 1)
        idx.contig_name = config["contig"]
        idx.planes = cs.genome_planes(genome)
        return cs.map_reads(idx, reads, sat=sat)
    if mode == "cs":
        prs = [(cs.prepare("", a.decode()), cs.prepare("", b.decode()))
               for a, b in items]
        reads = [r for p in prs for r in p]
        codes = [np.stack([r.codes[0] for r in reads]),
                 np.stack([r.codes[1] for r in reads])]
        idx = index.Index(genome, "cs", codes, 1)
        idx.contig_name = config["contig"]
        idx.planes = cs.genome_planes(genome)
        return pairs.map_pairs(idx, prs, tuple(traffic["insert_range"]),
                               sat=sat)
    raise NotImplementedError(f"no reference for {mode} "
                              f"{'pairs' if 'insert' in traffic else ''}")
