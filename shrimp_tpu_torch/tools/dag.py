"""Helicos two-pass DAG aligner (common/dag_align.cpp, dag_glue.cpp,
dag_kmers.cpp — legacy SHRiMP1 component, not linked into gmapper).

A Helicos molecule is sequenced twice; the two error-laden passes are
first co-aligned into a DAG whose paths spell every near-optimal joint
reading (within ``epsilon`` of the best read1-vs-read2 alignment), then
a genome window is aligned against the DAG with pair-aware scores.

The reference exposes this as a C API (dag_glue.h:63-71): ``dag_setup``
(score table), ``dag_build_kmer_graph`` (read1 x read2 lattice ->
epsilon-pruned DAG), ``dag_get_kmers`` (all k-length consensus strings
spelled by DAG paths, for seeding), and ``dag_build_alignment`` (local
genome-vs-DAG DP).  This module mirrors that surface with plain Python
objects; the component is host-side tooling (per-read graphs of ~100
nodes), not a TPU compute path.

Copied from `shrimp_tpu/tools/dag.py` unchanged: the port keeps its own
copy of the JAX package's host modules and imports none of them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

MINSCORE = -1000

# default score table (prettyprint/prettyprint.c:501-507 commented
# defaults; dag_align.cpp:20-31 documents the historical values)
DEF_READ_MATCH = 2
DEF_READ_GAP = -1
DEF_READ_MISMATCH = -100
DEF_DAG_MATCH = 11
DEF_DAG_SNP = -10
DEF_DAG_HALF_MATCH = 4
DEF_DAG_NEITHER_MATCH = -5
DEF_DAG_MATCH_DELETION = 5
DEF_DAG_MISMATCH_DELETION = -6
DEF_DAG_ERROR_INSERTION = -6


@dataclass(frozen=True)
class DagScores:
    """Column::setscore parameters (dag_align.cpp:33-48)."""
    read_match: int = DEF_READ_MATCH
    read_gap: int = DEF_READ_GAP
    read_mismatch: int = DEF_READ_MISMATCH
    dag_match: int = DEF_DAG_MATCH
    dag_snp: int = DEF_DAG_SNP
    dag_half_match: int = DEF_DAG_HALF_MATCH
    dag_neither_match: int = DEF_DAG_NEITHER_MATCH
    dag_match_deletion: int = DEF_DAG_MATCH_DELETION
    dag_mismatch_deletion: int = DEF_DAG_MISMATCH_DELETION
    dag_error_insertion: int = DEF_DAG_ERROR_INSERTION


def _get2score(c1: str, c2: str, sc: DagScores) -> int:
    """Column::get2score (dag_align.cpp:50-60): read-vs-read column."""
    if c1 == "-" or c2 == "-":
        return 0                       # free end gaps
    if c1 == "_" or c2 == "_":
        return sc.read_gap
    if c1 == c2:
        return sc.read_match
    return sc.read_mismatch


def _consensus(col: str) -> str:
    """Column::consensus (dag_align.cpp:100-136): majority letter, ties
    resolved in A<C<G<T<_ scan order ('-' pools with '_')."""
    counts = {"A": 0, "C": 0, "G": 0, "T": 0, "_": 0}
    for ch in col:
        counts["_" if ch in "-_" else ch] += 1
    best, best_n = "A", counts["A"]
    for ch in "CGT_":
        if counts[ch] > best_n:
            best, best_n = ch, counts[ch]
    return best


def _column_score(col: str, sc: DagScores) -> int:
    """Column::getscore (dag_align.cpp:153-177): 2-char columns score
    directly; wider columns score every char against the consensus."""
    if len(col) == 2:
        return _get2score(col[0], col[1], sc)
    cons = _consensus(col)
    return sum(_get2score(cons, ch, sc) for ch in col)


def _get3score(gen_col: str, pair_col: str, sc: DagScores) -> int:
    """Column::get3score (dag_align.cpp:222-280): one genome letter vs a
    2-char read-pair column."""
    gen = gen_col[0]
    if gen == "-":
        gen = "_"
    l0, l1 = pair_col[0], pair_col[1]
    g0, g1 = l0 in "-_", l1 in "-_"
    if g0 and g1:                                       # GAPGAP
        return sc.dag_neither_match
    if g0 or g1:                                        # LETTERGAP
        letter = l1 if g0 else l0
        if gen == "_":
            return sc.dag_error_insertion
        return (sc.dag_match_deletion if gen == letter
                else sc.dag_mismatch_deletion)
    if l0 == l1:                                        # MATCH
        return sc.dag_match if gen == l0 else sc.dag_snp
    # MISMATCH between the two passes
    return (sc.dag_half_match if gen in (l0, l1)
            else sc.dag_neither_match)


class _Graph:
    """Node-indexed DAG; edges are (src, dst, column) with parallel
    edges allowed (dag_align.h Graph/Node/Edge)."""

    def __init__(self, n_nodes: int, column_length: int):
        self.column_length = column_length
        self.n = n_nodes
        # succ[i] = list of (dst, column)
        self.succ: List[List[Tuple[int, str]]] = [[] for _ in range(n_nodes)]
        self.pred: List[List[Tuple[int, str]]] = [[] for _ in range(n_nodes)]
        self.loops_added = False

    def add_edge(self, src: int, dst: int, col: str) -> None:
        self.succ[src].append((dst, col))
        self.pred[dst].append((src, col))

    @classmethod
    def chain(cls, s: str) -> "_Graph":
        """Graph::Graph(string) (dag_align.cpp:316-331)."""
        g = cls(len(s) + 1, 1)
        for i, ch in enumerate(s):
            g.add_edge(i, i + 1, ch)
        return g

    def add_self_loops(self) -> None:
        """Graph::AddSelfLoops (dag_align.cpp:528-537): '_' columns on
        every node, '-' (free end gap) on the last."""
        if self.loops_added:
            return
        for i in range(self.n - 1):
            self.add_edge(i, i, "_" * self.column_length)
        self.add_edge(self.n - 1, self.n - 1, "-" * self.column_length)
        self.loops_added = True

    def get_kmers(self, size: int) -> List[Set[str]]:
        """Graph::getkmers (dag_kmers.cpp:50-73): forward DP in node
        order collecting, per length 1..size, every string of edge
        consensus letters spelled by a path."""
        aux: List[Optional[List[Set[str]]]] = [None] * self.n
        aux[0] = [set() for _ in range(size)]
        out: List[Set[str]] = [set() for _ in range(size)]
        for i in range(self.n):
            src_km = aux[i]
            if src_km is None:
                src_km = aux[i] = [set() for _ in range(size)]
            for dst, col in self.succ[i]:
                letter = _consensus(col)
                if aux[dst] is None:
                    aux[dst] = [set() for _ in range(size)]
                aux[dst][0].add(letter)
                out[0].add(letter)
                for ln in range(size):
                    for km in src_km[ln]:
                        out[ln].add(km)
                        if ln + 1 < size:
                            aux[dst][ln + 1].add(km + letter)
            aux[i] = None
        return out


@dataclass
class DagAlignment:
    """struct dag_alignment (dag_glue.h:13-21)."""
    score: int
    start_index: int
    end_index: int
    sequence: str
    read1: str
    read2: str


@dataclass
class DagStatistics:
    """struct dag_statistics (dag_glue.h:23-29)."""
    aligner_seconds: float = 0.0
    aligner_invocations: int = 0
    kmers_invocations: int = 0
    kmers_total_kmers: int = 0
    kmers_seconds: float = 0.0


_STATS = DagStatistics()


def get_statistics() -> DagStatistics:
    return DagStatistics(**vars(_STATS))


def build_kmer_graph(read1: str, read2: str, epsilon: int,
                     scores: DagScores = DagScores()) -> _Graph:
    """dag_build_kmer_graph (dag_glue.cpp:46-63): global read1-vs-read2
    lattice DP; keep every lattice edge on a path scoring within
    ``epsilon`` of the best (Graph::Graph(CrossProduct&, int),
    dag_align.cpp:353-426) and rebuild them as a DAG."""
    t0 = time.perf_counter()
    n1, n2 = len(read1) + 1, len(read2) + 1
    ga, gb = _Graph.chain(read1), _Graph.chain(read2)
    ga.add_self_loops()
    gb.add_self_loops()

    # lattice edges: every (pred-edge of i) x (pred-edge of j), column =
    # concat (CrossProduct ctor, dag_align.cpp:572-604)
    fscore = [[MINSCORE] * n2 for _ in range(n1)]
    bscore = [[MINSCORE] * n2 for _ in range(n1)]
    fscore[0][0] = 0
    bscore[n1 - 1][n2 - 1] = 0

    def lattice_preds(i: int, j: int):
        for (sa, ca) in ga.pred[i]:
            for (sb, cb) in gb.pred[j]:
                yield sa, sb, ca + cb

    # forward best-path (DijkstraForward, dag_align.cpp:606-647; the
    # lattice is scanned in (i, j) order, which is topological because
    # every non-self edge decreases neither coordinate)
    for i in range(n1):
        for j in range(n2):
            for sa, sb, col in lattice_preds(i, j):
                s = fscore[sa][sb]
                if s > MINSCORE:
                    cand = s + _column_score(col, scores)
                    if cand > fscore[i][j] and (sa, sb) != (i, j):
                        fscore[i][j] = cand
    # backward (DijkstraBackward, dag_align.cpp:799-836)
    for i in range(n1 - 1, -1, -1):
        for j in range(n2 - 1, -1, -1):
            for sa, sb, col in lattice_preds(i, j):
                s = bscore[i][j]
                if s > MINSCORE:
                    cand = s + _column_score(col, scores)
                    if cand > bscore[sa][sb] and (sa, sb) != (i, j):
                        bscore[sa][sb] = cand
    best = fscore[n1 - 1][n2 - 1]

    # epsilon-pruned rebuild: a lattice node joins the DAG when it has a
    # good incoming edge; (0,0) is always node 0
    node_of: Dict[Tuple[int, int], int] = {(0, 0): 0}
    kg = _Graph(1, 2)
    for i in range(n1):
        for j in range(n2):
            created = (i, j) in node_of
            for sa, sb, col in lattice_preds(i, j):
                if (sa, sb) == (i, j):
                    continue
                tot = (fscore[sa][sb] + _column_score(col, scores)
                       + bscore[i][j])
                if tot >= best - epsilon:
                    if not created:
                        node_of[(i, j)] = kg.n
                        kg.n += 1
                        kg.succ.append([])
                        kg.pred.append([])
                        created = True
                    src = node_of.get((sa, sb))
                    if src is not None:
                        kg.add_edge(src, node_of[(i, j)], col)
    _STATS.kmers_seconds += time.perf_counter() - t0
    return kg


def get_kmers(kg: _Graph, length: int) -> List[str]:
    """dag_get_kmers (dag_glue.cpp:79-119): the sorted set of
    ``length``-letter strings spelled by DAG paths."""
    t0 = time.perf_counter()
    _STATS.kmers_invocations += 1
    if length < 1:
        return []
    km = sorted(kg.get_kmers(length)[length - 1])
    _STATS.kmers_total_kmers += len(km)
    _STATS.kmers_seconds += time.perf_counter() - t0
    return km


def build_alignment(genome: str, kg: _Graph,
                    scores: DagScores = DagScores()) -> DagAlignment:
    """dag_build_alignment (dag_glue.cpp:134-172): local genome-vs-DAG
    DP (SmallCrossProduct::DijkstraForward, dag_align.cpp:649-685) and
    traceback into (sequence, read1, read2) strings."""
    t0 = time.perf_counter()
    _STATS.aligner_invocations += 1
    g = _Graph.chain(genome)
    g.add_self_loops()
    kg.add_self_loops()
    ng, nk = g.n, kg.n
    fscore = [[0] * nk for _ in range(ng)]
    # parent[(i,j)] = (pi, pj, genome_col, pair_col)
    parent: Dict[Tuple[int, int],
                 Tuple[int, int, str, str]] = {}
    best, bi, bj = MINSCORE, 0, 0
    for i in range(ng):
        gpred = g.pred[i]
        for j in range(nk):
            f = fscore[i][j]
            for (sa, ca) in gpred:
                for (sb, cb) in kg.pred[j]:
                    e = _get3score(ca, cb, scores)
                    cand = fscore[sa][sb] + e
                    if cand > f:
                        f = cand
                        parent[(i, j)] = (sa, sb, ca, cb)
            fscore[i][j] = f
            if f > best:
                best, bi, bj = f, i, j
    seq: List[str] = []
    r1: List[str] = []
    r2: List[str] = []
    end_index = bi - 1
    i, j = bi, bj
    while (i, j) in parent:
        pi, pj, ca, cb = parent[(i, j)]
        seq.append(ca)
        r1.append(cb[0])
        r2.append(cb[1])
        i, j = pi, pj
    al = DagAlignment(score=best, start_index=i, end_index=end_index,
                      sequence="".join(reversed(seq)),
                      read1="".join(reversed(r1)),
                      read2="".join(reversed(r2)))
    _STATS.aligner_seconds += time.perf_counter() - t0
    return al
