"""Shared pieces of the reference mapper: SHRiMP2 v2.2.3's default
constants, encodings, the hit record, the bounded heap, the score
calibration and the SAM renderer. Plain Python and NumPy, written after
SHRiMP2's C sources (file:line cited) and the JAX package's scalar host
code; nothing here imports the program."""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

BASE_N = 15
LS_CHARS = "ACGTUMRWSYKVHDBN"
CHAR_TO_INT = np.full(256, -1, np.int16)
for _i, _c in enumerate(LS_CHARS):
    CHAR_TO_INT[ord(_c)] = _i
    CHAR_TO_INT[ord(_c.lower())] = _i
for _c, _v in (("0", 0), ("1", 1), ("2", 2), ("3", 3), (".", BASE_N),
               ("4", BASE_N), ("X", BASE_N), ("x", BASE_N)):
    CHAR_TO_INT[ord(_c)] = _v
COMPLEMENT = np.array([3, 2, 1, 0, 0, 10, 9, 7, 8, 6, 5, 14, 13, 12, 11, 15],
                      np.uint8)
COLOUR_MAT = np.full((16, 16), BASE_N, np.uint8)
COLOUR_MAT[:4, :4] = np.arange(4)[:, None] ^ np.arange(4)[None, :]

# gmapper-defaults.h / gmapper.c defaults
SEEDS = ["11110111101111", "1111011100100001111", "1111000011001101111"]
LS_SCORES = dict(match=10, mismatch=-15, a_gap_open=-33, a_gap_ext=-7,
                 b_gap_open=-33, b_gap_ext=-3)
CS_SCORES = dict(match=10, mismatch=-24, a_gap_open=-33, a_gap_ext=-7,
                 b_gap_open=-33, b_gap_ext=-3, crossover=-20)
WINDOW_LEN = 140.0          # % of the read length
WINDOW_OVERLAP = 90.0       # % of the window length
WINDOW_GEN_THRESHOLD = 55.0
SW_FULL_THRESHOLD = 50.0
CS_SW_VECT_THRESHOLD = 47.0  # LS takes the full threshold (gmapper.c:2464)
NUM_OUTPUTS = 10
NUM_TMP_OUTPUTS = 30
ANCHOR_WIDTH = 8
REGION_BITS = 11
REGION_OVERLAP = 50
PR_XOVER = 0.03
SEED_WEIGHT = 12


def abs_or_pct(x: float, base: float) -> float:
    """util.h:53: negative values are absolute."""
    return -x if x < 0 else base * (x / 100.0)


def list_cutoff(genome_len: int) -> int:
    """gmapper.c:2830-2834."""
    return max(1000, (100 * genome_len) // (4 ** SEED_WEIGHT))


@dataclass
class Calibration:
    """Score -> probability calibration (gmapper.c:2557-2572)."""
    alpha: float
    beta: float
    pr_mismatch: float
    pr_xover: float
    pr_del_open: float
    pr_del_extend: float
    pr_ins_open: float
    pr_ins_extend: float


def calibration(mode: str) -> Calibration:
    log2 = math.log(2.0)
    if mode == "cs":
        sc = CS_SCORES
        alpha = sc["crossover"] / (math.log(PR_XOVER / 3) / log2)
        pr_mm = 1.0 / (1.0 + (1.0 / 3.0) * math.pow(
            2.0, (sc["match"] - sc["mismatch"]) / alpha))
    else:
        sc = LS_SCORES
        pr_mm = 0.01
        alpha = (sc["match"] - sc["mismatch"]) / (
            math.log((1 - pr_mm) / (pr_mm / 3.0)) / log2)
    beta = sc["match"] - 2 * alpha - alpha * math.log(1 - pr_mm) / log2
    return Calibration(alpha, beta, pr_mm, PR_XOVER,
                       math.pow(2.0, sc["a_gap_open"] / alpha),
                       math.pow(2.0, sc["a_gap_ext"] / alpha),
                       math.pow(2.0, sc["b_gap_open"] / alpha),
                       math.pow(2.0, (sc["b_gap_ext"] - beta) / alpha))


@dataclass
class Read:
    name: str
    seq: str
    read_len: int
    codes: tuple          # strand 0 (input), strand 1 (reverse)
    window_len: int
    min_kmer_pos: int = 0
    initbp: int = -1
    input_strand: int = 0
    paired: bool = False
    first_in_pair: bool = False
    mate: Optional["Read"] = None
    delta_g_off_min: tuple = (0, 0)
    delta_g_off_max: tuple = (0, 0)
    final_unpaired_hits: list = field(default_factory=list)


@dataclass
class Hit:
    """A candidate window, then an alignment (read_hit + sw_full_results)."""
    st: int
    gen_st: int
    cn: int
    g_off: int
    w_len: int
    score_window_gen: int
    kmer_matches: int
    score_vector: int
    score_max: int
    ax: int = 0
    ay: int = 0
    alen: int = 0
    awid: int = 0
    g_off_pos_strand: int = 0
    sort_idx: int = 0
    pct_score_vector: int = 0
    pass1_key: int = 0
    pass2_key: int = 0
    score_full: int = -1
    pct_score_full: int = 0
    sw_score: int = 0
    read_start: int = 0
    genome_start: int = 0
    rmapped: int = 0
    gmapped: int = 0
    matches: int = 0
    mismatches: int = 0
    insertions: int = 0
    deletions: int = 0
    ops: list = field(default_factory=list)
    posterior: float = 0.0
    posterior_score: int = 0
    mqv: int = 255
    z0: float = 0.0
    z1: float = 0.0
    crossovers: int = 0
    dbalign: Optional[str] = None
    qralign: Optional[str] = None
    saved: int = 0
    pair_min: int = -1
    pair_max: int = -1
    z2: float = 0.0
    z3: float = 0.0
    pr_top_random_at_location: float = 1.0
    pr_missed_mp: float = 0.0
    insert_size_denom: float = 0.0


class ExtHeap:
    """Bounded top-k min-heap of DEF_EXTHEAP (common/heap.h:226-318); its
    array order is the order pass 2 walks."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.a: List[Hit] = []

    def insert(self, e: Hit) -> None:
        self.a.append(e)
        node = len(self.a)
        while node > 1 and self.a[node - 1].pass1_key < \
                self.a[node // 2 - 1].pass1_key:
            p = node // 2
            self.a[node - 1], self.a[p - 1] = self.a[p - 1], self.a[node - 1]
            node = p

    def replace_min(self, e: Hit) -> None:
        self.a[0] = e
        node, load = 1, len(self.a)
        while True:
            left, right, mn = node * 2, node * 2 + 1, node
            if left <= load and self.a[left - 1].pass1_key < \
                    self.a[mn - 1].pass1_key:
                mn = left
            if right <= load and self.a[right - 1].pass1_key < \
                    self.a[mn - 1].pass1_key:
                mn = right
            if mn == node:
                return
            self.a[mn - 1], self.a[node - 1] = self.a[node - 1], \
                self.a[mn - 1]
            node = mn


def qv_from_pr_corr(pr_corr: float) -> int:
    """util.h:267-282."""
    pr_err = 1 - pr_corr
    if pr_err > .99999999:
        return 0
    if pr_err < 1e-25:
        return 250
    return int(-10.0 * math.log(pr_err) / math.log(10.0))


def neglog(x: float) -> int:
    """double_to_neglog, util.h:296-300."""
    return int(1000 * -math.log(x))


def dedup(hits: List[Hit], key) -> List[Hit]:
    """read_remove_duplicate_hits (mapping.c:1520-1606): per key group,
    the first hit of the highest pass2_key."""
    order = sorted(range(len(hits)), key=lambda i: key(hits[i]))
    out, i = [], 0
    while i < len(order):
        j, best = i, order[i]
        while j + 1 < len(order) and key(hits[order[j + 1]]) == \
                key(hits[order[i]]):
            j += 1
            if hits[order[j]].pass2_key > hits[best].pass2_key:
                best = order[j]
        out.append(hits[best])
        i = j + 1
    return out


def pass2(hits: List[Hit], fresh=None) -> List[Hit]:
    """read_pass2 (mapping.c:1631-1750) with the default options: a new
    pass-2 key for the hits whose full SW ran this round (`fresh`, every
    hit when None), the threshold, duplicate removal, the top 10."""
    survivors = []
    for h in hits:
        if fresh is None or id(h) in fresh:
            h.pass2_key = h.pct_score_full
        if h.score_full >= abs_or_pct(SW_FULL_THRESHOLD, h.score_max):
            survivors.append(h)
    if len(survivors) > 1:
        survivors = dedup(survivors, lambda h: (h.cn, h.gen_st,
                                                h.genome_start))
        survivors = dedup(survivors, lambda h: (
            h.cn, h.gen_st,
            -h.genome_start - h.rmapped + h.deletions - h.insertions))
        survivors.sort(key=lambda h: -h.pass2_key)
    survivors = survivors[:NUM_OUTPUTS]
    for h in survivors:
        h.saved = 1
    return survivors


def plain_sum(values) -> float:
    """A double accumulated left to right from 0.0, as gmapper adds the
    posteriors into a MAPQ's normaliser (compute_unpaired_mqv,
    output.c:777-793; compute_paired_mqv, output.c:811-942). Not `sum()`:
    since CPython 3.12 it compensates a float sum (Neumaier), which can
    differ from the C loop in the last bit, and one ulp of z1 moves a
    MAPQ near 150."""
    z = 0.0
    for v in values:
        z += v
    return z


def finalize(hits: List[Hit]) -> List[Hit]:
    """Pass 2 and compute_unpaired_mqv (output.c:777-793)."""
    survivors = pass2(hits)
    if survivors:
        z1 = plain_sum(h.posterior for h in survivors)
        for h in survivors:
            h.z0 = h.posterior
            h.z1 = z1
            h.mqv = qv_from_pr_corr(h.posterior / z1)
            if h.mqv < 4:
                h.mqv = 0
    return survivors


# output.c:326-352: upper case, wobble codes -> N
_CLEAN = str.maketrans({ord(c): ("N" if c.upper() in "RYSWKMBDHV"
                                 else c.upper()) for c in map(chr, range(256))})
_COMP = str.maketrans({"A": "T", "T": "A", "C": "G", "G": "C", "N": "N",
                       "a": "t", "t": "a", "c": "g", "g": "c", "n": "n",
                       "-": "-"} | {c: "N" for c in "RYSWKMBDHVryswkmbdhv"})


def _revcomp(s: str) -> str:
    return s[::-1].translate(_COMP)


def cigar(h: Hit, read_len: int) -> list:
    """make_cigar (output.c:15-64): run-length ops, S clips."""
    rs1 = h.read_start + 1
    re1 = rs1 + h.rmapped - 1
    out = [(rs1 - 1, "S")] if rs1 > 1 else []
    opmap = {1: "D", 2: "I", 3: "M"}
    i, ops = 0, h.ops
    while i < len(ops):
        j = i
        while j + 1 < len(ops) and ops[j + 1] == ops[i]:
            j += 1
        out.append((j - i + 1, opmap[int(ops[i])]))
        i = j + 1
    if re1 != read_len:
        out.append((read_len - re1, "S"))
    return out


def render(r: Read, h: Hit, contig: str, contig_len: int,
           mode: str) -> str:
    """One unpaired SAM record without its QNAME (hit_output,
    output.c:227-774, default options)."""
    rev = h.gen_st == 1
    if mode == "ls":
        seq = r.seq.translate(_CLEAN)
    else:
        seq = "".join(c for c in (h.qralign or "") if c != "-").translate(
            _CLEAN)
    if rev:
        seq = _revcomp(seq)
    cig = cigar(h, r.read_len)
    if mode == "cs":
        cig = [(n, "H" if op == "S" else op) for n, op in cig]
    if rev:
        cig = cig[::-1]
    rs1 = h.read_start + 1
    re1 = rs1 + h.rmapped - 1
    if not rev:
        pos = h.genome_start + 1
    else:
        pos = (contig_len - h.genome_start) - (re1 - rs1 - h.deletions
                                               + h.insertions)
    fields = [str(0x10 if rev else 0), contig, str(pos), str(h.mqv),
              "".join(f"{n}{op}" for n, op in cig), "*", "0", "0", seq, "*"]
    line = "\t".join(fields)
    line += f"\tAS:i:{h.score_full}"
    line += f"\tZ0:i:{neglog(h.z0)}\tZ1:i:{neglog(h.z1)}"
    line += f"\tNM:i:{h.mismatches + h.deletions + h.insertions}"
    if mode == "cs":
        line += (f"\tCS:Z:{r.seq}\tCM:i:{h.crossovers}"
                 f"\tXX:Z:{h.qralign}")
    return line
