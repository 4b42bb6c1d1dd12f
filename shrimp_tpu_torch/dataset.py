"""The E. coli-scale workloads of `bench.py` and `bench_all.py`, made from
a seed.

Letter space (`bench.py::get_dataset`): a 4.6 Mbp random genome and
36 bp reads sampled from it with 0-2 substitutions each, every odd read
reverse-complemented. Colour space (`bench_all.py::bench_cs`, the
`ecoli-cs` workload): the same genome bytes, SOLiD reads of a `T` primer
and 36 colours from letters with 0-2 substitutions. Paired
(`ecoli_paired_ls`, bench_all.py's `ecoli-paired` workload): 2x36 bp
opp-in pairs of inserts 120-280 bp over the same genome; in colour
space (`ecoli_paired_cs`, bench_all.py's `ecoli-cs-paired`) 2x36-colour
SOLiD pairs. All are the
generators of those scripts without their on-disk caches. Long reads
(`ecoli_unpaired_ls_long`, no counterpart in the bench scripts): the
same genome, 250 bp reads with substitutions and, in one read of ten,
a short indel; in colour space (`ecoli_unpaired_cs_long`) the same,
on the `ecoli-cs` index. The indexes are built with the port's
`index.build.build_index`.

Human-genome candidate density (`hg_bin`, `hg_reads`, `hg_pairs`):
one bin of bench_hg.py's synthetic genome (seed 20260818, bin 0), a
random sequence with hg-like repeats: SINE-like 300 bp copies on 25 % of
it (5-25 % divergence), 5'-truncated LINE-like fragments on 15 %,
alpha-satellite-like tandem arrays on 5 % and N gaps on 1.5 %; and
bench_hg.py's 36 bp reads (LS or CS rendering) and opp-in pairs drawn
from that one bin. bench_hg.py maps 4 bins of 750 Mbp; the bin length
is the caller's. `edge_bands` draws the band geometries at
which the banded DP kernels take their special cases, for the tests and
`chip_smoke.py`.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from . import constants as C
from .config import MapperConfig
from .core.encode import decode_ls
from .index.build import GenomeIndex, build_index
from .index.seeds import default_seeds
from .io.fasta import SeqRecord

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


def ecoli_unpaired_ls_long(n_reads: int, read_len: int = 250,
                           seed: int = SEED
                           ) -> Tuple[GenomeIndex, List[SeqRecord]]:
    """(index, reads) of the long-read letter-space workload: the genome
    bytes and contig of `ecoli_unpaired_ls` (default seeds), `n_reads`
    reads of `read_len` bp with 0-4 substitutions each; every tenth read
    (k % 10 == 9) also carries an insertion or a deletion of 1-3 bp, so
    that alignments walk real indels; odd reads are reverse-complemented.
    Map with the default `MapperConfig()` (longest read 1000). The reads
    of Illumina 2x250 bp runs, mapped one end at a time with gmapper-ls,
    look like these."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, GENOME_LEN).astype(np.uint8)
    idx = build_index([("ecoli_synth", codes)], default_seeds())
    comp = np.array([3, 2, 1, 0], np.uint8)
    span = read_len + 3
    pos = rng.integers(0, GENOME_LEN - span, n_reads)
    src = codes[pos[:, None] + np.arange(span)[None, :]]
    mat = src[:, :read_len].copy()
    for k in range(9, n_reads, 10):
        d = int(rng.integers(1, 4))
        cut = int(rng.integers(20, read_len - 20))
        if rng.integers(0, 2):      # deletion: skip d genome bases
            mat[k, cut:] = src[k, cut + d:read_len + d]
        else:                       # insertion of d random bases
            mat[k, cut + d:] = src[k, cut:read_len - d]
            mat[k, cut:cut + d] = rng.integers(0, 4, d)
    nmut = rng.integers(0, 5, n_reads)
    for j in range(4):
        rows = np.nonzero(nmut > j)[0]
        mat[rows, rng.integers(0, read_len, len(rows))] = \
            rng.integers(0, 4, len(rows)).astype(np.uint8)
    odd = np.arange(n_reads) % 2 == 1
    mat[odd] = comp[mat[odd, ::-1]]
    seqs = np.frombuffer(b"ACGT", np.uint8)[mat].tobytes().decode()
    reads = [SeqRecord(f"l{k}", seqs[k * read_len:(k + 1) * read_len])
             for k in range(n_reads)]
    return idx, reads


def _to_cs(lets: np.ndarray) -> str:
    """The bench scripts' SOLiD read of READ_LEN + 1 letter codes: a `T`
    primer and READ_LEN colours, the first against the primer's T (a dot
    for a colour past BASE_N)."""
    cm = C.COLOUR_MAT
    cols = [int(cm[3, lets[0]])] + [int(cm[lets[i], lets[i + 1]])
                                    for i in range(READ_LEN - 1)]
    return "T" + "".join(str(c) if c <= 3 else "." for c in cols)


def ecoli_cs_config() -> MapperConfig:
    """The configuration bench_all.py maps the `ecoli-cs` workload with:
    gmapper-cs's defaults."""
    return MapperConfig(mode=C.MODE_COLOUR_SPACE)


def ecoli_unpaired_cs(n_reads: int, seed: int = SEED
                      ) -> Tuple[GenomeIndex, List[SeqRecord]]:
    """(colour-space index, reads) of bench_all.py's `ecoli-cs` workload
    with `n_reads` reads: reads drawn with default_rng(9), 36 colours
    after a `T` primer, 0-2 letter substitutions, forward strand."""
    codes = np.random.default_rng(seed).integers(0, 4, GENOME_LEN).astype(
        np.uint8)
    idx = build_index([("ecoli_synth2", codes)],
                      default_seeds(mode=C.MODE_COLOUR_SPACE),
                      mode=C.MODE_COLOUR_SPACE)
    rng = np.random.default_rng(9)
    reads = []
    for k in range(n_reads):
        p = int(rng.integers(0, len(codes) - READ_LEN - 1))
        lets = codes[p:p + READ_LEN + 1].copy()
        for _ in range(int(rng.integers(0, 3))):
            lets[int(rng.integers(READ_LEN + 1))] = rng.integers(4)
        reads.append(SeqRecord(f"c{k}", _to_cs(lets)))
    return idx, reads


def ecoli_unpaired_cs_long(n_reads: int, read_len: int = 250,
                           seed: int = SEED
                           ) -> Tuple[GenomeIndex, List[SeqRecord]]:
    """(colour-space index, reads) of the long-read colour-space workload:
    the genome and index of `ecoli_unpaired_cs`, `n_reads` SOLiD reads of
    a `T` primer and `read_len` colours, from letters with 0-4
    substitutions; every tenth read (k % 10 == 9) also carries an
    insertion or a deletion of 1-3 bp, and odd reads come from the
    reverse strand. Map with `MapperConfig(mode="cs")` and a
    `longest_read_len` of at least `read_len` (the default, 1000, takes
    reads up to 1000 colours): windows of G = 352 at 250 colours, 1408
    at 1000."""
    codes = np.random.default_rng(seed).integers(0, 4, GENOME_LEN).astype(
        np.uint8)
    idx = build_index([("ecoli_synth2", codes)],
                      default_seeds(mode=C.MODE_COLOUR_SPACE),
                      mode=C.MODE_COLOUR_SPACE)
    rng = np.random.default_rng(seed + read_len)
    span = read_len + 3
    pos = rng.integers(0, GENOME_LEN - span, n_reads)
    src = codes[pos[:, None] + np.arange(span)[None, :]]
    lets = src[:, :read_len].copy()
    for k in range(9, n_reads, 10):
        d = int(rng.integers(1, 4))
        cut = int(rng.integers(20, read_len - 20))
        if rng.integers(0, 2):      # deletion: skip d genome bases
            lets[k, cut:] = src[k, cut + d:read_len + d]
        else:                       # insertion of d random bases
            lets[k, cut + d:] = src[k, cut:read_len - d]
            lets[k, cut:cut + d] = rng.integers(0, 4, d)
    nmut = rng.integers(0, 5, n_reads)
    for j in range(4):
        rows = np.nonzero(nmut > j)[0]
        lets[rows, rng.integers(0, read_len, len(rows))] = \
            rng.integers(0, 4, len(rows)).astype(np.uint8)
    odd = np.arange(n_reads) % 2 == 1
    lets[odd] = 3 - lets[odd, ::-1]
    cm = C.COLOUR_MAT
    cols = np.concatenate([cm[3, lets[:, :1]], cm[lets[:, :-1], lets[:, 1:]]],
                          axis=1)
    text = np.frombuffer(b"0123", np.uint8)[cols].tobytes().decode()
    reads = [SeqRecord(f"c{k}", "T" + text[k * read_len:(k + 1) * read_len])
             for k in range(n_reads)]
    return idx, reads


EDGE_KINDS = 6


def edge_bands(rng: np.random.Generator, n: int, G: int, R: int) -> dict:
    """Band geometry (int32 glen, ax, ay, alen, awid [n]) of n (window,
    read) pairs of G columns and R rows at the edges of the anchor band
    (anchor_get_x_range clipped to [0, glen - 1]), cycling through
    EDGE_KINDS kinds: (0) ax >= glen, the band clips to the last column;
    (1) ax + awid < 0, it clips to column 0; (2) the flow's pad rows,
    glen = alen = awid = 1; (3) awid = 1 along the diagonal; (4) a short
    narrow anchor, so the band jumps at the anchor's end to reach
    glen - 1; (5) glen = 1 under a wide anchor."""
    kind = np.arange(n) % EDGE_KINDS
    glen = rng.integers(max(1, G // 2), G + 1, n)
    awid = rng.integers(1, 12, n)
    alen = rng.integers(1, max(2, R // 2), n)
    ay = rng.integers(-4, R, n)
    ax = rng.integers(0, G, n)

    def pick(k):
        return np.nonzero(kind == k)[0]
    k = pick(0)
    ax[k] = glen[k] + rng.integers(0, 8, len(k))
    k = pick(1)
    ax[k] = -awid[k] - rng.integers(1, 8, len(k))
    k = pick(2)
    glen[k] = alen[k] = awid[k] = 1
    ax[k] = ay[k] = 0
    k = pick(3)
    awid[k] = 1
    ay[k] = rng.integers(0, max(1, R // 2), len(k))
    ax[k] = (rng.random(len(k)) * np.maximum(glen[k] - alen[k], 1)).astype(
        ax.dtype)
    k = pick(4)
    awid[k] = 2
    alen[k] = rng.integers(1, 9, len(k))
    ay[k] = rng.integers(R // 4, R // 2 + 1, len(k))
    ax[k] = rng.integers(0, max(1, G // 4), len(k))
    k = pick(5)
    glen[k] = 1
    awid[k] = rng.integers(8, 30, len(k))
    return {name: v.astype(np.int32) for name, v in
            (("glen", glen), ("ax", ax), ("ay", ay), ("alen", alen),
             ("awid", awid))}


def bands(a: dict, R: int) -> tuple:
    """The band [x_min, x_max] of rows 0 .. R - 1 of the pairs whose
    geometry `a` holds (numpy glen, ax, ay, alen, awid [n]), as the DP
    kernels compute it (anchor_get_x_range clipped to [0, glen - 1]): two
    int64 [n, R]."""
    i = np.arange(R)[None, :]
    ax, ay, alen, awid, glen = (np.asarray(a[k], np.int64)[:, None] for k in
                                ("ax", "ay", "alen", "awid", "glen"))
    x_min = np.where(i < ay, 0, np.where(i <= ay + alen - 1, ax + (i - ay),
                                         ax + alen))
    ay2 = ay - (awid - 1)
    x_max = np.where(i < ay2, ax + awid - 2,
                     np.where(i <= ay2 + alen - 1, ax + (awid - 1) + (i - ay2),
                              glen - 1))
    return (np.minimum(np.maximum(x_min, 0), glen - 1),
            np.minimum(np.maximum(x_max, 0), glen - 1))


def long_gaps(rng: np.random.Generator, genome: np.ndarray, R: int) -> dict:
    """Reads and band geometry (uint8 read [n, R]; int32 glen, rlen, ax,
    ay, alen, awid [n]) for the windows `genome` [n, G], G >= R + 35 and
    R >= 64: each read is copied from its window with two substitutions
    and one gap of 33 to 120 columns, so that a traceback walk runs a long
    straight stretch. Odd rows miss window bases (a run of W moves,
    insertions in the walk's ops; the gap is at most G - R - 1), even
    rows carry extra read bases (N moves, deletions; the gap is at most
    3R/4 - 1). The anchor starts at the read's first base and the band is
    wide enough to hold the gap."""
    n, G = genome.shape
    read = rng.integers(0, 4, (n, R)).astype(np.uint8)
    geo = {k: np.zeros(n, np.int32) for k in
           ("glen", "rlen", "ax", "ay", "alen", "awid")}
    for k in range(n):
        odd = k % 2 == 1
        room = G - R if odd else R - R // 4
        gap = int(rng.integers(33, max(34, min(121, room))))
        # the first `cut` read bases follow the window from o; the rest
        # follow it from o + cut + gap (odd), or from o + cut after gap
        # extra read bases (even)
        cut_hi = 3 * R // 4 if odd else R - gap - R // 8
        cut = int(rng.integers(R // 8, max(R // 8 + 1, cut_hi)))
        o = int(rng.integers(0, max(1, G - R - gap)))
        g = genome[k]
        read[k, :cut] = g[o:o + cut]
        if odd:
            m = min(R - cut, G - (o + cut + gap))
            read[k, cut:cut + m] = g[o + cut + gap:o + cut + gap + m]
        else:
            read[k, cut + gap:] = g[o + cut:o + R - gap]
        read[k, rng.integers(0, R, 2)] = rng.integers(0, 4, 2)
        for name, v in (("glen", G), ("rlen", R), ("ax", o), ("ay", 0),
                        ("alen", max(1, cut // 2)), ("awid", gap + 40)):
            geo[name][k] = v
    return dict(read=read, **geo)


def length_edges(rng: np.random.Generator, glen: np.ndarray,
                 rlen: np.ndarray, G: int, R: int) -> None:
    """Give a sixteenth of the (window, read) pairs each length edge of
    the vector SW, in place in the int32 arrays glen and rlen [n]:
    glen = 1, glen = G, rlen = 1, and glen = G with rlen = R."""
    k = rng.permutation(len(glen))[:4 * (len(glen) // 16)].reshape(4, -1)
    glen[k[0]] = 1
    glen[k[1]] = G
    rlen[k[2]] = 1
    glen[k[3]], rlen[k[3]] = G, R


def cs_walk_pairs(rng: np.random.Generator, B: int, R: int, G: int) -> dict:
    """Colour-space traceback inputs whose walks reach the edges (uint8
    genome [B, G] and qr [B, 4, R]; int16 bp [B, R, 4, G]; int32 best, bi,
    bj, bk, bfrm, thresh [B]): random backpointers, mostly diagonal codes
    with now and then a gap, a layer switch or a stop, so walks wander off
    the diagonal; best cells at the last row and column for a quarter of
    the pairs and left of column R / 2 for another (walks that end at
    column 0); start layers other than 0 and layer switches (the leading
    crossover); bfrm = 0 in every sixteenth pair; scores below thresh;
    BASE_N cells."""
    g = rng.integers(0, 4, (B, G)).astype(np.uint8)
    qr = rng.integers(0, 4, (B, 4, R)).astype(np.uint8)
    g[rng.random((B, G)) < 0.02] = C.BASE_N
    qr[rng.random((B, 4, R)) < 0.02] = C.BASE_N
    code = rng.choice(8, size=(B, R, 4, G, 3),
                      p=[0.005, 0.06, 0.06, 0.06, 0.06, 0.5, 0.205, 0.05])
    lyr = rng.choice(4, size=(B, R, 4, G, 3), p=[0.91, 0.03, 0.03, 0.03])
    f = code << 2 | lyr
    bp = (f[..., 0] | f[..., 1] << 5 | f[..., 2] << 10).astype(np.int16)
    bi = rng.integers(0, R, B)
    bj = rng.integers(0, G, B)
    q = B // 4
    bi[:q], bj[:q] = R - 1, G - 1
    bj[q:2 * q] = rng.integers(0, max(1, R // 2), q)
    bfrm = rng.integers(1, 8, B) << 2 | rng.integers(0, 4, B)
    bfrm[::16] = 0
    i32 = {k: v.astype(np.int32) for k, v in dict(
        best=rng.integers(1, 400, B), bi=bi, bj=bj,
        bk=rng.integers(0, 4, B), bfrm=bfrm,
        thresh=rng.integers(0, 100, B)).items()}
    return dict(genome=g, qr=qr, bp=bp, **i32)


def ecoli_paired_ls(n_reads: int, seed: int = SEED
                    ) -> Tuple[GenomeIndex, List[SeqRecord]]:
    """(index, reads) of bench_all.py's `ecoli-paired` workload with
    `n_reads` reads (n_reads // 2 interleaved opp-in pairs): the genome
    of `ecoli_unpaired_ls` as contig `ecoli_synth2`, pairs from
    default_rng(8), inserts of 120-280 bp, mate 2 reverse-complemented,
    0-2 substitutions a mate. Map with MapperConfig(pair_mode="opp-in")
    through a paired.PairedMapper."""
    codes = np.random.default_rng(seed).integers(0, 4, GENOME_LEN).astype(
        np.uint8)
    idx = build_index([("ecoli_synth2", codes)], default_seeds())
    comp = np.array([3, 2, 1, 0], np.uint8)
    rng = np.random.default_rng(8)
    reads = []
    for k in range(n_reads // 2):
        isz = int(rng.integers(120, 280))
        p = int(rng.integers(0, len(codes) - isz - READ_LEN))
        a = codes[p:p + READ_LEN].copy()
        b = comp[codes[p + isz - READ_LEN:p + isz][::-1]].copy()
        for r in (a, b):
            for _ in range(int(rng.integers(0, 3))):
                r[int(rng.integers(READ_LEN))] = rng.integers(4)
        reads.append(SeqRecord(f"p{k}/1", decode_ls(a)))
        reads.append(SeqRecord(f"p{k}/2", decode_ls(b)))
    return idx, reads


def ecoli_paired_cs(n_reads: int, seed: int = SEED
                    ) -> Tuple[GenomeIndex, List[SeqRecord]]:
    """(colour-space index, reads) of bench_all.py's `ecoli-cs-paired`
    workload (`bench_cs_paired`) with `n_reads` reads (n_reads // 2
    interleaved opp-in pairs): the genome of `ecoli_unpaired_cs`, pairs
    from default_rng(11), inserts of 120-280 bp, 36 colours a mate after
    a `T` primer, mate 2 reverse-complemented, 0-2 letter substitutions
    a mate. Map with MapperConfig(mode="cs", pair_mode="opp-in") through
    a paired.PairedMapper."""
    codes = np.random.default_rng(seed).integers(0, 4, GENOME_LEN).astype(
        np.uint8)
    idx = build_index([("ecoli_synth2", codes)],
                      default_seeds(mode=C.MODE_COLOUR_SPACE),
                      mode=C.MODE_COLOUR_SPACE)
    comp = np.array([3, 2, 1, 0], np.uint8)
    rng = np.random.default_rng(11)
    reads = []
    for k in range(n_reads // 2):
        isz = int(rng.integers(120, 280))
        p = int(rng.integers(0, len(codes) - isz - READ_LEN - 1))
        a = codes[p:p + READ_LEN + 1].copy()
        b = comp[codes[p + isz - READ_LEN - 1:p + isz][::-1]].copy()
        for r in (a, b):
            for _ in range(int(rng.integers(0, 3))):
                r[int(rng.integers(READ_LEN + 1))] = rng.integers(4)
        reads.append(SeqRecord(f"q{k}/1", _to_cs(a)))
        reads.append(SeqRecord(f"q{k}/2", _to_cs(b)))
    return idx, reads


HG_SEED = 20260818
# bench_hg.py's complement LUT: codes 0-3 complement, BASE_N maps to
# itself
_HG_COMP = np.arange(16, dtype=np.uint8)
_HG_COMP[:4] = [3, 2, 1, 0]


def _mutate_copies(rng, copies: np.ndarray, div: np.ndarray) -> None:
    """Per-copy point mutation at per-row divergence rates (in place)."""
    n, L = copies.shape
    for off in range(0, n, 100_000):      # bound the float mask's memory
        end = min(off + 100_000, n)
        mask = rng.random((end - off, L)) < div[off:end, None]
        copies[off:end][mask] = rng.integers(
            0, 4, int(mask.sum()), dtype=np.int64).astype(np.uint8)


def hg_bin(slen: int, i: int = 0) -> np.ndarray:
    """Bin `i` (`slen` bases, uint8 codes) of bench_hg.py's synthetic
    genome (bench_hg.shard_codes without its on-disk cache): the repeat
    library is shared across bins, the copies and their mutations are
    the bin's own."""
    lib = np.random.default_rng(HG_SEED)     # shared library
    sine = lib.integers(0, 4, 300, dtype=np.int64).astype(np.uint8)
    line = lib.integers(0, 4, 6000, dtype=np.int64).astype(np.uint8)
    sat = lib.integers(0, 4, 171, dtype=np.int64).astype(np.uint8)
    rng = np.random.default_rng(HG_SEED + 1000 + i)
    codes = rng.integers(0, 4, slen, dtype=np.int64).astype(np.uint8)
    # SINE-like: ~25% of bases, 300 bp copies, 5-25% divergence
    n_sine = int(0.25 * slen) // 300
    starts = rng.integers(0, slen - 300, n_sine)
    copies = np.tile(sine, (n_sine, 1))
    _mutate_copies(rng, copies, rng.uniform(0.05, 0.25, n_sine))
    pos = starts[:, None] + np.arange(300)[None, :]
    codes[pos.ravel()] = copies.ravel()
    del copies, pos
    # LINE-like: ~15% of bases, 5'-truncated 0.5-6 kb fragments, 5-20%
    # divergence
    budget = int(0.15 * slen)
    while budget > 0:
        L = int(rng.integers(500, 6001))
        s = int(rng.integers(0, slen - L))
        frag = line[-L:].copy()
        d = float(rng.uniform(0.05, 0.20))
        m = rng.random(L) < d
        frag[m] = rng.integers(0, 4, int(m.sum()),
                               dtype=np.int64).astype(np.uint8)
        codes[s:s + L] = frag
        budget -= L
    # alpha-satellite-like tandem arrays: ~5%, 10-200 kb, 1-3%
    # divergence
    budget = int(0.05 * slen)
    while budget > 0:
        L = int(rng.integers(10_000, 200_001))
        s = int(rng.integers(0, slen - L))
        reps = -(-L // len(sat))
        arr = np.tile(sat, reps)[:L].copy()
        d = float(rng.uniform(0.01, 0.03))
        m = rng.random(L) < d
        arr[m] = rng.integers(0, 4, int(m.sum()),
                              dtype=np.int64).astype(np.uint8)
        codes[s:s + L] = arr
        budget -= L
    # N gaps: ~1.5% in 20 blocks
    budget = int(0.015 * slen)
    for _ in range(20):
        L = budget // 20
        s = int(rng.integers(0, slen - L))
        codes[s:s + L] = C.BASE_N
    return codes


def _hg_render(mode: str, r: np.ndarray) -> str:
    """bench_hg.py's rendering of a read: letters, or (colour space) a
    `T` primer and the colours of its letters."""
    if mode == C.MODE_COLOUR_SPACE:
        return _to_cs(r)
    return decode_ls(r)


def hg_reads(codes: np.ndarray, n_reads: int, mode: str = "ls"
             ) -> List[SeqRecord]:
    """bench_hg.py's gen_reads on one bin: 36 bp reads (37 letters in
    colour space), 0-2 errors, odd reads reverse-complemented, resampled
    out of N gaps."""
    slen = len(codes)
    rng = np.random.default_rng(HG_SEED)
    plen = READ_LEN + (1 if mode == C.MODE_COLOUR_SPACE else 0)
    picks = []
    for k in range(n_reads):
        picks.append((int(rng.integers(0, slen - plen - 1)), k % 2 == 1,
                      [(int(rng.integers(plen)), int(rng.integers(4)))
                       for _ in range(int(rng.integers(0, 3)))]))
    recs = []
    for k, (p, rc, errs) in enumerate(picks):
        r = codes[p:p + plen].copy()
        while (r == C.BASE_N).any():     # resample out of N gaps
            p = int(rng.integers(0, slen - plen - 1))
            r = codes[p:p + plen].copy()
        if rc:
            r = _HG_COMP[r[::-1]]
        for pos, b in errs:
            r[pos] = b
        recs.append(SeqRecord(f"q{k}", _hg_render(mode, r)))
    return recs


def hg_pairs(codes: np.ndarray, n_reads: int, mode: str = "ls"
             ) -> List[SeqRecord]:
    """bench_hg.py's gen_pairs on one bin: n_reads // 2 opp-in pairs
    (interleaved), inserts of 100-300 bp, 0-2 errors a mate, resampled
    out of N gaps. Map with MapperConfig(pair_mode="opp-in",
    min_insert_size=0, max_insert_size=1000), as bench_hg.py does."""
    slen = len(codes)
    rng = np.random.default_rng(HG_SEED + 77)
    plen = READ_LEN + (1 if mode == C.MODE_COLOUR_SPACE else 0)
    picks = []
    for k in range(n_reads // 2):
        isz = int(rng.integers(100, 300))
        picks.append((int(rng.integers(0, slen - isz - 2)), isz,
                      [(int(rng.integers(plen)), int(rng.integers(4)))
                       for _ in range(int(rng.integers(0, 3)))],
                      [(int(rng.integers(plen)), int(rng.integers(4)))
                       for _ in range(int(rng.integers(0, 3)))]))
    recs = []
    for k, (p, isz, e1, e2) in enumerate(picks):
        r1 = codes[p:p + plen].copy()
        r2 = _HG_COMP[codes[p + isz - plen:p + isz][::-1]].copy()
        while (r1 == C.BASE_N).any() or (r2 == C.BASE_N).any():
            p = int(rng.integers(0, slen - isz - 2))
            r1 = codes[p:p + plen].copy()
            r2 = _HG_COMP[codes[p + isz - plen:p + isz][::-1]].copy()
        for pos, b in e1:
            r1[pos] = b
        for pos, b in e2:
            r2[pos] = b
        recs.append(SeqRecord(f"q{k}/1", _hg_render(mode, r1)))
        recs.append(SeqRecord(f"q{k}/2", _hg_render(mode, r2)))
    return recs


def hg_index(codes: np.ndarray, mode: str = "ls") -> GenomeIndex:
    """The index of one hg-like bin, contig `chr1`, as bench_hg.py
    builds bin 0's."""
    return build_index([("chr1", codes)], default_seeds(mode=mode),
                       mode=mode)
