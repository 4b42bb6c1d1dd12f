"""Offline sharding workflow: split-db / split-reads / project-db.

Recreates the reference's cluster workflow scripts (utils/split-db.py,
utils/splitreads.py, utils/project-db.py; README:236-352): bin-pack whole
contigs into RAM-budget chunks (contigs are never split, README:158-166),
split read files on read/pair boundaries, and pre-build one saved index
per genome chunk. The per-chunk SAM outputs recombine exactly with
`shrimp_tpu merge` (mergesam semantics) or on-device with
parallel.meshmap.ShardedIndexMapper.

Copied from `shrimp_tpu/tools/split.py` unchanged: the port keeps its own
copy of the JAX package's host modules and imports none of them.
"""
from __future__ import annotations

import os
import sys
from typing import List, Optional, Tuple

from ..io.fasta import read_fasta, read_seqs


def index_ram_bytes(genome_len: int, n_seeds: int, weight: int,
                    colour_space: bool = False) -> int:
    """RAM model for an index over a genome of `genome_len` bases
    (README:128-150) — the SAME model the runtime memory cap uses
    (utils/memmodel.plan_index_ram), so `split-db --ram-size G` chunks
    are guaranteed to build under a `--max-mem G` cap."""
    from ..utils.memmodel import plan_index_ram
    return plan_index_ram(genome_len, n_seeds, weight, colour_space)


def split_contig_pieces(name: str, seq: str, piece_len: int,
                        overlap: int) -> List[Tuple[str, str]]:
    """Split one contig into overlapping pieces named `name/OFFSET`.

    Goes BEYOND the reference, which never splits contigs and documents
    the resulting lost mappings as a limitation (README:158-166,
    TODO:3 "Split mapping mode"). Consecutive pieces overlap by
    `overlap` bases, so any candidate window shorter than the overlap
    lies fully inside at least one piece; `shrimp_tpu merge` rebases
    `name/OFFSET` records back to `name` and deduplicates alignments
    duplicated inside the halos (with exact z-statistic correction).
    """
    if len(seq) <= piece_len:
        return [(name, seq)]
    if overlap >= piece_len:
        raise ValueError("overlap must be smaller than the piece length")
    pieces = []
    step = piece_len - overlap
    off = 0
    while True:
        piece = seq[off:off + piece_len]
        pieces.append((f"{name}/{off}", piece))
        if off + piece_len >= len(seq):
            break
        off += step
    return pieces


def split_db(genome_files: List[str], ram_size_gb: float, prefix: str,
             n_seeds: int = 4, weight: int = 12,
             max_contig_len: int = 0, contig_overlap: int = 2000,
             colour_space: bool = False,
             out=sys.stderr) -> List[str]:
    """Greedy in-order bin-packing of whole contigs into chunk fasta
    files sized so each chunk's index fits in `ram_size_gb`
    (utils/split-db.py semantics).

    With `max_contig_len` > 0, contigs longer than that are split into
    `name/OFFSET` pieces overlapping by `contig_overlap` bases first
    (see split_contig_pieces) — a capability the reference lacks."""
    budget = int(ram_size_gb * (1 << 30))
    fixed = index_ram_bytes(0, n_seeds, weight, colour_space)
    chunk_paths: List[str] = []
    cur_len = 0
    cur_f = None

    def open_chunk():
        path = f"{prefix}-{len(chunk_paths):04d}.fa"
        chunk_paths.append(path)
        return open(path, "w")

    def records():
        for path in genome_files:
            for rec in read_fasta(path):
                if max_contig_len and len(rec.seq) > max_contig_len:
                    yield from split_contig_pieces(
                        rec.name, rec.seq, max_contig_len, contig_overlap)
                else:
                    yield rec.name, rec.seq

    for name, seq in records():
        cost = index_ram_bytes(len(seq), n_seeds, weight,
                               colour_space) - fixed
        if cur_f is None or (cur_len and
                             fixed + cur_len + cost > budget):
            if cur_f:
                cur_f.close()
            cur_f = open_chunk()
            cur_len = 0
        if fixed + cost > budget and cur_len == 0:
            print(f"warning: contig {name} alone exceeds the "
                  f"RAM budget; emitting it as its own chunk",
                  file=out)
        cur_f.write(f">{name}\n")
        for i in range(0, len(seq), 70):
            cur_f.write(seq[i:i + 70] + "\n")
        cur_len += cost
    if cur_f:
        cur_f.close()
    print(f"split into {len(chunk_paths)} chunk(s)", file=out)
    return chunk_paths


def split_contigs(contigs: List[Tuple[str, int]], target_ram_gb: float,
                  seed_weights: Optional[List[int]] = None,
                  out=sys.stderr) -> List[List[Tuple[str, int]]]:
    """Balanced contig->chunk assignment (utils/split-contigs.c).

    Unlike split_db's in-order packing, this sorts contigs by size
    descending, first-fit packs them into chunks bounded by the
    RAM-model target length (split-contigs.c:90-122), then rebalances by
    shrinking the target in 0.1% steps while the chunk count holds
    (split-contigs.c:215-243). Returns the per-chunk [(name, size)]
    lists in chunk order.
    """
    weights = seed_weights or [12, 12, 12]
    n_seeds = len(weights)
    overhead = 1.5                                 # GB, split-contigs.c:32
    index_gb = sum((1 << (2 * w)) * 12 / (1 << 30) for w in weights)
    if target_ram_gb < overhead + index_gb:
        raise ValueError("not enough memory for current settings")
    target_len = int((target_ram_gb - overhead - index_gb) / n_seeds
                     * (1 << 30)) // 4
    order = sorted(contigs, key=lambda c: -c[1])
    if order and order[0][1] > target_len:
        raise ValueError(
            f"the largest contig [{order[0][0]},{order[0][1]}] does not "
            "fit in target memory")

    def greedy_fit(tlen: int) -> List[int]:
        """Repeated first-fit passes (split-contigs.c:90-122)."""
        chunk = [-1] * len(order)
        n_chunks = 0
        while True:
            try:
                i0 = chunk.index(-1)
            except ValueError:
                break
            n_chunks += 1
            chunk[i0] = n_chunks - 1
            tmp = order[i0][1]
            for i in range(i0 + 1, len(order)):
                if chunk[i] < 0 and tmp + order[i][1] < tlen:
                    chunk[i] = n_chunks - 1
                    tmp += order[i][1]
        return chunk

    assign = greedy_fit(target_len)
    target_chunks = max(assign) + 1 if assign else 0
    if target_chunks > 1:
        while True:
            try_len = target_len
            ok = False
            for _ in range(10):
                try_len -= target_len // 1000
                if try_len < order[0][1]:
                    break
                a = greedy_fit(try_len)
                if max(a) + 1 <= target_chunks:
                    target_chunks = max(a) + 1
                    ok = True
                    break
            if not ok:
                break
            target_len = try_len
    assign = greedy_fit(target_len)
    n = max(assign) + 1 if assign else 0
    chunks: List[List[Tuple[str, int]]] = [[] for _ in range(n)]
    for (name, size), c in zip(order, assign):
        chunks[c].append((name, size))
    for i, ch in enumerate(chunks):
        print(f"chunk {i + 1}: {sum(s for _, s in ch)}", file=out)
    return chunks


def temp_sink(dest_path: str, src=None, block_size: int = 1 << 20,
              out=sys.stderr) -> int:
    """Buffer a stream into a temp file, then flush it to `dest_path`
    once the input is complete (utils/temp-sink.c): lets a pipeline
    safely overwrite a file that is also one of its inputs. Returns the
    byte count."""
    import shutil
    import tempfile
    src = src if src is not None else sys.stdin.buffer
    total = 0
    with tempfile.TemporaryFile() as tmp:
        while True:
            block = src.read(block_size)
            if not block:
                break
            tmp.write(block)
            total += len(block)
        tmp.seek(0)
        with open(dest_path, "wb") as dest:
            shutil.copyfileobj(tmp, dest, block_size)
    print(f"temp-sink: {total} bytes -> {dest_path}", file=out)
    return total


def split_reads(reads_file: str, n_chunks: int, prefix: str,
                paired: bool = False, fastq: Optional[bool] = None,
                out=sys.stderr) -> List[str]:
    """Split a read file into `n_chunks` round-sized pieces on read (or
    pair) boundaries (utils/splitreads.py)."""
    recs = list(read_seqs(reads_file, fastq=fastq))
    unit = 2 if paired else 1
    n_units = (len(recs) + unit - 1) // unit
    per = (n_units + n_chunks - 1) // n_chunks
    paths = []
    for c in range(n_chunks):
        lo, hi = c * per * unit, min((c + 1) * per * unit, len(recs))
        if lo >= hi:
            break
        path = f"{prefix}-{c:04d}" + (".fq" if recs[0].qual else ".fa")
        paths.append(path)
        with open(path, "w") as f:
            for r in recs[lo:hi]:
                if r.qual is not None:
                    f.write(f"@{r.name}\n{r.seq}\n+\n{r.qual}\n")
                else:
                    f.write(f">{r.name}\n{r.seq}\n")
    print(f"split {len(recs)} reads into {len(paths)} chunk(s)", file=out)
    return paths


def fasta2fastq(fasta_path: str, qual_path: str, out) -> int:
    """fasta + qual -> fastq (mergesam/fasta2fastq.c). Quality files hold
    space-separated numeric QVs per record."""
    seqs = list(read_fasta(fasta_path))
    quals: List[Tuple[str, List[int]]] = []
    name, vals = None, []
    with open(qual_path) as f:
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                if name is not None:
                    quals.append((name, vals))
                name, vals = line[1:].split()[0], []
            elif line:
                vals.extend(int(x) for x in line.split())
    if name is not None:
        quals.append((name, vals))
    qd = dict(quals)
    n = 0
    for rec in seqs:
        q = qd.get(rec.name)
        if q is None or len(q) != len(rec.seq):
            print(f"warning: no matching quality for {rec.name}",
                  file=sys.stderr)
            continue
        out.write(f"@{rec.name}\n{rec.seq}\n+\n"
                  + "".join(chr(33 + min(v, 93)) for v in q) + "\n")
        n += 1
    return n


def lineindex(path: str, out) -> int:
    """Byte offset of every line (mergesam/lineindex.c)."""
    n = 0
    off = 0
    with open(path, "rb") as f:
        for line in f:
            out.write(f"{off}\n")
            off += len(line)
            n += 1
    return n
