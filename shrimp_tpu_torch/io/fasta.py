"""FASTA/FASTQ reading (plain or gzip), format autodetection.

Behavioral reference: common/fasta.c (fasta_open autodetect at :96-125,
record parsing fasta_get_next_read_with_range). Host-side input pipeline
for the TPU mapper; parsing stays simple and streaming.

Copied from `shrimp_tpu/io/fasta.py` unchanged: the port keeps its own
copy of the JAX package's host modules and imports none of them.
"""
from __future__ import annotations

import gzip
import io
import os
from dataclasses import dataclass
from typing import Iterator, Optional, TextIO


@dataclass
class SeqRecord:
    name: str
    seq: str
    qual: Optional[str] = None


def _open_text(path: str) -> TextIO:
    if path == "-":
        import sys
        return sys.stdin
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return io.TextIOWrapper(gzip.GzipFile(fileobj=f))
    return io.TextIOWrapper(f)


def detect_fastq(path: str) -> bool:
    """Autodetect fastq by the first non-comment char (fasta.c:96-125)."""
    with _open_text(path) as fh:
        for line in fh:
            if not line.strip():
                continue
            if line[0] in "#;":
                continue
            return line[0] == "@"
    return False


def read_fasta(path: str) -> Iterator[SeqRecord]:
    name = None
    chunks = []
    with _open_text(path) as fh:
        for line in fh:
            line = line.rstrip("\n").rstrip("\r")
            if not line or line[0] in "#;":
                continue
            if line[0] == ">":
                if name is not None:
                    yield SeqRecord(name, "".join(chunks))
                # name = first whitespace-delimited token after '>'
                name = line[1:].strip().split()[0] if line[1:].strip() else ""
                chunks = []
            else:
                chunks.append(line.strip())
        if name is not None:
            yield SeqRecord(name, "".join(chunks))


def read_fastq(path: str) -> Iterator[SeqRecord]:
    with _open_text(path) as fh:
        while True:
            hdr = fh.readline()
            if not hdr:
                return
            hdr = hdr.rstrip("\n")
            if not hdr.strip() or hdr[0] in "#;":
                continue
            if hdr[0] != "@":
                raise ValueError(f"bad fastq header line: {hdr!r}")
            seq = fh.readline().rstrip("\n")
            plus = fh.readline()
            if not plus.startswith("+"):
                raise ValueError("bad fastq record: missing '+' line")
            qual = fh.readline().rstrip("\n")
            name = hdr[1:].strip().split()[0] if hdr[1:].strip() else ""
            yield SeqRecord(name, seq, qual)


def read_seqs(path: str, fastq: Optional[bool] = None) -> Iterator[SeqRecord]:
    if fastq is None:
        fastq = detect_fastq(path)
    return read_fastq(path) if fastq else read_fasta(path)
