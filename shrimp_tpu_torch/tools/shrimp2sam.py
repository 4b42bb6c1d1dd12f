"""shrimp2sam: legacy SHRiMP-format output -> SAM converter
(shrimp2sam/shrimp2sam.c; line grammar common/output.c:273-352, edit
string grammar README:1550-1565, parser common/input.c:58).

Copied from `shrimp_tpu/tools/shrimp2sam.py` unchanged: the port keeps its own
copy of the JAX package's host modules and imports none of them.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Optional, TextIO, Tuple

_COMP = str.maketrans("ACGTUacgtu", "TGCAAtgcaa")


def _revcomp(s: str) -> str:
    return s.translate(_COMP)[::-1]


def parse_edit_string(edit: str) -> List[Tuple[str, int]]:
    """Edit string -> [(op, n)] with ops M (match/mismatch), I (letters in
    the read only), D (reference letters missing from the read)."""
    ops: List[Tuple[str, int]] = []

    def push(op: str, n: int) -> None:
        if n == 0:
            return
        if ops and ops[-1][0] == op:
            ops[-1] = (op, ops[-1][1] + n)
        else:
            ops.append((op, n))

    i = 0
    while i < len(edit):
        c = edit[i]
        if c.isdigit():
            j = i
            while j < len(edit) and edit[j].isdigit():
                j += 1
            push("M", int(edit[i:j]))
            i = j
        elif c == "(":
            j = edit.index(")", i)
            push("I", j - i - 1)
            i = j + 1
        elif c == "-":
            push("D", 1)
            i += 1
        elif c == "x":
            i += 1                    # crossover: no alignment step
        else:
            push("M", 1)              # mismatch letter
            i += 1
    return ops


def edit_to_cigar(edit: str, read_start: int, read_end: int,
                  read_len: int, reverse: bool) -> Tuple[str, int]:
    """CIGAR string + NM from a SHRiMP edit string and 1-based read
    bounds; soft-clips outside [read_start, read_end], flipped for the
    reverse strand (make_cigar, gmapper/output.c:16-66)."""
    ops = parse_edit_string(edit)
    nm = 0
    i = 0
    # NM: count non-match columns
    for op, n in ops:
        if op in ("I", "D"):
            nm += n
    for ch in edit:
        if ch in "ACGTUNacgtun":
            nm += 1
    pre = read_start - 1
    post = read_len - read_end
    if reverse:
        pre, post = post, pre
    parts = []
    if pre:
        parts.append(f"{pre}S")
    for op, n in ops:
        parts.append(f"{n}{op}")
    if post:
        parts.append(f"{post}S")
    return "".join(parts) or "*", nm


def shrimp2sam(shrimp_lines: TextIO, reads: Dict[str, str], out: TextIO,
               contig_lengths: Optional[Dict[str, int]] = None) -> int:
    """Convert SHRiMP-format hit lines to SAM records. `reads` maps read
    name -> sequence (letter space); unknown reads emit SEQ *."""
    n = 0
    header_done = False
    for line in shrimp_lines:
        line = line.rstrip("\n")
        if not line or line.startswith("#"):
            continue
        if not line.startswith(">"):
            continue
        f = line.split("\t")
        name = f[0][1:]
        contig, strand = f[1], f[2]
        g_start, g_end = int(f[3]), int(f[4])
        r_start, r_end = int(f[5]), int(f[6])
        read_len, score, edit = int(f[7]), int(f[8]), f[9]
        if not header_done:
            out.write("@HD\tVN:1.0\tSO:unsorted\n")
            if contig_lengths:
                for cname, clen in contig_lengths.items():
                    out.write(f"@SQ\tSN:{cname}\tLN:{clen}\n")
            out.write("@PG\tID:shrimp_tpu_shrimp2sam\n")
            header_done = True
        rev = strand == "-"
        flag = 16 if rev else 0
        cigar, nm = edit_to_cigar(edit, r_start, r_end, read_len, rev)
        seq = reads.get(name, "*")
        if seq != "*" and rev:
            seq = _revcomp(seq)
        out.write("\t".join([
            name, str(flag), contig, str(g_start), "255", cigar, "*",
            "0", "0", seq, "*", f"AS:i:{score}", f"NM:i:{nm}"]) + "\n")
        n += 1
    return n


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    from ..io.fasta import read_seqs
    ap = argparse.ArgumentParser(prog="shrimp2sam")
    ap.add_argument("reads", help="reads fasta/fastq")
    ap.add_argument("shrimp_output", help="SHRiMP-format mapping output")
    args = ap.parse_args(argv)
    reads = {r.name: r.seq for r in read_seqs(args.reads)}
    with open(args.shrimp_output) as f:
        shrimp2sam(f, reads, sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
