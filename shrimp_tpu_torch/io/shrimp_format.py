"""Legacy SHRiMP output format: edit strings and the tab-separated
`>read contig strand ...` lines (common/output.c, README:1550-1565).

Copied from `shrimp_tpu/io/shrimp_format.py` unchanged: the port keeps its own
copy of the JAX package's host modules and imports none of them.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .. import constants as C
from ..index.build import GenomeIndex
from ..mapper import Hit, ReadEntry


def alignment_edit_string(dbalign: str, qralign: str) -> str:
    """common/output.c:60-120: <n> match run, letter = mismatch,
    (<letters>) = gap in reference, '-' = gap in read, 'x' = crossover."""
    out: List[str] = []
    consec = 0
    refgap = False
    n = len(dbalign)
    for i in range(n + 1):
        if i != n and dbalign[i] == qralign[i] and dbalign[i] != "-":
            consec += 1
            continue
        if refgap and (consec != 0 or i == n or dbalign[i] != "-"):
            out.append(")")
            refgap = False
        if consec:
            out.append(str(consec))
            consec = 0
        if i == n:
            break
        if dbalign[i] == "-":
            if qralign[i].islower():
                out.append("x")
            if not refgap:
                out.append("(")
            out.append(qralign[i].upper())
            refgap = True
            continue
        if qralign[i] == "-":
            out.append("-")
        else:
            if dbalign[i] == qralign[i].upper():
                out.append("x")
                consec += 1
            elif qralign[i].islower():
                out.append("x")
                out.append(qralign[i].upper())
            else:
                out.append(qralign[i])
    return "".join(out)


def reverse_edit_string(editstr: str) -> str:
    """gmapper/output.c:83-122 (reverse + complement for reverse-strand
    SAM ZE fields)."""
    comp = {"A": "T", "T": "A", "C": "G", "G": "C"}
    res: List[str] = []
    i = len(editstr) - 1
    while i >= 0:
        c = editstr[i]
        if c.isdigit():
            j = i
            while j - 1 >= 0 and editstr[j - 1].isdigit():
                j -= 1
            res.append(editstr[j:i + 1])
            i = j - 1
        elif c in "-x":
            res.append(c)
            i -= 1
        elif c == ")":
            res.append("(")
            i -= 1
        elif c == "(":
            res.append(")")
            i -= 1
        else:
            res.append(comp.get(c, c))
            i -= 1
    return "".join(res)


def materialize_alignment(h: Hit, e: ReadEntry, index: GenomeIndex
                          ) -> None:
    """Build dbalign/qralign strings for a letter-space hit from its
    backtrace ops (CS hits carry them already)."""
    if h.dbalign is not None:
        return
    coff = int(index.contig_offsets[h.cn])
    src = index.codes if h.gen_st == 0 else index.codes_rc
    read = e.codes[h.st]
    db_chars, qr_chars = [], []
    i = h.read_start
    j = h.genome_start  # contig-local, includes g_off
    from ..core.sw_np import BACK_DELETION, BACK_INSERTION
    for op in (h.ops if h.ops is not None else []):
        if op == BACK_DELETION:      # read-consuming
            db_chars.append("-")
            qr_chars.append("ACGTUMRWSYKVHDBN"[read[i]])
            i += 1
        elif op == BACK_INSERTION:   # genome-consuming
            db_chars.append("ACGTUMRWSYKVHDBN"[src[coff + j]])
            qr_chars.append("-")
            j += 1
        else:
            db_chars.append("ACGTUMRWSYKVHDBN"[src[coff + j]])
            qr_chars.append("ACGTUMRWSYKVHDBN"[read[i]])
            i += 1
            j += 1
    h.dbalign = "".join(db_chars)
    h.qralign = "".join(qr_chars)


FORMAT_LINE = ("#FORMAT: readname contigname strand contigstart contigend "
               "readstart readend readlength score editstring")


def read_to_str(e: ReadEntry, cs: bool) -> str:
    if cs:
        return ("ACGTUMRWSYKVHDBN"[e.initbp[0]]
                + "".join(C.CS_INT_TO_CHAR_DOT[c].to_bytes(1, "little")
                          .decode() for c in e.codes[0]))
    return "".join("ACGTUMRWSYKVHDBN"[c] for c in e.codes[0])


def output_normal(e: ReadEntry, h: Hit, index: GenomeIndex,
                  include_read: bool = False) -> str:
    """common/output.c:273-352; score printed is score_full
    (gmapper/output.c:275-276)."""
    cs = index.mode == C.MODE_COLOUR_SPACE
    materialize_alignment(h, e, index)
    glen = int(index.contig_lengths[h.cn])
    gs = h.genome_start
    ge = h.genome_start + h.gmapped - 1
    if h.gen_st == 1:
        idx_gs, idx_ge = glen - ge - 1, glen - gs - 1
    else:
        idx_gs, idx_ge = gs, ge
    edit = alignment_edit_string(h.dbalign, h.qralign)
    # the readseq field is always present (empty without -R), so a
    # trailing tab appears in the reference output (output.c:344-346)
    fields = [f">{e.name}", index.contig_names[h.cn],
              "-" if h.gen_st == 1 else "+",
              str(idx_gs + 1), str(idx_ge + 1),
              str(h.read_start + 1), str(h.read_start + h.rmapped),
              str(e.read_len), str(h.score_full), edit,
              read_to_str(e, cs) if include_read else ""]
    return "\t".join(fields)
