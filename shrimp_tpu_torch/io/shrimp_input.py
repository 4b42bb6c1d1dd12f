"""Parser for legacy SHRiMP-format output lines (common/input.c).

The legacy SHRiMP1 tools (probcalc, probcalc_mp, prettyprint, shrimp_var)
consume the tab-separated `>readname contigname strand ...` lines that
gmapper emits with `--shrimp-format`.  This module re-implements
input_parseline / editstr_to_sfr (common/input.c:57-135,199-267) and the
`#FORMAT:` header dispatch (common/input.c:36-55,137-196).

Copied from `shrimp_tpu/io/shrimp_input.py` unchanged: the port keeps its own
copy of the JAX package's host modules and imports none of them.
"""
from __future__ import annotations

import gzip
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, TextIO

# Field names understood in a #FORMAT: header (common/input.c:38-55)
_FIELDS = ("readname", "contigname", "strand", "contigstart", "contigend",
           "readstart", "readend", "readlength", "score", "editstring",
           "normodds", "pgenome", "pchance", "readsequence")

DEFAULT_FORMAT: List[str] = list(_FIELDS[:10])


@dataclass
class InputRecord:
    """struct input (common/input.h) with the editstr-derived counts."""
    read: str = ""
    genome: str = ""
    revcmpl: bool = False
    genome_start: int = 0       # 0-based (input is 1-based, input.c:222)
    genome_end: int = 0
    read_start: int = 0
    read_end: int = 0
    read_length: int = 0
    score: int = 0
    edit: str = ""
    normodds: Optional[float] = None
    pgenome: Optional[float] = None
    pchance: Optional[float] = None
    read_seq: Optional[str] = None
    # derived from the edit string (editstr_to_sfr)
    matches: int = 0
    mismatches: int = 0
    insertions: int = 0
    deletions: int = 0
    crossovers: int = 0


_NUC = set("ACGTUMRWSYKVHDBXNacgtumrwsykvhdbn")
_MISMATCH = set("ACGTNacgtn")


def editstr_to_counts(editstr: str) -> Optional[tuple]:
    """editstr_to_sfr (common/input.c:57-135): matches from digit runs,
    mismatches from letters, insertions from '-' (gap in read),
    deletions from letters inside parens (gap in genome), crossovers
    from 'x'/'X'."""
    matches = mismatches = insertions = deletions = crossovers = 0
    inparen = False
    digits = 0
    paren_chars = 0
    n = len(editstr)
    for i in range(n + 1):
        c = editstr[i] if i < n else "\0"
        if inparen:
            if c == ")":
                inparen = False
            elif c == "\0":
                return None
            elif c in _NUC:
                paren_chars += 1
            else:
                return None
            if not inparen:
                deletions += paren_chars
                paren_chars = 0
            continue
        if not c.isdigit() and digits:
            matches += digits
            digits = 0
        if c == "-":
            insertions += 1
        elif c == "(":
            inparen = True
        elif c == "\0":
            pass
        elif c in "xX":
            crossovers += 1
        elif c in _MISMATCH:
            mismatches += 1
        elif c.isdigit():
            digits = digits * 10 + int(c)
        else:
            return None
    if inparen:
        return None
    return (matches, mismatches, insertions, deletions, crossovers)


def parse_format_line(line: str) -> List[str]:
    """#FORMAT: header -> field list (format_get_from_string)."""
    fields = []
    for tok in line.split():
        tok = tok.strip()
        if tok == "#FORMAT:" or not tok:
            continue
        fields.append(tok if tok in _FIELDS else "unknown")
    return fields


def parse_line(line: str, fmt: List[str]) -> Optional[InputRecord]:
    """input_parse_string (common/input.c:286-320) + handle_field."""
    line = line.rstrip("\n").rstrip("\r")
    if line.startswith(">"):
        line = line[1:]
    vals = line.split("\t")
    rec = InputRecord()
    for ftype, val in zip(fmt, vals):
        if val.strip() == "":
            continue
        if ftype == "readname":
            rec.read = val
        elif ftype == "contigname":
            rec.genome = val
        elif ftype == "strand":
            rec.revcmpl = val.startswith("-")
        elif ftype == "contigstart":
            rec.genome_start = int(val) - 1
        elif ftype == "contigend":
            rec.genome_end = int(val) - 1
        elif ftype == "readstart":
            rec.read_start = int(val) - 1
        elif ftype == "readend":
            rec.read_end = int(val) - 1
        elif ftype == "readlength":
            rec.read_length = int(val)
        elif ftype == "score":
            rec.score = int(val)
        elif ftype == "normodds":
            rec.normodds = float(val)
        elif ftype == "pgenome":
            rec.pgenome = float(val)
        elif ftype == "pchance":
            rec.pchance = float(val)
        elif ftype == "readsequence":
            rec.read_seq = val
        elif ftype == "editstring":
            rec.edit = val
            counts = editstr_to_counts(val)
            if counts is not None:
                (rec.matches, rec.mismatches, rec.insertions,
                 rec.deletions, rec.crossovers) = counts
    return rec


def open_maybe_gz(path: str) -> TextIO:
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rt")
    return open(path, "r")


def iter_records(fp: TextIO, fmt: Optional[List[str]] = None
                 ) -> Iterator[InputRecord]:
    """input_parseline: skips comments, tracks #FORMAT: headers."""
    cur = list(fmt) if fmt is not None else list(DEFAULT_FORMAT)
    for line in fp:
        if line.startswith("#FORMAT:"):
            cur[:] = parse_format_line(line)
            continue
        if line.startswith("#") or not line.strip():
            continue
        rec = parse_line(line, cur)
        if rec is not None:
            yield rec
