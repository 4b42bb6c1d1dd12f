"""shrimp_var: per-position variation report from rmapper/probcalc
output (shrimp_var/shrimp_var.c).

For every SHRiMP-format alignment line, re-walks the edit string and
emits `>read\tedit\tcontigstart\t<#snps #ins #dels>\t` followed by one
`s-<base>-<pos>` / `i-<bases>-<pos>` / `d-<len>-<pos>` token per event,
with reverse-strand edit strings walked backwards and complemented
(editstr_to_stats, shrimp_var.c:349-482).

Note the reference parses fields only at tab boundaries, so the last
field of each line (no trailing tab) is never consumed; field values
also persist across lines.  Both quirks are reproduced.

Copied from `shrimp_tpu/tools/shrimp_var.py` unchanged: the port keeps its own
copy of the JAX package's host modules and imports none of them.
"""
from __future__ import annotations

import os
import sys
from typing import List, Optional, TextIO

_COMPL = {"A": "T", "T": "A", "C": "G", "G": "C"}
_VALID = set("ACGT1234567890()-x")


def _editstr_to_stats(s: str, readloc: int, is_forward: bool,
                      out: TextIO) -> None:
    """Literal port of editstr_to_stats (shrimp_var.c:349-482), keeping
    its exact branch order (a SNP inside an open '-' run leaves the run
    open, etc.)."""
    inins = indel = 0
    innum = 0
    nr_snps = nr_ins = nr_dels = 0
    inssize = -1
    delsize = -1
    num: List[str] = []
    ins: List[str] = []
    tokens: List[str] = []
    slen = len(s)
    for i in range(slen):
        ech = s[i] if is_forward else s[slen - i - 1]
        if ech not in _VALID:
            print("Unrecognized character: %c" % ech, file=sys.stderr)
            raise SystemExit(1)
        if ech.isdigit():
            num.append(ech)
            innum += 1
        elif innum > 0:
            digits = "".join(num)
            readloc += int(digits if is_forward else digits[::-1])
            innum = 0
            num = []
        isnuc = ech in "ACTG"
        # SNP (shrimp_var.c:421-430)
        if (not inins) and isnuc:
            nr_snps += 1
            base = ech if is_forward else _COMPL[ech]
            tokens.append("s-%s-%d\t" % (base, readloc))
            readloc += 1
            continue
        # '-' runs ("deletions" in shrimp_var's naming, :433-447)
        if ech == "-" and indel:
            delsize += 1
            continue
        elif ech == "-":
            indel = 1
            delsize = 1
        elif indel:
            indel = 0
            tokens.append("d-%d-%d\t" % (delsize, readloc))
            nr_dels += 1
            readloc += delsize
            delsize = 0
        # paren runs ("insertions", :451-477)
        if (is_forward and ech == "(") or (not is_forward and ech == ")"):
            inins = 1
            inssize = 0
            ins = []
        elif isnuc and inins:
            ins.append(ech)
            inssize += 1
            continue
        elif (is_forward and ech == ")") or (not is_forward
                                             and ech == "("):
            nr_ins += 1
            seq = "".join(ins) if is_forward \
                else "".join(_COMPL[c] for c in ins)
            tokens.append("i-%s-%d\t" % (seq, readloc - 1))
            inins = 0
            inssize = 0
            continue
    out.write("\t%d %d %d\t" % (nr_snps, nr_ins, nr_dels))
    out.write("".join(tokens))


def variant_transform(path: str, rflag: bool, out: TextIO) -> int:
    fp = sys.stdin if path == "-" else open(path, "r")
    n = 0
    # field state persists across lines (shrimp_var.c:198-219)
    readname = contigname = strand = editstring = ""
    contigstart = -1
    try:
        for line in fp:
            if line.startswith("#"):
                continue
            parts = line.split("\t")
            # the last piece (no trailing tab) is never consumed
            for fieldnr, field in enumerate(parts[:-1], 1):
                if fieldnr == 1:
                    readname = field
                elif fieldnr == 2:
                    contigname = field
                elif fieldnr == 3:
                    strand = field
                elif fieldnr == 4:
                    contigstart = int(field)
                elif fieldnr == 10:
                    editstring = field
            n += 1
            out.write("%s\t%s\t%d" % (readname, editstring, contigstart))
            _editstr_to_stats(editstring, contigstart, strand == "+", out)
            out.write("\n")
    finally:
        if fp is not sys.stdin:
            fp.close()
    return n


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="shrimp_var", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-R", dest="rflag", action="store_true",
                    help="input includes readsequence column")
    ap.add_argument("-r", dest="itype", action="store_const",
                    const="rmapper", help="rmapper input")
    ap.add_argument("-p", dest="itype", action="store_const",
                    const="probcalc", help="probcalc input")
    ap.add_argument("-v", dest="itype", action="store_const",
                    const="rmapper_v09", help="rmapper v0.9 input")
    ap.add_argument("-o", dest="outfile")
    ap.add_argument("inputs", nargs="+")
    args = ap.parse_args(argv)
    if args.itype is None:
        ap.error("one of -r/-p/-v is required")
    out = open(args.outfile, "w") if args.outfile else sys.stdout
    print("#assuming format:\n"
          ">readname contigname strand contigstart contigend readstart "
          "readend readlength score editstring %snormodds pgenome pchance"
          % ("readsequence " if args.rflag else ""), file=sys.stderr)
    try:
        for p in args.inputs:
            if os.path.isdir(p):
                for f in sorted(os.listdir(p)):
                    fp = os.path.join(p, f)
                    if os.path.isfile(fp):
                        print("processing file: %s" % f, file=sys.stderr)
                        variant_transform(fp, args.rflag, out)
            else:
                variant_transform(p, args.rflag, out)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
