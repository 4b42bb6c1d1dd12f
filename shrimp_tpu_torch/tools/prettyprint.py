"""prettyprint: re-align SHRiMP-format hits and render pretty alignments
(prettyprint/prettyprint.c).

Re-runs the full Smith-Waterman (local mode, threshold-derived band,
no anchors — prettyprint.c:118-129) for every alignment in a
SHRiMP-format output file against the referenced contig and read
sequences, then prints the re-derived `>read ...` line (output_normal)
followed by a human-readable alignment block (output_pretty,
common/output.c:126-266).

Copied from `shrimp_tpu/tools/prettyprint.py` unchanged: the port keeps its own
copy of the JAX package's host modules and imports none of them.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import constants as C
from ..core import encode
from ..core.sw_np import sw_full_ls
from ..core.sw_cs_np import sw_full_cs
from ..io.fasta import read_seqs
from ..io.shrimp_format import alignment_edit_string
from ..io.shrimp_input import InputRecord, iter_records, open_maybe_gz

LS_CHARS = "ACGTUMRWSYKVHDBN"


def _decode(codes: np.ndarray) -> str:
    return "".join(LS_CHARS[c] for c in codes)


def readtostr(codes: np.ndarray, cs: bool, initbp: int) -> str:
    """common/output.c:21-42."""
    if not cs:
        return _decode(codes)
    return LS_CHARS[initbp] + "".join(
        chr(C.CS_INT_TO_CHAR[c]) for c in codes)


def output_normal(rec_read: str, rec_contig: str, sfr, genome_len: int,
                  cs: bool, read_codes: np.ndarray, readlen: int,
                  initbp: int, revcmpl: bool, inc_read: bool) -> str:
    """common/output.c:285-352 over our SWFullResult/CSFullResult."""
    genome_start = sfr.genome_start
    genome_end = sfr.genome_start + sfr.gmapped - 1
    if revcmpl:
        idx_gs = genome_len - genome_end - 1
        idx_ge = genome_len - genome_start - 1
    else:
        idx_gs, idx_ge = genome_start, genome_end
    edit = alignment_edit_string(sfr.dbalign, sfr.qralign)
    readseq = readtostr(read_codes, cs, initbp) if inc_read else ""
    return (">%s\t%s\t%c\t%u\t%u\t%d\t%d\t%d\t%d\t%s\t%s"
            % (rec_read, rec_contig, "-" if revcmpl else "+",
               idx_gs + 1, idx_ge + 1, sfr.read_start + 1,
               sfr.read_start + sfr.rmapped, readlen, sfr.score, edit,
               readseq))


def output_pretty(sfr, contig_codes: np.ndarray, genome_len: int,
                  cs: bool, read_codes: np.ndarray, readlen: int,
                  initbp: int, revcmpl: bool) -> str:
    """common/output.c:126-266: G/match/R (and CS T/R) alignment block.
    `contig_codes` is the contig in the already-reversed orientation when
    revcmpl (matching the reference's in-place reverse_complement)."""
    dbalign, qralign = sfr.dbalign, sfr.qralign
    genome_start = sfr.genome_start
    genome_end = sfr.genome_start + sfr.gmapped - 1
    if revcmpl:
        idx_gs = genome_len - genome_end - 1
        idx_ge = genome_len - genome_start - 1
    else:
        idx_gs, idx_ge = genome_start, genome_end
    read_start = sfr.read_start
    read_end = sfr.read_start + sfr.rmapped - 1

    gpre = lspre = mpre = ""
    if read_start > 0:
        g, l, m = [], [], []
        for j in range(read_start):
            if genome_start + j > read_start:
                g.append(LS_CHARS[contig_codes[genome_start - read_start
                                               + j]])
            else:
                g.append("-")
            l.append("-")
            m.append(" ")
        gpre, lspre, mpre = "".join(g), "".join(l), "".join(m)
    gpost = lspost = ""
    if read_end < readlen - 1:
        g, l = [], []
        for j in range(readlen - read_end - 1):
            if genome_end + 1 + j < genome_len:
                g.append(LS_CHARS[contig_codes[genome_end + 1 + j]])
            else:
                g.append("-")
            l.append("-")
        gpost, lspost = "".join(g), "".join(l)

    out: List[str] = []
    out.append("G: %10d    %s%s%s    %-10d\n"
               % (idx_ge + 1 if revcmpl else idx_gs + 1, gpre, dbalign,
                  gpost, idx_gs + 1 if revcmpl else idx_ge + 1))
    marks = []
    for dj, qj in zip(dbalign, qralign):
        if dj == qj and dj != "-":
            marks.append("|")
        elif dj == qj.upper():
            marks.append("X")
        elif qj.islower():
            marks.append("x")
        else:
            marks.append(" ")
    out.append("%16s %s%s\n" % ("", mpre, "".join(marks)))
    if cs:
        out.append("T: %10s    %s%s%s\n" % ("", lspre, qralign, lspost))
        rstr = readtostr(read_codes, True, initbp)
        line = ["R: %10u   " % (read_start + 1)]
        pos = 0
        line.append(rstr[pos])
        pos += 1
        for _ in range(read_start):
            line.append(rstr[pos])
            pos += 1
        j = 0
        while pos < len(rstr):
            if j < len(qralign) and qralign[j] == "-":
                line.append("-")
            else:
                line.append(rstr[pos])
                pos += 1
            if j < len(qralign):
                j += 1
        line.append("    %-10u\n" % (read_end + 1))
        out.append("".join(line))
    else:
        out.append("R: %10u    %s%s%s    %-10u\n"
                   % (read_start + 1, lspre, qralign, lspost,
                      read_end + 1))
    return "".join(out)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="prettyprint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cs", action="store_true",
                    help="colour-space mode (prettyprint-cs)")
    ap.add_argument("-m", dest="match", type=int, default=None)
    ap.add_argument("-i", dest="mismatch", type=int, default=None)
    ap.add_argument("-g", dest="a_gap_open", type=int, default=None)
    ap.add_argument("-q", dest="b_gap_open", type=int, default=None)
    ap.add_argument("-e", dest="a_gap_extend", type=int, default=None)
    ap.add_argument("-f", dest="b_gap_extend", type=int, default=None)
    ap.add_argument("-x", dest="crossover", type=int, default=-20)
    ap.add_argument("-R", dest="inc_read", action="store_true")
    ap.add_argument("-T", dest="tiebreak", action="store_true")
    ap.add_argument("output_file")
    ap.add_argument("genome_file")
    ap.add_argument("reads_file")
    args = ap.parse_args(argv)

    cs = args.cs
    # defaults (gmapper-defaults.h:44-58)
    if cs:
        dflt = dict(match=10, mismatch=-24, a_gap_open=-33,
                    b_gap_open=-33, a_gap_extend=-7, b_gap_extend=-3)
    else:
        dflt = dict(match=10, mismatch=-15, a_gap_open=-33,
                    b_gap_open=-33, a_gap_extend=-7, b_gap_extend=-3)
    sc = {k: (getattr(args, k) if getattr(args, k) is not None else v)
          for k, v in dflt.items()}
    if args.a_gap_open is not None and args.b_gap_open is None:
        sc["b_gap_open"] = sc["a_gap_open"]
    if args.a_gap_extend is not None and args.b_gap_extend is None:
        sc["b_gap_extend"] = sc["a_gap_extend"]

    # load alignments in input order; bucket needed reads/contigs
    aligns: List[InputRecord] = []
    with open_maybe_gz(args.output_file) as fp:
        for rec in iter_records(fp):
            aligns.append(rec)
    needed_reads = {r.read for r in aligns}

    reads: Dict[str, Tuple[np.ndarray, int]] = {}
    for rec in read_seqs(args.reads_file):
        if rec.name not in needed_reads:
            continue
        if rec.name in reads:
            raise SystemExit("error: read [%s] occurs multiple times in "
                             "the read input files" % rec.name)
        if cs:
            initbp, codes = encode.encode_cs(rec.seq)
            reads[rec.name] = (codes, initbp)
        else:
            reads[rec.name] = (encode.encode_ls(rec.seq), -1)

    contigs: Dict[str, np.ndarray] = {}
    for rec in read_seqs(args.genome_file):
        contigs[rec.name] = encode.encode_ls(rec.seq)

    seen_probs = any(a.normodds is not None or a.pgenome is not None
                     or a.pchance is not None for a in aligns)
    out = sys.stdout
    out.write("#FORMAT: readname contigname strand contigstart contigend "
              "readstart readend readlength score editstring%s%s\n"
              % (" readsequence" if args.inc_read else "",
                 " normodds pgenome pchance" if seen_probs else ""))
    warned = False
    for a in aligns:
        if a.read not in reads:
            print("error: read [%s] is missing" % a.read, file=sys.stderr)
            return 1
        if a.genome not in contigs:
            print("warning: could not align read [%s] to contig[%s] - "
                  "missing contig file!" % (a.read, a.genome),
                  file=sys.stderr)
            continue
        codes, initbp = reads[a.read]
        contig = contigs[a.genome]
        glen_total = len(contig)
        src = contig
        genome_start = a.genome_start
        genome_len = a.genome_end - genome_start + 1
        if a.revcmpl:
            src = C.COMPLEMENT[contig[::-1]]
            genome_start = glen_total - a.genome_end - 1
        window = src[genome_start:genome_start + genome_len]
        rev = a.revcmpl and args.tiebreak
        if cs:
            sfr = sw_full_cs(window, codes, initbp, sc["match"],
                             sc["mismatch"], sc["a_gap_open"],
                             sc["a_gap_extend"], sc["b_gap_open"],
                             sc["b_gap_extend"], threshscore=a.score,
                             global_xover=args.crossover, revcmpl=rev,
                             anchor=None, anchor_width=-1,
                             local_alignment=True)
        else:
            sfr = sw_full_ls(window, codes, sc["match"], sc["mismatch"],
                             sc["a_gap_open"], sc["a_gap_extend"],
                             sc["b_gap_open"], sc["b_gap_extend"],
                             threshscore=a.score, maxscore=a.score,
                             revcmpl=rev, anchor=None, anchor_width=-1,
                             local_alignment=True)
        if sfr.score != a.score and not warned:
            print("warning: score differs from input file (read=\"%s\", "
                  "genome=\"%s\")" % (a.read, a.genome), file=sys.stderr)
            print("         Most likely cause is that prettyprint does "
                  "not use anchors.", file=sys.stderr)
            warned = True
        # sfr.genome_start is window-relative; make it contig-absolute
        sfr.genome_start += genome_start
        out.write(output_normal(a.read, a.genome, sfr, glen_total, cs,
                                codes, len(codes), initbp, a.revcmpl,
                                args.inc_read))
        if a.normodds is not None:
            out.write("\t%e" % a.normodds)
        if a.pgenome is not None:
            out.write("\t%e" % a.pgenome)
        if a.pchance is not None:
            out.write("\t%e" % a.pchance)
        out.write("\n\n")
        out.write(output_pretty(sfr, src, glen_total, cs, codes,
                                len(codes), initbp, a.revcmpl))
        out.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
