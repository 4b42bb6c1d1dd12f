"""SAM emission, mirroring gmapper's hit_output (gmapper/output.c:227-774).

String assembly is host-side work in both designs; the numbers flowing in
come from the device kernels.

Copied from `shrimp_tpu/io/sam.py` unchanged: the port keeps its own
copy of the JAX package's host modules and imports none of them.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from .. import constants as C
from ..config import MapperConfig
from ..core.sw_np import BACK_DELETION, BACK_INSERTION, BACK_MATCH_MISMATCH
from ..index.build import GenomeIndex
from ..mapper import Hit, ReadEntry, double_to_neglog

_COMP = {"A": "T", "T": "A", "C": "G", "G": "C", "N": "N",
         "a": "t", "t": "a", "c": "g", "g": "c", "n": "n", "-": "-"}

# str.translate tables (C-speed per-character maps)
_CLEAN_TBL = {}
for _c in map(chr, range(256)):
    _u = _c.upper()
    _CLEAN_TBL[ord(_c)] = "N" if _u in "RYSWKMBDHV" else _u
_CLEAN_TBL = str.maketrans(_CLEAN_TBL)
_COMP_TBL = str.maketrans(
    {ord(k): v for k, v in _COMP.items()} | {
        ord(c): "N" for c in "RYSWKMBDHVryswkmbdhv"})


def _cat_lines(path: str) -> List[str]:
    with open(path) as f:
        return f.read().splitlines()


def sam_header(index: GenomeIndex, command_line: str,
               cfg: Optional[MapperConfig] = None,
               version: str = "2.2.3",
               header_file: Optional[str] = None,
               hd_file: Optional[str] = None,
               sq_file: Optional[str] = None,
               rg_file: Optional[str] = None,
               pg_file: Optional[str] = None) -> List[str]:
    """gmapper.c:2968-3014, incl. the --sam-header[-hd/-sq/-rg/-pg]
    per-section override files."""
    if header_file is not None:
        return _cat_lines(header_file)
    lines = (_cat_lines(hd_file) if hd_file is not None
             else ["@HD\tVN:1.0\tSO:unsorted"])
    if sq_file is not None:
        lines += _cat_lines(sq_file)
    else:
        for name, ln in zip(index.contig_names, index.contig_lengths):
            lines.append(f"@SQ\tSN:{name}\tLN:{ln}")
    if rg_file is not None:
        lines += _cat_lines(rg_file)
    elif cfg is not None and cfg.read_group_name is not None:
        lines.append(f"@RG\tID:{cfg.read_group_name}"
                     f"\tSM:{cfg.sam_sample_name or cfg.read_group_name}")
    if pg_file is not None:
        lines += _cat_lines(pg_file)
    else:
        lines.append(f"@PG\tID:gmapper\tVN:{version}\tCL:{command_line}")
    return lines


def _clean_seq(seq: str) -> str:
    """output.c:326-352: uppercase, wobble codes -> N."""
    return seq.translate(_CLEAN_TBL)


def _revcomp_str(s: str) -> str:
    return s[::-1].translate(_COMP_TBL)


def cigar_ops(h: Hit, read_len: int) -> List[Tuple[int, str]]:
    """make_cigar (output.c:15-64): ops from the backtrace, plus S clips."""
    read_start1 = h.read_start + 1
    read_end1 = read_start1 + h.rmapped - 1
    out: List[Tuple[int, str]] = []
    if read_start1 > 1:
        out.append((read_start1 - 1, "S"))
    ops = h.ops if h.ops is not None else np.zeros(0, np.int8)
    i = 0
    n = len(ops)
    opmap = {BACK_DELETION: "I", BACK_INSERTION: "D",
             BACK_MATCH_MISMATCH: "M"}
    while i < n:
        o = ops[i]
        j = i
        while j + 1 < n and ops[j + 1] == o:
            j += 1
        out.append((j - i + 1, opmap[int(o)]))
        i = j + 1
    if read_end1 != read_len:
        out.append((read_len - read_end1, "S"))
    return out


def _pair_qname(name: str, mate_name: str) -> str:
    """Longest common prefix, trailing ':' or '/' stripped
    (output.c:372-385)."""
    i = 0
    n = min(len(name), len(mate_name))
    while i < n and name[i] == mate_name[i]:
        i += 1
    if i > 0 and name[i - 1] in ":/":
        i -= 1
    return name[:i]


def _requal(qual: str, qual_delta: int) -> str:
    """Rescale quality string to PHRED+33 (output.c:562-568)."""
    if qual_delta == 33:
        return qual
    return "".join(chr(ord(c) - qual_delta + 33) for c in qual)


def _mate_coords(index: GenomeIndex, rh_mp: Hit) -> Tuple[int, int, bool]:
    """1-based genome start/end of the mate (output.c:391-404)."""
    glen = int(index.contig_lengths[rh_mp.cn])
    rs1 = rh_mp.read_start + 1
    re1 = rs1 + rh_mp.rmapped - 1
    rev = rh_mp.gen_st == 1
    if not rev:
        gs = rh_mp.genome_start + 1
    else:
        right = glen - rh_mp.genome_start
        gs = right - (re1 - rs1 - rh_mp.deletions + rh_mp.insertions)
    return gs, gs + rh_mp.gmapped - 1, rev


def render_hit(re: ReadEntry, rh: Optional[Hit], rh_mp: Optional[Hit],
               first_in_pair: bool, index: GenomeIndex, cfg: MapperConfig,
               fastq: bool = False, improper_mapping: bool = False) -> str:
    """One SAM line (hit_output, output.c:227-774). rh may be None
    (unmapped record); rh_mp is the mate's hit if any."""
    paired_read = re.paired
    re_mp = re.mate_pair
    qname = re.name
    mrnm = "*"
    mpos = 0
    isize = 0
    reverse_strand_mp = False
    genome_start_mp = genome_end_mp = 0
    mate_unmapped = False
    if paired_read:
        qname = _pair_qname(re.name, re_mp.name)
        mate_unmapped = rh_mp is None
        if not mate_unmapped:
            genome_start_mp, genome_end_mp, reverse_strand_mp = \
                _mate_coords(index, rh_mp)
            mpos = genome_start_mp
            mrnm = index.contig_names[rh_mp.cn]
    query_unmapped = rh is None
    second_in_pair = paired_read and not first_in_pair
    paired_alignment = paired_read and (rh is not None and rh_mp is not None
                                        and not improper_mapping)

    def flags(reverse_strand: bool) -> int:
        return ((0x0001 if paired_read else 0)
                | (0x0002 if paired_alignment else 0)
                | (0x0004 if query_unmapped else 0)
                | (0x0008 if mate_unmapped else 0)
                | (0x0010 if reverse_strand else 0)
                | (0x0020 if reverse_strand_mp else 0)
                | (0x0040 if first_in_pair else 0)
                | (0x0080 if second_in_pair else 0))

    # ---- unmapped-style record (output.c:417-474)
    if query_unmapped or (not cfg.half_paired and paired_read
                          and mate_unmapped):
        out_seq = re.trimmed_seq if getattr(re, "trimmed_seq", None) \
            else re.seq
        seq = (_clean_seq(out_seq) if cfg.mode == C.MODE_LETTER_SPACE
               else "*")
        qual = "*"
        if fastq and cfg.mode == C.MODE_LETTER_SPACE and re.qual:
            # unmapped records carry the RAW quality string — no
            # PHRED+33 rescale (strcpy, output.c:419-421)
            qual = re.qual
        fields = [qname, str(flags(False)), "*", "0", "0", "*", mrnm,
                  str(mpos), "0", seq, qual]
        line = "\t".join(fields)
        if cfg.mode == C.MODE_COLOUR_SPACE:
            line += f"\tCQ:Z:{re.qual if fastq and re.qual else '*'}"
            line += f"\tCS:Z:{out_seq}"
        if cfg.sam_r2 and re_mp is not None:
            tag = "X2" if cfg.mode == C.MODE_COLOUR_SPACE else "R2"
            line += f"\t{tag}:Z:{re_mp.seq}"
        if cfg.read_group_name:
            line += f"\tRG:Z:{cfg.read_group_name}"
        return line

    # ---- mapped record
    reverse_strand = rh.gen_st == 1
    rname = index.contig_names[rh.cn]
    genome_length = int(index.contig_lengths[rh.cn])
    read_start1 = rh.read_start + 1
    read_end1 = read_start1 + rh.rmapped - 1

    if cfg.mode == C.MODE_LETTER_SPACE:
        seq = _clean_seq(re.seq)
        if reverse_strand:
            seq = _revcomp_str(seq)
    else:
        # CS: the called letters of the aligned portion (output.c:491-545)
        seq = _clean_seq("".join(c for c in (rh.qralign or "")
                                 if c != "-"))
        if reverse_strand:
            seq = _revcomp_str(seq)

    qual = "*"
    if fastq and cfg.mode == C.MODE_LETTER_SPACE and re.qual:
        q = re.qual[::-1] if reverse_strand else re.qual
        qual = _requal(q, cfg.qual_delta)
    elif (fastq and cfg.mode == C.MODE_COLOUR_SPACE and cfg.bfast
          and re.qual):
        # bfast-style base quals from adjacent colour quals
        # (--bfast, output.c:581-612); raw char arithmetic kept as-is
        q = [ord(re.qual[i + rh.read_start]) for i in range(rh.rmapped)]
        qr = rh.qralign or ""
        for i in range(rh.rmapped - 1):
            mm1 = i < len(qr) and ord(qr[i]) > 96
            mm2 = i + 1 < len(qr) and ord(qr[i + 1]) > 96
            if mm1 and mm2:
                bq = 0
            elif mm1:
                bq = q[i + 1] - q[i]
            elif mm2:
                bq = q[i] - q[i + 1] + 33
            else:
                bq = q[i] + q[i + 1] + 10 - 33
            q[i] = min(ord("`"), max(bq, ord('"')))
        qual = "".join(chr(c) for c in q)
        if reverse_strand:
            qual = qual[::-1]
    elif (fastq and cfg.mode == C.MODE_COLOUR_SPACE
          and cfg.compute_mapping_qualities and rh.qual_str):
        # post-SW base qualities (output.c:613-622)
        qual = (rh.qual_str[::-1] if reverse_strand else rh.qual_str)

    cig = cigar_ops(rh, re.read_len)
    if cfg.mode == C.MODE_COLOUR_SPACE:
        cig = [(n, "H" if op == "S" else op) for n, op in cig]
    if reverse_strand:
        cig = cig[::-1]
    cigar = "".join(f"{n}{op}" for n, op in cig)

    if not reverse_strand:
        pos = rh.genome_start + 1
    else:
        right_most = genome_length - rh.genome_start
        pos = right_most - (read_end1 - read_start1 - rh.deletions
                            + rh.insertions)
    genome_end = pos + rh.gmapped - 1

    if paired_read and not mate_unmapped:
        if rname == mrnm:
            mrnm = "="
            fivep = genome_end if reverse_strand else pos - 1
            fivep_mp = (genome_end_mp if reverse_strand_mp
                        else genome_start_mp - 1)
            isize = fivep_mp - fivep
        else:
            isize = 0

    mapq = rh.mqv
    fields = [qname, str(flags(reverse_strand)), rname, str(pos), str(mapq),
              cigar, mrnm, str(mpos), str(isize), seq, qual]
    line = "\t".join(fields)
    line += f"\tAS:i:{rh.score_full}"
    if cfg.compute_mapping_qualities and not cfg.all_contigs:
        if not paired_read:
            line += (f"\tZ0:i:{double_to_neglog(rh.z0)}"
                     f"\tZ1:i:{double_to_neglog(rh.z1)}")
        else:
            if rh is not None and rh_mp is not None and not improper_mapping:
                line += (f"\tZ2:i:{double_to_neglog(rh.z2)}"
                         f"\tZ3:i:{double_to_neglog(rh.z3)}"
                         f"\tZ4:i:{double_to_neglog(rh.pr_top_random_at_location)}"
                         f"\tZ6:i:{double_to_neglog(rh.insert_size_denom)}")
            else:
                line += (f"\tZ0:i:{double_to_neglog(rh.z0)}"
                         f"\tZ1:i:{double_to_neglog(rh.z1)}"
                         f"\tZ4:i:{double_to_neglog(rh.pr_top_random_at_location)}"
                         f"\tZ5:i:{double_to_neglog(rh.pr_missed_mp)}")
    line += f"\tNM:i:{rh.mismatches + rh.deletions + rh.insertions}"
    if cfg.mode == C.MODE_COLOUR_SPACE:
        if fastq and re.qual:
            line += f"\tCQ:Z:{re.qual}"
        cs_seq = re.trimmed_seq if getattr(re, "trimmed_seq", None) \
            else re.seq
        line += (f"\tCS:Z:{cs_seq}\tCM:i:{rh.crossovers}"
                 f"\tXX:Z:{rh.qralign}")
    if cfg.sam_r2 and re_mp is not None:
        tag = "X2" if cfg.mode == C.MODE_COLOUR_SPACE else "R2"
        line += f"\t{tag}:Z:{re_mp.seq}"
    if cfg.read_group_name:
        line += f"\tRG:Z:{cfg.read_group_name}"
    if cfg.extra_sam_fields:
        from .shrimp_format import (alignment_edit_string,
                                    materialize_alignment,
                                    reverse_edit_string)
        materialize_alignment(rh, re, index)
        editstr = alignment_edit_string(rh.dbalign, rh.qralign)
        if reverse_strand:
            editstr = reverse_edit_string(editstr)
        line += (f"\tZM:i:{rh.kmer_matches}\tZR:i:{rh.score_window_gen}"
                 f"\tZV:i:{rh.score_vector}\tZH:i:{rh.sw_score}"
                 f"\tZE:Z:{editstr}")
    return line


def render_unpaired(re: ReadEntry, h: Optional[Hit], index: GenomeIndex,
                    cfg: MapperConfig, fastq: bool = False) -> str:
    return render_hit(re, h, None, False, index, cfg, fastq)


def render_pair_entry(pe, index: GenomeIndex, cfg: MapperConfig,
                      paired_out, unpaired_out, fastq: bool = False
                      ) -> List[str]:
    """Emission order of readpair_output (output.c:1236-1282)."""
    lines: List[str] = []
    for ph in paired_out:
        rh1, rh2 = ph.rh
        imp = ph.improper_mapping
        lines.append(render_hit(pe.re[0], rh1, rh2, True, index, cfg,
                                fastq, imp))
        lines.append(render_hit(pe.re[1], rh2, rh1, False, index, cfg,
                                fastq, imp))
    for nip in (0, 1):
        rep = pe.re[nip]
        for h in unpaired_out[nip]:
            if rep.first_in_pair:
                lines.append(render_hit(rep, h, None, True, index, cfg,
                                        fastq))
                lines.append(render_hit(rep.mate_pair, None, h, False,
                                        index, cfg, fastq))
            else:
                lines.append(render_hit(rep.mate_pair, None, h, True,
                                        index, cfg, fastq))
                lines.append(render_hit(rep, h, None, False, index, cfg,
                                        fastq))
    if not lines and cfg.sam_unaligned:
        lines.append(render_hit(pe.re[0], None, None, True, index, cfg,
                                fastq))
        lines.append(render_hit(pe.re[1], None, None, False, index, cfg,
                                fastq))
    return lines
