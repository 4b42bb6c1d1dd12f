"""mergesam equivalent: merge per-genome-shard SAM files for one read set,
recombining mapping qualities exactly from the Z fields.

Behavioral reference: mergesam/mergesam.c + mergesam/sam_reader.c
(consolidate_paired :119-295, consolidate_single :297-400,
pp_ll_combine_and_check :417-520) and the algebra specification in
not_in_dist/MAPPING_QUALITIES Parts 1c/2c: z1/z3/z6 recombine additively
across shards, z4 by min (max in neg-log space).

Copied from `shrimp_tpu/tools/mergesam.py` unchanged: the port keeps its own
copy of the JAX package's host modules and imports none of them.
"""
from __future__ import annotations

import math
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, TextIO, Tuple

from ..io.fasta import read_seqs

PAIRED, FIRST_LEG, SECOND_LEG, UNPAIRED, UNMAPPED = range(5)


def tnlog_decode(v: int) -> float:
    return math.exp(-v / 1000.0)


def tnlog(x: float) -> int:
    return int(1000 * -math.log(x)) if x > 0 else 2 ** 31 - 1


def qv_from_pr_corr(pr_corr: float) -> int:
    pr_err = 1 - pr_corr
    if pr_err > .99999999:
        return 0
    if pr_err < 1e-25:
        return 250
    return int(-10.0 * math.log(pr_err) / math.log(10.0))


@dataclass
class SamRec:
    fields: List[str]
    fileno: int
    z: Dict[int, float] = field(default_factory=dict)
    mate: Optional["SamRec"] = None

    @property
    def qname(self) -> str:
        return self.fields[0]

    @property
    def flag(self) -> int:
        return int(self.fields[1])

    @property
    def mapq(self) -> int:
        return int(self.fields[4])

    @mapq.setter
    def mapq(self, v: int) -> None:
        self.fields[4] = str(v)

    @property
    def score(self) -> int:
        for f in self.fields[11:]:
            if f.startswith("AS:i:"):
                return int(f[5:])
        return 0

    @property
    def mapped(self) -> bool:
        return not (self.flag & 0x4)

    @property
    def paired_seq(self) -> bool:
        return bool(self.flag & 0x1)

    @property
    def proper(self) -> bool:
        return bool(self.flag & 0x2)

    @property
    def first_in_pair(self) -> bool:
        return bool(self.flag & 0x40)

    def parse_z(self) -> None:
        for f in self.fields[11:]:
            if f.startswith("Z") and f[2:5] == ":i:":
                self.z[int(f[1])] = tnlog_decode(int(f[5:]))

    def rewrite_z(self) -> None:
        for i, f in enumerate(self.fields[11:], start=11):
            if f.startswith("Z") and f[2:5] == ":i:":
                zi = int(f[1])
                if zi in self.z:
                    self.fields[i] = f"Z{zi}:i:{tnlog(self.z[zi])}"

    def line(self) -> str:
        # mapq < 4 renders as 0 (render.c:237); internal selection
        # keeps the raw value like the reference heap
        if not self.mapped:
            return self.line_unaligned()
        f = list(self.fields)
        if f[4].isdigit() and int(f[4]) < 4:
            f[4] = "0"
        return "\t".join(f)

    def line_unaligned(self) -> str:
        """Unmapped records re-render with mate fields cleared and both
        unmapped bits set (render_sam_unaligned_string, render.c:27-39);
        only the CQ/CS/RG/R2 tags survive."""
        tags = [t for t in self.fields[11:]
                if t[:2] in ("CQ", "CS", "RG", "R2")]
        f = [self.fields[0], str(self.flag | 0x4 | 0x8), "*", "0", "0",
             "*", "*", "0", "0", self.fields[9], self.fields[10]]
        return "\t".join(f + tags)


_PIECE_RE = None


def _piece_split(name: str):
    """`contig/OFFSET` piece name -> (base, offset), else None (the
    overlap-halo contig splitting of tools/split.py, which goes beyond
    the reference's whole-contig-only sharding)."""
    global _PIECE_RE
    if _PIECE_RE is None:
        import re
        _PIECE_RE = re.compile(r"^(.*)/(\d+)$")
    m = _PIECE_RE.match(name)
    return (m.group(1), int(m.group(2))) if m else None


def _rebase_piece_fields(rec: SamRec) -> None:
    """Rebase a record mapped to a contig piece back to the whole
    contig: RNAME/POS and RNEXT/PNEXT."""
    ps = _piece_split(rec.fields[2]) if rec.fields[2] != "*" else None
    if ps is not None:
        rec.fields[2] = ps[0]
        rec.fields[3] = str(int(rec.fields[3]) + ps[1])
    if rec.fields[6] not in ("*", "="):
        ps2 = _piece_split(rec.fields[6])
        if ps2 is not None:
            rec.fields[6] = ps2[0]
            rec.fields[7] = str(int(rec.fields[7]) + ps2[1])
            if rec.fields[6] == rec.fields[2]:
                rec.fields[6] = "="


def classify(rec: SamRec) -> int:
    if not rec.mapped:
        return UNMAPPED
    if not rec.paired_seq:
        return UNPAIRED
    if rec.proper:
        return PAIRED
    if rec.flag & 0x8:  # mate unmapped
        return FIRST_LEG if rec.first_in_pair else SECOND_LEG
    return FIRST_LEG if rec.first_in_pair else SECOND_LEG


def _open_text(path: str):
    """Open a possibly-gzipped SAM file as text (the reference's
    mergesam reads inputs through a gz-capable file_buffer,
    mergesam/file_buffer.c)."""
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        import gzip
        return gzip.open(path, "rt")
    return open(path)


def _read_sam_grouped(path: str):
    """Yield (qname, [record-lines]) groups preserving order; pairs lines
    of the same read stay together (gmapper emits them adjacently)."""
    headers = []
    groups: Dict[str, List[List[str]]] = {}
    order: List[str] = []
    with _open_text(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            if line.startswith("@"):
                headers.append(line)
                continue
            fields = line.split("\t")
            qn = fields[0]
            if qn not in groups:
                groups[qn] = []
                order.append(qn)
            groups[qn].append(fields)
    return headers, groups, order


def merge_sam_files(reads_path: str, sam_paths: List[str], out: TextIO,
                    single_best: bool = False, strata: bool = False,
                    max_outputs: int = 10, max_alignments: int = 0,
                    insert_size_mean: float = 200.0,
                    insert_size_stddev: float = 100.0,
                    half_paired: bool = True,
                    mapping_qualities: bool = True) -> int:
    all_headers = None
    per_file = []
    genome_length = 0
    for fn, path in enumerate(sam_paths):
        headers, groups, order = _read_sam_grouped(path)
        if all_headers is None:
            all_headers = headers
        for h in headers:
            if h.startswith("@SQ") and fn == 0:
                pass
        per_file.append(groups)
    # genome length from ALL files' @SQ lines (mergesam.c:48-117);
    # contig pieces `name/OFFSET` (overlap-halo splitting) collapse to
    # their base contig with LN = max(offset + piece length)
    base_len: Dict[str, int] = {}
    sq_order: List[str] = []
    any_pieces = False
    for path in sam_paths:
        with _open_text(path) as f:
            for line in f:
                if not line.startswith("@"):
                    break
                if line.startswith("@SQ"):
                    name = ln = None
                    for t in line.rstrip().split("\t")[1:]:
                        if t.startswith("SN:"):
                            name = t[3:]
                        elif t.startswith("LN:"):
                            ln = int(t[3:])
                    if name is None:
                        continue
                    ps = _piece_split(name)
                    if ps is not None:
                        any_pieces = True
                        base, off = ps
                    else:
                        base, off = name, 0
                    if base not in base_len:
                        sq_order.append(base)
                        base_len[base] = 0
                    base_len[base] = max(base_len[base], off + (ln or 0))
    genome_length = sum(base_len.values())
    for h in all_headers or []:
        if any_pieces and h.startswith("@SQ"):
            continue   # replaced by the collapsed lines below
        out.write(h + "\n")
        if any_pieces and h.startswith("@HD"):
            for base in sq_order:
                out.write(f"@SQ\tSN:{base}\tLN:{base_len[base]}\n")

    # canonical read order from the reads file; paired data lists both
    # mates, merge emits one group per SAM qname (common prefix)
    emitted = set()
    for rec in read_seqs(reads_path):
        name = rec.name
        # find the matching SAM qname: exact, else the LONGEST proper
        # prefix ending at a ':'/'/' boundary (pair qnames are the
        # mates' common prefix with the separator stripped,
        # output.c:372-385) — a bare startswith would collapse p11/1
        # onto qname p1
        qn = None
        for groups in per_file:
            if name in groups:
                qn = name
                break
        if qn is None:
            # candidate qnames are exactly the proper prefixes of the
            # read name ending at a ':'/'/' boundary — probe those in
            # the qname dicts (longest first) instead of scanning every
            # qname per read, which is O(reads x qnames)
            best = None
            for i in range(len(name) - 1, 0, -1):
                if name[i] in ":/":
                    cand = name[:i]
                    if any(cand in groups for groups in per_file):
                        best = cand
                        break
            qn = best
        if qn is None or qn in emitted:
            continue
        emitted.add(qn)
        _merge_one_read(qn, per_file, out, genome_length, single_best,
                        strata, max_outputs, max_alignments, half_paired,
                        mapping_qualities, insert_size_mean,
                        insert_size_stddev)
    return 0


def _build_records(qn: str, per_file) -> List[List[SamRec]]:
    """Per class: the records across all files, mates linked."""
    classes: List[List[SamRec]] = [[] for _ in range(5)]
    for fn, groups in enumerate(per_file):
        lines = groups.get(qn, [])
        recs = [SamRec(fields=f, fileno=fn) for f in lines]
        for r in recs:
            r.parse_z()
            _rebase_piece_fields(r)
        # link adjacent mates (first/second flags)
        i = 0
        while i < len(recs):
            r = recs[i]
            if r.paired_seq and i + 1 < len(recs) and \
                    recs[i + 1].first_in_pair != r.first_in_pair:
                r.mate = recs[i + 1]
                recs[i + 1].mate = r
                i += 2
                a, b = r, r.mate
                for x in (a, b):
                    cl = classify(x)
                    if cl != UNMAPPED:
                        if cl == PAIRED:
                            if x.first_in_pair:
                                classes[PAIRED].append(x)
                        else:
                            classes[cl].append(x)
            else:
                cl = classify(r)
                if cl != UNMAPPED:
                    classes[cl].append(r)
                i += 1
    return classes


def _merge_one_read(qn: str, per_file, out: TextIO, genome_length: int,
                    single_best: bool, strata: bool, max_outputs: int,
                    max_alignments: int, half_paired: bool,
                    mapping_qualities: bool,
                    insert_size_mean: float = 200.0,
                    insert_size_stddev: float = 100.0) -> None:
    classes = _build_records(qn, per_file)
    n_files = len(per_file)

    # --- overlap-halo dedup: alignments duplicated inside split-contig
    # halos keep one copy; the removed copies' posterior mass is
    # subtracted from the additive z statistics so recombined MQVs
    # still match the whole-genome run exactly
    dup_z0 = [0.0] * 5
    dup_z2 = 0.0
    dup_ins = 0.0
    # per-class per-file additive z contributions, captured BEFORE
    # dedup so a file whose only record was a duplicate still counts
    file_z1 = [dict() for _ in range(5)]   # fileno -> z1
    file_z3 = {}                           # fileno -> (z3, z6)

    def _aln_key(r: SamRec):
        key = (r.fields[1], r.fields[2], r.fields[3], r.fields[5])
        if r.mate is not None:
            key += (r.mate.fields[1], r.mate.fields[2], r.mate.fields[3],
                    r.mate.fields[5])
        return key

    for cl in (PAIRED, FIRST_LEG, SECOND_LEG, UNPAIRED):
        seen_keys = {}
        kept = []
        for r in classes[cl]:
            if cl == PAIRED:
                file_z3.setdefault(r.fileno, (r.z.get(3, 0.0),
                                              r.z.get(6, 0.0)))
            else:
                file_z1[cl].setdefault(r.fileno, r.z.get(1, 0.0))
            k = _aln_key(r)
            if k in seen_keys:
                if cl == PAIRED:
                    dup_z2 += r.z.get(2, 0.0)
                    from ..paired import normal_cdf
                    isz = abs(int(r.fields[8]))
                    pr = (normal_cdf(isz + 10, insert_size_mean,
                                     insert_size_stddev)
                          - normal_cdf(isz - 10, insert_size_mean,
                                       insert_size_stddev))
                    dup_ins += max(pr, 1e-200)
                else:
                    dup_z0[cl] += r.z.get(0, 0.0)
            else:
                seen_keys[k] = r
                kept.append(r)
        classes[cl] = kept

    # --- consolidate PAIRED (sam_reader.c:119-295)
    paired = classes[PAIRED]
    if paired and mapping_qualities:
        z3_sum = sum(v[0] for v in file_z3.values()) - dup_z2
        ins_denom = sum(v[1] for v in file_z3.values()) - dup_ins
        z4_min = 1.0
        for pa in paired:
            z4_min = min(z4_min, pa.z.get(4, 1.0))
        for pa in paired:
            pa.z[3] = z3_sum
            pa.z[4] = z4_min
            pa.z[6] = ins_denom
            if pa.mate:
                pa.mate.z[3] = z3_sum
                pa.mate.z[4] = z4_min
                pa.mate.z[6] = ins_denom

    # --- consolidate legs / unpaired (sam_reader.c:297-400)
    def consolidate_single(cl: int, is_leg: bool):
        recs = classes[cl]
        if not recs or not mapping_qualities:
            return
        z1_sum = sum(file_z1[cl].values()) - dup_z0[cl]
        max_pa = None
        for pa in recs:
            if max_pa is None or max_pa.z.get(0, 0) < pa.z.get(0, 0):
                max_pa = pa
        for pa in recs:
            pa.z[1] = z1_sum
            if is_leg:
                pa.z[4] = max_pa.z.get(4, 1.0)

    consolidate_single(FIRST_LEG, True)
    consolidate_single(SECOND_LEG, True)
    consolidate_single(UNPAIRED, False)

    first_leg = classes[FIRST_LEG]
    second_leg = classes[SECOND_LEG]
    unpaired = classes[UNPAIRED]

    # --- class priors + mapqs (pp_ll_combine_and_check, :455-520)
    if mapping_qualities:
        def scale_of(recs):
            return (min(recs[0].z.get(4, 1.0) * genome_length, 1.0)
                    if recs else 1.0)
        paired_scale = scale_of(first_leg) * scale_of(second_leg)
        first_scale = (scale_of(paired) * scale_of(second_leg)
                       * first_leg[0].z.get(5, 0.0)) if first_leg else 0.0
        second_scale = (scale_of(paired) * scale_of(first_leg)
                        * second_leg[0].z.get(5, 0.0)) if second_leg else 0.0
        class_denom = ((paired_scale if paired else 0.0)
                       + (first_scale if first_leg else 0.0)
                       + (second_scale if second_leg else 0.0))
        if unpaired or class_denom > 0:
            for pa in paired:
                pa.mapq = qv_from_pr_corr(
                    (pa.z.get(2, 0.0) * paired_scale)
                    / (pa.z.get(3, 1.0) * class_denom))
                if pa.mate:
                    pa.mate.mapq = qv_from_pr_corr(
                        (pa.mate.z.get(2, 0.0) * paired_scale)
                        / (pa.mate.z.get(3, 1.0) * class_denom))
            for pa in first_leg:
                pa.mapq = qv_from_pr_corr(
                    (pa.z.get(0, 0.0) * first_scale)
                    / (pa.z.get(1, 1.0) * class_denom))
            for pa in second_leg:
                pa.mapq = qv_from_pr_corr(
                    (pa.z.get(0, 0.0) * second_scale)
                    / (pa.z.get(1, 1.0) * class_denom))
            for pa in unpaired:
                pa.mapq = qv_from_pr_corr(pa.z.get(0, 0.0)
                                          / pa.z.get(1, 1.0))

    # --- selection + emission
    def bounded(recs: List[SamRec], key):
        recs = sorted(recs, key=key)
        if strata and recs:
            recs = [r for r in recs if key(r) == key(recs[0])]
        if len(recs) > max_outputs:
            recs = recs[:max_outputs]
        if max_alignments and len(recs) > max_alignments:
            recs = []
        return recs

    if single_best and mapping_qualities:
        best = None
        for pa in paired + first_leg + second_leg + unpaired:
            cand = pa
            if pa.mate and pa.mate.mapped and pa.mate.mapq > pa.mapq:
                cand = pa.mate
            if best is None or cand.mapq > best.mapq:
                best = cand
        sel_paired = [best] if best is not None and classify(best) == PAIRED \
            else []
        sel_first = [best] if best is not None and \
            classify(best) == FIRST_LEG else []
        sel_second = [best] if best is not None and \
            classify(best) == SECOND_LEG else []
        sel_unpaired = [best] if best is not None and \
            classify(best) == UNPAIRED else []
    else:
        sel_paired = bounded(paired,
                             key=lambda p: (-(p.mapq + (p.mate.mapq if
                                                        p.mate else 0)),
                                            -(p.score + (p.mate.score if
                                                         p.mate else 0))))
        sel_first = bounded(first_leg, key=lambda p: (-p.mapq, -p.score))
        sel_second = bounded(second_leg, key=lambda p: (-p.mapq, -p.score))
        sel_unpaired = bounded(unpaired, key=lambda p: (-p.mapq, -p.score))

    for pa in sel_paired:
        for r in ((pa, pa.mate) if pa.first_in_pair else (pa.mate, pa)):
            if r is not None:
                r.rewrite_z()
                out.write(r.line() + "\n")
    for pa in sel_first + sel_second:
        pa.rewrite_z()
        first = pa if pa.first_in_pair else pa.mate
        second = pa.mate if pa.first_in_pair else pa
        for r in (first, second):
            if r is not None:
                r.rewrite_z()
                out.write(r.line() + "\n")
    for pa in sel_unpaired:
        pa.rewrite_z()
        out.write(pa.line() + "\n")
