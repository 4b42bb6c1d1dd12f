"""probcalc_mp: mate-pair analysis of probcalc output
(probcalc_mp/probcalc_mp.c).

Pass 1 estimates the insert-size mean/stdev/histogram from read pairs
with a unique "good" pairing (same strand, correct order, distance
below -M); pass 2 scores every fwd x rev mapping combination with
  - pgenome: pg_fwd * pg_rev * Pr[|dist-mean| this large] (cumulative
    histogram tail, probcalc_mp.c:885-906),
  - pchance: distance-adjusted chance probabilities (:915-932),
  - normodds: pgenome/pchance normalised per pair group,
and prints the top -T combinations per group.

Reference quirks reproduced exactly:
  - the ASCII parser only consumes a field at a tab boundary, so the
    final pchance column (no trailing tab) is never read and every
    mapping's pchance is 0.0 (fresh stack page in the reference);
  - `-x` falls through to `-d` (sets discordant) and `-i` falls through
    to `-M` (sets distcutoff=atoll(type)=0) in the reference getopt
    (probcalc_mp.c:121-183);
  - the final read group in the file is never analysed (no trailing
    mp_analysis call, probcalc_mp.c:500-508).

Copied from `shrimp_tpu/tools/probcalc_mp.py` unchanged: the port keeps its own
copy of the JAX package's host modules and imports none of them.
"""
from __future__ import annotations

import math
import struct
import sys
from dataclasses import dataclass, field
from typing import List, Optional, TextIO

MAX_READS = 100
HIST_BINS = 2000
MEAN_MPS = 50000
PCHANCE_CUTOFF = 0.05
PGENOME_CUTOFF = 0.95
PRINT_MAX = 20
ALMOST_ZERO = 0.000000001
ALMOST_ONE = 0.999999999

MEAN_PASS, OUTPUT_PASS = 0, 1
SORT_PGENOME, SORT_PCHANCE, SORT_NORMODDS = 0, 1, 2

# mapping_t with C alignment (dbtypes.h:8-24)
_BIN_FMT = "<32s32sQQcBBBB32s3xddd"
assert struct.calcsize(_BIN_FMT) == 144


@dataclass
class Mapping:
    readname: str = ""
    contigname: str = ""
    strand: str = "+"
    contigstart: int = 0
    contigend: int = 0
    readstart: int = 0
    readend: int = 0
    readlength: int = 0
    score: int = 0
    editstring: str = ""
    normodds: float = 0.0
    pgenome: float = 0.0
    pchance: float = 0.0


class ProbcalcMP:
    def __init__(self, fwd_suffix: str, rev_suffix: str, genome_length: int,
                 distcutoff: int, rflag: bool = False, discordant: int = 0,
                 do_unique: int = 0, gl_mean_nr: int = MEAN_MPS,
                 print_max: int = PRINT_MAX,
                 pgenome_cutoff: float = PGENOME_CUTOFF,
                 pchance_cutoff: float = PCHANCE_CUTOFF,
                 allow_diff_chr: int = 1, quickmode: int = 0,
                 nr_stdev: float = 2.0, max_reads: int = MAX_READS,
                 sort_field: int = SORT_PGENOME, binary: bool = False,
                 out: Optional[TextIO] = None):
        self.fwd_suffix = fwd_suffix
        self.rev_suffix = rev_suffix
        self.genome_length = genome_length
        self.distcutoff = distcutoff
        self.hist_distcutoff = distcutoff
        self.rflag = rflag
        self.discordant = discordant
        self.do_unique = do_unique
        self.gl_mean_nr = gl_mean_nr
        self.print_max = print_max
        self.pgenome_cutoff = pgenome_cutoff
        self.pchance_cutoff = pchance_cutoff
        self.allow_diff_chr = allow_diff_chr
        self.quickmode = quickmode
        self.nr_stdev = nr_stdev
        self.max_reads = max_reads
        self.sort_field = sort_field
        self.binary = binary
        self.out = out or sys.stdout
        # global statistics (probcalc_mp.c:39-46)
        self.gl_mean = 0.0
        self.gl_stdev = 0.0
        self.gl_hist = [0] * HIST_BINS
        self.gl_hist_cumsum = [0.0] * HIST_BINS
        self.gl_good_mps = 0
        self.gl_done_mean = 0
        self.gl_uniq_reads = 0
        self.gl_printed_mp = 0
        self.called_mp = False

    # ------------------------------------------------------------- parsing
    def iter_mappings(self, path: str):
        if self.binary:
            with open(path, "rb") as fp:
                while True:
                    buf = fp.read(144)
                    if len(buf) < 144:
                        return
                    vals = struct.unpack(_BIN_FMT, buf)
                    m = Mapping(
                        readname=vals[0].split(b"\0")[0].decode(),
                        contigname=vals[1].split(b"\0")[0].decode(),
                        contigstart=vals[2], contigend=vals[3],
                        strand=vals[4].decode(), readstart=vals[5],
                        readend=vals[6], readlength=vals[7],
                        score=vals[8],
                        editstring=vals[9].split(b"\0")[0].decode(),
                        normodds=vals[10], pgenome=vals[11],
                        pchance=vals[12])
                    yield m
            return
        with open(path, "r") as fp:
            for line in fp:
                if line.startswith("#"):
                    continue
                m = Mapping()
                # tab-boundary parse: the last piece is never consumed
                parts = line.split("\t")
                for fieldnr, val in enumerate(parts[:-1], 1):
                    if fieldnr == 1:
                        m.readname = val
                    elif fieldnr == 2:
                        m.contigname = val
                    elif fieldnr == 3:
                        m.strand = val
                    elif fieldnr == 4:
                        m.contigstart = int(val)
                    elif fieldnr == 5:
                        m.contigend = int(val)
                    elif fieldnr == 6:
                        m.readstart = int(val)
                    elif fieldnr == 7:
                        m.readend = int(val)
                    elif fieldnr == 8:
                        m.readlength = int(val)
                    elif fieldnr == 9:
                        m.score = int(float(val))
                    elif fieldnr == 10:
                        m.editstring = val
                    elif fieldnr == 11:
                        if not self.rflag:
                            m.normodds = float(val)
                    elif fieldnr == 12:
                        if self.rflag:
                            m.normodds = float(val)
                        else:
                            m.pgenome = float(val)
                    elif fieldnr == 13:
                        if self.rflag:
                            m.pgenome = float(val)
                        else:
                            m.pchance = float(val)
                    elif fieldnr == 14:
                        if self.rflag:
                            m.pchance = float(val)
                        else:
                            raise SystemExit(
                                "no R Flag, and too many fields")
                yield m

    def is_forward(self, name: str) -> bool:
        if name.endswith(self.fwd_suffix):
            return True
        if name.endswith(self.rev_suffix):
            return False
        raise SystemExit("error: read is neither forward nor reverse\n"
                         "read name: %s   fwd_suffix: %s   rev_suffix: %s"
                         % (name, self.fwd_suffix, self.rev_suffix))

    # ------------------------------------------------------------ filepass
    def filepass(self, path: str, pass_type: int) -> int:
        """probcalc_mp.c:317-509 (minus the progress bar)."""
        self.gl_good_mps = 0 if pass_type == MEAN_PASS else self.gl_good_mps
        fwd_maps: List[Mapping] = []
        rev_maps: List[Mapping] = []
        nr_reads = 0
        do_analysis = 1
        cur_name: Optional[str] = None
        stop = False
        for m in self.iter_mappings(path):
            if stop:
                break
            name = m.readname
            fwd = self.is_forward(name)
            test_name = name[:len(name) - (len(self.fwd_suffix) if fwd
                                           else len(self.rev_suffix))]
            if cur_name != test_name:
                if nr_reads > 0 and fwd_maps and rev_maps and do_analysis:
                    self.mp_analysis(fwd_maps, rev_maps, pass_type)
                if fwd_maps:
                    self.gl_uniq_reads += 1
                if rev_maps:
                    self.gl_uniq_reads += 1
                do_analysis = 1
                if pass_type == MEAN_PASS and self.gl_done_mean:
                    stop = True
                    break
                cur_name = test_name
                fwd_maps = []
                rev_maps = []
                nr_reads += 1
            if pass_type == MEAN_PASS and self.do_unique and \
                    ((fwd and len(fwd_maps) >= 1)
                     or (not fwd and len(rev_maps) >= 1)):
                do_analysis = 0
            if do_analysis:
                (fwd_maps if fwd else rev_maps).append(m)
        # NB: the reference never analyses the final group
        return nr_reads

    # --------------------------------------------------------- statistics
    def good_mp_dst(self, f: Mapping, r: Mapping) -> int:
        """probcalc_mp.c:761-801."""
        if f.contigstart < r.contigstart:
            cs_fwd, cs_rev = f.contigstart, r.contigend
        else:
            cs_fwd, cs_rev = f.contigend, r.contigstart
        dist = abs(cs_fwd - cs_rev)
        is_small = dist < self.distcutoff
        plus = f.strand == r.strand == "+"
        minus = f.strand == r.strand == "-"
        if is_small and ((plus and cs_rev < cs_fwd)
                         or (minus and cs_fwd < cs_rev)):
            return dist
        return 0

    def increments_stats(self, dist: int) -> None:
        """Welford mean/stdev + histogram (probcalc_mp.c:807-853)."""
        self.gl_good_mps += 1
        prev_mean = self.gl_mean
        self.gl_mean += (dist - self.gl_mean) / self.gl_good_mps
        self.gl_stdev += (dist - prev_mean) * (dist - self.gl_mean)
        binnr = int(math.floor(dist * 1.0 / self.hist_distcutoff
                               * HIST_BINS))
        if 0 <= binnr < HIST_BINS:
            self.gl_hist[binnr] += 1
        if (self.gl_mean_nr != 0 and self.gl_good_mps >= self.gl_mean_nr
                and abs(prev_mean - self.gl_mean) < 1.0):
            self.gl_done_mean = 1

    def compute_cumsum(self) -> None:
        """probcalc_mp.c:706-722."""
        self.gl_hist_cumsum[0] = 1.0
        mean_bin = int(math.floor(self.gl_mean * 1.0 / self.hist_distcutoff
                                  * HIST_BINS))
        for i in range(1, HIST_BINS):
            subtract = 0
            if mean_bin + (i - 1) < HIST_BINS:
                subtract += self.gl_hist[mean_bin + (i - 1)]
            if mean_bin - (i - 1) > 0 and (i - 1) != 0:
                subtract += self.gl_hist[mean_bin - (i - 1)]
            v = self.gl_hist_cumsum[i - 1] - subtract / self.gl_good_mps
            self.gl_hist_cumsum[i] = max(v, 0.0)

    # ------------------------------------------------------------ analysis
    def mp_analysis(self, fwd_maps: List[Mapping], rev_maps: List[Mapping],
                    pass_type: int) -> None:
        """probcalc_mp.c:517-622."""
        good_mps = 0
        good_dist = 0
        if pass_type == MEAN_PASS or self.discordant:
            for f in fwd_maps:
                for r in rev_maps:
                    d = self.good_mp_dst(f, r)
                    if d > 0:
                        good_dist = d
                        good_mps += 1
                    if pass_type == MEAN_PASS and good_mps > 1:
                        break
                if pass_type == MEAN_PASS and good_mps > 1:
                    break
        if pass_type == MEAN_PASS and good_mps == 1:
            self.increments_stats(good_dist)
        if pass_type == OUTPUT_PASS and (not self.discordant
                                         or good_mps == 0):
            mp_set = []
            totnormodds = 0.0
            for f in fwd_maps:
                for r in rev_maps:
                    row = self.add_p_stats(f, r)
                    if row is not None:
                        mp_set.append(row)
                        totnormodds += row[3]
            rows = [(f, r, d, (no / totnormodds if totnormodds else 0.0),
                     pg, pc) for (f, r, d, no, pg, pc) in mp_set]
            if self.sort_field == SORT_PGENOME:
                key = lambda t: -t[4]
            elif self.sort_field == SORT_PCHANCE:
                key = lambda t: t[5]
            else:
                key = lambda t: -t[3]
            rows.sort(key=key)
            if not self.called_mp:
                self.out.write(
                    "#FORMAT: fwd_name fwd_chr fwd_editstring fwd_strand "
                    "fwd_start fwd_end fwd_pg"
                    "rev_name rev_chr rev_editstring rev_strand rev_start "
                    "rev_end rev_pg"
                    "distance normodds pgenome pchance\n")
                self.called_mp = True
            for i, (f, r, d, no, pg, pc) in enumerate(rows):
                if i >= self.print_max and key(rows[i - 1]) != key(rows[i]):
                    break
                self.out.write("%d\t" % self.gl_printed_mp)
                self.gl_printed_mp += 1
                self.out.write("%s\t%s\t%s\t%s\t%d\t%d\t%1.3f\t"
                               % (f.readname[1:], f.contigname,
                                  f.editstring, f.strand, f.contigstart,
                                  f.contigend, f.pgenome))
                self.out.write("%s\t%s\t%s\t%s\t%d\t%d\t%1.3f\t"
                               % (r.readname[1:], r.contigname,
                                  r.editstring, r.strand, r.contigstart,
                                  r.contigend, r.pgenome))
                self.out.write("%d\t%1.3f\t%1.3f\t%1.10f\n"
                               % (d, no, pg, pc))

    def add_p_stats(self, f: Mapping, r: Mapping):
        """probcalc_mp.c:859-952."""
        if not self.allow_diff_chr and f.contigname != r.contigname:
            return None
        if f.contigstart < r.contigstart:
            cs_fwd, cs_rev = f.contigstart, r.contigend
        else:
            cs_fwd, cs_rev = f.contigend, r.contigstart
        dist = abs(cs_fwd - cs_rev)
        if self.discordant:
            pgenome = f.pgenome * r.pgenome
        else:
            pgenome_bin = int(math.floor(abs(dist - self.gl_mean)
                                         / self.hist_distcutoff
                                         * HIST_BINS))
            cum = (0.0 if pgenome_bin >= HIST_BINS
                   else self.gl_hist_cumsum[pgenome_bin])
            pgenome = f.pgenome * r.pgenome * cum
        pgenome = min(ALMOST_ONE, pgenome)
        if pgenome < self.pgenome_cutoff:
            return None
        if self.discordant or self.quickmode:
            pchance = f.pchance * r.pchance
        else:
            x = abs(dist - self.gl_mean + 1) * 1.0 / self.genome_length
            alt_f = 1 - math.pow(1 - f.pchance, x)
            alt_r = 1 - math.pow(1 - r.pchance, x)
            pchance = (f.pchance * alt_r + r.pchance * alt_f) / 2
        pchance = max(ALMOST_ZERO, pchance)
        if pchance > self.pchance_cutoff:
            return None
        return (f, r, dist, pgenome / pchance, pgenome, pchance)

    # ----------------------------------------------------------------- run
    def run(self, path: str) -> None:
        self.filepass(path, MEAN_PASS)
        stdev = math.sqrt(self.gl_stdev / self.gl_good_mps) \
            if self.gl_good_mps else 0.0
        print("Mean: %.2f. STDev: %.2f (%d good pairs)"
              % (self.gl_mean, stdev, self.gl_good_mps), file=sys.stderr)
        self.compute_cumsum()
        self.distcutoff = int(math.ceil(self.gl_mean
                                        + self.nr_stdev * stdev))
        print("new M cutoff: %d = %.2f + %.2f * %.2f"
              % (self.distcutoff, self.gl_mean, self.nr_stdev, stdev),
              file=sys.stderr)
        self.filepass(path, OUTPUT_PASS)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="probcalc_mp", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-m", dest="mapping_file", required=True)
    ap.add_argument("-f", dest="fwd_suffix", required=True)
    ap.add_argument("-b", dest="rev_suffix", required=True)
    ap.add_argument("-g", dest="genome_length", type=int, required=True)
    ap.add_argument("-M", dest="distcutoff", type=int, required=True)
    ap.add_argument("-x", dest="max_reads", type=int, default=None,
                    help="max mappings per read (NB: reference fall-"
                    "through also sets -d)")
    ap.add_argument("-R", dest="rflag", action="store_true")
    ap.add_argument("-d", dest="discordant", action="store_true")
    ap.add_argument("-u", dest="do_unique", action="store_true")
    ap.add_argument("-L", dest="mean_nr", type=int, default=MEAN_MPS)
    ap.add_argument("-T", dest="print_max", type=int, default=PRINT_MAX)
    ap.add_argument("-G", dest="pgenome_cutoff", type=float,
                    default=PGENOME_CUTOFF)
    ap.add_argument("-C", dest="pchance_cutoff", type=float,
                    default=PCHANCE_CUTOFF)
    ap.add_argument("-c", dest="same_chr_only", action="store_true")
    ap.add_argument("-q", dest="quickmode", action="store_true")
    ap.add_argument("-s", dest="nr_stdev", type=float, default=2.0)
    ap.add_argument("-i", dest="input_type", default="ascii",
                    choices=["ascii", "binary"])
    args = ap.parse_args(argv)

    discordant = args.discordant or (args.max_reads is not None)
    mp = ProbcalcMP(
        fwd_suffix=args.fwd_suffix, rev_suffix=args.rev_suffix,
        genome_length=args.genome_length, distcutoff=args.distcutoff,
        rflag=args.rflag, discordant=int(discordant),
        do_unique=int(args.do_unique), gl_mean_nr=args.mean_nr,
        print_max=args.print_max, pgenome_cutoff=args.pgenome_cutoff,
        pchance_cutoff=args.pchance_cutoff,
        allow_diff_chr=int(not args.same_chr_only),
        quickmode=int(args.quickmode), nr_stdev=args.nr_stdev,
        max_reads=args.max_reads or MAX_READS,
        binary=args.input_type == "binary")
    mp.run(args.mapping_file)
    return 0


if __name__ == "__main__":
    sys.exit(main())
