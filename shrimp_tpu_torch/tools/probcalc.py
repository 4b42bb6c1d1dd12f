"""probcalc: pchance/pgenome/normodds statistics over SHRiMP-format
output (probcalc/probcalc.c).

Given the total genome length and one or more SHRiMP-format result
files, estimates mutation/error rates from the best alignments and
assigns each retained alignment
  - pchance:  probability the alignment arose by chance
              (probcalc.c:278-335),
  - pgenome:  probability a genuine genomic source would diverge this
              much (p_thissource, probcalc.c:391-436),
  - normodds: pgenome/pchance normalised over the read's alignments.

Mirrors the reference CLI: -n/-o/-p cutoffs, -s sort field, -t top
matches, -m matches kept per read, -g rates file / -r rates string,
-G rates-only, -R read sequences, -S single pass, -B progress bar.

Copied from `shrimp_tpu/tools/probcalc.py` unchanged: the port keeps its own
copy of the JAX package's host modules and imports none of them.
"""
from __future__ import annotations

import math
import os
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..io.shrimp_input import InputRecord, iter_records, open_maybe_gz

ALMOST_ZERO = 0.000000001
ALMOST_ONE = 0.999999999

DEF_NORMODDS_CUTOFF = 0.0
DEF_PCHANCE_CUTOFF = 1.0
DEF_PGENOME_CUTOFF = 0.0
DEF_TOP_MATCHES = 10
DEF_NUMBER_MATCHES = 100

SORT_PCHANCE, SORT_PGENOME, SORT_NORMODDS = 1, 2, 3


@dataclass
class Rates:
    samples: int = 0
    total_len: int = 0
    insertions: int = 0
    deletions: int = 0
    matches: int = 0
    mismatches: int = 0
    crossovers: int = 0
    erate: float = 0.0
    srate: float = 0.0
    irate: float = 0.0
    mrate: float = 0.0


class MatchHeap:
    """probcalc's fixed-size min-heap of matches per read
    (probcalc.c:119-157): slot scores start at INT32_MIN+i sentinels and
    save_match replaces the minimum."""

    __slots__ = ("cap", "scores", "recs")

    def __init__(self, cap: int):
        self.cap = cap
        self.scores: List[int] = [-(2 ** 31) + i for i in range(cap + 1)]
        self.scores[0] = cap
        self.recs: List[Optional[InputRecord]] = [None] * (cap + 1)

    def save_match(self, rec: InputRecord) -> None:
        s = self.scores
        if rec.score < s[1]:
            return
        s[1] = rec.score
        self.recs[1] = rec
        node = 1
        while True:
            left, right = node * 2, node * 2 + 1
            mx = node
            if left <= self.cap and s[left] < s[mx]:
                mx = left
            if right <= self.cap and s[right] < s[mx]:
                mx = right
            if mx == node:
                return
            s[node], s[mx] = s[mx], s[node]
            self.recs[node], self.recs[mx] = self.recs[mx], self.recs[node]
            node = mx

    def best(self) -> InputRecord:
        """Strictly-greater scan (calc_rates, probcalc.c:355-363)."""
        best = 0
        for i in range(1, self.cap + 1):
            if best == 0 or self.scores[i] > self.scores[best]:
                best = i
        return self.recs[best]

    def entries(self) -> List[InputRecord]:
        return [r for i, r in enumerate(self.recs[1:], 1)
                if self.scores[i] >= 0 and r is not None]


class _Stats:
    """objBinsTable (probcalc.c:1187-1218): compositions table for the
    indel placement counts."""

    def __init__(self):
        self.maxlen = -1
        self.table: List[List[float]] = []

    def init(self, maxlen: int) -> None:
        if maxlen <= self.maxlen:
            return
        self.maxlen = maxlen
        t = [[0.0] * (maxlen + 1) for _ in range(maxlen + 1)]
        for obj in range(maxlen + 1):
            for bins in range(maxlen + 1):
                if obj < bins:
                    t[obj][bins] = 0.0
                elif obj == bins or bins == 1:
                    t[obj][bins] = 1.0
                else:
                    t[obj][bins] = sum(t[obj - bins][i]
                                       for i in range(1, bins + 1))
        self.table = t


_stats = _Stats()


def _lchoose(n: int, m: int) -> float:
    """fastlchoose (probcalc.c:1249-1252), lgamma-based."""
    if m > n:
        return 0.0
    return (math.lgamma(n + 1) - math.lgamma(n - m + 1)
            - math.lgamma(m + 1))


_LS_FACT = [math.log(math.factorial(i)) for i in range(21)]


def _ls_factorial(n: int) -> float:
    """util.c:263-299: exact to 20!, Stirling's approximation beyond."""
    if n <= 20:
        return _LS_FACT[n]
    return (math.log(math.sqrt(2 * math.pi * n))
            + n * math.log(n / math.e))


def _ls_choose(n: int, k: int) -> float:
    """util.c:301-315 (p_thissource uses this, NOT fastlchoose)."""
    if k < 0 or k > n:
        return 0.0
    return _ls_factorial(n) - (_ls_factorial(k) + _ls_factorial(n - k))


def _choose(n: int, m: int) -> float:
    if m > n:
        return 0.0
    return math.exp(_lchoose(n, m))


def _fact(n: int) -> float:
    return math.exp(math.lgamma(n + 1))


def _read_indel_stats(readlen: int, editstr: str
                      ) -> Tuple[float, float, float, float]:
    """readIndelStats + editstr_to_stats (probcalc.c:1272-1349):
    run-length histograms of insertion ('-' runs) and deletion (paren
    nucleotide runs) events."""
    del_freq = [0] * (readlen + 1)
    ins_freq = [0] * (readlen + 1)
    inins = indel = 0
    inssize = -1
    delsize = -1
    for ch in editstr:
        isnuc = ch in "ACTG"
        if ch == "-" and inins:
            inssize += 1
        elif ch == "-":
            inins = 1
            inssize = 1
        elif inins:
            inins = 0
            ins_freq[inssize] += 1
            inssize = 0
        if ch == "(":
            indel = 1
            delsize = 0
        elif isnuc and indel:
            delsize += 1
        elif ch == ")":
            indel = 0
            del_freq[delsize] += 1
            delsize = 0
    if indel:
        del_freq[delsize] += 1
    if inins:
        ins_freq[inssize] += 1
    delev = insev = 0.0
    deln = insn = 1.0
    for i in range(readlen + 1):
        if del_freq[i]:
            delev += del_freq[i]
            deln *= _fact(del_freq[i])
        if ins_freq[i]:
            insev += ins_freq[i]
            insn *= _fact(ins_freq[i])
    return delev, insev, deln, insn


def _max_count(ins: int, dels: int, length: int, delev: float, deln: float,
               insev: float, insn: float) -> float:
    t = _stats.table
    return ((_fact(int(delev)) / deln) * (_fact(int(insev)) / insn)
            * _choose(length, int(insev)) * t[dels][int(delev)]
            * _choose(int(length + delev - ins), int(delev))
            * math.pow(3.0, float(dels)))


def _min_count(ins: int, dels: int, length: int, delev: float, deln: float
               ) -> float:
    t = _stats.table
    if ins == 0:
        return ((_fact(int(delev)) / deln)
                * _choose(int(length + delev), int(delev))
                * math.pow(3.0, float(dels)))
    return ((_fact(int(delev)) / deln) * t[dels][int(delev)]
            * _choose(int(length + delev - ins), int(delev))
            * math.pow(3.0, float(dels)))


def p_chance(genome_len: int, k: int, nsubs: int, nerrors: int,
             origlen: int, ins: int, dels: int, editstr: str) -> float:
    """probcalc.c:278-335."""
    corr_fact = origlen - k + 1
    delev, insev, deln, insn = _read_indel_stats(origlen, editstr)
    # subCount (probcalc.c:1240-1242)
    r = _lchoose(k, nsubs + nerrors) + (nsubs + nerrors) * math.log(3.0)
    r += math.log(0.5 * (_max_count(ins, dels, k, delev, deln, insev, insn)
                         + _min_count(ins, dels, k, delev, deln)))
    r += math.log(float(corr_fact))
    if r <= k * math.log(4.0):
        r -= k * math.log(4.0)
    else:
        return 1.0
    r = math.exp(r)
    if 1 - r == 1:
        r = (2.0 * genome_len) * r
    else:
        r = 1 - r
        r = 2 * genome_len * math.log(r)
        r = 1.0 - math.exp(r)
    return max(r, ALMOST_ZERO)


def p_thissource(k: int, nerrors: int, erate: float, nsubs: int,
                 subrate: float, nindels: int, indelrate: float) -> float:
    """probcalc.c:391-436."""
    p_err = 0.0
    for i in range(nerrors):
        p_err += math.exp(_ls_choose(k - 1, i) + i * math.log(erate)
                          + (k - 1 - i) * math.log(1 - erate))
    p_err = 1 - p_err
    p_sub = 0.0
    for i in range(nsubs):
        p_sub += math.exp(_ls_choose(k - 2 - nerrors, i)
                          + i * math.log(subrate)
                          + (k - 2 - nerrors - i) * math.log(1 - subrate))
    p_sub = 1 - p_sub
    p_indel = 0.0
    for i in range(nindels):
        p_indel += math.exp(_ls_choose(k - 1, i) + i * math.log(indelrate)
                            + (k - 1 - i) * math.log(1 - indelrate))
    p_indel = 1 - p_indel
    r = p_err * p_sub * p_indel
    return min(max(r, ALMOST_ZERO), ALMOST_ONE)


class ProbcalcState:
    def __init__(self, genome_len: int, number_matches: int,
                 pchance_cutoff: float):
        self.genome_len = genome_len
        self.number_matches = number_matches
        self.pchance_cutoff = pchance_cutoff
        self.read_list: Dict[str, MatchHeap] = {}
        self.total_alignments = 0
        self.total_unique_reads = 0
        self.max_read_len = 0

    def read_file(self, path: str) -> None:
        with open_maybe_gz(path) as fp:
            for rec in iter_records(fp):
                self.total_alignments += 1
                heap = self.read_list.get(rec.read)
                if heap is None:
                    self.total_unique_reads += 1
                    heap = MatchHeap(self.number_matches)
                    self.read_list[rec.read] = heap
                    heap.save_match(rec)
                elif rec.score > heap.scores[1]:
                    heap.save_match(rec)
                self.max_read_len = max(self.max_read_len, rec.read_length)

    def accumulate_rates(self, rates: Rates) -> None:
        """calc_rates over every read's best match (probcalc.c:337-389)."""
        for heap in self.read_list.values():
            rs = heap.best()
            if rs is None:
                continue
            rlen = rs.matches + rs.mismatches + rs.deletions
            d = p_chance(self.genome_len, rlen, rs.mismatches,
                         rs.crossovers, rs.read_length, rs.insertions,
                         rs.deletions, rs.edit)
            if d < self.pchance_cutoff:
                rates.samples += 1
                rates.total_len += rs.matches + rs.mismatches
                rates.insertions += rs.insertions
                rates.deletions += rs.deletions
                rates.matches += rs.matches
                rates.mismatches += rs.mismatches
                rates.crossovers += rs.crossovers


def finish_rates(rates: Rates) -> None:
    rates.erate = rates.crossovers / rates.total_len if rates.total_len \
        else 0.0
    rates.srate = rates.mismatches / rates.total_len if rates.total_len \
        else 0.0
    rates.irate = ((rates.insertions + rates.deletions) / rates.total_len
                   if rates.total_len else 0.0)
    rates.mrate = rates.matches / rates.total_len if rates.total_len \
        else 0.0
    for f in ("erate", "srate", "irate", "mrate"):
        if getattr(rates, f) == 0.0:
            setattr(rates, f, ALMOST_ZERO)


def calc_probs_for_read(heap: MatchHeap, rates: Rates, genome_len: int,
                        pchance_cutoff: float
                        ) -> List[Tuple[InputRecord, float, float, float]]:
    """pchance/pgenome/normodds for a read's saved matches
    (calc_probs, probcalc.c:475-590); returns (rec, normodds, pgenome,
    pchance) tuples with normodds normalised."""
    rspv = []
    norm = 0.0
    for rs in heap.entries():
        if rs.score < 0:
            continue
        rlen = rs.matches + rs.mismatches + rs.deletions
        s = p_chance(genome_len, rlen, rs.mismatches, rs.crossovers,
                     rs.read_length, rs.insertions, rs.deletions, rs.edit)
        if s < ALMOST_ZERO or math.isnan(s):
            s = ALMOST_ZERO
        if s > pchance_cutoff:
            continue
        k = rs.matches + rs.mismatches
        pg = p_thissource(k, rs.crossovers, rates.erate, rs.mismatches,
                          rates.srate, rs.insertions + rs.deletions,
                          rates.irate)
        no = pg / s
        norm += no
        rspv.append([rs, no, pg, s])
    for row in rspv:
        row[1] = row[1] / norm if norm else 0.0
    return [tuple(r) for r in rspv]


def _sort_key(sort_field: int):
    if sort_field == SORT_PCHANCE:
        return lambda r: r[3]
    if sort_field == SORT_PGENOME:
        return lambda r: -r[2]
    return lambda r: -r[1]


FORMAT = ("#FORMAT: readname contigname strand contigstart contigend "
          "readstart readend readlength score editstring "
          "{}normodds pgenome pchance")


def emit(rows, sort_field: int, top_matches: int, normodds_cutoff: float,
         pgenome_cutoff: float, pchance_cutoff: float, rflag: bool,
         out) -> None:
    """Filtered, sorted emission (calc_probs steps 3-4)."""
    rows = sorted(rows, key=_sort_key(sort_field))
    printed = 0
    for rs, no, pg, pc in rows:
        if printed >= top_matches:
            break
        if no < normodds_cutoff:
            if sort_field == SORT_NORMODDS:
                break
            continue
        if pg < pgenome_cutoff:
            if sort_field == SORT_PGENOME:
                break
            continue
        if pc > pchance_cutoff:
            if sort_field == SORT_PCHANCE:
                break
            continue
        printed += 1
        readseq = ""
        if rs.read_seq:
            readseq = rs.read_seq
        elif rflag:
            readseq = " "
        out.write(">%s\t%s\t%c\t%u\t%u\t%d\t%d\t%d\t%d\t%s\t%s%s%e\t%e\t%e\n"
                  % (rs.read, rs.genome, "-" if rs.revcmpl else "+",
                     rs.genome_start + 1, rs.genome_end + 1,
                     rs.read_start + 1, rs.read_end + 1, rs.read_length,
                     rs.score, rs.edit, readseq if rflag else "",
                     "\t" if rflag else "", no, pg, pc))


def _iter_files(paths: List[str]) -> List[str]:
    """file_iterator_n: each arg is a file or a directory of files."""
    out = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(os.path.join(p, f) for f in os.listdir(p)
                              if os.path.isfile(os.path.join(p, f))))
        else:
            out.append(p)
    return out


def parse_rates_string(s: str) -> Rates:
    parts = s.split(",")
    if len(parts) != 4:
        raise SystemExit("error: failed to parse -r argument")
    r = Rates()
    r.erate, r.srate, r.irate, r.mrate = (float(x) for x in parts)
    for f in ("erate", "srate", "irate", "mrate"):
        v = getattr(r, f)
        if v > 1.0:
            raise SystemExit("error: user-provided rate(s) > 1.0")
        if v == 0.0:
            setattr(r, f, ALMOST_ZERO)
    return r


def load_rates_file(path: str, state: ProbcalcState) -> Rates:
    """-g file: '>' lines of 9 accumulated counters (probcalc.c:648-697)."""
    r = Rates()
    with open(path) as fp:
        for line in fp:
            if not line.startswith(">"):
                continue
            vals = [int(x) for x in line[1:].split()]
            if len(vals) != 9:
                raise SystemExit(
                    "error: failed to parse rates file line [%s]"
                    % line.strip())
            state.total_alignments += vals[0]
            state.total_unique_reads += vals[1]
            r.samples += vals[2]
            r.total_len += vals[3]
            r.insertions += vals[4]
            r.deletions += vals[5]
            r.matches += vals[6]
            r.mismatches += vals[7]
            r.crossovers += vals[8]
    return r


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="probcalc", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-g", dest="rates_file")
    ap.add_argument("-n", dest="normodds_cutoff", type=float,
                    default=DEF_NORMODDS_CUTOFF)
    ap.add_argument("-o", dest="pgenome_cutoff", type=float,
                    default=DEF_PGENOME_CUTOFF)
    ap.add_argument("-p", dest="pchance_cutoff", type=float,
                    default=DEF_PCHANCE_CUTOFF)
    ap.add_argument("-r", dest="rates_string")
    ap.add_argument("-s", dest="sort", default="pchance",
                    choices=["pchance", "pgenome", "normodds"])
    ap.add_argument("-t", dest="top_matches", type=int,
                    default=DEF_TOP_MATCHES)
    ap.add_argument("-m", dest="number_matches", type=int,
                    default=DEF_NUMBER_MATCHES)
    ap.add_argument("-B", dest="progress", action="store_true")
    ap.add_argument("-G", dest="rates_only", action="store_true")
    ap.add_argument("-R", dest="read_seq", action="store_true")
    ap.add_argument("-S", dest="single_pass", action="store_true")
    ap.add_argument("genome_len", type=int)
    ap.add_argument("inputs", nargs="+")
    args = ap.parse_args(argv)

    if args.rates_file and args.rates_string:
        raise SystemExit("error: -g and -r flags cannot be mixed")
    if args.rates_only and args.rates_file:
        raise SystemExit("error: -G and -g flags cannot be mixed")

    sort_field = {"pchance": SORT_PCHANCE, "pgenome": SORT_PGENOME,
                  "normodds": SORT_NORMODDS}[args.sort]
    files = _iter_files(args.inputs)
    if not files:
        raise SystemExit("error: no files found to parse!")
    out = sys.stdout

    # The reference's single-pass (-S) holds everything in RAM; its
    # double-pass re-reads each file per phase assuming a read's matches
    # are file-local.  Both reduce to the same math; we stream per file
    # in double-pass mode for the same memory profile.
    def one_state() -> ProbcalcState:
        return ProbcalcState(args.genome_len, args.number_matches,
                             args.pchance_cutoff)

    rates: Optional[Rates] = None
    if args.rates_string:
        rates = parse_rates_string(args.rates_string)

    header_written = False

    def run_probs(state: ProbcalcState) -> None:
        nonlocal header_written
        _stats.init(state.max_read_len)
        if not header_written:
            out.write(FORMAT.format("readsequence " if args.read_seq
                                    else "") + "\n")
            header_written = True
        for name in state.read_list:
            rows = calc_probs_for_read(
                state.read_list[name], rates, args.genome_len,
                args.pchance_cutoff)
            emit(rows, sort_field, args.top_matches, args.normodds_cutoff,
                 args.pgenome_cutoff, args.pchance_cutoff, args.read_seq,
                 out)

    if args.single_pass:
        state = one_state()
        for f in files:
            state.read_file(f)
        _stats.init(state.max_read_len)
        if rates is None:
            if args.rates_file:
                rates = load_rates_file(args.rates_file, state)
            else:
                rates = Rates()
                state.accumulate_rates(rates)
            if args.rates_only:
                print(">%d %d %d %d %d %d %d %d %d"
                      % (state.total_alignments, state.total_unique_reads,
                         rates.samples, rates.total_len, rates.insertions,
                         rates.deletions, rates.matches, rates.mismatches,
                         rates.crossovers))
                return 0
            finish_rates(rates)
        if state.total_unique_reads == 0 and args.rates_string is None:
            raise SystemExit("error: no matches were found in input "
                             "file(s)")
        run_probs(state)
        return 0

    # double pass: pass 1 rates (one best match per read per file)
    if rates is None:
        acc = Rates()
        tot_aligns = tot_unique = 0
        max_rl = 0
        if args.rates_file:
            s0 = one_state()
            rates = load_rates_file(args.rates_file, s0)
            tot_aligns, tot_unique = (s0.total_alignments,
                                      s0.total_unique_reads)
        else:
            for f in files:
                st = ProbcalcState(args.genome_len, 1, args.pchance_cutoff)
                st.read_file(f)
                _stats.init(st.max_read_len)
                st.accumulate_rates(acc)
                tot_aligns += st.total_alignments
                tot_unique += st.total_unique_reads
                max_rl = max(max_rl, st.max_read_len)
            rates = acc
        if tot_unique == 0 and args.rates_string is None \
                and not args.rates_file:
            raise SystemExit("error: no matches were found in input "
                             "file(s)")
        if args.rates_only:
            print(">%d %d %d %d %d %d %d %d %d"
                  % (tot_aligns, tot_unique, rates.samples,
                     rates.total_len, rates.insertions, rates.deletions,
                     rates.matches, rates.mismatches, rates.crossovers))
            return 0
        finish_rates(rates)
    # pass 2: probabilities, one file at a time
    for f in files:
        st = one_state()
        st.read_file(f)
        run_probs(st)
    return 0


if __name__ == "__main__":
    sys.exit(main())
