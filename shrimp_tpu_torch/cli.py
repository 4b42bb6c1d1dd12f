"""Command-line interface: `python -m shrimp_tpu_torch {index,map,merge,...}`

Port of `shrimp_tpu/cli.py`, every subcommand: `index` and `map`, with
the reference's flags, config building, index load/build/save and
output, mirroring the gmapper command-line surface
(gmapper/gmapper.c:1720-3110) with explicit subcommands instead of
argv[0] dispatch; `map --cs` replaces the gmapper-cs symlink. Flag names
follow gmapper's long options (gmapper-defaults.h:74-173). Two flags
are new: `--device` (default `cuda`) names the torch device the mapper
runs on; `--device cpu` runs the plain PyTorch versions of the kernels,
and `cuda` without a card raises; `map --spans PATH` records the
mapper's spans (`utils/spans.py`) and writes them as Chrome trace JSON.
`map` writes its SAM through the fast streams where the config allows
them and through the generic mapper otherwise, as the reference does;
`map --shrimp-format -P` prints each hit's alignment after its line. The
memory cap (`--max-mem`, default 64 GB, and `--strict-mem`) is installed
before any index is built.

The host tools run the same on any machine and take no `--device`:
`merge` (mergesam), the split-db workflow (`split-db`, `project-db`,
`split-reads`, `split-contigs`), `temp-sink`, `fasta2fastq`,
`lineindex`, `shrimp2sam`, and the legacy tools `probcalc`,
`probcalc-mp`, `prettyprint`, `shrimp-var` and `colorconsensus`, which
take their own arguments.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time
from typing import List, Optional

from . import constants as C
from .utils import spans

# the fast streams map their input in windows of at least this many
# records, each drained before the next is read
WINDOW_READS = 32768
# the legacy SHRiMP1 tools, which take their own argv verbatim
LEGACY_TOOLS = ("probcalc", "probcalc-mp", "prettyprint", "shrimp-var",
                "colorconsensus")


def _add_map_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--cs", action="store_true",
                   help="colour-space mode (gmapper-cs)")
    p.add_argument("-s", "--seeds", default=None,
                   help="comma-separated spaced seeds or w<N>")
    p.add_argument("-o", "--report", type=int, default=C.DEF_NUM_OUTPUTS,
                   help="maximum hits to report per read")
    p.add_argument("-w", "--match-window", type=float,
                   default=C.DEF_WINDOW_LEN)
    p.add_argument("-n", "--cmw-mode", type=int, default=None)
    p.add_argument("-l", "--cmw-overlap", type=float,
                   default=C.DEF_WINDOW_OVERLAP)
    p.add_argument("-a", "--anchor-width", type=int,
                   default=C.DEF_ANCHOR_WIDTH)
    p.add_argument("-r", "--cmw-threshold", type=float,
                   default=C.DEF_WINDOW_GEN_THRESHOLD)
    p.add_argument("-h-threshold", "--full-threshold", type=float,
                   default=C.DEF_SW_FULL_THRESHOLD, dest="full_threshold")
    p.add_argument("-v", "--vec-threshold", type=float,
                   default=C.DEF_SW_VECT_THRESHOLD)
    p.add_argument("-m", "--match", type=int, default=None)
    p.add_argument("-i", "--mismatch", type=int, default=None)
    p.add_argument("-g", "--open-r", type=int, default=None)
    p.add_argument("-q", "--open-q", type=int, default=None)
    p.add_argument("-e", "--ext-r", type=int, default=None)
    p.add_argument("-f", "--ext-q", type=int, default=None)
    p.add_argument("-x", "--crossover", type=int, default=None)
    p.add_argument("-p", "--pair-mode", default="none",
                   choices=["none", "opp-in", "opp-out", "col-fw", "col-bw"])
    p.add_argument("-I", "--isize", default=None,
                   help="min,max insert size")
    p.add_argument("--insert-size-dist", default=None, help="mean,stddev")
    p.add_argument("-z", "--cutoff", type=int, default=None,
                   help="index list cutoff")
    p.add_argument("-V", "--trim-off", action="store_true",
                   help="disable automatic index trimming")
    p.add_argument("--strata", action="store_true")
    p.add_argument("--max-alignments", type=int, default=0)
    p.add_argument("--local", action="store_true",
                   help="local alignment instead of global")
    p.add_argument("-U", "--ungapped", action="store_true")
    p.add_argument("-C", "--negative", action="store_true",
                   help="reverse strand only")
    p.add_argument("-F", "--positive", action="store_true",
                   help="forward strand only")
    p.add_argument("-t", "--tiebreak-off", action="store_true")
    p.add_argument("--no-mapping-qualities", action="store_true")
    p.add_argument("--single-best-mapping", action="store_true")
    p.add_argument("--all-contigs", action="store_true")
    p.add_argument("--no-half-paired", action="store_true")
    p.add_argument("--no-improper-mappings", action="store_true")
    p.add_argument("--sam-unaligned", action="store_true")
    p.add_argument("--sam-r2", action="store_true")
    p.add_argument("--read-group", default=None, help="name,sample")
    p.add_argument("--qv-offset", type=int, default=None)
    p.add_argument("--ignore-qvs", action="store_true")
    p.add_argument("--longest-read", type=int,
                   default=C.DEF_LONGEST_READ_LENGTH)
    p.add_argument("--trim-front", type=int, default=0)
    p.add_argument("--trim-end", type=int, default=0)
    p.add_argument("--trim-first", action="store_true",
                   help="trim only the first read in each pair")
    p.add_argument("--trim-second", action="store_true",
                   help="trim only the second read in each pair")
    p.add_argument("--trim-illumina", action="store_true")
    p.add_argument("--min-avg-qv", type=int, default=10)
    p.add_argument("--no-qv-check", action="store_true")
    p.add_argument("--unpaired-options", action="append", default=[],
                   metavar="NIP;RO",
                   help="multi-round unpaired option-set DSL "
                        "(gmapper.c:2204-2220); may be repeated")
    p.add_argument("--paired-options", action="append", default=[],
                   metavar="PAIRING;RO;RO",
                   help="multi-round paired option-set DSL "
                        "(gmapper.c:2184-2201); may be repeated")
    p.add_argument("--un", default=None,
                   help="write unaligned reads to this file")
    p.add_argument("--al", default=None,
                   help="write aligned reads to this file")
    p.add_argument("-1", "--upstream", default=None,
                   help="first-mate reads file (use with -2)")
    p.add_argument("-2", "--downstream", default=None,
                   help="second-mate reads file (use with -1)")
    p.add_argument("--bfast", action="store_true",
                   help="bfast-style CS base qualities (CS only)")
    p.add_argument("-P", "--pretty", action="store_true",
                   help="pretty-print alignments (SHRiMP format only)")
    p.add_argument("--half-paired", action="store_true",
                   dest="half_paired_on")
    p.add_argument("--use-regions", action="store_true",
                   dest="toggle_regions",
                   help="toggle the region-count prefilter (default: on)")
    p.add_argument("--region-bits", type=int, default=None)
    p.add_argument("--pr-xover", type=float, default=None)
    p.add_argument("--no-autodetect-input", action="store_true")
    p.add_argument("--sam-header", default=None,
                   help="replace the whole SAM header with this file")
    p.add_argument("--sam-header-hd", default=None)
    p.add_argument("--sam-header-sq", default=None)
    p.add_argument("--sam-header-rg", default=None)
    p.add_argument("--sam-header-pg", default=None)
    p.add_argument("-N", "--threads", type=int, default=None,
                   help="host filter threads (device work is batched)")
    p.add_argument("-K", "--thread-chunk", type=int, default=None,
                   help="accepted for gmapper compatibility; batching "
                        "replaces per-thread read chunks")
    p.add_argument("-Z", "--cachebypass-off", action="store_true",
                   help="accepted for gmapper compatibility; batch-level "
                        "window dedup replaces the per-thread SW cache")
    p.add_argument("-G", "--global", action="store_true",
                   dest="global_mode",
                   help="global alignment (the default)")
    p.add_argument("--extra-sam-fields", action="store_true")
    p.add_argument("--shrimp-format", action="store_true",
                   help="legacy SHRiMP output format instead of SAM")
    p.add_argument("-R", "--print-reads", action="store_true",
                   help="include read sequence in legacy format")
    p.add_argument("--progress", type=int, default=100000)
    p.add_argument("-B", "--batch-size", type=int, default=4096)
    p.add_argument("-Q", "--fastq", action="store_true",
                   help="force fastq input")
    p.add_argument("-M", "--mode", default=None,
                   help="mode presets, e.g. mirna")
    p.add_argument("-E", "--sam", action="store_true",
                   help="output SAM format (the default here; accepted "
                        "for gmapper command-line compatibility)")
    p.add_argument("-L", "--load-index", default=None,
                   help="load a saved genome index (gmapper -L; takes "
                        "the saved .npz path, a prefix thereof, or a "
                        "warm mmap image directory)")
    p.add_argument("-H", "--hash-spaced-kmers", action="store_true",
                   help="24-bit hashed mapidx (for seeds of weight > 14)")
    p.add_argument("-X", "--insert-histogram", action="store_true",
                   help="print insert-size histogram (paired mode)")
    p.add_argument("-Y", "--index-histogram", action="store_true",
                   help="print per-seed index list-length histogram")
    p.add_argument("-D", "--detailed-stats", action="store_true",
                   help="print detailed per-stage statistics")
    p.add_argument("-S", "--save", default=None, metavar="PREFIX",
                   help="project + index the genome and save it as "
                        "PREFIX.genome.npz / PREFIX.seed.N.npz, then exit "
                        "without mapping (gmapper -S); with -L and -z, "
                        "re-checkpoints the loaded index after trimming "
                        "(gmapper.c:2846-2857)")
    p.add_argument("--max-mem", type=float, default=64.0, metavar="GB",
                   help="global memory cap in GB (my_alloc_init analogue, "
                        "gmapper.c:1740; default 64)")
    p.add_argument("--strict-mem", action="store_true",
                   help="fail (not just warn) when the cap is exceeded "
                        "(MYALLOC_ERR_MAX analogue)")
    p.add_argument("--device", default="cuda",
                   help="torch device to map on: cuda (the default; "
                        "raises without a card) or cpu (the plain "
                        "PyTorch versions of the kernels)")
    p.add_argument("--spans", default=None, metavar="PATH",
                   help="record the mapper's spans (the CLI window, reads "
                        "in, SAM out, the pipeline lanes, every stage and "
                        "host-to-device copy) and write them to PATH as "
                        "Chrome trace JSON at the end of the run")


def build_config(args) -> "MapperConfig":
    from .config import MapperConfig, Scores
    mode = C.MODE_COLOUR_SPACE if args.cs else C.MODE_LETTER_SPACE
    if args.mode == "mirna":
        # miRNA preset (set_mode_from_string, gmapper.c:1498-1521)
        args.hash_spaced_kmers = True
        args.ungapped = True
        args.anchor_width = 0
        args.open_r = args.open_q = -255
        args.match_window = 100.0
        args.local = True
        args.no_mapping_qualities = True
        if args.cmw_mode is None:
            args.cmw_mode = 1
    sc = Scores() if mode == C.MODE_LETTER_SPACE else Scores.cs_defaults()
    if args.match is not None:
        sc.match = args.match
    if args.mismatch is not None:
        sc.mismatch = args.mismatch
    if args.open_r is not None:
        sc.a_gap_open = args.open_r
        if args.open_q is None:
            sc.b_gap_open = args.open_r
    if args.open_q is not None:
        sc.b_gap_open = args.open_q
    if args.ext_r is not None:
        sc.a_gap_extend = args.ext_r
        if args.ext_q is None:
            sc.b_gap_extend = args.ext_r
    if args.ext_q is not None:
        sc.b_gap_extend = args.ext_q
    if args.crossover is not None:
        sc.crossover = args.crossover
    kw = dict(
        mode=mode, scores=sc,
        window_len=args.match_window,
        window_overlap=args.cmw_overlap,
        window_gen_threshold=args.cmw_threshold,
        sw_full_threshold=args.full_threshold,
        sw_vect_threshold=args.vec_threshold,
        num_outputs=args.report,
        num_tmp_outputs=20 + args.report,
        anchor_width=args.anchor_width,
        longest_read_len=args.longest_read,
        global_alignment=not args.local,
        gapless=args.ungapped,
        strata=args.strata,
        max_alignments=args.max_alignments,
        rev_tiebreak=not args.tiebreak_off,
        compute_mapping_qualities=not args.no_mapping_qualities,
        single_best_mapping=args.single_best_mapping,
        all_contigs=args.all_contigs,
        half_paired=not args.no_half_paired,
        improper_mappings=not args.no_improper_mappings,
        sam_unaligned=args.sam_unaligned,
        sam_r2=args.sam_r2,
        shrimp_format=args.shrimp_format,
        ignore_qvs=args.ignore_qvs,
        pair_mode=args.pair_mode,
        extra_sam_fields=args.extra_sam_fields,
        list_cutoff=args.cutoff,
        trim_front=args.trim_front,
        trim_end=args.trim_end,
        trim_illumina=args.trim_illumina,
        min_avg_qv=args.min_avg_qv,
        no_qv_check=args.no_qv_check,
        custom_unpaired_options=tuple(args.unpaired_options),
        custom_paired_options=tuple(args.paired_options),
        bfast=args.bfast,
    )
    if args.ungapped and not args.local:
        raise SystemExit("error: cannot use global (or bfast) and "
                         "ungapped mode at the same time!")
    if args.pretty and not args.shrimp_format:
        raise SystemExit("error: -P/--pretty requires --shrimp-format")
    if args.sam_unaligned and args.shrimp_format:
        raise SystemExit("error: when using flag --sam-unaligned must "
                         "also use SAM output")
    if args.toggle_regions:
        kw["use_regions"] = False
    if args.region_bits is not None:
        if not 8 <= args.region_bits <= 20:
            raise SystemExit(f"invalid number of region bits: "
                             f"{args.region_bits}; must be between 8 and 20")
        kw["region_bits"] = args.region_bits
    if args.pr_xover is not None:
        kw["pr_xover"] = args.pr_xover
    if args.half_paired_on:
        kw["half_paired"] = True
    if args.paired_options:
        # the first paired set's pair mode takes over (gmapper.c:2201)
        from .config import parse_paired_options_arg
        try:
            first = parse_paired_options_arg(args.paired_options[0])
        except ValueError as exc:
            raise SystemExit(f"error: {exc}")
        kw["pair_mode"] = first.pairing.pair_mode
        if args.unpaired_options:
            # both kinds present -> half-paired (gmapper.c:2185-2212)
            kw["half_paired"] = True
    elif args.unpaired_options:
        from .config import parse_unpaired_options_arg
        try:
            for t in args.unpaired_options:
                parse_unpaired_options_arg(t)
        except ValueError as exc:
            raise SystemExit(f"error: {exc}")
    if args.trim_first or args.trim_second:
        if args.pair_mode == C.PAIR_NONE:
            raise SystemExit("error: cannot use --trim-first or "
                             "--trim-second in unpaired mode")
        kw["trim_first"] = args.trim_first or not args.trim_second
        kw["trim_second"] = args.trim_second or not args.trim_first
    if args.cmw_mode is not None:
        kw["match_mode"] = args.cmw_mode
    if args.isize:
        mn, mx = args.isize.split(",")
        kw["min_insert_size"] = int(mn)
        kw["max_insert_size"] = int(mx)
    if args.insert_size_dist:
        mean, std = args.insert_size_dist.split(",")
        kw["insert_size_mean"] = float(mean)
        kw["insert_size_stddev"] = float(std)
    if args.read_group:
        parts = args.read_group.split(",")
        kw["read_group_name"] = parts[0]
        kw["sam_sample_name"] = parts[1] if len(parts) > 1 else parts[0]
    if args.qv_offset is not None:
        kw["qual_delta"] = args.qv_offset
    if args.negative and not args.positive:
        kw["search_forward"] = False
    if args.positive and not args.negative:
        kw["search_reverse"] = False
    return MapperConfig(**kw)


def load_or_build_index(genome_args: List[str], seeds_spec: Optional[str],
                        mode: str, mirna: bool = False,
                        hashed: bool = False):
    from .core import encode
    from .index.build import GenomeIndex, build_index
    from .index.seeds import default_seeds, mirna_seeds, parse_seeds
    from .io.fasta import read_fasta
    import os
    if len(genome_args) == 1:
        g = genome_args[0]
        explicit_build = bool(seeds_spec) or mirna or hashed
        if g.endswith(".genome.npz") or (os.path.exists(g + ".genome.npz")
                                         and not explicit_build):
            # split-file checkpoint (gmapper -S layout): short-form -L
            # prefix loads genome + every seed projection. A sibling
            # checkpoint next to a FASTA argument is only auto-loaded
            # when no explicit seed/mode flags ask for a fresh build —
            # otherwise the stale index would silently win over -s/-H.
            base = g if g.endswith(".genome.npz") else g + ".genome"
            if not g.endswith(".genome.npz"):
                print(f"Loading saved index {base}.npz (pass -s/-H or "
                      "delete it to rebuild)", file=sys.stderr)
            return GenomeIndex.load_split(base)
        if g.endswith(".npz"):
            return GenomeIndex.load(g)
        if os.path.isdir(g):
            # warm mmap image (--save-mmap analogue, genome.c:606-667)
            return GenomeIndex.load_mmap(g)
    if mirna:
        seeds = mirna_seeds()
    elif seeds_spec:
        seeds = parse_seeds(seeds_spec, hashed=hashed)
    else:
        seeds = default_seeds()
    contigs = []
    for path in genome_args:
        for rec in read_fasta(path):
            print(f"- Processing contig {rec.name}", file=sys.stderr)
            contigs.append((rec.name, encode.encode_ls(rec.seq)))
    return build_index(contigs, seeds, mode=mode, hashed=hashed)


def print_settings(cfg, idx, out) -> None:
    """Effective-settings dump at startup (print_settings,
    gmapper.c:1350-1497): seeds, thresholds, scores with their derived
    probabilities — the reference prints this for reproducibility."""
    cal = cfg.calibration
    print("Settings:", file=out)
    seeds = idx.seeds
    label = "    Spaced Seeds (weight/span)"
    for i, si in enumerate(seeds):
        s = si.seed
        mask = "".join("1" if k in set(s.offsets) else "0"
                       for k in range(s.span))
        print(f"{label if i == 0 else ' ' * len(label)}"
              f"             {mask} ({s.weight}/{s.span})", file=out)
    mode_name = ("COLOUR SPACE" if cfg.mode == C.MODE_COLOUR_SPACE
                 else "LETTER SPACE")
    rows = [
        ("Mode", mode_name),
        ("Window length", f"{cfg.window_len:.2f}%"
         if cfg.window_len >= 0 else str(-cfg.window_len)),
        ("Window overlap length", f"{cfg.window_overlap:.2f}%"
         if cfg.window_overlap >= 0 else str(-cfg.window_overlap)),
        ("Seed matches per window", str(cfg.match_mode)),
        ("Anchor width", str(cfg.anchor_width)),
        ("Indel taboo len", str(cfg.indel_taboo_len)),
        ("Gapless mode", "yes" if cfg.gapless else "no"),
        ("Global alignment", "yes" if cfg.global_alignment else "no"),
        ("Region filter", "yes" if cfg.use_regions else "no"),
        ("Region size", str(1 << cfg.region_bits)),
        ("Region overlap", str(cfg.region_overlap)),
        ("Ignore QVs", "yes" if cfg.ignore_qvs else "no"),
        ("Compute mapping qualities",
         "yes" if cfg.compute_mapping_qualities else "no"),
        ("All contigs", "yes" if cfg.all_contigs else "no"),
        ("Single best mapping",
         "yes" if cfg.single_best_mapping else "no"),
        ("Half paired", "yes" if cfg.half_paired else "no"),
        ("Number of outputs", str(cfg.num_outputs)),
        ("Window gen. threshold", f"{cfg.window_gen_threshold:.2f}%"),
        ("S-W vect. threshold", f"{cfg.sw_vect_threshold:.2f}%"),
        ("S-W full threshold", f"{cfg.sw_full_threshold:.2f}%"),
    ]
    if cfg.pair_mode != C.PAIR_NONE:
        rows += [("Pair mode", cfg.pair_mode),
                 ("Insert size", f"{cfg.min_insert_size},"
                                 f"{cfg.max_insert_size}"),
                 ("Insert size dist", f"{cfg.insert_size_mean:.0f},"
                                      f"{cfg.insert_size_stddev:.0f}")]
    for k, v in rows:
        print(f"    {k}:{' ' * max(1, 40 - len(k) - 5)}{v}", file=out)
    sc = cfg.scores
    print(f"\n    SW Match Score:                         {sc.match}",
          file=out)
    print(f"    SW Mismatch Score [Prob]:               {sc.mismatch}"
          f"\t[{cal.pr_mismatch:.1e}]", file=out)
    print(f"    SW Del Open Score [Prob]:               {sc.b_gap_open}"
          f"\t[{cal.pr_del_open:.1e}]", file=out)
    print(f"    SW Ins Open Score [Prob]:               {sc.a_gap_open}"
          f"\t[{cal.pr_ins_open:.1e}]", file=out)
    print(f"    SW Del Extend Score [Prob]:             {sc.b_gap_extend}"
          f"\t[{cal.pr_del_extend:.1e}]", file=out)
    print(f"    SW Ins Extend Score [Prob]:             {sc.a_gap_extend}"
          f"\t[{cal.pr_ins_extend:.1e}]", file=out)
    if cfg.mode == C.MODE_COLOUR_SPACE:
        print(f"    SW Crossover Score:                     "
              f"{sc.crossover}", file=out)
    print("", file=out)


def print_index_histogram(idx, list_cutoff: int, out=None) -> None:
    """-Y: per-seed list-length stats + 100-bucket histogram
    (print_genomemap_stats, genome.c:834-902)."""
    import numpy as np
    if out is None:
        out = sys.stderr
    print("Genome Map stats:", file=out)
    cutoff = list_cutoff if list_cutoff else (1 << 62)
    for sn, si in enumerate(idx.seeds):
        lens = si.list_lengths().astype(np.int64)
        capacity = len(lens)
        over = lens > cutoff
        eff = np.where(over, 0, lens)
        nz = eff[eff > 0]
        mx = int(eff.max()) if capacity else 0
        sd = float(eff.std(ddof=1)) if capacity > 1 else 0.0
        sd_nz = float(nz.std(ddof=1)) if len(nz) > 1 else 0.0
        print(f"sn:{sn} weight:{si.seed.weight} "
              f"total_kmers:{int(eff.sum())} lists:{capacity} "
              f"(non-zero:{len(nz)}) "
              f"list_sz_avg:{float(eff.mean()) if capacity else 0:.2f} "
              f"({float(nz.mean()) if len(nz) else 0:.2f}) "
              f"list_sz_stddev:{sd:.2f} ({sd_nz:.2f}) max:{mx}", file=out)
        bucket_size = -(-(mx + 1) // 100)
        bucket = np.where(over, 0, np.minimum(lens // bucket_size, 99))
        hist = np.bincount(bucket.astype(np.int64), minlength=100)
        cum = np.cumsum(hist)
        for i in range(100):
            print(f"[{i * bucket_size}-{(i + 1) * bucket_size}]: {hist[i]} "
                  f"(cummulative: {cum[i] / capacity * 100:.4f}%)",
                  file=out)


class InsertHistogram:
    """-X: 100-bucket insert-size histogram
    (gmapper.c:664-677, output.c:1255-1264)."""

    def __init__(self, min_insert: int, max_insert: int):
        self.min = min_insert
        self.bucket_size = max(
            1, -(-(max_insert - min_insert + 1) // 100))
        self.hist = [0] * 100
        self.total = 0

    def add_pair_entry(self, pe) -> None:
        for ph in getattr(pe, "final_paired_hits", []) or []:
            self.total += 1
            if getattr(ph, "improper_mapping", False):
                continue
            b = (ph.insert_size - self.min) // self.bucket_size
            self.hist[min(max(b, 0), 99)] += 1

    def print(self, out=None) -> None:
        if out is None:
            out = sys.stderr
        for i in range(100):
            lo = self.min + i * self.bucket_size
            hi = self.min + (i + 1) * self.bucket_size - 1
            pct = (0.0 if self.total == 0
                   else self.hist[i] / self.total * 100)
            print(f"[{lo}-{hi}]: {pct:.2f}%", file=out)


def cmd_index(args) -> int:
    mode = C.MODE_COLOUR_SPACE if args.cs else C.MODE_LETTER_SPACE
    idx = load_or_build_index(args.genome, args.seeds, mode,
                              mirna=args.mode == "mirna",
                              hashed=getattr(args, "hash_spaced_kmers",
                                             False) or args.mode == "mirna")
    if args.save_mmap:
        idx.save_mmap(args.output)
    else:
        idx.save(args.output)
    print(f"Saved genome index to {args.output}", file=sys.stderr)
    return 0


def cmd_map(args) -> int:
    from .io import sam
    from .io.fasta import detect_fastq, read_seqs
    from .mapper import Mapper
    from .paired import PairedMapper

    if args.cs and args.trim_front:
        # gmapper.c:2135: front trims would eat the CS primer base
        raise SystemExit(
            "--trim-front cannot be used in colour space mode!")
    split_mates = args.upstream is not None or args.downstream is not None
    if split_mates:
        if args.upstream is None or args.downstream is None:
            raise SystemExit('error: when using "-1" must also specify '
                             '"-2" (and vice versa)')
        # the reads positional slot actually holds the first genome path
        if args.reads is not None:
            args.genome = [args.reads] + args.genome
            args.reads = None
    preloaded_idx = None
    if args.load_index is not None:
        # gmapper -L: genome positionals are not needed; whatever landed
        # in the genome slot is treated as extra reads-file noise only if
        # reads is unset (mirrors gmapper's argv layout `-L idx reads`)
        if args.reads is None and args.genome:
            args.reads = args.genome[0]
            args.genome = args.genome[1:]
        lp = args.load_index
        if "," in lp:
            # long form `-L genome,seed_a,seed_b`: explicit seed-subset
            # load (genome.c:670-831, README:680-719)
            from .index.build import GenomeIndex
            parts = lp.split(",")
            preloaded_idx = GenomeIndex.load_split(parts[0], parts[1:])
            args.genome = []
        else:
            if not os.path.exists(lp) and os.path.exists(lp + ".npz"):
                lp = lp + ".npz"
            args.genome = [lp]
    if args.save is not None and args.reads is not None \
            and args.load_index is None:
        # gmapper -S layout `-S prefix genome.fa`: with no mapping run
        # the first positional is a genome file, not reads
        args.genome = [args.reads] + args.genome
        args.reads = None
    if not split_mates and args.reads is None and args.save is None:
        raise SystemExit("error: no reads file given")
    if not args.genome and preloaded_idx is None:
        raise SystemExit("error: no genome given")

    t_load = time.time()
    cfg = build_config(args)
    idx = preloaded_idx if preloaded_idx is not None else \
        load_or_build_index(args.genome, args.seeds, cfg.mode,
                            mirna=args.mode == "mirna",
                            hashed=args.hash_spaced_kmers)
    print(f"Loaded genome in {time.time()-t_load:.1f}s", file=sys.stderr)

    if args.save is not None:
        # -S: project + index + save, then exit without mapping
        # (gmapper.c:2846-2857); with -L and -z this re-checkpoints the
        # loaded index after trimming
        if args.cutoff:
            print(f"\nTrimming index lists longer than: {args.cutoff}",
                  file=sys.stderr)
            idx.trim(args.cutoff)
        print(f"Saving genome map to {args.save}", file=sys.stderr)
        idx.save_split(args.save)
        return 0

    if args.spans:
        spans.enable()
    paired = cfg.pair_mode != C.PAIR_NONE
    mapper = (PairedMapper(idx, cfg, args.device) if paired
              else Mapper(idx, cfg, args.device))
    # host filter threads (-N); the device work is batched
    mapper.f1_threads = args.threads
    print_settings(cfg, idx, sys.stderr)
    if args.index_histogram:
        print_index_histogram(idx, mapper.cutoff)
    ins_hist = (InsertHistogram(cfg.min_insert_size, cfg.max_insert_size)
                if args.insert_histogram and paired else None)

    probe = args.upstream if split_mates else args.reads
    fastq = args.fastq or (not args.no_autodetect_input
                           and detect_fastq(probe))
    out = sys.stdout
    if cfg.shrimp_format:
        from .io import shrimp_format
        line = shrimp_format.FORMAT_LINE
        if args.print_reads:
            line += " readsequence"
        out.write(line + "\n")
    else:
        for line in sam.sam_header(idx, " ".join(sys.argv), cfg,
                                   header_file=args.sam_header,
                                   hd_file=args.sam_header_hd,
                                   sq_file=args.sam_header_sq,
                                   rg_file=args.sam_header_rg,
                                   pg_file=args.sam_header_pg):
            out.write(line + "\n")

    un_f = open(args.un, "w") if args.un else None
    al_f = open(args.al, "w") if args.al else None

    def write_read(f, re_):
        if re_.qual is not None:
            f.write(f"@{re_.name}\n{re_.seq}\n+\n{re_.qual}\n")
        else:
            f.write(f">{re_.name}\n{re_.seq}\n")

    nreads = 0
    t0 = time.time()
    B = args.batch_size
    if paired and B % 2:
        B += 1
    total_lines = 0

    def flush(batch):
        nonlocal total_lines
        if not batch:
            return
        if paired:
            pairs = mapper.map_paired(batch)
            for pe in pairs:
                if ins_hist is not None:
                    ins_hist.add_pair_entry(pe)
                p_out, u_out = mapper.select_output(pe)
                for line in sam.render_pair_entry(pe, idx, cfg, p_out,
                                                  u_out, fastq=fastq):
                    out.write(line + "\n")
                    total_lines += 1
                any_mapped = pe.mapped or any(e.mapped for e in pe.re)
                for e in pe.re:
                    if al_f and any_mapped:
                        write_read(al_f, e)
                    if un_f and not any_mapped:
                        write_read(un_f, e)
        elif cfg.shrimp_format:
            from .io import shrimp_format
            for re_, hits in mapper.map_unpaired(batch):
                for h in hits:
                    out.write(shrimp_format.output_normal(
                        re_, h, idx, include_read=args.print_reads) + "\n")
                    total_lines += 1
                    if args.pretty:
                        # -P: alignment block after each hit line
                        # (hit_output, gmapper/output.c:283-290)
                        from .tools.prettyprint import output_pretty
                        coff = int(idx.contig_offsets[h.cn])
                        glen = int(idx.contig_lengths[h.cn])
                        out.write(output_pretty(
                            h, idx.codes[coff:coff + glen], glen,
                            cfg.mode == C.MODE_COLOUR_SPACE,
                            re_.codes[h.st], re_.read_len,
                            re_.initbp[h.st], h.gen_st == 1) + "\n")
                if al_f and hits:
                    write_read(al_f, re_)
                if un_f and not hits:
                    write_read(un_f, re_)
        else:
            for re_, hits in mapper.map_unpaired(batch):
                for h in hits:
                    out.write(sam.render_unpaired(re_, h, idx, cfg,
                                                  fastq=fastq) + "\n")
                    total_lines += 1
                if not hits and cfg.sam_unaligned:
                    out.write(sam.render_unpaired(re_, None, idx, cfg,
                                                  fastq=fastq) + "\n")
                    total_lines += 1
                if al_f and hits:
                    write_read(al_f, re_)
                if un_f and not hits:
                    write_read(un_f, re_)

    # Flat-array fast path (fastpath.py): SAM straight to bytes,
    # pipelined across batches. A window whose first batch the flat
    # encoder rejects goes through the generic mapper.
    use_fast = False
    if (not cfg.shrimp_format
            and un_f is None and al_f is None
            and (not paired or ins_hist is None)):
        from .fastpath import (fastpath_paired_supported,
                               fastpath_supported,
                               map_paired_sam_stream,
                               map_unpaired_sam_stream)
        from .fastpath_cs import (fastpath_cs_paired_supported,
                                  fastpath_cs_supported,
                                  map_paired_cs_sam_stream,
                                  map_unpaired_cs_sam_stream)
        if paired and cfg.mode == C.MODE_COLOUR_SPACE:
            use_fast = fastpath_cs_paired_supported(cfg)
        elif paired:
            use_fast = fastpath_paired_supported(cfg)
        elif cfg.mode == C.MODE_COLOUR_SPACE:
            use_fast = fastpath_cs_supported(cfg)
        else:
            use_fast = fastpath_supported(cfg)
    win_size = max(8 * B, WINDOW_READS) if use_fast else B
    out_b = getattr(out, "buffer", None)

    def flush_window(win):
        nonlocal total_lines
        if not win:
            return
        if paired and cfg.mode == C.MODE_COLOUR_SPACE:
            gen = map_paired_cs_sam_stream(mapper, win, batch_size=B)
        elif paired:
            gen = map_paired_sam_stream(mapper, win, batch_size=B)
        elif cfg.mode == C.MODE_COLOUR_SPACE:
            gen = map_unpaired_cs_sam_stream(mapper, win, batch_size=B)
        else:
            gen = map_unpaired_sam_stream(mapper, win, batch_size=B)
        if gen is None:
            for off in range(0, len(win), B):
                flush(win[off:off + B])
            return
        for chunk in gen:
            total_lines += chunk.count(b"\n")
            with mapper.span("cli write", bytes=len(chunk)):
                if out_b is not None:
                    out_b.write(chunk)
                else:
                    out.write(chunk.decode())

    def input_records():
        if not split_mates:
            yield from read_seqs(args.reads, fastq=fastq)
            return
        # -1/-2: interleave the two mate files (gmapper.c:356-376)
        it1 = read_seqs(args.upstream, fastq=fastq)
        it2 = read_seqs(args.downstream, fastq=fastq)
        while True:
            r1 = next(it1, None)
            r2 = next(it2, None)
            if (r1 is None) != (r2 is None):
                raise SystemExit(
                    "error: when using options -1 and -2, both files "
                    "specified must have the same number of entries")
            if r1 is None:
                return
            yield r1
            yield r2

    do_flush = flush_window if use_fast else flush
    recs = input_records()
    # a window of win_size records at a time: read, then mapped and
    # written (trimming/qv gating happens in Mapper.prepare_read)
    for w in itertools.count():
        with spans.span("cli window", window=w):
            with mapper.span("cli read"):
                batch = list(itertools.islice(recs, win_size))
            nreads += len(batch)
            do_flush(batch)
        if len(batch) < win_size:
            break
        if args.progress and nreads % args.progress < win_size:
            dt = time.time() - t0
            print(f"{nreads} reads, {nreads/dt:.0f} reads/s",
                  file=sys.stderr)
    dt = time.time() - t0
    print(f"Mapped {nreads} reads in {dt:.1f}s "
          f"({nreads/max(dt,1e-9):.0f} reads/s, "
          f"{nreads/max(dt,1e-9)*3600:.0f} reads/hour); "
          f"{total_lines} alignments", file=sys.stderr)
    if ins_hist is not None:
        ins_hist.print(sys.stderr)
    mapper.stats.report(sys.stderr, detailed=args.detailed_stats)
    if args.spans:
        spans.disable()
        with open(args.spans, "w") as f:
            json.dump(spans.chrome_trace(spans.drain(), os.getpid()), f)
    if un_f:
        un_f.close()
    if al_f:
        al_f.close()
    return 0


def cmd_merge(args) -> int:
    from .tools.mergesam import merge_sam_files
    return merge_sam_files(args.reads, args.sams, sys.stdout,
                           single_best=args.single_best_mapping,
                           strata=args.strata,
                           max_alignments=args.max_alignments,
                           insert_size_mean=args.insert_size_mean,
                           insert_size_stddev=args.insert_size_stddev)


_NEG_VALUE_FLAGS = {"-m", "--match", "-i", "--mismatch", "-g", "--open-r",
                    "-q", "--open-q", "-e", "--ext-r", "-f", "--ext-q",
                    "-x", "--crossover", "-r", "--cmw-threshold",
                    "-h-threshold", "--full-threshold", "-v",
                    "--vec-threshold", "--min-avg-qv", "-z", "--cutoff"}


def _join_negative_values(argv: List[str]) -> List[str]:
    """Fold `-i -20` into `-i=-20`: argparse would otherwise read the
    negative number as an option because -1/-2 (mate files) make every
    -<digit> token look like a flag (gmapper scores are negative)."""
    out: List[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if (a in _NEG_VALUE_FLAGS and i + 1 < len(argv)
                and len(argv[i + 1]) > 1 and argv[i + 1][0] == "-"
                and argv[i + 1][1].isdigit()):
            out.append(f"{a}={argv[i + 1]}")
            i += 2
        else:
            out.append(a)
            i += 1
    return out


def main(argv: Optional[List[str]] = None) -> int:
    argv = _join_negative_values(list(argv if argv is not None
                                      else sys.argv[1:]))
    ap = argparse.ArgumentParser(
        prog="shrimp_tpu_torch",
        description="short-read mapper (SHRiMP2 capabilities) on PyTorch "
                    "and CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_idx = sub.add_parser("index", help="build and save a genome index")
    p_idx.add_argument("genome", nargs="+")
    p_idx.add_argument("-o", "--output", required=True)
    p_idx.add_argument("-s", "--seeds", default=None)
    p_idx.add_argument("--cs", action="store_true")
    p_idx.add_argument("-M", "--mode", default=None)
    p_idx.add_argument("-H", "--hash-spaced-kmers", action="store_true")
    p_idx.add_argument("--save-mmap", action="store_true",
                       help="save a raw mmap-able image directory for "
                       "instant warm loads (genome.c:290-667 analogue)")

    p_map = sub.add_parser("map", help="map reads", add_help=False)
    p_map.add_argument("--help", action="help")
    p_map.add_argument("reads", nargs="?", default=None)
    p_map.add_argument("genome", nargs="*",
                       help="genome fasta file(s) or a saved .npz index")
    _add_map_flags(p_map)

    p_mrg = sub.add_parser("merge",
                           help="merge per-shard SAM files (mergesam)")
    p_mrg.add_argument("reads")
    p_mrg.add_argument("sams", nargs="+")
    p_mrg.add_argument("--single-best-mapping", action="store_true")
    p_mrg.add_argument("--strata", action="store_true")
    p_mrg.add_argument("--max-alignments", type=int, default=0)
    p_mrg.add_argument("--insert-size-mean", type=float,
                       default=C.DEF_INSERT_SIZE_MEAN)
    p_mrg.add_argument("--insert-size-stddev", type=float,
                       default=C.DEF_INSERT_SIZE_STDDEV)

    p_sdb = sub.add_parser(
        "split-db", help="bin-pack contigs into RAM-budget genome chunks "
        "(utils/split-db.py)")
    p_sdb.add_argument("genome", nargs="+")
    p_sdb.add_argument("--ram-size", type=float, required=True,
                       help="per-chunk RAM budget in GB")
    p_sdb.add_argument("--prefix", required=True)
    p_sdb.add_argument("--n-seeds", type=int, default=4)
    p_sdb.add_argument("--seed-weight", type=int, default=12)
    p_sdb.add_argument("--max-contig-len", type=int, default=0,
                       help="split contigs longer than this into "
                            "overlapping name/OFFSET pieces (beyond the "
                            "reference, which never splits contigs; "
                            "merge rebases and dedups exactly)")
    p_sdb.add_argument("--contig-overlap", type=int, default=2000,
                       help="halo overlap between contig pieces")
    p_sdb.add_argument("--cs", action="store_true",
                       help="size chunks with the colour-space RAM model "
                            "(4 genome planes instead of 2), matching "
                            "build_index's pre-check for CS genomes")

    p_pdb = sub.add_parser(
        "project-db", help="pre-build a saved index per genome chunk "
        "(utils/project-db.py / gmapper -S)")
    p_pdb.add_argument("chunks", nargs="+",
                       help="chunk fasta files from split-db")
    p_pdb.add_argument("-s", "--seeds", default=None)
    p_pdb.add_argument("--cs", action="store_true")
    p_pdb.add_argument("-H", "--hash-spaced-kmers", action="store_true")

    p_srd = sub.add_parser(
        "split-reads", help="split a read file into N chunks "
        "(utils/splitreads.py)")
    p_srd.add_argument("reads")
    p_srd.add_argument("-n", "--n-chunks", type=int, required=True)
    p_srd.add_argument("--prefix", required=True)
    p_srd.add_argument("--paired", action="store_true",
                       help="keep read pairs together")

    p_sct = sub.add_parser(
        "split-contigs", help="balanced contig->chunk assignment for a "
        "RAM budget (utils/split-contigs.c)")
    p_sct.add_argument("genome",
                       help="fasta file, or - for name/size pairs on stdin")
    p_sct.add_argument("ram_size", type=float,
                       help="target RAM size in GB")
    p_sct.add_argument("seed_weights", nargs="?", default=None,
                       help="comma-separated seed weights (default 12,12,12)")

    p_tsk = sub.add_parser(
        "temp-sink", help="buffer stdin to a temp file, flush to DEST at "
        "EOF (utils/temp-sink.c)")
    p_tsk.add_argument("dest")
    p_tsk.add_argument("-b", "--block-size", type=int, default=1 << 20)

    p_f2q = sub.add_parser("fasta2fastq",
                           help="fasta + .qual -> fastq (mergesam tool)")
    p_f2q.add_argument("fasta")
    p_f2q.add_argument("qual")

    p_lin = sub.add_parser("lineindex",
                           help="byte offset of every line (mergesam tool)")
    p_lin.add_argument("file")

    p_s2s = sub.add_parser("shrimp2sam",
                           help="legacy SHRiMP-format output -> SAM")
    p_s2s.add_argument("reads")
    p_s2s.add_argument("shrimp_output")

    # listed for --help only: a legacy tool's argv goes to it verbatim,
    # leading options included, which a REMAINDER subparser would refuse
    # (`probcalc -S ...` reads -S as one of the CLI's own options)
    for tool in LEGACY_TOOLS:
        sub.add_parser(tool, add_help=False,
                       help="legacy %s tool (args passed through)"
                       % tool.replace("-", "_"))

    if argv and argv[0] in LEGACY_TOOLS:
        args = argparse.Namespace(cmd=argv[0], tool_args=argv[1:])
    else:
        args = ap.parse_args(argv)
    # my_alloc_init analogue (gmapper.c:1740): install the process-wide
    # memory cap before any index build or load can allocate
    from .utils import memmodel
    memmodel.init(int(getattr(args, "max_mem", 64.0) * (1 << 30)),
                  strict=bool(getattr(args, "strict_mem", False)))
    if args.cmd in LEGACY_TOOLS:
        import importlib
        mod = importlib.import_module(
            ".tools." + args.cmd.replace("-", "_"), __package__)
        return mod.main(args.tool_args)
    if args.cmd == "index":
        return cmd_index(args)
    if args.cmd == "map":
        return cmd_map(args)
    if args.cmd == "merge":
        return cmd_merge(args)
    if args.cmd == "split-db":
        from .tools.split import split_db
        split_db(args.genome, args.ram_size, args.prefix,
                 n_seeds=args.n_seeds, weight=args.seed_weight,
                 max_contig_len=args.max_contig_len,
                 contig_overlap=args.contig_overlap,
                 colour_space=args.cs)
        return 0
    if args.cmd == "project-db":
        mode = C.MODE_COLOUR_SPACE if args.cs else C.MODE_LETTER_SPACE
        for chunk in args.chunks:
            idx = load_or_build_index([chunk], args.seeds, mode,
                                      hashed=args.hash_spaced_kmers)
            out_path = chunk.rsplit(".", 1)[0] + ".npz"
            idx.save(out_path)
            idx.release()   # un-account the chunk before the next build
            print(f"Saved {out_path}", file=sys.stderr)
        return 0
    if args.cmd == "split-reads":
        from .tools.split import split_reads
        split_reads(args.reads, args.n_chunks, args.prefix,
                    paired=args.paired)
        return 0
    if args.cmd == "split-contigs":
        from .io.fasta import read_seqs
        from .tools.split import split_contigs
        if args.genome == "-":
            toks = sys.stdin.read().split()
            contigs = [(toks[i], int(toks[i + 1]))
                       for i in range(0, len(toks) - 1, 2)]
        else:
            contigs = [(r.name, len(r.seq)) for r in read_seqs(args.genome)]
        weights = ([int(w) for w in args.seed_weights.split(",")]
                   if args.seed_weights else None)
        chunks = split_contigs(contigs, args.ram_size, weights)
        for i, ch in enumerate(chunks):
            print(f"chunk {i + 1}:")
            for name, size in ch:
                print(f"{name}\t{size}")
        return 0
    if args.cmd == "temp-sink":
        from .tools.split import temp_sink
        temp_sink(args.dest, block_size=args.block_size)
        return 0
    if args.cmd == "fasta2fastq":
        from .tools.split import fasta2fastq
        fasta2fastq(args.fasta, args.qual, sys.stdout)
        return 0
    if args.cmd == "lineindex":
        from .tools.split import lineindex
        lineindex(args.file, sys.stdout)
        return 0
    if args.cmd == "shrimp2sam":
        from .io.fasta import read_seqs
        from .tools.shrimp2sam import shrimp2sam
        reads = {r.name: r.seq for r in read_seqs(args.reads)}
        with open(args.shrimp_output) as f:
            shrimp2sam(f, reads, sys.stdout)
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
