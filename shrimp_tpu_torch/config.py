"""Configuration tree for shrimp-tpu.

Mirrors SHRiMP2's global-flag + per-stage option-struct system
(gmapper/gmapper.h:32-305, gmapper/gmapper-definitions.h:205-294,
construction at gmapper/gmapper.c:2599-2720) as dataclasses.

Threshold convention: percentages are positive, absolute values are
negative (common/util.h:48-53 `IS_ABSOLUTE` / `abs_or_pct`).

Copied from `shrimp_tpu/config.py` unchanged: the port keeps its own
copy of the JAX package's host modules and imports none of them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import List, Optional

from . import constants as C


def is_absolute(x: float) -> bool:
    """util.h:48 — negative values encode absolute thresholds."""
    return x < 0


def abs_or_pct(x: float, base: float) -> float:
    """util.h:53."""
    return -x if is_absolute(x) else base * (x / 100.0)


@dataclass
class Scores:
    """SW scores; defaults gmapper-defaults.h:44-58."""
    match: int = C.DEF_LS_MATCH_SCORE
    mismatch: int = C.DEF_LS_MISMATCH_SCORE
    a_gap_open: int = C.DEF_LS_A_GAP_OPEN      # gap in genome dir ("reference")
    a_gap_extend: int = C.DEF_LS_A_GAP_EXTEND
    b_gap_open: int = C.DEF_LS_B_GAP_OPEN      # gap in read dir ("query")
    b_gap_extend: int = C.DEF_LS_B_GAP_EXTEND
    crossover: int = C.DEF_CS_XOVER_SCORE      # colour space only

    @staticmethod
    def cs_defaults() -> "Scores":
        return Scores(match=C.DEF_CS_MATCH_SCORE,
                      mismatch=C.DEF_CS_MISMATCH_SCORE,
                      a_gap_open=C.DEF_CS_A_GAP_OPEN,
                      a_gap_extend=C.DEF_CS_A_GAP_EXTEND,
                      b_gap_open=C.DEF_CS_B_GAP_OPEN,
                      b_gap_extend=C.DEF_CS_B_GAP_EXTEND,
                      crossover=C.DEF_CS_XOVER_SCORE)


@dataclass
class ScoreCalibration:
    """Score -> probability calibration (gmapper.c:2557-2572)."""
    alpha: float
    beta: float
    pr_mismatch: float
    pr_xover: float
    pr_del_open: float
    pr_del_extend: float
    pr_ins_open: float
    pr_ins_extend: float

    @staticmethod
    def from_scores(scores: Scores, mode: str, pr_xover: float = 0.03
                    ) -> "ScoreCalibration":
        log2 = math.log(2.0)
        if mode == C.MODE_COLOUR_SPACE:
            alpha = scores.crossover / (math.log(pr_xover / 3) / log2)
            pr_mismatch = 1.0 / (1.0 + (1.0 / 3.0) * math.pow(
                2.0, (scores.match - scores.mismatch) / alpha))
        else:
            pr_mismatch = 0.01
            alpha = (scores.match - scores.mismatch) / (
                math.log((1 - pr_mismatch) / (pr_mismatch / 3.0)) / log2)
        beta = (scores.match - 2 * alpha
                - alpha * math.log(1 - pr_mismatch) / log2)
        return ScoreCalibration(
            alpha=alpha, beta=beta, pr_mismatch=pr_mismatch, pr_xover=pr_xover,
            pr_del_open=math.pow(2.0, scores.a_gap_open / alpha),
            pr_del_extend=math.pow(2.0, scores.a_gap_extend / alpha),
            pr_ins_open=math.pow(2.0, scores.b_gap_open / alpha),
            pr_ins_extend=math.pow(2.0, (scores.b_gap_extend - beta) / alpha),
        )


@dataclass
class RegionOptions:
    """gmapper-definitions.h regions_options."""
    recompute: bool = True


@dataclass
class AnchorListOptions:
    recompute: bool = True
    collapse: bool = True
    use_region_counts: bool = True
    use_mp_region_counts: int = 0


@dataclass
class HitListOptions:
    recompute: bool = True
    gapless: bool = False
    match_mode: int = C.DEF_MATCH_MODE_UNPAIRED
    threshold: float = C.DEF_WINDOW_GEN_THRESHOLD


@dataclass
class Pass1Options:
    recompute: bool = True
    only_paired: bool = False
    gapless: bool = False
    min_matches: int = 2
    num_outputs: int = 20 + C.DEF_NUM_OUTPUTS   # num_tmp_outputs, gmapper.h:55
    threshold: float = C.DEF_SW_VECT_THRESHOLD
    window_overlap: float = C.DEF_WINDOW_OVERLAP


@dataclass
class Pass2Options:
    strata: bool = False
    save_outputs: bool = False
    num_outputs: int = C.DEF_NUM_OUTPUTS
    threshold: float = C.DEF_SW_FULL_THRESHOLD
    stop_count: int = 0
    stop_threshold: float = 0.0


@dataclass
class ReadMappingOptions:
    regions: RegionOptions = field(default_factory=RegionOptions)
    anchor_list: AnchorListOptions = field(default_factory=AnchorListOptions)
    hit_list: HitListOptions = field(default_factory=HitListOptions)
    pass1: Pass1Options = field(default_factory=Pass1Options)
    pass2: Pass2Options = field(default_factory=Pass2Options)


@dataclass
class PairingOptions:
    pair_mode: str = C.PAIR_NONE
    min_insert_size: int = C.DEF_MIN_INSERT_SIZE
    max_insert_size: int = C.DEF_MAX_INSERT_SIZE
    strata: bool = False
    save_outputs: bool = True
    pass1_num_outputs: int = 20 + C.DEF_NUM_OUTPUTS
    pass2_num_outputs: int = C.DEF_NUM_OUTPUTS
    pass1_threshold: float = C.DEF_SW_VECT_THRESHOLD
    pass2_threshold: float = C.DEF_SW_FULL_THRESHOLD
    stop_count: int = 0
    stop_threshold: float = 0.0


@dataclass
class ReadpairMappingOptions:
    pairing: PairingOptions = field(default_factory=PairingOptions)
    read: List[ReadMappingOptions] = field(default_factory=list)


# --------------------------------------------------------------- DSL parsing
# --unpaired-options / --paired-options mini-language
# (gmapper.c:1530-1718, option handling :2184-2220)

def _dsl_int(tok: str) -> int:
    if tok is None:
        raise ValueError("invalid integer")
    return int(tok)


def _dsl_bool(tok: str) -> bool:
    if tok in ("true", "1"):
        return True
    if tok in ("false", "0"):
        return False
    raise ValueError(f"invalid bool [{tok}]")


def _dsl_threshold(tok: str) -> float:
    """get_threshold (gmapper.c:1560-1573): non-negative; bare integers
    (no '%' or '.') are negated to mark them absolute."""
    if tok is None:
        raise ValueError("invalid threshold")
    t = float(tok.rstrip("%"))
    if t < 0.0:
        raise ValueError(f"invalid threshold [{tok}]")
    if "%" not in tok and "." not in tok:
        t = -t
    return t


class _TokStream:
    """strtok-style sequential consumption of comma-separated fields."""

    def __init__(self, text: str):
        self.toks = [t for t in text.split(",") if t != ""]
        self.i = 0

    def next(self) -> str:
        if self.i >= len(self.toks):
            raise ValueError("missing option field")
        t = self.toks[self.i]
        self.i += 1
        return t


def parse_pairing_options(text: str) -> PairingOptions:
    """get_pairing_options (gmapper.c:1588-1619): 11 comma-separated
    fields."""
    s = _TokStream(text)
    pair_mode = s.next()
    if pair_mode not in C.PAIR_MODES:
        raise ValueError(f"invalid pair mode [{pair_mode}]")
    return PairingOptions(
        pair_mode=pair_mode,
        min_insert_size=_dsl_int(s.next()),
        max_insert_size=_dsl_int(s.next()),
        pass1_num_outputs=_dsl_int(s.next()),
        pass1_threshold=_dsl_threshold(s.next()),
        pass2_num_outputs=_dsl_int(s.next()),
        pass2_threshold=_dsl_threshold(s.next()),
        stop_count=_dsl_int(s.next()),
        stop_threshold=_dsl_threshold(s.next()),
        strata=_dsl_bool(s.next()),
        save_outputs=_dsl_bool(s.next()),
    )


def parse_read_mapping_options(text: str, is_paired: bool
                               ) -> ReadMappingOptions:
    """get_read_mapping_options (gmapper.c:1621-1718): '/'-separated
    stage sections, comma-separated fields within each."""
    secs = text.split("/")
    want = 5 if is_paired else 6
    if len(secs) != want:
        raise ValueError(
            f"expected {want} '/'-separated sections, got {len(secs)}")
    ro = ReadMappingOptions()
    # regions
    s = _TokStream(secs[0])
    ro.regions.recompute = _dsl_bool(s.next())
    # anchor_list
    s = _TokStream(secs[1])
    ro.anchor_list.recompute = _dsl_bool(s.next())
    if ro.anchor_list.recompute:
        ro.anchor_list.collapse = _dsl_bool(s.next())
        ro.anchor_list.use_region_counts = _dsl_bool(s.next())
        if is_paired:
            ro.anchor_list.use_mp_region_counts = _dsl_int(s.next())
    # hit_list
    s = _TokStream(secs[2])
    ro.hit_list.recompute = _dsl_bool(s.next())
    if ro.hit_list.recompute:
        ro.hit_list.gapless = _dsl_bool(s.next())
        ro.hit_list.match_mode = _dsl_int(s.next())
        ro.hit_list.threshold = _dsl_threshold(s.next())
    # pass1
    s = _TokStream(secs[3])
    ro.pass1.recompute = _dsl_bool(s.next())
    if ro.pass1.recompute:
        ro.pass1.threshold = _dsl_threshold(s.next())
        ro.pass1.window_overlap = _dsl_threshold(s.next())
        ro.pass1.min_matches = _dsl_int(s.next())
        ro.pass1.gapless = _dsl_bool(s.next())
        if is_paired:
            ro.pass1.only_paired = _dsl_bool(s.next())
        else:
            ro.pass1.num_outputs = _dsl_int(s.next())
    # pass2
    s = _TokStream(secs[4])
    ro.pass2.threshold = _dsl_threshold(s.next())
    if not is_paired:
        ro.pass2.strata = _dsl_bool(s.next())
        ro.pass2.save_outputs = _dsl_bool(s.next())
        ro.pass2.num_outputs = _dsl_int(s.next())
        # stop
        s = _TokStream(secs[5])
        ro.pass2.stop_count = _dsl_int(s.next())
        if ro.pass2.stop_count > 0:
            ro.pass2.stop_threshold = _dsl_threshold(s.next())
    return ro


def parse_unpaired_options_arg(text: str) -> tuple:
    """One --unpaired-options value: 'nip;read-options'
    (gmapper.c:2204-2220). Returns (nip, ReadMappingOptions)."""
    head, _, rest = text.partition(";")
    if head not in ("0", "1") or not rest:
        raise ValueError(f"invalid unpaired mapping options [{text}]")
    return int(head), parse_read_mapping_options(rest, is_paired=False)


def parse_paired_options_arg(text: str) -> ReadpairMappingOptions:
    """One --paired-options value: 'pairing;read0-options;read1-options'
    (gmapper.c:2184-2201)."""
    parts = text.split(";")
    if len(parts) != 3:
        raise ValueError(f"invalid paired mapping options [{text}]")
    pairing = parse_pairing_options(parts[0])
    r0 = parse_read_mapping_options(parts[1], is_paired=True)
    r1 = parse_read_mapping_options(parts[2], is_paired=True)
    # pass1.num_outputs is not in the paired read DSL; the extraction
    # heap is sized by pairing.pass1_num_outputs (mapping.c:2571-2574)
    r0.pass1.num_outputs = pairing.pass1_num_outputs
    r1.pass1.num_outputs = pairing.pass1_num_outputs
    return ReadpairMappingOptions(pairing=pairing, read=[r0, r1])


@dataclass
class MapperConfig:
    """Top-level config; mirrors the gmapper globals it needs."""
    mode: str = C.MODE_LETTER_SPACE
    scores: Scores = field(default_factory=Scores)
    window_len: float = C.DEF_WINDOW_LEN           # % unless negative
    window_overlap: float = C.DEF_WINDOW_OVERLAP
    window_gen_threshold: float = C.DEF_WINDOW_GEN_THRESHOLD
    sw_vect_threshold: float = C.DEF_SW_VECT_THRESHOLD
    sw_full_threshold: float = C.DEF_SW_FULL_THRESHOLD
    num_outputs: int = C.DEF_NUM_OUTPUTS
    num_tmp_outputs: int = 20 + C.DEF_NUM_OUTPUTS
    match_mode: Optional[int] = None               # None -> mode default
    anchor_width: int = C.DEF_ANCHOR_WIDTH
    indel_taboo_len: int = 0
    longest_read_len: int = C.DEF_LONGEST_READ_LENGTH
    global_alignment: bool = True                  # Gflag, gmapper.h:98
    gapless: bool = False                          # -U
    use_regions: bool = True
    region_bits: int = C.DEF_REGION_BITS
    region_overlap: int = C.DEF_REGION_OVERLAP
    list_cutoff: Optional[int] = None              # None -> auto (gmapper.c:2830)
    hash_filter_calls: bool = True                 # SW cache; we dedup in batch
    compute_mapping_qualities: bool = True
    single_best_mapping: bool = False
    all_contigs: bool = False
    improper_mappings: bool = True
    half_paired: bool = True
    sam_unaligned: bool = False
    sam_r2: bool = False
    strata: bool = False
    max_alignments: int = 0
    rev_tiebreak: bool = True   # Tflag, default true (gmapper.h:91); -t off
    pair_mode: str = C.PAIR_NONE
    min_insert_size: int = C.DEF_MIN_INSERT_SIZE
    max_insert_size: int = C.DEF_MAX_INSERT_SIZE
    insert_size_mean: float = C.DEF_INSERT_SIZE_MEAN
    insert_size_stddev: float = C.DEF_INSERT_SIZE_STDDEV
    qual_delta: Optional[int] = None               # None -> mode default
    pr_xover: float = 0.03
    ignore_qvs: bool = False
    # read trimming + quality gating (gmapper.c:262-281, 430-473)
    trim_front: int = 0
    trim_end: int = 0
    trim_first: bool = True     # --trim-first: trim only leg 1 of a pair
    trim_second: bool = True    # --trim-second: trim only leg 2
    trim_illumina: bool = False  # strip trailing 'B' quals (LS only)
    min_avg_qv: int = 10        # drop fastq reads below this avg qv; <0 off
    no_qv_check: bool = False   # disable the PHRED offset sanity check
    read_group_name: Optional[str] = None
    sam_sample_name: Optional[str] = None
    extra_sam_fields: bool = False
    bfast: bool = False          # Bflag: bfast-style CS base quals (CS only)
    shrimp_format: bool = False                    # legacy output format
    # strand restriction (-F / -C)
    search_forward: bool = True
    search_reverse: bool = True
    # multi-round option-set DSL (--unpaired-options / --paired-options,
    # gmapper.c:2184-2220); raw strings as given on the command line
    custom_unpaired_options: tuple = ()            # of 'nip;...' strings
    custom_paired_options: tuple = ()              # of 'pairing;ro;ro'

    def __post_init__(self):
        if self.mode == C.MODE_COLOUR_SPACE and self.scores == Scores():
            self.scores = Scores.cs_defaults()
        if self.match_mode is None:
            self.match_mode = (C.DEF_MATCH_MODE_UNPAIRED
                               if self.pair_mode == C.PAIR_NONE
                               else C.DEF_MATCH_MODE_PAIRED)
        if self.qual_delta is None:
            self.qual_delta = (C.DEF_LS_QUAL_DELTA
                               if self.mode == C.MODE_LETTER_SPACE
                               else C.DEF_CS_QUAL_DELTA)
        # LS: vector threshold follows full threshold (gmapper.c:2464-2466)
        if self.mode == C.MODE_LETTER_SPACE:
            self.sw_vect_threshold = self.sw_full_threshold
        if not self.global_alignment:
            # mapping qualities unavailable in local mode (gmapper.c:2325-2328)
            self.compute_mapping_qualities = False

    @property
    def calibration(self) -> ScoreCalibration:
        return ScoreCalibration.from_scores(self.scores, self.mode,
                                            self.pr_xover)

    def _custom_unpaired(self, nip: int) -> List[ReadMappingOptions]:
        return [ro for n, ro in map(parse_unpaired_options_arg,
                                    self.custom_unpaired_options)
                if n == nip]

    def unpaired_options(self) -> List[ReadMappingOptions]:
        """Default unpaired option set (gmapper.c:2610-2632), or the
        --unpaired-options DSL sets when given."""
        custom = self._custom_unpaired(0)
        if custom:
            return custom
        mm = self.match_mode
        use_rc = mm == 2 and self.use_regions
        return [ReadMappingOptions(
            regions=RegionOptions(recompute=use_rc),
            anchor_list=AnchorListOptions(recompute=True, collapse=True,
                                          use_region_counts=use_rc,
                                          use_mp_region_counts=0),
            hit_list=HitListOptions(recompute=True, gapless=self.gapless,
                                    match_mode=mm,
                                    threshold=self.window_gen_threshold),
            pass1=Pass1Options(recompute=True, only_paired=False,
                               gapless=self.gapless, min_matches=mm,
                               num_outputs=self.num_tmp_outputs,
                               threshold=self.sw_vect_threshold,
                               window_overlap=self.window_overlap),
            pass2=Pass2Options(strata=self.strata, save_outputs=False,
                               num_outputs=self.num_outputs,
                               threshold=self.sw_full_threshold,
                               stop_count=0),
        )]

    def paired_options(self) -> List[ReadpairMappingOptions]:
        """Default paired option set (gmapper.c:2636-2718), or the
        --paired-options DSL sets when given."""
        if self.custom_paired_options:
            return [parse_paired_options_arg(t)
                    for t in self.custom_paired_options]
        mm = self.match_mode
        use_rc = self.use_regions and mm != 2
        mp_rc = 0
        if self.use_regions:
            if mm == 4 and not self.half_paired:
                mp_rc = 1
            elif mm == 3 and self.half_paired:
                mp_rc = 2
            elif mm == 3 and not self.half_paired:
                mp_rc = 3
        ro = ReadMappingOptions(
            regions=RegionOptions(recompute=use_rc),
            anchor_list=AnchorListOptions(recompute=True, collapse=True,
                                          use_region_counts=use_rc,
                                          use_mp_region_counts=mp_rc),
            hit_list=HitListOptions(recompute=True, gapless=self.gapless,
                                    match_mode=(2 if mm == 4 else
                                                3 if mm == 3 else 1),
                                    threshold=self.window_gen_threshold),
            pass1=Pass1Options(recompute=True, only_paired=True,
                               gapless=self.gapless,
                               min_matches=(2 if mm == 4 else 1),
                               num_outputs=self.num_tmp_outputs,
                               threshold=self.sw_vect_threshold,
                               window_overlap=self.window_overlap),
            pass2=Pass2Options(strata=self.strata,
                               threshold=self.sw_full_threshold * 0.5),
        )
        pairing = PairingOptions(
            pair_mode=self.pair_mode,
            min_insert_size=self.min_insert_size,
            max_insert_size=self.max_insert_size,
            strata=self.strata,
            save_outputs=self.compute_mapping_qualities,
            pass1_num_outputs=self.num_tmp_outputs,
            pass2_num_outputs=self.num_outputs,
            pass1_threshold=self.sw_vect_threshold,
            pass2_threshold=self.sw_full_threshold,
            stop_count=1 if self.half_paired else 0,
            stop_threshold=101.0 if self.half_paired else 0.0,
        )
        return [ReadpairMappingOptions(pairing=pairing, read=[ro, replace(ro)])]

    def half_paired_unpaired_options(self, nip: int = 0
                                     ) -> List[ReadMappingOptions]:
        """Unpaired fallback options in half-paired mode (gmapper.c:2700-2716),
        or the per-leg --unpaired-options DSL sets when given."""
        custom = self._custom_unpaired(nip)
        if custom:
            return custom
        return [ReadMappingOptions(
            regions=RegionOptions(recompute=False),
            anchor_list=AnchorListOptions(recompute=False),
            hit_list=HitListOptions(recompute=False),
            pass1=Pass1Options(recompute=True, gapless=self.gapless,
                               min_matches=2, only_paired=False,
                               num_outputs=self.num_tmp_outputs,
                               threshold=self.sw_vect_threshold,
                               window_overlap=self.window_overlap),
            pass2=Pass2Options(strata=self.strata,
                               save_outputs=self.compute_mapping_qualities,
                               num_outputs=self.num_outputs,
                               threshold=self.sw_full_threshold,
                               stop_count=0),
        )]
