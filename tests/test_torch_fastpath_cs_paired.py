"""The port's CS paired stream (shrimp_tpu_torch.fastpath_cs.
map_paired_cs_sam_stream, on the CPU) must write the same SAM bytes as
shrimp_tpu.fastpath_cs.map_paired_cs_sam_stream: in every pair mode,
with fastq qualities, --sam-unaligned and a mate-pair region config,
with the select-then-full dispatch forced and on a repeat-dense genome
where it fires by itself, and over 4 and 16 lanes. The reference runs
at lanes=1 throughout: its `lanes` > 1 raises UnboundLocalError.
Tolerance: none, the bytes are equal."""
import sys

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from shrimp_tpu import constants as RC
from shrimp_tpu import fastpath_cs as ref_fastpath_cs
from shrimp_tpu.config import MapperConfig
from shrimp_tpu.index.build import build_index
from shrimp_tpu.index.seeds import default_seeds
from shrimp_tpu.io.fasta import SeqRecord
from shrimp_tpu.paired import PairedMapper as RefPairedMapper
from shrimp_tpu_torch import fastpath, fastpath_cs
from shrimp_tpu_torch.config import MapperConfig as PortConfig
from shrimp_tpu_torch.index import build as port_index
from shrimp_tpu_torch.index import seeds as port_seeds
from shrimp_tpu_torch.paired import PairedMapper

from .test_torch_two_phase import NEVER, _dense_codes

CS = RC.MODE_COLOUR_SPACE
COMP = np.array([3, 2, 1, 0], np.uint8)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tocs(lets: np.ndarray) -> str:
    """A SOLiD read of the letters `lets`: a `T` primer and their
    colours."""
    cm = RC.COLOUR_MAT
    cols = [int(cm[3, lets[0]])] + [int(cm[lets[i], lets[i + 1]])
                                    for i in range(len(lets) - 1)]
    return "T" + "".join(str(c) for c in cols)


def cs_pairs(seed, n_pairs, mode, glen=20_000, codes=None):
    """(genome codes, interleaved CS mate pairs): 36 colours a mate,
    inserts of 120-280 bp laid out for `mode`, 0-2 letter errors a
    mate, one pair in six with a scattered mate 2 (half-paired cases).
    `codes` replaces the random genome."""
    rng = np.random.default_rng(seed)
    g = (rng.integers(0, 4, glen).astype(np.uint8) if codes is None
         else codes)
    glen = len(g)
    recs = []
    for i in range(n_pairs):
        isz = int(rng.integers(120, 280))
        p = int(rng.integers(0, glen - isz - 40))
        a = g[p:p + 36].copy()
        b = g[p + isz - 36:p + isz].copy()
        for s in (a, b):
            for _ in range(int(rng.integers(0, 3))):
                s[int(rng.integers(36))] = rng.integers(4)
        if mode == "opp-in":
            a, b = a, COMP[b[::-1]]
        elif mode == "opp-out":
            a, b = COMP[a[::-1]], b
        if rng.random() < 1 / 6:
            q = int(rng.integers(0, glen - 36))
            b = g[q:q + 36]
        recs.append(SeqRecord(f"cp{i}/1", _tocs(a)))
        recs.append(SeqRecord(f"cp{i}/2", _tocs(b)))
    return g, recs


def _indexes(codes):
    return (build_index([("chrP", codes)], default_seeds(mode=CS),
                        mode=CS),
            port_index.build_index([("chrP", codes)],
                                   port_seeds.default_seeds(mode=CS),
                                   mode=CS))


def _with_quals(recs, seed=3):
    rng = np.random.default_rng(seed)
    return [SeqRecord(r.name, r.seq, "".join(
        chr(33 + int(q)) for q in rng.integers(3, 41, len(r.seq) - 1)))
        for r in recs]


def _ref_sam(idx, recs, batch_size, tp_env="auto", **cfgkw):
    """shrimp_tpu's CS paired SAM at lanes=1, its two-phase knob set for
    the JAX side only."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SHRIMP_TPU_CS_TWO_PHASE", tp_env)
        gen = ref_fastpath_cs.map_paired_cs_sam_stream(
            RefPairedMapper(idx, MapperConfig(mode=CS, **cfgkw)), recs,
            batch_size=batch_size, lanes=1)
        assert gen is not None
        return b"".join(gen)


def _port_sam(pidx, recs, batch_size, lanes=1, wpr=None, **cfgkw):
    """(SAM bytes, mapper) of the port's CS paired stream, its two-phase
    threshold at `wpr` windows per read (None: the default)."""
    with pytest.MonkeyPatch.context() as mp:
        if wpr is not None:
            mp.setattr(fastpath_cs, "CS_TWO_PHASE_WPR", wpr)
        m = PairedMapper(pidx, PortConfig(mode=CS, **cfgkw), "cpu")
        gen = fastpath_cs.map_paired_cs_sam_stream(
            m, recs, batch_size=batch_size, lanes=lanes)
        assert gen is not None, "port CS paired stream unsupported"
        return b"".join(gen), m


@pytest.mark.parametrize("mode,seed", [("opp-in", 21), ("opp-out", 22),
                                       ("col-fw", 23), ("col-bw", 24)])
def test_cs_paired_matches_reference(mode, seed):
    """The fused dispatch (the default at this density), one lane."""
    g, recs = cs_pairs(seed, 60, mode)
    idx, pidx = _indexes(g)
    got, m = _port_sam(pidx, recs, 64, pair_mode=mode)
    assert "device full (2ph)" not in m.stats.stage_secs
    assert got == _ref_sam(idx, recs, 64, pair_mode=mode)
    assert got.count(b"\n") >= len(recs)
    assert m.stats.reads == len(recs)


@pytest.mark.parametrize("ignore_qvs", [False, True])
def test_cs_paired_fastq_matches_reference(ignore_qvs):
    """fastq qualities: the crossover penalties from qualities, or
    ignored."""
    g, recs = cs_pairs(31, 50, "opp-in")
    recs = _with_quals(recs)
    idx, pidx = _indexes(g)
    kw = dict(pair_mode="opp-in", ignore_qvs=ignore_qvs)
    got, _ = _port_sam(pidx, recs, 32, **kw)
    assert got == _ref_sam(idx, recs, 32, **kw)
    assert b"\tCQ:Z:" in got


def test_cs_paired_sam_unaligned_matches_reference():
    """--sam-unaligned with a read group and --sam-r2: a last batch of
    pairs of random colours has no candidate window at all, so its
    records come from the Python block; the rest from the native
    renderer."""
    g, recs = cs_pairs(5, 40, "opp-in")
    rng = np.random.default_rng(2)
    for k in range(16):
        for nip in (1, 2):
            recs.append(SeqRecord(f"junk{k}:x/{nip}", "T" + "".join(
                "0123"[c] for c in rng.integers(0, 4, 36))))
    idx, pidx = _indexes(g)
    kw = dict(pair_mode="opp-in", sam_unaligned=True, read_group_name="rg7",
              sam_r2=True)
    got, m = _port_sam(pidx, recs, 32, **kw)
    assert got == _ref_sam(idx, recs, 32, **kw)
    assert b"junk0:x\t77\t" in got and b"\tRG:Z:rg7" in got
    assert b"\tX2:Z:" in got
    assert m.stats.reads == len(recs)


def test_cs_paired_mp_region_config_matches_reference():
    """The mate-pair region filter (half-paired off: mp region counts)."""
    g, recs = cs_pairs(6, 50, "opp-in")
    idx, pidx = _indexes(g)
    kw = dict(pair_mode="opp-in", half_paired=False)
    assert PortConfig(mode=CS, **kw).paired_options()[0].read[
        0].anchor_list.use_mp_region_counts
    got, _ = _port_sam(pidx, recs, 64, **kw)
    assert got == _ref_sam(idx, recs, 64, **kw)


def test_cs_paired_select_then_full_matches_reference():
    """The select-then-full dispatch forced (threshold 0) against
    shrimp_tpu's (SHRIMP_TPU_CS_TWO_PHASE=1) and the port's fused run,
    half-paired fallbacks of scattered mates included."""
    g, recs = cs_pairs(77, 70, "opp-in")
    idx, pidx = _indexes(g)
    fused, m0 = _port_sam(pidx, recs, 64, wpr=NEVER, pair_mode="opp-in")
    got, m = _port_sam(pidx, recs, 64, wpr=0, pair_mode="opp-in")
    assert "cs paired select (2ph)" in m.stats.stage_secs
    assert "device full (2ph)" in m.stats.stage_secs
    assert got == fused
    assert got == _ref_sam(idx, recs, 64, "1", pair_mode="opp-in")
    assert 0 < m.stats.full_invocs <= m0.stats.full_invocs
    assert (m.stats.reads_mapped, m.stats.alignments) == (
        m0.stats.reads_mapped, m0.stats.alignments)


def test_cs_paired_dense_genome_select_then_full():
    """A repeat-dense genome: the select-then-full dispatch fires by
    itself, and the SAM equals shrimp_tpu's (gate on "auto") and the
    port's fused run."""
    codes, _ = _dense_codes()
    _, recs = cs_pairs(13, 50, "opp-in", codes=codes)
    idx, pidx = _indexes(codes)
    got, m = _port_sam(pidx, recs, 100, pair_mode="opp-in")
    assert m.stats.vec_invocs / m.stats.reads >= fastpath_cs.CS_TWO_PHASE_WPR
    assert "cs paired select (2ph)" in m.stats.stage_secs
    fused, _ = _port_sam(pidx, recs, 100, wpr=NEVER, pair_mode="opp-in")
    assert got == fused
    assert got == _ref_sam(idx, recs, 100, pair_mode="opp-in")


def test_cs_paired_lanes_four_match_reference():
    g, recs = cs_pairs(9, 64, "opp-in")
    idx, pidx = _indexes(g)
    got, m = _port_sam(pidx, recs, 32, lanes=4, pair_mode="opp-in")
    assert got == _ref_sam(idx, recs, 32, pair_mode="opp-in")
    assert m.stats.reads == len(recs)


def test_cs_paired_lanes_share_stats_without_lost_updates():
    """16 lane threads over 16 small batches with a tiny switch
    interval: the shared run statistics count every read, and the SAM
    and counts equal the single-lane run's."""
    g, recs = cs_pairs(21, 64, "opp-in")
    _, pidx = _indexes(g)
    want, m1 = _port_sam(pidx, recs, len(recs), pair_mode="opp-in")
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got, m = _port_sam(pidx, recs, 8, lanes=16, pair_mode="opp-in")
    finally:
        sys.setswitchinterval(prev)
    assert got == want
    assert m.stats.reads == len(recs)
    assert (m.stats.reads_mapped, m.stats.alignments, m.stats.vec_invocs) \
        == (m1.stats.reads_mapped, m1.stats.alignments,
            m1.stats.vec_invocs) and m.stats.alignments > 0


def test_cs_paired_gate_configs_return_none():
    """Configs outside the native paired renderer's CS gate return None,
    as the reference's do: letter space, unpaired, --single-best-mapping,
    --shrimp-format, --extra-sam-fields, local alignment and raw-string
    trims."""
    g, recs = cs_pairs(3, 4, "opp-in")
    _, pidx = _indexes(g)
    ls_idx = port_index.build_index([("chrP", g)],
                                    port_seeds.default_seeds())
    for ix, kw in ((ls_idx, dict(mode="ls")),
                   (pidx, dict(mode=CS, single_best_mapping=True)),
                   (pidx, dict(mode=CS, shrimp_format=True)),
                   (pidx, dict(mode=CS, extra_sam_fields=True)),
                   (pidx, dict(mode=CS, global_alignment=False)),
                   (pidx, dict(mode=CS, trim_front=2))):
        m = PairedMapper(ix, PortConfig(pair_mode="opp-in", **kw), "cpu")
        assert fastpath_cs.map_paired_cs_sam_stream(m, recs) is None, kw
        assert ref_fastpath_cs.fastpath_cs_paired_supported(
            MapperConfig(pair_mode="opp-in", **kw)) == \
            fastpath_cs.fastpath_cs_paired_supported(m.config), kw
    assert fastpath_cs.fastpath_cs_paired_supported(
        PortConfig(mode=CS, pair_mode="opp-in"))
    assert not fastpath_cs.fastpath_cs_paired_supported(PortConfig(mode=CS))
    # the LS paired stream answers None for a CS paired config
    m = PairedMapper(pidx, PortConfig(mode=CS, pair_mode="opp-in"), "cpu")
    assert fastpath.map_paired_sam_stream(m, recs) is None


def test_cs_paired_rejected_batch_raises():
    """A batch the flat encoder rejects (a short mate, a pair under
    --min-avg-qv) raises, naming its reads; the port has no generic
    mapper to hand it to."""
    g, recs = cs_pairs(8, 60, "opp-in")
    _, pidx = _indexes(g)
    bad = list(recs)
    bad[70] = SeqRecord(bad[70].name, bad[70].seq[:30])
    for lanes in (1, 4):
        m = PairedMapper(pidx, PortConfig(mode=CS, pair_mode="opp-in"),
                         "cpu")
        gen = fastpath_cs.map_paired_cs_sam_stream(m, bad, batch_size=32,
                                                   lanes=lanes)
        with pytest.raises(NotImplementedError, match=r"reads 64\.\.95"):
            b"".join(gen)
    low = _with_quals(recs)
    low[5] = SeqRecord(low[5].name, low[5].seq, "#" * 36)
    m = PairedMapper(pidx, PortConfig(mode=CS, pair_mode="opp-in",
                                      min_avg_qv=10), "cpu")
    with pytest.raises(NotImplementedError, match=r"reads 0\.\.33"):
        fastpath_cs.map_paired_cs_sam_stream(m, low, batch_size=33)
