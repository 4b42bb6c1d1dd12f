"""The port's LS paired stream (shrimp_tpu_torch.fastpath.
map_paired_sam_stream, on the CPU) must write the same SAM bytes as
shrimp_tpu.fastpath.map_paired_sam_stream: on the pairs of
tests/test_fastpath_paired.py in every pair mode, with the
select-then-full dispatch forced, on a repeat-dense genome where it
fires by itself, over 1 and 4 lanes, with --sam-unaligned, fastq
qualities and the mate-pair region configs. Tolerance: none, the bytes
are equal."""
import sys

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from shrimp_tpu import constants as RC
from shrimp_tpu import fastpath as ref_fastpath
from shrimp_tpu.config import MapperConfig
from shrimp_tpu.core import encode
from shrimp_tpu.index.build import build_index
from shrimp_tpu.index.seeds import default_seeds
from shrimp_tpu.io.fasta import SeqRecord
from shrimp_tpu.paired import PairedMapper as RefPairedMapper
from shrimp_tpu_torch import fastpath
from shrimp_tpu_torch.config import MapperConfig as PortConfig
from shrimp_tpu_torch.core.encode import decode_ls
from shrimp_tpu_torch.index import build as port_index
from shrimp_tpu_torch.index import seeds as port_seeds
from shrimp_tpu_torch.mapper import Mapper
from shrimp_tpu_torch.paired import PairedMapper

from .test_fastpath_paired import make_pairs
from .test_torch_two_phase import NEVER, _dense_codes


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _indexes(g):
    codes = encode.encode_ls(g) if isinstance(g, str) else g
    return (build_index([("chrP", codes)], default_seeds()),
            port_index.build_index([("chrP", codes)],
                                   port_seeds.default_seeds()))


def _ref_sam(idx, recs, batch_size, tp_env="auto", **cfgkw):
    """shrimp_tpu's paired SAM, its two-phase knob set for the JAX side
    only."""
    mp = pytest.MonkeyPatch()
    mp.setenv("SHRIMP_TPU_LS_TWO_PHASE", tp_env)
    try:
        gen = ref_fastpath.map_paired_sam_stream(
            RefPairedMapper(idx, MapperConfig(**cfgkw)), recs,
            batch_size=batch_size, lanes=1)
        assert gen is not None
        return b"".join(gen)
    finally:
        mp.undo()


def _port_sam(pidx, recs, batch_size, lanes=1, wpr=None, **cfgkw):
    """(SAM bytes, mapper) of the port's paired stream, its two-phase
    threshold at `wpr` windows per read (None: the default)."""
    mp = pytest.MonkeyPatch()
    if wpr is not None:
        mp.setattr(fastpath, "LS_TWO_PHASE_WPR", wpr)
    try:
        m = PairedMapper(pidx, PortConfig(**cfgkw), "cpu")
        gen = fastpath.map_paired_sam_stream(m, recs, batch_size=batch_size,
                                             lanes=lanes)
        assert gen is not None, "port paired stream unexpectedly unsupported"
        return b"".join(gen), m
    finally:
        mp.undo()


@pytest.mark.parametrize("mode,seed", [("opp-in", 1), ("opp-out", 2),
                                       ("col-fw", 3), ("col-bw", 4)])
def test_paired_matches_reference(mode, seed):
    """The fused dispatch (the default at this density), one lane."""
    g, recs = make_pairs(seed, 60, mode)
    idx, pidx = _indexes(g)
    got, m = _port_sam(pidx, recs, 64, pair_mode=mode)
    assert "device full (2ph)" not in m.stats.stage_secs
    assert got == _ref_sam(idx, recs, 64, pair_mode=mode)
    assert got.count(b"\n") >= len(recs)
    assert m.stats.reads == len(recs)


def test_paired_select_then_full_matches_reference():
    """The select-then-full dispatch forced (threshold 0) against
    shrimp_tpu's (SHRIMP_TPU_LS_TWO_PHASE=1) and the port's fused run,
    half-paired fallbacks of discordant pairs included."""
    g, recs = make_pairs(77, 80, "opp-in")
    idx, pidx = _indexes(g)
    fused, m0 = _port_sam(pidx, recs, 64, wpr=NEVER, pair_mode="opp-in")
    got, m = _port_sam(pidx, recs, 64, wpr=0, pair_mode="opp-in")
    assert "paired select (2ph)" in m.stats.stage_secs
    assert "device full (2ph)" in m.stats.stage_secs
    assert got == fused
    assert got == _ref_sam(idx, recs, 64, "1", pair_mode="opp-in")
    assert 0 < m.stats.full_invocs <= m0.stats.full_invocs
    assert (m.stats.reads_mapped, m.stats.alignments) == (
        m0.stats.reads_mapped, m0.stats.alignments)


def test_paired_dense_genome_select_then_full():
    """A repeat-dense genome: the select-then-full dispatch fires by
    itself, and the SAM equals shrimp_tpu's (gate on "auto") and the
    port's fused run."""
    codes, rng = _dense_codes()
    comp = np.array([3, 2, 1, 0], np.uint8)
    recs = []
    for k in range(100):
        isz = int(rng.integers(120, 280))
        p = int(rng.integers(0, len(codes) - isz - 36))
        a = codes[p:p + 36].copy()
        b = comp[codes[p + isz - 36:p + isz][::-1]].copy()
        for r in (a, b):
            for _ in range(int(rng.integers(0, 3))):
                r[int(rng.integers(36))] = rng.integers(4)
        recs += [SeqRecord(f"d{k}/1", decode_ls(a)),
                 SeqRecord(f"d{k}/2", decode_ls(b))]
    idx, pidx = _indexes(codes)
    got, m = _port_sam(pidx, recs, 200, pair_mode="opp-in")
    assert m.stats.vec_invocs / m.stats.reads >= fastpath.LS_TWO_PHASE_WPR
    assert "paired select (2ph)" in m.stats.stage_secs
    fused, _ = _port_sam(pidx, recs, 200, wpr=NEVER, pair_mode="opp-in")
    assert got == fused
    assert got == _ref_sam(idx, recs, 200, pair_mode="opp-in")


def test_paired_lanes_four_match_reference():
    g, recs = make_pairs(9, 80, "opp-in")
    idx, pidx = _indexes(g)
    got, m = _port_sam(pidx, recs, 32, lanes=4, pair_mode="opp-in")
    assert got == _ref_sam(idx, recs, 32, pair_mode="opp-in")
    assert m.stats.reads == len(recs)


def test_paired_lanes_share_stats_without_lost_updates():
    """16 lane threads over 20 small batches with a tiny switch
    interval: the shared run statistics count every read, and the SAM
    and counts equal the single-lane run's."""
    g, recs = make_pairs(21, 80, "opp-in")
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


def test_paired_sam_unaligned_matches_reference():
    """--sam-unaligned with a read group: a last batch of pairs of random
    bases has no candidate window at all, so its records come from the
    Python block (`_pair_qname`); the rest from the native renderer."""
    g, recs = make_pairs(5, 40, "opp-in")
    rng = np.random.default_rng(2)
    for k in range(16):
        for nip in (1, 2):
            recs.append(SeqRecord(f"junk{k}:x/{nip}", "".join(
                "ACGT"[c] for c in rng.integers(0, 4, 36))))
    idx, pidx = _indexes(g)
    kw = dict(pair_mode="opp-in", sam_unaligned=True, read_group_name="rg7",
              sam_r2=True)
    got, m = _port_sam(pidx, recs, 32, **kw)
    assert got == _ref_sam(idx, recs, 32, **kw)
    assert b"junk0:x\t77\t" in got and b"\tRG:Z:rg7" in got
    assert m.stats.reads == len(recs)


def test_paired_fastq_quals_match_reference():
    g, recs = make_pairs(12, 50, "opp-in")
    rng = np.random.default_rng(3)
    recs = [SeqRecord(r.name, r.seq,
                      "".join(chr(64 + int(rng.integers(12, 41)))
                              for _ in range(len(r.seq))))
            for r in recs]
    idx, pidx = _indexes(g)
    got, _ = _port_sam(pidx, recs, 64, pair_mode="opp-in")
    assert got == _ref_sam(idx, recs, 64, pair_mode="opp-in")


@pytest.mark.parametrize("kw,seed", [
    (dict(half_paired=False), 5),              # mp_rc=1, hit mode 2
    (dict(match_mode=3), 6),                   # mp_rc=2, hit mode 3
    (dict(match_mode=3, half_paired=False), 7),  # mp_rc=3
])
def test_paired_mp_region_configs_match_reference(kw, seed):
    g, recs = make_pairs(seed, 50, "opp-in")
    idx, pidx = _indexes(g)
    got, _ = _port_sam(pidx, recs, 64, pair_mode="opp-in", **kw)
    assert got == _ref_sam(idx, recs, 64, pair_mode="opp-in", **kw)


def test_paired_gate_configs_return_none():
    """Configs outside the native paired renderer's gate return None, as
    the reference's do: colour space, --single-best-mapping,
    --shrimp-format, --extra-sam-fields and raw-string trims."""
    g, recs = make_pairs(3, 4, "opp-in")
    _, pidx = _indexes(g)
    cs_idx = port_index.build_index(
        [("chrP", encode.encode_ls(g))],
        port_seeds.default_seeds(mode=RC.MODE_COLOUR_SPACE),
        mode=RC.MODE_COLOUR_SPACE)
    for ix, kw in ((cs_idx, dict(mode=RC.MODE_COLOUR_SPACE)),
                   (pidx, dict(single_best_mapping=True)),
                   (pidx, dict(shrimp_format=True)),
                   (pidx, dict(extra_sam_fields=True)),
                   (pidx, dict(trim_front=2))):
        m = PairedMapper(ix, PortConfig(pair_mode="opp-in", **kw), "cpu")
        assert fastpath.map_paired_sam_stream(m, recs) is None, kw
        assert ref_fastpath.fastpath_paired_supported(
            MapperConfig(pair_mode="opp-in", **kw)) == \
            fastpath.fastpath_paired_supported(m.config), kw
    with pytest.raises(ValueError, match="paired config"):
        PairedMapper(pidx, PortConfig(), "cpu")
    assert fastpath.map_paired_sam_stream(
        Mapper(pidx, PortConfig(), "cpu"), recs) is None


def test_paired_rejected_batch_raises():
    """A batch the flat encoder rejects (a short mate) takes the generic
    paired mapper's slow tail (map_paired, select_output) with the
    reference stream's bytes, at 1 and 4 lanes and with an odd batch
    size (rounded up to whole pairs); a rejected first batch makes the
    stream return None, as the reference's does."""
    g, recs = make_pairs(8, 60, "opp-in")
    idx, pidx = _indexes(g)
    recs[70] = SeqRecord(recs[70].name, recs[70].seq[:30])
    for bs, lanes in ((32, 1), (32, 4), (33, 1)):
        got, m = _port_sam(pidx, recs, bs, lanes=lanes, pair_mode="opp-in")
        assert got == _ref_sam(idx, recs, bs + bs % 2, pair_mode="opp-in")
        assert m.stats.full_invocs > 0
    recs[1] = SeqRecord(recs[1].name, recs[1].seq[:30])
    m = PairedMapper(pidx, PortConfig(pair_mode="opp-in"), "cpu")
    assert fastpath.map_paired_sam_stream(m, recs, batch_size=32) is None
