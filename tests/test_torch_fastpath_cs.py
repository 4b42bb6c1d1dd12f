"""The port's CS unpaired stream (shrimp_tpu_torch.fastpath_cs, on the
CPU) must write the same SAM bytes as shrimp_tpu.fastpath_cs.
map_unpaired_cs_sam_stream on the colour-space datasets of
tests/test_e2e_cs.py."""
import sys

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from shrimp_tpu import constants as C
from shrimp_tpu import fastpath_cs as ref_fastpath_cs
from shrimp_tpu.config import MapperConfig
from shrimp_tpu.core import encode
from shrimp_tpu.index.build import build_index
from shrimp_tpu.index.seeds import default_seeds
from shrimp_tpu.io.fasta import SeqRecord
from shrimp_tpu.mapper import Mapper as RefMapper
from shrimp_tpu_torch import fastpath_cs
from shrimp_tpu_torch.config import MapperConfig as PortConfig
from shrimp_tpu_torch.index import build as port_index
from shrimp_tpu_torch.index import seeds as port_seeds
from shrimp_tpu_torch.mapper import Mapper

from .test_e2e_cs import make_cs_dataset

CS = C.MODE_COLOUR_SPACE


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _build(tmp_path, n_reads=200, genome_len=30_000, **dskw):
    _, _, g, reads = make_cs_dataset(str(tmp_path), n_reads=n_reads,
                                     genome_len=genome_len, **dskw)
    codes = encode.encode_ls(g)
    idx = build_index([("chrC", codes)], default_seeds(mode=CS), mode=CS)
    pidx = port_index.build_index([("chrC", codes)],
                                  port_seeds.default_seeds(mode=CS), mode=CS)
    return idx, pidx, [SeqRecord(n, s) for n, s in reads]


def _with_quals(recs, seed=8, offset=33):
    rng = np.random.default_rng(seed)
    return [SeqRecord(r.name, r.seq,
                      "".join(chr(offset + int(q)) for q in
                              rng.integers(3, 40, len(r.seq) - 1)))
            for r in recs]


def _with_junk(recs, n=12, seed=5):
    """Append reads of random colours, which map nowhere."""
    rng = np.random.default_rng(seed)
    L = len(recs[0].seq) - 1
    return recs + [SeqRecord(f"junk{k}", "G" + "".join(
        "0123"[c] for c in rng.integers(0, 4, L))) for k in range(n)]


def _ref_sam(idx, cfg, recs, batch_size):
    gen = ref_fastpath_cs.map_unpaired_cs_sam_stream(
        RefMapper(idx, cfg), recs, batch_size=batch_size)
    assert gen is not None
    return b"".join(gen)


def _port_sam(m, recs, batch_size, lanes=None):
    gen = fastpath_cs.map_unpaired_cs_sam_stream(m, recs,
                                                 batch_size=batch_size,
                                                 lanes=lanes)
    assert gen is not None, "port CS fast path unexpectedly unsupported"
    return b"".join(gen)


@pytest.mark.parametrize("quals,cfgkw,batch_size", [
    (False, {}, None),                               # one batch
    (False, {}, 48),                                 # multi-batch lanes
    (True, {}, None),                                # fastq quals
    (True, dict(ignore_qvs=True), None),
    (False, dict(sam_unaligned=True, read_group_name="rg1"), 48),
], ids=["200-one-batch", "200-lanes-bs48", "fastq-quals", "ignore-qvs",
        "sam-unaligned-rg"])
def test_cs_sam_matches_reference(tmp_path, quals, cfgkw, batch_size):
    idx, pidx, recs = _build(tmp_path)
    if cfgkw.get("sam_unaligned"):
        recs = _with_junk(recs)
    if quals:
        recs = _with_quals(recs)
    cfg = MapperConfig(mode=CS, **cfgkw)
    bs = batch_size or len(recs)
    m = Mapper(pidx, PortConfig(mode=CS, **cfgkw), "cpu")
    got = _port_sam(m, recs, bs)
    assert got == _ref_sam(idx, cfg, recs, bs)
    mapped = {ln.split(b"\t")[0] for ln in got.split(b"\n")[:-1]
              if not int(ln.split(b"\t")[1]) & 4}
    assert len(mapped) >= 180
    assert m.stats.reads == len(recs)
    assert m.stats.reads_mapped == len(mapped)
    if cfgkw.get("sam_unaligned"):
        assert b"\tRG:Z:rg1" in got and b"\t4\t*\t" in got


def test_cs_lanes_share_stats_without_lost_updates(tmp_path):
    """16 lane threads over 20 small batches with a tiny switch
    interval: the shared run statistics count every read, and the SAM
    bytes equal the single-batch run (the reference's FastCS updates
    them with a bare `+=`). Short reads keep the padded chunks cheap."""
    idx, pidx, recs = _build(tmp_path, n_reads=80, read_len=24)
    want = _port_sam(Mapper(pidx, PortConfig(mode=CS), "cpu"), recs,
                     len(recs))
    m = Mapper(pidx, PortConfig(mode=CS), "cpu")
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = _port_sam(m, recs, 4, lanes=16)
    finally:
        sys.setswitchinterval(prev)
    assert got == want
    names = {ln.split(b"\t")[0] for ln in got.split(b"\n")[:-1]
             if not int(ln.split(b"\t")[1]) & 4}
    assert m.stats.reads == len(recs)
    assert m.stats.reads_mapped == len(names) > 0
    assert m.stats.alignments == got.count(b"\n")


def test_cs_gate_configs_return_none(tmp_path):
    idx, pidx, recs = _build(tmp_path, n_reads=8)
    for kw in (dict(), dict(mode=CS, pair_mode=C.PAIR_OPP_IN),
               dict(mode=CS, compute_mapping_qualities=False),
               dict(mode=CS, global_alignment=False),
               dict(mode=CS, extra_sam_fields=True),
               dict(mode=CS, trim_front=2)):
        m = Mapper(pidx, PortConfig(**kw), "cpu")
        assert fastpath_cs.map_unpaired_cs_sam_stream(m, recs) is None, kw
        assert not fastpath_cs._config_supported(m.config)


def test_cs_two_phase_density_identical(tmp_path, monkeypatch):
    """A batch at >= CS_TWO_PHASE_WPR candidate windows per read (the
    threshold lowered to 1 here) takes the two-phase dispatch, and its
    SAM equals the reference's and the fused run's."""
    idx, pidx, recs = _build(tmp_path, n_reads=40)
    want = _ref_sam(idx, MapperConfig(mode=CS), recs, 20)
    fused = _port_sam(Mapper(pidx, PortConfig(mode=CS), "cpu"), recs, 20)
    monkeypatch.setattr(fastpath_cs, "CS_TWO_PHASE_WPR", 1)
    m = Mapper(pidx, PortConfig(mode=CS), "cpu")
    got = _port_sam(m, recs, 20)
    assert "device full (2ph)" in m.stats.stage_secs
    assert got == fused == want
    assert m.stats.reads == len(recs)


def test_cs_chunk_ladder_matches_reference():
    for n in (0, 1, 2047, 2048, 9300, 18_700, 65_535, 200_000, 5_000_000):
        assert fastpath_cs._cs_chunk(n) == ref_fastpath_cs._cs_chunk(n), n
