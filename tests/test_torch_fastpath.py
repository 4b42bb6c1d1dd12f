"""The port's LS unpaired stream (shrimp_tpu_torch.fastpath, on the CPU)
must write the same SAM bytes as shrimp_tpu.fastpath.map_unpaired_sam_
stream on the datasets of tests/test_fastpath.py."""
import sys

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from shrimp_tpu import fastpath as ref_fastpath
from shrimp_tpu.config import MapperConfig
from shrimp_tpu.core import encode
from shrimp_tpu.index.build import build_index
from shrimp_tpu.index.seeds import default_seeds
from shrimp_tpu.io.fasta import SeqRecord
from shrimp_tpu.mapper import Mapper as RefMapper
from shrimp_tpu_torch import fastpath
from shrimp_tpu_torch.config import MapperConfig as PortConfig
from shrimp_tpu_torch.index import build as port_index
from shrimp_tpu_torch.index import seeds as port_seeds
from shrimp_tpu_torch.mapper import Mapper

from .test_e2e_unpaired import make_dataset


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _build(tmp_path, **dskw):
    _, _, g, reads = make_dataset(str(tmp_path), **dskw)
    codes = encode.encode_ls(g)
    idx = build_index([("chr_test", codes)], default_seeds())
    pidx = port_index.build_index([("chr_test", codes)],
                                  port_seeds.default_seeds())
    return idx, pidx, [SeqRecord(n, s) for n, s in reads]


def _ref_sam(idx, cfg, recs, batch_size):
    gen = ref_fastpath.map_unpaired_sam_stream(RefMapper(idx, cfg), recs,
                                               batch_size=batch_size)
    assert gen is not None
    return b"".join(gen)


def _port_sam(m, recs, batch_size, lanes=None):
    gen = fastpath.map_unpaired_sam_stream(m, recs, batch_size=batch_size,
                                           lanes=lanes)
    assert gen is not None, "port fast path unexpectedly unsupported"
    return b"".join(gen)


@pytest.mark.parametrize("dskw,cfgkw,batch_size", [
    (dict(n_reads=300), {}, None),                  # one batch
    (dict(n_reads=257), {}, 64),                    # multi-batch lanes
    (dict(n_reads=150, seed=3), {}, None),          # indel paths
    (dict(n_reads=300), dict(extra_sam_fields=True), None),
    (dict(n_reads=300), dict(sam_unaligned=True), None),
], ids=["300-one-batch", "257-lanes-bs64", "seed3-indels", "extra-sam",
        "sam-unaligned"])
def test_sam_matches_reference(tmp_path, dskw, cfgkw, batch_size):
    idx, pidx, recs = _build(tmp_path, **dskw)
    cfg = MapperConfig(**cfgkw)
    bs = batch_size or len(recs)
    m = Mapper(pidx, PortConfig(**cfgkw), "cpu")
    got = _port_sam(m, recs, bs)
    assert got == _ref_sam(idx, cfg, recs, bs)
    assert got.count(b"\n") >= len(recs) // 2
    # indel / cross-plane paths went through the native host DP
    assert m.stats.full_host_tb > 0
    assert m.stats.reads == len(recs)


def test_lanes_one_matches_reference(tmp_path):
    idx, pidx, recs = _build(tmp_path, n_reads=257)
    cfg = MapperConfig()
    got = _port_sam(Mapper(pidx, PortConfig(), "cpu"), recs, 64, lanes=1)
    assert got == _ref_sam(idx, cfg, recs, 64)


def test_lanes_share_stats_without_lost_updates(tmp_path):
    """16 lane threads over 33 small batches with a tiny switch
    interval: the shared run statistics count every read, and the SAM
    bytes equal the single-batch run."""
    idx, pidx, recs = _build(tmp_path, n_reads=257)
    want = _port_sam(Mapper(pidx, None, "cpu"), recs, len(recs))
    m = Mapper(pidx, None, "cpu")
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = _port_sam(m, recs, 8, lanes=16)
    finally:
        sys.setswitchinterval(prev)
    assert got == want
    names = {ln.split(b"\t")[0] for ln in got.split(b"\n")[:-1]
             if not int(ln.split(b"\t")[1]) & 4}
    assert m.stats.reads == len(recs)
    assert m.stats.reads_mapped == len(names) > 0
    assert m.stats.alignments == got.count(b"\n")


def test_fastq_quals_match_reference(tmp_path):
    idx, pidx, recs = _build(tmp_path, n_reads=150)
    rng = np.random.default_rng(8)
    recs = [SeqRecord(r.name, r.seq,
                      "".join(chr(64 + int(q)) for q in
                              rng.integers(2, 41, len(r.seq))))
            for r in recs]
    cfg = MapperConfig()
    got = _port_sam(Mapper(pidx, PortConfig(), "cpu"), recs, 64)
    assert got == _ref_sam(idx, cfg, recs, 64)
    assert got.split(b"\n")[0].split(b"\t")[10] != b"*"


def test_gate_configs_return_none(tmp_path):
    idx, pidx, recs = _build(tmp_path, n_reads=8)
    for kw in (dict(shrimp_format=True),
               dict(compute_mapping_qualities=False), dict(trim_front=2)):
        m = Mapper(pidx, PortConfig(**kw), "cpu")
        assert fastpath.map_unpaired_sam_stream(m, recs) is None, kw
