"""The port's LS unpaired stream on long reads (shrimp_tpu_torch.fastpath
on the CPU, through the traceback flow) must write the same SAM bytes as
shrimp_tpu.fastpath.map_unpaired_sam_stream, whose CPU backend runs its
own traceback flow (sw_jax.sw_vec_full_tb_packed: XLA DP and the
on-device traceback). Tolerance: none, the bytes are equal."""
import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
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
from shrimp_tpu_torch.core import sw_full
from shrimp_tpu_torch.index import build as port_index
from shrimp_tpu_torch.index import seeds as port_seeds
from shrimp_tpu_torch.mapper import Mapper

from .test_e2e_unpaired import make_dataset


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _build(tmp_path, **dskw):
    _, _, g, reads = make_dataset(str(tmp_path), **dskw)
    codes = encode.encode_ls(g)
    idx = build_index([("chr_test", codes)], default_seeds())
    pidx = port_index.build_index([("chr_test", codes)],
                                  port_seeds.default_seeds())
    return idx, pidx, [SeqRecord(n, s) for n, s in reads]


def _port_sam(pidx, recs, batch_size, flows):
    """SAM bytes of the port's stream; `flows` collects the flow each
    batch took (True: stats, False: traceback)."""
    m = Mapper(pidx, None, "cpu")
    fast = fastpath.FastLS(m)
    prep = fast.stage_prepare

    def stage_prepare(records, batch_cap=None):
        ctx = prep(records, batch_cap)
        flows.append(ctx["stats_flow"])
        return ctx
    gen = fastpath.batch_pipeline(fast, stage_prepare, fast.stage_finish,
                                  recs, batch_size, 1, "")
    return b"".join(gen)


@pytest.mark.parametrize("read_len,n_reads,genome_len,batch_size", [
    (250, 48, 20_000, 48),      # G = 352: one 2048-row FULL_BUCKETS chunk
    (600, 24, 20_000, 12),      # G = 864: pow2 buckets of 16 rows
], ids=["250bp", "600bp"])
def test_long_reads_match_reference(tmp_path, read_len, n_reads, genome_len,
                                    batch_size):
    idx, pidx, recs = _build(tmp_path, n_reads=n_reads, read_len=read_len,
                             genome_len=genome_len)
    want = b"".join(ref_fastpath.map_unpaired_sam_stream(
        RefMapper(idx, MapperConfig()), recs, batch_size=batch_size))
    before = sw_full.BP_LAUNCHES.n, sw_full.TB_LAUNCHES.n
    flows = []
    got = _port_sam(pidx, recs, batch_size, flows)
    assert flows and not any(flows)          # the traceback flow ran
    # the CPU takes the plain versions: no kernel launch is counted
    assert (sw_full.BP_LAUNCHES.n, sw_full.TB_LAUNCHES.n) == before
    assert got == want
    lines = got.split(b"\n")[:-1]
    assert len(lines) >= n_reads // 2
    # indel reads (make_dataset kinds 2 and 3) align with an I or D
    assert any(b"I" in ln.split(b"\t")[5] or b"D" in ln.split(b"\t")[5]
               for ln in lines)


def test_traceback_flow_matches_stats_flow(tmp_path, monkeypatch):
    """36 bp reads forced through the traceback flow by the gate give the
    stats flow's SAM (and the reference's)."""
    idx, pidx, recs = _build(tmp_path, n_reads=120, seed=3)
    flows = []
    stats_sam = _port_sam(pidx, recs, len(recs), flows)
    assert flows == [True]
    monkeypatch.setattr(fastpath, "_stats_flow_enabled", lambda G: False)
    flows = []
    tb_sam = _port_sam(pidx, recs, len(recs), flows)
    assert flows == [False]
    assert tb_sam == stats_sam
    want = b"".join(ref_fastpath.map_unpaired_sam_stream(
        RefMapper(idx, MapperConfig()), recs, batch_size=len(recs)))
    assert tb_sam == want


@pytest.mark.parametrize("k,eff,want", [
    (100, 8192, 2048), (5000, 8192, 8192), (2978, 2978, 4096),
    (517, 517, 1024), (12, 517, 16), (3, 8, 8), (9, 16, 16)])
def test_chunk_buckets(k, eff, want):
    """Launch rows: FULL_BUCKETS while the chunk size is at least 2048,
    else the next power of two >= k (min 8), as the reference pads."""
    assert fastpath._chunk_bucket(k, eff) == want


@pytest.mark.parametrize("G,stats", [(64, True), (256, True), (288, False),
                                     (352, False), (1408, False)])
def test_flow_gate(G, stats):
    assert fastpath._stats_flow_enabled(G) is stats
