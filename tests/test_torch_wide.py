"""Windows past the old kernel widths, on the CPU: the port maps every
read the JAX package maps, whatever its window's width.

Letter-space reads of 3,000 bp have windows of G = 4,224 columns (past
the packed flow's 4,095: the unpacked traceback flow), colour-space
reads of 200 colours windows of G = 288 (past the 4-layer DP's strip
kernel, 256). The port's streams and its generic mapper write the same
SAM bytes as shrimp_tpu's on them; the plain 4-layer DP and its
traceback equal sw_cs_jax.sw_full_cs_tpu (the XLA scan the reference runs
for G > 128) at G = 288 and 1,408, also when a launch is split by the
wide colour-space cap (core/sw_cs.py::cs_wide_rows), which leaves every
launch of G <= 256 as it was. One reference run per case, shared through
module fixtures. Tolerance 0 throughout: bytes and integers are equal.
Tests marked `cuda` hold the kernels at these widths against their plain
versions in tests/test_torch_sw_cs.py and tests/test_torch_sw_tb.py.
"""
from types import SimpleNamespace

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from shrimp_tpu import constants as RC
from shrimp_tpu import fastpath as ref_fastpath
from shrimp_tpu import fastpath_cs as ref_fastpath_cs
from shrimp_tpu.config import MapperConfig
from shrimp_tpu.core import encode
from shrimp_tpu.core.sw_cs_jax import sw_full_cs_tpu
from shrimp_tpu.index.build import build_index
from shrimp_tpu.index.seeds import default_seeds
from shrimp_tpu.io.fasta import SeqRecord
from shrimp_tpu.mapper import Mapper as RefMapper
from shrimp_tpu_torch import fastpath, fastpath_cs
from shrimp_tpu_torch.config import MapperConfig as PortConfig
from shrimp_tpu_torch.core import sw_cs
from shrimp_tpu_torch.index import build as port_index
from shrimp_tpu_torch.index import seeds as port_seeds
from shrimp_tpu_torch.mapper import Mapper

from .test_e2e_cs import make_cs_dataset
from .test_e2e_unpaired import make_dataset
from .test_torch_sw_cs import _DP_ORDER, KW as CS_KW, _dp_inputs, _t

CS = RC.MODE_COLOUR_SPACE
LS_CFG = dict(longest_read_len=4000)
CS_CFG = dict(mode=CS)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ls_data(tmp_path_factory):
    """Four reads of 3,000 bp on a 20 kbp genome (both packages'
    indexes): windows of G = 4,224."""
    _, _, g, reads = make_dataset(str(tmp_path_factory.mktemp("ls")),
                                  n_reads=4, read_len=3000,
                                  genome_len=20_000)
    codes = encode.encode_ls(g)
    return (build_index([("chr_test", codes)], default_seeds()),
            port_index.build_index([("chr_test", codes)],
                                   port_seeds.default_seeds()),
            [SeqRecord(n, s) for n, s in reads])


@pytest.fixture(scope="module")
def cs_data(tmp_path_factory):
    """Eight colour-space reads of 200 colours on a 20 kbp genome:
    windows of G = 288."""
    _, _, g, reads = make_cs_dataset(str(tmp_path_factory.mktemp("cs")),
                                     n_reads=8, read_len=200,
                                     genome_len=20_000)
    codes = encode.encode_ls(g)
    return (build_index([("chrC", codes)], default_seeds(mode=CS), mode=CS),
            port_index.build_index([("chrC", codes)],
                                   port_seeds.default_seeds(mode=CS),
                                   mode=CS),
            [SeqRecord(n, s) for n, s in reads])


@pytest.fixture(scope="module")
def ls_ref_sam(ls_data):
    idx, _, recs = ls_data
    return b"".join(ref_fastpath.map_unpaired_sam_stream(
        RefMapper(idx, MapperConfig(**LS_CFG)), recs, batch_size=4))


@pytest.fixture(scope="module")
def cs_ref_sam(cs_data):
    idx, _, recs = cs_data
    gen = ref_fastpath_cs.map_unpaired_cs_sam_stream(
        RefMapper(idx, MapperConfig(**CS_CFG)), recs, batch_size=8)
    assert gen is not None
    return b"".join(gen)


def test_ls_stream_past_4095_matches_reference(ls_data, ls_ref_sam,
                                               monkeypatch):
    """The LS stream on 3,000 bp reads (G = 4,224: the unpacked traceback
    flow) writes shrimp_tpu's bytes; no width raises."""
    _, pidx, recs = ls_data
    m = Mapper(pidx, PortConfig(**LS_CFG), "cpu")
    flows = []
    prep = fastpath.FastLS.stage_prepare

    def stage_prepare(self, records, batch_cap=None):
        ctx = prep(self, records, batch_cap)
        flows.append((ctx["stats_flow"], ctx["G"],
                      ctx["win"]["packed_io"]))
        return ctx
    monkeypatch.setattr(fastpath.FastLS, "stage_prepare", stage_prepare)
    got = b"".join(fastpath.map_unpaired_sam_stream(m, recs, batch_size=4))
    assert flows == [(False, 4224, False)]
    assert got == ls_ref_sam
    lines = got.split(b"\n")[:-1]
    assert sum(not int(ln.split(b"\t")[1]) & 4 for ln in lines) >= 3


def test_cs_stream_past_256_matches_reference(cs_data, cs_ref_sam,
                                              monkeypatch):
    """The CS stream on 200-colour reads (G = 288) writes shrimp_tpu's
    bytes. A 64-row chunk bucket holds the batch's windows: the pad rows
    of the smallest bucket (2,048 rows, cut to 1,165 by the wide cap) cost
    the plain 4-layer DP as much as windows do, and a row's bytes do not
    depend on its chunk (test_cs_chunker_cap,
    test_wide_cs_cap_splits_launches_and_changes_no_byte)."""
    monkeypatch.setattr(fastpath_cs, "CS_CHUNK_BUCKETS",
                        (64,) + fastpath_cs.CS_CHUNK_BUCKETS)
    _, pidx, recs = cs_data
    m = Mapper(pidx, PortConfig(**CS_CFG), "cpu")
    got = b"".join(fastpath_cs.map_unpaired_cs_sam_stream(m, recs,
                                                          batch_size=8))
    assert got == cs_ref_sam
    lines = got.split(b"\n")[:-1]
    assert sum(not int(ln.split(b"\t")[1]) & 4 for ln in lines) >= 6
    assert m.stats.full_invocs > 0


@pytest.mark.parametrize("case", ["ls-g4224", "cs-g288"])
def test_generic_mapper_past_old_widths(ls_data, cs_data, ls_ref_sam,
                                        cs_ref_sam, case):
    """The generic mapper (Mapper.map_unpaired, rendered as the streams'
    slow tail renders it) on the reads past each old limit writes
    shrimp_tpu's bytes: the 3,000 bp reads (G = 4,224; the vector SW, the
    full SW with backpointers and the traceback) and the 200-colour reads
    (G = 288; the CS vector SW, the 4-layer DP and its traceback). The
    reference is shrimp_tpu's stream, whose bytes its generic mapper
    writes too (tests/test_torch_mapper.py); its own generic mapper takes
    minutes a read at G = 4,224 on the CPU."""
    ls = case.startswith("ls")
    _, pidx, recs = ls_data if ls else cs_data
    m = Mapper(pidx, PortConfig(**(LS_CFG if ls else CS_CFG)), "cpu")
    got = fastpath.unpaired_slow_tail(m, recs, len(recs))(0)
    assert got == (ls_ref_sam if ls else cs_ref_sam)
    assert m.stats.full_invocs > 0


@pytest.mark.parametrize("B,R,G", [(24, 200, 288), (6, 120, 1408)],
                         ids=["g288", "g1408"])
def test_cs_dp_and_traceback_match_xla_scan(B, R, G):
    """The plain 4-layer DP and its traceback (sw_cs.sw_full_cs on CPU
    tensors) against sw_cs_jax.sw_full_cs_tpu, the XLA scan the reference
    runs for G > 128: packed rows and step strings, global and local,
    taboo 0 and 4, a quarter of the pairs at dataset.edge_bands."""
    a = _dp_inputs(G + R, B, G, R, edge=True)
    args = [a[k] for k in _DP_ORDER] + [a["thresh"]]
    jargs = args[:8] + [args[8] != 0] + args[9:]
    aligned = 0
    for local, taboo in ((False, 0), (True, 4)):
        kw = dict(CS_KW, local_alignment=local, indel_taboo_len=taboo)
        want = [np.asarray(x) for x in sw_full_cs_tpu(*jargs, **kw)]
        packed, steps = (x.numpy() for x in sw_cs.sw_full_cs(*_t(*args),
                                                             **kw))
        assert steps.shape == (B, R + G)
        assert np.array_equal(packed, want[0])
        assert np.array_equal(steps, want[1])
        aligned += int((packed[:, 0] > 0).sum())
    assert aligned >= B // 2


def test_wide_cs_cap_splits_launches_and_changes_no_byte(monkeypatch):
    """sw_cs.sw_full_cs splits windows over 256 columns into launches of
    at most cs_wide_rows rows (here, with the cap cut to three rows'
    backpointers, into launches of three rows), and the rows come out as
    one launch gives them."""
    B, R, G = 10, 40, 288
    a = _dp_inputs(5, B, G, R, edge=True)
    args = _t(*([a[k] for k in _DP_ORDER] + [a["thresh"]]))
    want = [x.numpy() for x in sw_cs.sw_full_cs(*args, **CS_KW)]
    monkeypatch.setattr(sw_cs, "CS_BP_CELLS", 3 * R * 4 * G + 1)
    assert sw_cs.cs_wide_rows(R, G) == 3
    launches = []
    dp = sw_cs.sw_full_cs_dp

    def counted(genome_ls, *rest, **kw):
        launches.append(genome_ls.shape[0])
        return dp(genome_ls, *rest, **kw)
    monkeypatch.setattr(sw_cs, "sw_full_cs_dp", counted)
    got = [x.numpy() for x in sw_cs.sw_full_cs(*args, **CS_KW)]
    assert launches == [3, 3, 3, 1]
    for x, w in zip(got, want):
        assert np.array_equal(x, w)
    assert (want[0][:, 0] > 0).any()


@pytest.mark.parametrize("G,R,phase,CB,rows", [
    (64, 36, "fused", 2048, 2048), (128, 72, "full", 8192, 8192),
    (256, 256, "fused", 131072, 131072), (256, 4000, "full", 2048, 2048),
    (288, 200, "fused", 2048, 1165), (288, 200, "vec", 2048, 2048),
    (1408, 1000, "full", 2048, 47), (1408, 1000, "fused", 8, 8)])
def test_cs_chunker_cap(monkeypatch, G, R, phase, CB, rows):
    """FastCS._cs_chunks launches CB rows a chunk for every G <= 256 (the
    shapes of the launches are as they were) and for the vector SW
    alone; a chunk that runs the 4-layer DP on wider windows holds at
    most 2^28 backpointer cells (rows * R * 4 * G)."""
    seen = []

    def step(planes0, *a, **kw):
        seen.append(a[3].shape[0])
        return kw["phase"]
    monkeypatch.setattr(fastpath_cs, "sw_vec_cs_full_from_index", step)
    m = SimpleNamespace(device=torch.device("cpu"),
                        _upload=torch.from_numpy,
                        _dev_cs_planes=lambda: [None] * 4,
                        _dev_cs_cat_words=lambda: None)
    fake = SimpleNamespace(m=m)
    n = 2 * CB + 3
    args = np.zeros((n, 12), np.int32)
    futures = fastpath_cs.FastCS._cs_chunks(
        fake, args, CB, torch.zeros((4, R), dtype=torch.uint8), None, None,
        dict(G=G, phase=phase))
    assert set(seen) == {rows}
    assert sum(k for _, k, _ in futures) == n
    if rows != CB:
        assert rows * R * 4 * G <= 1 << 28 < (rows + 1) * R * 4 * G
    assert sw_cs.cs_wide_rows(R, G) == (None if G <= 256 else
                                        max(1, (1 << 28) // (R * 4 * G)))


@pytest.mark.parametrize("R,G,rows", [(256, 352, 2978), (1000, 1408, 1024),
                                      (3000, 4224, 1024),
                                      (100_000, 200_000, 894)])
def test_ls_vec_only_launch_rows(R, G, rows):
    """The traceback flow's vec-only launches (two-phase dispatch) hold
    at least the fused launch's rows (2,978 at 250 bp, as before) and up
    to 1,024 windows of long reads, within 2^28 bytes of windows and read
    rows: the vec-only launch keeps no backpointers."""
    assert fastpath._vec_batch(R, G) == rows
    assert rows >= fastpath._tb_batch(R, G)
    assert rows == fastpath._tb_batch(R, G) or (
        rows <= 1024 and rows * (G + R) <= 1 << 28)
