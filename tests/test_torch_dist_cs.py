"""The multi-process tier in colour space and on long reads
(shrimp_tpu_torch.parallel.dist.DistMapper): two rank processes over
gloo, 4 of the 8 sub-indexes a rank on ["cpu"] * 4, JAX and shrimp_tpu
blocked in them (tests/dist_data.py). Both ranks' SAM must equal, byte
for byte, shrimp_tpu's single-process whole-index fast path (batch 100,
lanes=1) and the port's unsharded stream: CS unpaired (the per-shard
fused CS launch, the ragged exchange of its rows, the owner-rank window
arena of the post-SW eval), CS pairs (the paired Z merge across ranks)
and 800 bp reads (G = 1120: the per-shard traceback flow, whose rows and
ops go through the exchange). Tolerance: none."""
import numpy as np
import pytest
import torch

from shrimp_tpu_torch import fastpath, fastpath_cs
from shrimp_tpu_torch.config import MapperConfig as PortConfig
from shrimp_tpu_torch.index.build import build_index as port_build
from shrimp_tpu_torch.index.seeds import default_seeds as port_seeds
from shrimp_tpu_torch.mapper import Mapper as PortMapper
from shrimp_tpu_torch.paired import PairedMapper as PortPairedMapper

from .dist_data import (make_cs_dataset, make_cs_paired_dataset,
                        make_long_dataset, run_ranks)

CS = dict(mode="cs")
CS_PAIRED = dict(mode="cs", pair_mode="opp-in")
LONG = dict(longest_read_len=1000)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain versions run on one torch thread here, as in the other
    port tests (and in the rank processes: OMP_NUM_THREADS=1)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _sams(contigs, reads, imode, paired, batch, cfgkw):
    """(shrimp_tpu's SAM, the port's unsharded SAM) of the whole index
    at lanes=1."""
    from shrimp_tpu import fastpath as ref_ls
    from shrimp_tpu import fastpath_cs as ref_cs
    from shrimp_tpu.config import MapperConfig
    from shrimp_tpu.index.build import build_index
    from shrimp_tpu.index.seeds import default_seeds
    from shrimp_tpu.mapper import Mapper
    from shrimp_tpu.paired import PairedMapper
    idx = build_index(contigs, default_seeds(mode=imode), mode=imode)
    pidx = port_build(contigs, port_seeds(mode=imode), mode=imode)
    ref_mod, port_mod = (ref_cs, fastpath_cs) if imode == "cs" else (
        ref_ls, fastpath)
    name = "map_{}_{}sam_stream".format("paired" if paired else "unpaired",
                                        "cs_" if imode == "cs" else "")
    ref = getattr(ref_mod, name)(
        (PairedMapper if paired else Mapper)(idx, MapperConfig(**cfgkw)),
        reads, batch_size=batch, lanes=1)
    port = getattr(port_mod, name)(
        (PortPairedMapper if paired else PortMapper)(
            pidx, PortConfig(**cfgkw), "cpu"), reads, batch_size=batch,
        lanes=1)
    out = b"".join(ref), b"".join(port)
    idx.release()
    pidx.release()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One rank pair maps the three cases; the oracles beside it."""
    cc, cr = make_cs_dataset()
    pc, pr = make_cs_paired_dataset()
    lc, lr = make_long_dataset()
    res = run_ranks(str(tmp_path_factory.mktemp("dist_cs")), {
        "cs": ("cs", cc), "cs_pairs": ("cs", pc), "long": ("ls", lc)}, [
        dict(name="c", genome="cs", reads=cr, batch_size=100, config=CS),
        dict(name="d", genome="cs_pairs", reads=pr, batch_size=100,
             paired=True, config=CS_PAIRED),
        dict(name="g", genome="long", reads=lr, batch_size=24, config=LONG)])
    want = {"c": _sams(cc, cr, "cs", False, 100, CS),
            "d": _sams(pc, pr, "cs", True, 100, CS_PAIRED),
            "g": _sams(lc, lr, "ls", False, 24, LONG)}
    return res, want


def _same_sam(runs, name):
    res, want = runs
    ref, port = want[name]
    assert ref == port
    for sam, _, _ in res[name]:
        assert sam == ref
    return res[name]


def test_dist_cs_unpaired_matches_single_process(runs):
    """(c) CS unpaired: the windows are allgathered before selection, so
    z1 needs no merge; every shard's rows went through the exchange."""
    got = _same_sam(runs, "c")
    assert got[0][0].count(b"\n") >= 150
    for _, meta, _ in got:
        assert meta["merge_bytes"] > 0
        assert meta["f1_local_windows"] > 0


def test_dist_cs_paired_matches_single_process(runs):
    """(d) CS pairs: the paired class statistics merged across ranks,
    the same bits on both ranks."""
    got = _same_sam(runs, "d")
    assert got[0][0].count(b"\n") >= 100
    assert got[0][1]["z1_max"] > 0.0
    assert np.array_equal(got[0][2]["zpair"], got[1][2]["zpair"])


def test_dist_long_reads_match_single_process(runs):
    """(g) 800 bp reads, G = 1120 > MAX_G: each local shard runs the
    traceback flow and the [k, 10] rows and ops are exchanged."""
    got = _same_sam(runs, "g")
    assert got[0][0].count(b"\n") >= 20
    assert np.array_equal(got[0][2]["z1"], got[1][2]["z1"])
    # vec (8 B), packed (40 B) and ops ((800 + 1120 + 3) // 4 B) a window
    assert got[0][1]["merge_bytes"] % (8 + 40 + 480) == 0
