"""The port's MeshMapper (shrimp_tpu_torch.parallel.meshmap, on meshes of
"cpu" devices: the plain versions) must write the SAM bytes of the JAX
package's MeshMapper on the 8-device CPU mesh of tests/conftest.py and
of the port's unsharded streams, in the six cases of tests/test_meshmap.py
at their sizes (LS unpaired with the z1 partials, LS pairs, uneven shard
counts, long reads, CS, CS pairs), over several shard counts. The
collectives zmerge_psum and zpair_merge must match the JAX ones on
seeded rows with ties in the best posterior, all-negative best
posteriors and a shard with no rows: the additive columns within rtol
1e-12, the min and the argmax-selected priors exactly. SAM tolerance:
none, the bytes are equal."""
import copy
import gc

import jax
import numpy as np
import pytest
import torch

from shrimp_tpu import constants as RC
from shrimp_tpu.config import MapperConfig as RefConfig
from shrimp_tpu.io.fasta import SeqRecord as RefRecord
from shrimp_tpu.parallel import meshmap as ref_mm
from shrimp_tpu.utils import hostmem as ref_hostmem
from shrimp_tpu_torch import fastpath, fastpath_cs
from shrimp_tpu_torch.config import MapperConfig
from shrimp_tpu_torch.core import sw_full, sw_vector
from shrimp_tpu_torch.index import build as port_build
from shrimp_tpu_torch.index.build import build_index
from shrimp_tpu_torch.index.seeds import default_seeds
from shrimp_tpu_torch.io.fasta import SeqRecord
from shrimp_tpu_torch.mapper import Mapper
from shrimp_tpu_torch.paired import PairedMapper
from shrimp_tpu_torch.parallel import meshmap

from .test_meshmap import COMP, _mk_genome, _mk_reads, mk_cs_pairs

CS = RC.MODE_COLOUR_SPACE


@pytest.fixture(scope="module", autouse=True)
def _index_memory_freed():
    """Both packages' index builds copy the big arrays into hugepage
    buffers that are never unmapped (`utils/hostmem.py::to_hugepages`).
    These cases build dozens of small indexes, each with CSR offset
    tables of 4^weight entries, so here the arrays stay in numpy memory,
    freed with their index: the copy's own fallback, the same bytes."""
    mp = pytest.MonkeyPatch()
    mp.setattr(port_build, "to_hugepages", lambda a: a)
    mp.setattr(ref_hostmem, "to_hugepages", lambda a: a)
    yield
    mp.undo()


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
    # the JAX tiers hold their indexes in reference cycles (jitted steps
    # bound to the tier): free them before the next case builds its own
    gc.collect()


def _port(recs):
    return [SeqRecord(r.name, r.seq, r.qual) for r in recs]


def _jax_mesh(D):
    return ref_mm.make_mesh(jax.devices()[:D])


def _case(contigs, reads, kw, mode="ls", paired=False, batch=96, jax_D=8,
          collect_z=False):
    """The JAX tier's SAM (and, with `collect_z`, its z1 partials) on a
    `jax_D`-device mesh, and the port's unsharded stream's, of one case.
    Both map the port's index: an index build costs about a second
    whatever the genome (its 4^12-entry CSR tables), and the port's build
    is held equal to the reference's by tests/test_torch_host.py."""
    cfg = RefConfig(**kw)
    pidx = build_index(contigs, default_seeds(mode=mode), mode=mode)
    mm = ref_mm.MeshMapper(pidx, cfg, mesh=_jax_mesh(jax_D))
    if paired:
        want_jax = mm.map_paired_sam(reads, batch_size=batch)
    else:
        want_jax = mm.map_unpaired_sam(reads, batch_size=batch,
                                       collect_z=collect_z)
    pcfg = MapperConfig(**kw)
    preads = _port(reads)
    cls = PairedMapper if paired else Mapper
    stream = {("ls", False): fastpath.map_unpaired_sam_stream,
              ("ls", True): fastpath.map_paired_sam_stream,
              ("cs", False): fastpath_cs.map_unpaired_cs_sam_stream,
              ("cs", True): fastpath_cs.map_paired_cs_sam_stream}[
                  (mode, paired)]
    want = b"".join(stream(cls(pidx, pcfg, "cpu"), preads, batch_size=batch,
                           lanes=1))
    assert want == want_jax
    return dict(idx=pidx, cfg=pcfg, reads=preads, want=want, batch=batch,
                paired=paired, zpart=getattr(mm, "last_zpart", None))


@pytest.fixture(scope="module")
def unpaired():
    rng = np.random.default_rng(101)
    contigs, gs = _mk_genome(rng)
    return _case(contigs, _mk_reads(rng, gs, 240), {}, collect_z=True)


@pytest.fixture(scope="module")
def paired():
    rng = np.random.default_rng(102)
    contigs, gs = _mk_genome(rng)
    reads = []
    for k in range(120):
        src = gs[k % len(gs)]
        isz = int(rng.integers(90, 200))
        p = int(rng.integers(0, len(src) - isz - 1))
        r2 = "".join(COMP[c] for c in reversed(src[p + isz - 36:p + isz]))
        reads += [RefRecord(f"p{k}/1", src[p:p + 36]),
                  RefRecord(f"p{k}/2", r2)]
    return _case(contigs, reads, dict(pair_mode="opp-in",
                                      min_insert_size=60,
                                      max_insert_size=240),
                 paired=True, batch=80)


@pytest.fixture(scope="module")
def uneven():
    rng = np.random.default_rng(103)
    contigs, gs = _mk_genome(rng, n_contigs=1, clen=12_000)
    return _case(contigs, _mk_reads(rng, gs, 64), {}, batch=64, jax_D=3)


@pytest.fixture(scope="module")
def long_reads():
    rng = np.random.default_rng(977)
    contigs, gs = _mk_genome(rng, n_contigs=1, clen=40_000)
    reads = []
    for k in range(12):
        p = int(rng.integers(0, len(gs[0]) - 1200))
        r = list(gs[0][p:p + 1200])
        for _ in range(int(rng.integers(0, 6))):
            r[int(rng.integers(0, 1200))] = "ACGT"[int(rng.integers(0, 4))]
        r = "".join(r)
        if k % 3 == 0:
            r = "".join(COMP[c] for c in reversed(r))
        reads.append(RefRecord(f"lr{k}", r))
    out = _case(contigs, reads, dict(longest_read_len=2000), batch=12,
                jax_D=4)
    assert out["want"].count(b"\n") >= 10
    return out


def _cs_reads(rng, gs, n):
    l2n = {c: i for i, c in enumerate("ACGT")}

    def tocs(s):
        return "T" + str(l2n["T"] ^ l2n[s[0]]) + "".join(
            str(l2n[s[i]] ^ l2n[s[i + 1]]) for i in range(len(s) - 1))
    reads = []
    for k in range(n):
        src = gs[k % len(gs)]
        p = int(rng.integers(0, len(src) - 36))
        s = list(src[p:p + 36])
        for _ in range(int(rng.integers(0, 2))):
            s[int(rng.integers(0, 36))] = "ACGT"[int(rng.integers(0, 4))]
        s = "".join(s)
        if k % 3 == 0:
            s = "".join(COMP[c] for c in reversed(s))
        reads.append(RefRecord(f"cs{k}", tocs(s)))
    return reads


@pytest.fixture(scope="module")
def colour_space():
    rng = np.random.default_rng(555)
    contigs, gs = _mk_genome(rng, n_contigs=2, clen=20_000)
    return _case(contigs, _cs_reads(rng, gs, 96), dict(mode=CS), mode="cs",
                 jax_D=4)


@pytest.fixture(scope="module")
def colour_space_paired():
    rng = np.random.default_rng(556)
    contigs, gs = _mk_genome(rng, n_contigs=2, clen=20_000)
    return _case(contigs, mk_cs_pairs(rng, gs, 60),
                 dict(mode=CS, pair_mode="opp-in"), mode="cs", paired=True,
                 batch=60, jax_D=4)


def _run(case, D, **kw):
    mm = meshmap.MeshMapper(case["idx"], case["cfg"],
                            mesh=meshmap.make_mesh(["cpu"] * D), **kw)
    f = mm.map_paired_sam if case["paired"] else mm.map_unpaired_sam
    return mm, f(case["reads"], batch_size=case["batch"])


@pytest.mark.parametrize("D", [8, 3])
def test_meshmap_unpaired_byte_identical(unpaired, D):
    """LS unpaired; the z1 partials summed by zmerge_psum equal their
    host sum (rtol 1e-12) and the JAX tier's per-read sums."""
    mm = meshmap.MeshMapper(unpaired["idx"], unpaired["cfg"],
                            mesh=meshmap.make_mesh(["cpu"] * D))
    got = mm.map_unpaired_sam(unpaired["reads"], batch_size=96,
                              collect_z=True)
    assert got == unpaired["want"]
    zp = mm.last_zpart
    assert zp.shape == (D, 240)
    host = zp.sum(axis=0)
    np.testing.assert_allclose(meshmap.zmerge_psum(mm.mesh, zp), host,
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(host, unpaired["zpart"].sum(axis=0),
                               rtol=1e-12, atol=0)
    assert float(host.max()) > 0.0
    assert (zp.sum(axis=1) > 0).sum() >= min(D, 3)   # shards share the work
    assert mm.m.device_planes() == []                # no whole-genome plane


@pytest.mark.parametrize("D", [8, 3])
def test_meshmap_paired_byte_identical(paired, D):
    assert _run(paired, D)[1] == paired["want"]


@pytest.mark.parametrize("D", [2, 3, 5])
def test_meshmap_uneven_mesh_sizes(uneven, D):
    """Byte identity for any shard count, some shards nearly empty."""
    assert _run(uneven, D)[1] == uneven["want"]


def test_meshmap_long_reads(long_reads, monkeypatch):
    """1200 bp reads: the halo grows with the window length, and windows
    the stats kernel does not take run one single-device launch of the
    traceback flow on mesh[0] (the only dispatch of the run)."""
    calls = []
    orig = meshmap._fused_dispatch

    def spy(m, *a, **k):
        calls.append(m.device)
        return orig(m, *a, **k)
    monkeypatch.setattr(meshmap, "_fused_dispatch", spy)
    mm, got = _run(long_reads, 4)
    assert mm.halo >= 2048
    assert got == long_reads["want"]
    assert calls == [torch.device("cpu")]


@pytest.mark.parametrize("D", [2, 4, 8])
def test_meshmap_colour_space(colour_space, D):
    assert _run(colour_space, D)[1] == colour_space["want"]


@pytest.mark.parametrize("D", [2, 4])
def test_meshmap_colour_space_paired(colour_space_paired, D):
    assert _run(colour_space_paired, D)[1] == colour_space_paired["want"]


def test_meshmap_cpu_mesh_runs_the_plain_versions(uneven, monkeypatch):
    """A mesh of "cpu" devices: every shard's planes on the CPU, one
    fused launch per shard with windows, through the plain versions (no
    CUDA kernel counted)."""
    seen = []
    for mod, name in ((sw_vector, "sw_vector_batch_ref"),
                      (sw_full, "sw_full_stats_ref")):
        orig = getattr(mod, name)

        def spy(*a, _o=orig, _n=name, **k):
            seen.append((_n, a[0].shape[0]))
            return _o(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    n0 = sw_vector.LAUNCHES.n + sw_full.LAUNCHES.n
    mm, got = _run(uneven, 3)
    assert got == uneven["want"]
    assert all(p.device.type == "cpu" for sh in mm.shards for p in sh.ls)
    rows = [r for n, r in seen if n == "sw_vector_batch_ref"]
    assert len(rows) >= 2 and sum(rows) == mm.m.stats.vec_invocs
    assert sorted(rows) == sorted(r for n, r in seen
                                  if n == "sw_full_stats_ref")
    assert sw_vector.LAUNCHES.n + sw_full.LAUNCHES.n == n0


def test_meshmap_window_past_the_halo_raises(uneven):
    with pytest.raises(ValueError, match="exceeds shard halo 32"):
        _run(uneven, 2, halo=32)


def test_meshmap_index_of_2_31_bases_raises(uneven, monkeypatch):
    """Window starts are int32: an index of 2^31 bases or more raises, as
    on one device (the length is faked once filter 1 has run)."""
    gen_cand = fastpath.generate_candidates_native
    mm = meshmap.MeshMapper(copy.copy(uneven["idx"]), uneven["cfg"],
                            mesh=meshmap.make_mesh(["cpu"] * 2))

    class Huge(type(mm.m.index)):
        total_len = property(lambda self: 1 << 31)

    def filter1(index, *a, **k):
        fh = gen_cand(index, *a, **k)
        mm.m.index.__class__ = Huge
        return fh
    monkeypatch.setattr(fastpath, "generate_candidates_native", filter1)
    with pytest.raises(NotImplementedError, match=r"2\^31"):
        mm.map_unpaired_sam(uneven["reads"], batch_size=64)


def test_meshmap_generic_fallback(uneven):
    """A config outside the fused fast path maps with the generic mapper
    on mesh[0]: the bytes of the port's generic mapper."""
    from shrimp_tpu_torch.io.sam import render_unpaired
    cfg = MapperConfig(compute_mapping_qualities=False)
    reads = uneven["reads"][:16]
    m = Mapper(uneven["idx"], cfg, "cpu")
    want = "".join(render_unpaired(e, h, m.index, cfg) + "\n"
                   for e, hs in m.map_unpaired(reads) for h in hs).encode()
    mm = meshmap.MeshMapper(uneven["idx"], cfg,
                            mesh=meshmap.make_mesh(["cpu"] * 2))
    assert want and mm.map_unpaired_sam(reads) == want


def _zrows(seed, D, n):
    """Seeded partial rows [D, n, 9] as pairedpipe.cpp writes them:
    sums >= 0, best posteriors with ties across shards, rows whose best
    posteriors are all -1 (no foot anywhere), the last shard with no
    rows (its sentinels only)."""
    rng = np.random.default_rng(seed)
    z = np.zeros((D, n, 9))
    z[:, :, :4] = rng.random((D, n, 4)) * (rng.random((D, n, 1)) < 0.6)
    best = rng.choice([-1.0, 0.25, 0.5, 0.75], size=(D, n, 2))
    z[:, :, 4], z[:, :, 6] = best[..., 0], best[..., 1]
    z[:, :, 5], z[:, :, 7] = rng.random((D, n)), rng.random((D, n))
    z[:, :, 8] = np.minimum(1.0, rng.random((D, n)) * 1.5)
    z[:, : n // 4, 4] = z[:, : n // 4, 6] = -1.0        # all negative
    z[-1] = 0.0
    z[-1, :, 4] = z[-1, :, 6] = -1.0
    z[-1, :, 5] = z[-1, :, 7] = z[-1, :, 8] = 1.0
    return z


@pytest.mark.parametrize("D", [8, 3])
@pytest.mark.parametrize("seed", [1, 2])
def test_zpair_merge_matches_jax(D, seed):
    z = _zrows(seed, D, 64)
    assert (z[:, :, 4] == z[:, :, 4].max(axis=0)).sum(axis=0).max() > 1
    want = ref_mm.zpair_merge(_jax_mesh(D), z)
    got = meshmap.zpair_merge(meshmap.make_mesh(["cpu"] * D), z)
    assert got.shape == want.shape == (64, 7)
    np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=1e-12, atol=0)
    assert np.array_equal(got[:, 4:], want[:, 4:])
    assert (got[: 16, 4:6] == 1.0).all()


@pytest.mark.parametrize("D", [8, 3])
@pytest.mark.parametrize("seed", [1, 2])
def test_zmerge_psum_matches_jax(D, seed):
    rng = np.random.default_rng(seed)
    z = rng.random((D, 200)) * (rng.random((D, 200)) < 0.5)
    z[-1] = 0.0                                  # a shard with no rows
    want = ref_mm.zmerge_psum(_jax_mesh(D), z)
    got = meshmap.zmerge_psum(meshmap.make_mesh(["cpu"] * D), z)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    np.testing.assert_allclose(got, z.sum(axis=0), rtol=1e-12, atol=0)


def test_make_mesh_devices():
    mesh = meshmap.make_mesh(["cpu"] * 3)
    assert mesh == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError):
        meshmap.make_mesh([])


@pytest.mark.cuda
def test_make_mesh_default_is_the_cards():
    """make_mesh() is every visible card; without one it raises (and a
    mesh never falls back to the CPU unless the caller lists "cpu")."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            meshmap.make_mesh()
        with pytest.raises(RuntimeError):
            meshmap.make_mesh(["cuda:0"] * 2)
        return
    mesh = meshmap.make_mesh()
    assert mesh == tuple(torch.device("cuda", i)
                         for i in range(torch.cuda.device_count()))


@pytest.mark.cuda
def test_cuda_mesh_matches_cpu(uneven):
    """Four shards on one card write the CPU mesh's bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mm = meshmap.MeshMapper(uneven["idx"], uneven["cfg"],
                            mesh=meshmap.make_mesh(["cuda:0"] * 4))
    assert mm.map_unpaired_sam(uneven["reads"], batch_size=64) == \
        uneven["want"]


def test_mapper_planes_upload_on_first_use(uneven, colour_space):
    """The inner mapper of a mesh tier uploads no plane until a fallback
    asks for one: a Mapper's planes go up on first use, once, however
    many lane threads race to it; a plane set to None stays withheld."""
    from concurrent.futures import ThreadPoolExecutor
    m = Mapper(colour_space["idx"], colour_space["cfg"], "cpu")
    assert m.device_planes() == []
    with ThreadPoolExecutor(8) as ex:
        got = list(ex.map(lambda _: m._dev_cs_planes(), range(16)))
    assert all(g is got[0] for g in got)
    assert got[0][2] is m._dev_codes() and got[0][3] is m._dev_codes_rc()
    assert m.device_planes() == ["_codes_dev", "_codes_rc_dev",
                                 "_cs_planes_dev"]
    m._cat_words_dev = None
    assert m._dev_cat_words() is None and m._dev_cs_cat_words() is None
    ls = Mapper(uneven["idx"], uneven["cfg"], "cpu")
    assert ls._dev_cs_planes() is None and ls._dev_cs_cat_words() is None
    assert ls._dev_cat_words() is not None
    assert ls.device_planes() == ["_cat_words_dev"]
