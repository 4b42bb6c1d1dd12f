"""The port's ShardedIndexMapper (shrimp_tpu_torch.parallel.meshmap, on
meshes of "cpu" devices) must write the SAM bytes of the JAX package's
ShardedIndexMapper on the CPU mesh of tests/conftest.py and of the
port's unsharded streams over the whole index, in the cases of
tests/test_sharded_index.py at their sizes (LS unpaired with the z1
collective, uneven shard counts, LS pairs with the zpair collective, the
refused config, CS, CS pairs), over several shard counts. Filter 1 runs
per shard on each shard's own sub-index; the collectives' merged rows,
which the render divides by, must match the JAX tier's (additive columns
within rtol 1e-12, the min and the argmax-selected priors exactly); no
structure holds the whole-genome CSR, and the inner mapper holds no
genome plane on its device. Contigs are multiples of 2^region_bits, as
in the reference's tests. SAM tolerance: none."""
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
from shrimp_tpu_torch.index import build as port_build
from shrimp_tpu_torch.index.build import build_index
from shrimp_tpu_torch.index.seeds import default_seeds
from shrimp_tpu_torch.io.fasta import SeqRecord
from shrimp_tpu_torch.mapper import Mapper
from shrimp_tpu_torch.paired import PairedMapper
from shrimp_tpu_torch.parallel import meshmap

from .test_meshmap import mk_cs_pairs
from .test_sharded_index import COMP, _mk_genome, _mk_reads

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


def _subs(contigs, D, mode="ls"):
    return [build_index(b, default_seeds(mode=mode), mode=mode)
            for b in meshmap.split_contig_bins(contigs, D)]


def _case(contigs, reads, kw, mode="ls", paired=False, batch=96, jax_D=2):
    """The JAX tier's SAM and last merged Z rows on a `jax_D`-shard mesh,
    and the port's unsharded stream's SAM over the whole index. An index
    build costs about a second whatever the genome (its 4^12-entry CSR
    tables), so the JAX tier maps the port's sub-indexes (the port's
    build is held equal to the reference's by tests/test_torch_host.py),
    which the port's case at D = jax_D then takes over (`_run`)."""
    subs = _subs(contigs, jax_D, mode)
    sim = ref_mm.ShardedIndexMapper(
        subs, RefConfig(**kw), mesh=ref_mm.make_mesh(jax.devices()[:jax_D]))
    f = sim.map_paired_sam if paired else sim.map_unpaired_sam
    want_jax = f(reads, batch_size=batch)
    idx = build_index(contigs, default_seeds(mode=mode), mode=mode)
    cfg = MapperConfig(**kw)
    preads = [SeqRecord(r.name, r.seq, r.qual) for r in reads]
    stream = {("ls", False): fastpath.map_unpaired_sam_stream,
              ("ls", True): fastpath.map_paired_sam_stream,
              ("cs", False): fastpath_cs.map_unpaired_cs_sam_stream,
              ("cs", True): fastpath_cs.map_paired_cs_sam_stream}[
                  (mode, paired)]
    cls = PairedMapper if paired else Mapper
    want = b"".join(stream(cls(idx, cfg, "cpu"), preads, batch_size=batch,
                           lanes=1))
    assert want == want_jax
    return dict(contigs=contigs, cfg=cfg, reads=preads, want=want,
                batch=batch, paired=paired, mode=mode, idx=idx,
                subs={jax_D: subs},
                z1=sim.last_z1_merged, zpair=sim.last_zpair_merged)


def _run(case, D, subs=None, **kw):
    subs = subs or case["subs"].pop(D, None) or _subs(case["contigs"], D,
                                                      case["mode"])
    sim = meshmap.ShardedIndexMapper(
        subs, case["cfg"], mesh=meshmap.make_mesh(["cpu"] * D), **kw)
    f = sim.map_paired_sam if case["paired"] else sim.map_unpaired_sam
    return sim, f(case["reads"], batch_size=case["batch"])


@pytest.fixture(scope="module")
def unpaired():
    rng = np.random.default_rng(211)
    contigs, gs = _mk_genome(rng)
    return _case(contigs, _mk_reads(rng, gs, 240), {}, jax_D=3)


@pytest.fixture(scope="module")
def uneven():
    rng = np.random.default_rng(212)
    contigs, gs = _mk_genome(rng, n_contigs=5)
    return _case(contigs, _mk_reads(rng, gs, 100), {}, batch=100, jax_D=3)


@pytest.fixture(scope="module")
def two_shards(uneven):
    """The uneven case's contigs over two sub-indexes, for the refusal
    and table cases."""
    return _subs(uneven["contigs"], 2)


@pytest.fixture(scope="module")
def paired():
    rng = np.random.default_rng(215)
    contigs, gs = _mk_genome(rng, n_contigs=4)
    reads = []
    for k in range(120):
        src = gs[k % len(gs)]
        isz = int(rng.integers(90, 200))
        p = int(rng.integers(0, len(src) - isz - 1))
        r2 = "".join(COMP[c] for c in reversed(src[p + isz - 36:p + isz]))
        if k % 11 == 0:     # discordant mate: the unpaired fallback
            q = int(rng.integers(0, len(src) - 36))
            r2 = src[q:q + 36]
        reads += [RefRecord(f"sp{k}/1", src[p:p + 36]),
                  RefRecord(f"sp{k}/2", r2)]
    return _case(contigs, reads, dict(pair_mode="opp-in",
                                      min_insert_size=60,
                                      max_insert_size=240),
                 paired=True, batch=80)


@pytest.fixture(scope="module")
def colour_space():
    rng = np.random.default_rng(31)
    contigs, gs = _mk_genome(rng, n_contigs=4)
    l2n = {c: i for i, c in enumerate("ACGT")}

    def tocs(s):
        return "T" + str(l2n["T"] ^ l2n[s[0]]) + "".join(
            str(l2n[s[i]] ^ l2n[s[i + 1]]) for i in range(len(s) - 1))
    reads = []
    for k in range(150):
        src = gs[k % len(gs)]
        p = int(rng.integers(0, len(src) - 36))
        s = list(src[p:p + 36])
        for _ in range(int(rng.integers(0, 2))):
            s[int(rng.integers(0, 36))] = "ACGT"[int(rng.integers(0, 4))]
        s = "".join(s)
        if k % 3 == 0:
            s = "".join(COMP[c] for c in reversed(s))
        reads.append(RefRecord(f"sc{k}", tocs(s)))
    return _case(contigs, reads, dict(mode=CS), mode="cs", batch=100)


@pytest.fixture(scope="module")
def colour_space_paired():
    rng = np.random.default_rng(557)
    contigs, gs = _mk_genome(rng, n_contigs=4)
    return _case(contigs, mk_cs_pairs(rng, gs, 80),
                 dict(mode=CS, pair_mode="opp-in"), mode="cs", paired=True,
                 batch=80)


def _check_zpair(got, want):
    np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=1e-12, atol=0)
    assert np.array_equal(got[:, 4:], want[:, 4:])
    assert float(np.max(got[:, 3])) > 0.0          # z3


@pytest.mark.parametrize("D", [8, 3])
def test_sharded_index_byte_identical_and_z1_collective(unpaired, D):
    sim, got = _run(unpaired, D)
    assert got == unpaired["want"]
    # the collective ran and gave the denominators the render used
    np.testing.assert_allclose(sim.last_z1_merged, unpaired["z1"],
                               rtol=1e-12, atol=0)
    assert float(np.max(sim.last_z1_merged)) > 0.0
    # no structure holds the whole-genome CSR, and no device the whole
    # genome: the inner mapper uploaded nothing
    assert not hasattr(sim.comp, "seeds")
    whole = sum(int(si.positions.nbytes) for si in unpaired["idx"].seeds)
    per_shard = [sum(int(si.positions.nbytes) for si in s.seeds)
                 for s in sim.comp.subs]
    assert max(per_shard) < whole
    assert sim.m.device_planes() == []
    assert sum(sim.plane_bytes) < 4 * unpaired["idx"].total_len


@pytest.mark.parametrize("D", [3, 5])
def test_sharded_index_uneven_mesh_sizes(uneven, D):
    assert _run(uneven, D)[1] == uneven["want"]


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_index_paired_byte_identical_and_zpair(paired, D):
    sim, got = _run(paired, D)
    assert got == paired["want"]
    _check_zpair(sim.last_zpair_merged, paired["zpair"])
    assert sim.m.device_planes() == []


def test_sharded_index_rejects_unsupported_config(two_shards):
    """Outside the fused fast path there is no generic fallback: the
    generic mapper would need the whole-genome CSR."""
    sim = meshmap.ShardedIndexMapper(
        two_shards, MapperConfig(compute_mapping_qualities=False),
        mesh=meshmap.make_mesh(["cpu"] * 2))
    with pytest.raises(ValueError, match="fast-path"):
        sim.map_unpaired_sam([SeqRecord("x", "ACGT" * 9)])
    with pytest.raises(ValueError, match="sub-indexes"):
        meshmap.ShardedIndexMapper(two_shards, None,
                                   mesh=meshmap.make_mesh(["cpu"] * 3))


def test_halo_for_scales_with_window():
    for kw, L in (({}, 36), ({}, None), (dict(longest_read_len=10000), None),
                  (dict(window_len=300.0), 250)):
        assert meshmap.halo_for(MapperConfig(**kw), read_len=L) == \
            ref_mm.halo_for(RefConfig(**kw), read_len=L)
    assert meshmap.halo_for(MapperConfig(), read_len=36) == 2048
    assert meshmap.halo_for(MapperConfig(longest_read_len=10000)) >= 14000


def test_composite_index_contig_table(uneven, two_shards):
    comp = meshmap.CompositeIndex(two_shards)
    idx = uneven["idx"]
    assert comp.contig_names == idx.contig_names
    assert np.array_equal(comp.contig_offsets, idx.contig_offsets)
    assert np.array_equal(comp.codes, idx.codes)
    assert np.array_equal(comp.codes_rc, idx.codes_rc)
    assert comp.auto_list_cutoff() == idx.auto_list_cutoff()


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_index_colour_space_byte_identical(colour_space, D):
    sim, got = _run(colour_space, D)
    assert got == colour_space["want"]
    assert sim.m.device_planes() == []


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_index_colour_space_paired_and_zpair(colour_space_paired,
                                                     D):
    sim, got = _run(colour_space_paired, D)
    assert got == colour_space_paired["want"]
    _check_zpair(sim.last_zpair_merged, colour_space_paired["zpair"])


def test_sharded_index_window_past_the_halo_raises(uneven, two_shards):
    with pytest.raises(ValueError, match="exceeds shard halo 32"):
        _run(uneven, 2, subs=two_shards, halo=32)


def test_sharded_index_of_2_31_bases_raises(uneven, two_shards,
                                            monkeypatch):
    """Window starts are int32: a composite index of 2^31 bases or more
    raises, as on one device (the length is faked once filter 1 has
    run)."""
    sim = meshmap.ShardedIndexMapper(two_shards, uneven["cfg"],
                                     mesh=meshmap.make_mesh(["cpu"] * 2))
    gen_cand = fastpath.generate_candidates_native

    class Huge(meshmap.CompositeIndex):
        total_len = property(lambda self: 1 << 31)

    def filter1(index, *a, **k):
        fh = gen_cand(index, *a, **k)
        sim.comp.__class__ = Huge
        return fh
    monkeypatch.setattr(fastpath, "generate_candidates_native", filter1)
    with pytest.raises(NotImplementedError, match=r"2\^31"):
        sim.map_unpaired_sam(uneven["reads"], batch_size=100)
