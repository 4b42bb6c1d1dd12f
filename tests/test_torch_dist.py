"""The multi-process tier in letter space (shrimp_tpu_torch.parallel.
dist.DistMapper): two rank processes over gloo (a file:// init), each
holding 4 of the 8 sub-indexes on ["cpu"] * 4, JAX and shrimp_tpu
blocked in them. Both ranks' SAM must equal, byte for byte, shrimp_tpu's
single-process whole-index fast path on the same reads (batch 100,
lanes=1: tests/test_dist.py's oracle) and the port's unsharded stream:
unpaired with the z1 merge, pairs with the paired Z merge, read sharding
unpaired and paired (each rank's selected jobs and filter-1 windows a
strict share), and the empty slice: a batch whose first half is random
reads (rank 0's slice has no pass-1 survivors) and a last batch of one
read (rank 1's slice is empty), where shrimp_tpu's own DistMapper waits
forever. The exchange primitives and the Z merges are held on two probe
ranks. Tolerance: none."""
import numpy as np
import pytest
import torch

from shrimp_tpu_torch import fastpath
from shrimp_tpu_torch.config import MapperConfig as PortConfig
from shrimp_tpu_torch.index.build import build_index as port_build
from shrimp_tpu_torch.index.seeds import default_seeds as port_seeds
from shrimp_tpu_torch.io.fasta import SeqRecord
from shrimp_tpu_torch.mapper import Mapper as PortMapper
from shrimp_tpu_torch.paired import PairedMapper as PortPairedMapper
from shrimp_tpu_torch.parallel import dist as port_dist
from shrimp_tpu_torch.parallel.meshmap import (make_mesh, zmerge_psum,
                                               zpair_merge)

from .dist_data import (make_dataset, make_paired_dataset, probe_rows,
                        run_probe, run_ranks)

PAIRED = dict(pair_mode="opp-in", min_insert_size=60, max_insert_size=240)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain versions run on one torch thread here, as in the other
    port tests (and in the rank processes: OMP_NUM_THREADS=1)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _empty_slice_reads(reads):
    """make_dataset's reads, then a batch whose first 50 reads are
    random (rank 0's slice of it has no pass-1 survivors) and whose last
    50 repeat the first reads, then one read (a last batch of one: rank
    1's slice of it is empty)."""
    rng = np.random.default_rng(7)
    rnd = [SeqRecord(f"rnd{i}", "".join(rng.choice(list("ACGT"), 36)))
           for i in range(50)]
    again = [SeqRecord(f"again{i}", r.seq) for i, r in enumerate(reads[:50])]
    return reads + rnd + again + [SeqRecord("last", reads[7].seq)]


def _sams(contigs, reads, paired, cfgkw):
    """(shrimp_tpu's SAM, the port's unsharded SAM) of the whole index
    at batch 100, lanes=1."""
    from shrimp_tpu import fastpath as ref_fastpath
    from shrimp_tpu.config import MapperConfig
    from shrimp_tpu.index.build import build_index
    from shrimp_tpu.index.seeds import default_seeds
    from shrimp_tpu.mapper import Mapper
    from shrimp_tpu.paired import PairedMapper
    idx = build_index(contigs, default_seeds())
    pidx = port_build(contigs, port_seeds())
    if paired:
        ref = ref_fastpath.map_paired_sam_stream(
            PairedMapper(idx, MapperConfig(**cfgkw)), reads, batch_size=100,
            lanes=1)
        port = fastpath.map_paired_sam_stream(
            PortPairedMapper(pidx, PortConfig(**cfgkw), "cpu"), reads,
            batch_size=100, lanes=1)
    else:
        ref = ref_fastpath.map_unpaired_sam_stream(
            Mapper(idx, MapperConfig(**cfgkw)), reads, batch_size=100,
            lanes=1)
        port = fastpath.map_unpaired_sam_stream(
            PortMapper(pidx, PortConfig(**cfgkw), "cpu"), reads,
            batch_size=100, lanes=1)
    out = b"".join(ref), b"".join(port)
    idx.release()
    pidx.release()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One rank pair maps every case; the oracles beside it."""
    contigs, reads = make_dataset()
    pcontigs, pairs = make_paired_dataset()
    f_reads = _empty_slice_reads(reads)
    res = run_ranks(str(tmp_path_factory.mktemp("dist_ls")),
                    {"ls": ("ls", contigs), "pairs": ("ls", pcontigs)}, [
        dict(name="a", genome="ls", reads=reads, batch_size=100),
        dict(name="e", genome="ls", reads=reads, batch_size=100,
             read_sharding=True),
        dict(name="f", genome="ls", reads=f_reads, batch_size=100,
             read_sharding=True),
        dict(name="b", genome="pairs", reads=pairs, batch_size=100,
             paired=True, config=PAIRED),
        dict(name="e_pairs", genome="pairs", reads=pairs, batch_size=100,
             paired=True, config=PAIRED, read_sharding=True)])
    want = {"a": _sams(contigs, reads, False, {}),
            "f": _sams(contigs, f_reads, False, {}),
            "b": _sams(pcontigs, pairs, True, PAIRED)}
    want["e"], want["e_pairs"] = want["a"], want["b"]
    return res, want


def _same_sam(runs, name):
    res, want = runs
    ref, port = want[name]
    assert ref == port
    for sam, _, _ in res[name]:
        assert sam == ref
    return res[name]


def test_dist_unpaired_matches_single_process(runs):
    """(a) Unpaired, the render dividing by the z1 merged across ranks:
    the merged rows are the same bits on both ranks."""
    got = _same_sam(runs, "a")
    assert got[0][0].count(b"\n") >= 190
    assert got[0][1]["z1_max"] > 0.0
    assert np.array_equal(got[0][2]["z1"], got[1][2]["z1"])


def test_dist_paired_matches_single_process(runs):
    """(b) opp-in pairs (60-240), the paired class statistics merged
    across ranks: the merged rows are the same bits on both ranks."""
    got = _same_sam(runs, "b")
    assert got[0][0].count(b"\n") >= 200
    assert got[0][1]["z1_max"] > 0.0
    assert np.array_equal(got[0][2]["zpair"], got[1][2]["zpair"])


def _split(metas, key):
    v = [m[key] for m in metas]
    assert min(v) > 0 and max(v) <= 0.75 * sum(v), (key, v)


def test_dist_read_sharding_unpaired(runs):
    """(e) Each rank selects, expands and renders its slice only; the
    jobs and filter 1's windows split between the ranks."""
    got = _same_sam(runs, "e")
    metas = [m for _, m, _ in got]
    _split(metas, "slice_jobs")
    _split(metas, "f1_local_windows")


def test_dist_read_sharding_paired(runs):
    """(e) The paired brain runs per rank on its pair slice."""
    got = _same_sam(runs, "e_pairs")
    metas = [m for _, m, _ in got]
    _split(metas, "slice_jobs")
    _split(metas, "f1_local_windows")


def test_dist_read_sharding_empty_slice(runs):
    """(f) A slice with no pass-1 survivors and an empty slice: every
    rank still joins every exchange, so the ranks finish (within
    dist_data.RANK_TIMEOUT_S) with the single-process bytes."""
    got = _same_sam(runs, "f")
    assert b"rnd" not in got[0][0]           # the random reads map nowhere
    assert got[0][0].endswith(b"\n") and b"\nlast\t" in got[0][0]


@pytest.mark.parametrize("paired", [False, True])
def test_read_slices_concatenate_to_the_batch(paired):
    """One process, no exchange: FastLS / FastPaired with `read_slice`
    render only their slice of a batch (with `slice_select` the
    selection and the expansion are sliced too, without it only the
    render); the slices of dist._slice_for, rendered in turn, are the
    whole batch's bytes, --sam-unaligned records included, and each
    slice's jobs are a share of the batch's."""
    contigs, reads = (make_paired_dataset() if paired else make_dataset())
    reads = reads[:96]
    cfg = PortConfig(sam_unaligned=True, **(PAIRED if paired else {}))
    idx = port_build(contigs, port_seeds())
    try:
        m = (PortPairedMapper if paired else PortMapper)(idx, cfg, "cpu")
        stage = (fastpath.FastPaired if paired else fastpath.FastLS)(m)
        ctx = stage.stage_prepare(reads)     # each finish takes a copy
        want = stage.stage_finish(dict(ctx))[0]
        units = len(reads) // (2 if paired else 1)
        for select in (False, True):
            got, jobs = [], []
            for r in range(3):
                stage.read_slice = port_dist._slice_for(r, 3, units)
                stage.slice_select = select
                before = stage.last_slice_jobs
                got.append(stage.stage_finish(dict(ctx))[0])
                jobs.append(stage.last_slice_jobs - before)
            assert b"".join(got) == want, select
            assert min(jobs) > 0 and max(jobs) < sum(jobs), (select, jobs)
    finally:
        idx.release()
    assert want.count(b"\n") >= len(reads)


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    return run_probe(str(tmp_path_factory.mktemp("dist_probe")))


def test_allgather_rows_keeps_counts_order_and_bits(probe):
    """Ragged rows from two ranks come back in rank order with their
    counts, int64 and float64 bit for bit, on both ranks."""
    rows = [probe_rows(r) for r in (0, 1)]
    for got in probe:
        assert list(got["counts"]) == [7, 0, 3, 5]
        assert got["i64"].dtype == np.int64
        assert np.array_equal(got["i64"], rows[0][0])
        f64 = np.concatenate([rows[0][1], rows[1][1]])
        assert got["f64"].dtype == np.float64
        assert np.array_equal(got["f64"].view(np.uint64), f64.view(np.uint64))


def test_z_merges_of_allgathered_partials(probe):
    """The z1 sum and the paired merge of the allgathered per-shard
    partials equal meshmap.zmerge_psum / zpair_merge on the same [D, ...]
    rows, the same bits on both ranks."""
    rows = [probe_rows(r) for r in (0, 1)]
    z1 = np.concatenate([rows[0][2], rows[1][2]])
    zp = np.concatenate([rows[0][3], rows[1][3]])
    mesh = make_mesh(["cpu"] * 4)
    want1, wantp = zmerge_psum(mesh, z1), zpair_merge(mesh, zp)
    for got in probe:
        assert np.array_equal(got["z1"].view(np.uint64),
                              want1.view(np.uint64))
        assert np.array_equal(got["zpair"], wantp)


def test_dist_index_matches_reference():
    """The global contig table and the shard bases of a rank's DistIndex
    equal shrimp_tpu's DistIndex for the same shard metadata (both over
    the port's sub-indexes of rank 1's two shards)."""
    from shrimp_tpu.parallel.dist import DistIndex as RefDistIndex
    contigs, _ = make_dataset()
    meta = [dict(names=[f"c{d}a", f"c{d}b"],
                 lengths=np.array([len(contigs[d][1]) - 100 * d, 100 * d + 1],
                                  np.uint32)) for d in range(4)]
    subs = [port_build([contigs[d]], port_seeds()) for d in (2, 3)]
    try:
        got = port_dist.DistIndex(meta, subs, 2)
        want = RefDistIndex(meta, subs, 2)
        assert got.contig_names == want.contig_names
        for k in ("contig_offsets", "contig_lengths", "cn_base", "pos_base"):
            a, b = getattr(got, k), getattr(want, k)
            assert a.dtype == b.dtype and np.array_equal(a, b), k
        assert got.total_len == want.total_len
        assert got.auto_list_cutoff() == want.auto_list_cutoff()
        assert got.max_seed_span == want.max_seed_span
        assert got.codes is None and got.codes_rc is None
        assert got.subs == subs and got.local_shard0 == 2
    finally:
        for s in subs:
            s.release()


def test_slice_for_matches_reference():
    """_slice_for is shrimp_tpu's: contiguous, in rank order, covering."""
    from shrimp_tpu.parallel.dist import _slice_for
    for n in range(0, 12):
        for P in (1, 2, 3, 5):
            got = [port_dist._slice_for(p, P, n) for p in range(P)]
            assert got == [_slice_for(p, P, n) for p in range(P)]
            assert sum(hi - lo for lo, hi in got) == n
    assert port_dist._slice_for(1, 2, 1) == (1, 1)


def test_dist_mapper_needs_a_process_group():
    """Without init_distributed DistMapper raises, naming it."""
    with pytest.raises(RuntimeError, match="init_distributed"):
        port_dist.DistMapper([], [], PortConfig(), mesh=["cpu"])
