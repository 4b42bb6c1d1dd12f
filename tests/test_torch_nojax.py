"""shrimp_tpu_torch runs where there is no JAX (the GPU machines have
none): it imports neither JAX nor any module of the JAX package
shrimp_tpu (it keeps its own copies of the host modules), and never
hands a batch it cannot take to a JAX or CPU fallback."""
import os
import re
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import pytest
import torch

from shrimp_tpu_torch import constants as C
from shrimp_tpu_torch import fastpath, fastpath_cs
from shrimp_tpu_torch.config import MapperConfig
from shrimp_tpu_torch.core import encode
from shrimp_tpu_torch.index.build import GenomeIndex, build_index
from shrimp_tpu_torch.index.seeds import default_seeds
from shrimp_tpu_torch.io.fasta import SeqRecord
from shrimp_tpu_torch.mapper import Mapper

from .test_e2e_cs import make_cs_dataset
from .test_e2e_unpaired import make_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "shrimp_tpu_torch")
# an import of the JAX package (shrimp_tpu, not shrimp_tpu_torch)
JAX_PKG_IMPORT = re.compile(r"^\s*(?:from|import)\s+shrimp_tpu(?!_torch)\b",
                            re.M)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port_sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "kernel_ab.py")


def test_port_sources_import_no_jax():
    srcs = list(_port_sources())
    assert len(srcs) >= 30
    rel = {os.path.relpath(p, PORT) for p in srcs}
    assert {"cli.py", "__main__.py", "mapper.py", "paired.py",
            "core/candidates.py", "core/batch_pipeline.py",
            "core/traceback.py", "core/sw_np.py", "core/sw_cs_np.py",
            "core/sw_cs_batch.py", "io/sam.py",
            "io/shrimp_format.py", "parallel/__init__.py",
            "parallel/meshmap.py", "parallel/dist.py",
            "parallel/dist_worker.py", "utils/memmodel.py",
            "io/shrimp_input.py", "tools/mergesam.py", "tools/split.py",
            "tools/shrimp2sam.py", "tools/prettyprint.py",
            "tools/probcalc.py", "tools/probcalc_mp.py",
            "tools/shrimp_var.py", "tools/colorconsensus.py",
            "tools/dag.py"} <= rel
    for path in srcs:
        with open(path) as f:
            text = f.read()
        assert "import jax" not in text and "from jax" not in text, path
        assert not JAX_PKG_IMPORT.search(text), path
    assert JAX_PKG_IMPORT.search("from shrimp_tpu.config import X")
    assert JAX_PKG_IMPORT.search("    import shrimp_tpu")
    assert not JAX_PKG_IMPORT.search("from shrimp_tpu_torch import fastpath")


def test_maps_to_sam_with_jax_blocked(tmp_path):
    """The GPU machine's situation, rehearsed: `import jax` fails, and the
    port still maps a small dataset to SAM on the CPU."""
    gpath, rpath, _, _ = make_dataset(str(tmp_path), n_reads=80)
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None
        sys.modules["shrimp_tpu"] = None
        sys.path.insert(0, {REPO!r})
        import torch
        torch.set_num_threads(1)
        from shrimp_tpu_torch.core.encode import encode_ls
        from shrimp_tpu_torch.index.build import GenomeIndex, build_index
        from shrimp_tpu_torch.index.seeds import default_seeds
        from shrimp_tpu_torch.io.fasta import read_seqs
        from shrimp_tpu_torch import fastpath
        from shrimp_tpu_torch.mapper import Mapper
        g = next(read_seqs({gpath!r}))
        idx = build_index([(g.name, encode_ls(g.seq))], default_seeds())
        reads = list(read_seqs({rpath!r}))
        m = Mapper(idx, None, "cpu")
        sam = b"".join(fastpath.map_unpaired_sam_stream(m, reads,
                                                        batch_size=32))
        loaded = [k for k, v in sys.modules.items() if v is not None
                  and k.split(".")[0] in ("jax", "jaxlib", "shrimp_tpu")]
        assert not loaded, loaded
        print("records", sam.count(b"\\n"), "reads", m.stats.reads)
    """)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-3000:]
    n_rec, n_reads = map(int, res.stdout.split()[1::2])
    assert n_reads == 80 and n_rec >= 40


def test_mesh_tiers_map_with_jax_blocked(tmp_path):
    """The mesh tiers with `import jax` failing: MeshMapper and
    ShardedIndexMapper on a mesh of two "cpu" shards write the
    unsharded stream's SAM (the genome cut at a region boundary into two
    contigs, one a shard)."""
    gpath, rpath, _, _ = make_dataset(str(tmp_path), n_reads=64,
                                      genome_len=16_384)
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None
        sys.modules["shrimp_tpu"] = None
        sys.path.insert(0, {REPO!r})
        import torch
        torch.set_num_threads(1)
        from shrimp_tpu_torch.core.encode import encode_ls
        from shrimp_tpu_torch.index.build import build_index
        from shrimp_tpu_torch.index.seeds import default_seeds
        from shrimp_tpu_torch.io.fasta import read_seqs
        from shrimp_tpu_torch import fastpath
        from shrimp_tpu_torch.mapper import Mapper
        from shrimp_tpu_torch.parallel import meshmap
        g = next(read_seqs({gpath!r}))
        codes = encode_ls(g.seq)
        half = len(codes) // 2
        contigs = [("a", codes[:half]), ("b", codes[half:])]
        idx = build_index(contigs, default_seeds())
        reads = list(read_seqs({rpath!r}))
        want = b"".join(fastpath.map_unpaired_sam_stream(
            Mapper(idx, None, "cpu"), reads, batch_size=32))
        mesh = meshmap.make_mesh(["cpu"] * 2)
        got = meshmap.MeshMapper(idx, None, mesh=mesh).map_unpaired_sam(
            reads, batch_size=32)
        subs = [build_index(b, default_seeds())
                for b in meshmap.split_contig_bins(contigs, 2)]
        sim = meshmap.ShardedIndexMapper(subs, None, mesh=mesh)
        got2 = sim.map_unpaired_sam(reads, batch_size=32)
        loaded = [k for k, v in sys.modules.items() if v is not None
                  and k.split(".")[0] in ("jax", "jaxlib", "shrimp_tpu")]
        assert not loaded, loaded
        print("records", want.count(b"\\n"), "same", int(got == want),
              "same_sharded", int(got2 == want))
    """)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-3000:]
    n_rec, same, same_sharded = map(int, res.stdout.split()[1::2])
    assert n_rec >= 32 and same == same_sharded == 1


def test_dist_ranks_map_with_jax_blocked(tmp_path):
    """Two ranks of the multi-process tier (parallel/dist_worker.py, 4
    "cpu" shards each, gloo) with `import jax` and `import shrimp_tpu`
    failing in them (tests/dist_data.BLOCKED): unpaired, read-sharded
    and paired runs write the unsharded stream's SAM on both ranks."""
    from shrimp_tpu_torch.paired import PairedMapper

    from .dist_data import make_dataset as dist_dataset
    from .dist_data import make_paired_dataset, run_ranks
    contigs, reads = dist_dataset()
    pcontigs, pairs = make_paired_dataset()
    reads, pairs = reads[:64], pairs[:64]
    res = run_ranks(str(tmp_path), {"ls": ("ls", contigs),
                                    "pairs": ("ls", pcontigs)}, [
        dict(name="u", genome="ls", reads=reads, batch_size=32),
        dict(name="rs", genome="ls", reads=reads, batch_size=32,
             read_sharding=True),
        dict(name="p", genome="pairs", reads=pairs, batch_size=32,
             paired=True, config=dict(pair_mode="opp-in"))])
    idx = build_index(contigs, default_seeds())
    pidx = build_index(pcontigs, default_seeds())
    want = b"".join(fastpath.map_unpaired_sam_stream(
        Mapper(idx, None, "cpu"), reads, batch_size=32, lanes=1))
    want_p = b"".join(fastpath.map_paired_sam_stream(
        PairedMapper(pidx, MapperConfig(pair_mode="opp-in"), "cpu"), pairs,
        batch_size=32, lanes=1))
    idx.release()
    pidx.release()
    assert want.count(b"\n") >= 60 and want_p.count(b"\n") >= 60
    for name, w in (("u", want), ("rs", want), ("p", want_p)):
        assert [sam == w for sam, _, _ in res[name]] == [True, True], name


def test_maps_cs_to_sam_with_jax_blocked(tmp_path):
    """The same rehearsal for the colour-space stream."""
    gpath, rpath, _, _ = make_cs_dataset(str(tmp_path), n_reads=60,
                                         genome_len=20_000)
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None
        sys.modules["shrimp_tpu"] = None
        sys.path.insert(0, {REPO!r})
        import torch
        torch.set_num_threads(1)
        from shrimp_tpu_torch.config import MapperConfig
        from shrimp_tpu_torch.core.encode import encode_ls
        from shrimp_tpu_torch.index.build import GenomeIndex, build_index
        from shrimp_tpu_torch.index.seeds import default_seeds
        from shrimp_tpu_torch.io.fasta import read_seqs
        from shrimp_tpu_torch import fastpath_cs
        from shrimp_tpu_torch.mapper import Mapper
        g = next(read_seqs({gpath!r}))
        idx = build_index([(g.name, encode_ls(g.seq))],
                          default_seeds(mode="cs"), mode="cs")
        reads = list(read_seqs({rpath!r}))
        m = Mapper(idx, MapperConfig(mode="cs"), "cpu")
        sam = b"".join(fastpath_cs.map_unpaired_cs_sam_stream(
            m, reads, batch_size=32))
        loaded = [k for k, v in sys.modules.items() if v is not None
                  and k.split(".")[0] in ("jax", "jaxlib", "shrimp_tpu")]
        assert not loaded, loaded
        print("records", sam.count(b"\\n"), "reads", m.stats.reads)
    """)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-3000:]
    n_rec, n_reads = map(int, res.stdout.split()[1::2])
    assert n_reads == 60 and n_rec >= 40


def test_maps_pairs_to_sam_with_jax_blocked(tmp_path):
    """The same rehearsal for the paired stream, select-then-full forced
    (its native renderer, the paired mapper and the two-phase path)."""
    from .test_fastpath_paired import make_pairs
    g, recs = make_pairs(4, 40, "opp-in")
    gpath = tmp_path / "g.fa"
    gpath.write_text(f">chrP\n{g}\n")
    rpath = tmp_path / "r.fa"
    rpath.write_text("".join(f">{r.name}\n{r.seq}\n" for r in recs))
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None
        sys.modules["shrimp_tpu"] = None
        sys.path.insert(0, {REPO!r})
        import torch
        torch.set_num_threads(1)
        from shrimp_tpu_torch.config import MapperConfig
        from shrimp_tpu_torch.core.encode import encode_ls
        from shrimp_tpu_torch.index.build import GenomeIndex, build_index
        from shrimp_tpu_torch.index.seeds import default_seeds
        from shrimp_tpu_torch.io.fasta import read_seqs
        from shrimp_tpu_torch import fastpath
        from shrimp_tpu_torch.paired import PairedMapper
        fastpath.LS_TWO_PHASE_WPR = 0
        g = next(read_seqs({str(gpath)!r}))
        idx = build_index([(g.name, encode_ls(g.seq))], default_seeds())
        reads = list(read_seqs({str(rpath)!r}))
        m = PairedMapper(idx, MapperConfig(pair_mode="opp-in"), "cpu")
        sam = b"".join(fastpath.map_paired_sam_stream(m, reads,
                                                      batch_size=32))
        assert "paired select (2ph)" in m.stats.stage_secs
        loaded = [k for k, v in sys.modules.items() if v is not None
                  and k.split(".")[0] in ("jax", "jaxlib", "shrimp_tpu")]
        assert not loaded, loaded
        print("records", sam.count(b"\\n"), "reads", m.stats.reads)
    """)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-3000:]
    n_rec, n_reads = map(int, res.stdout.split()[1::2])
    assert n_reads == 80 and n_rec >= 80


def test_maps_cs_pairs_to_sam_with_jax_blocked(tmp_path):
    """The same rehearsal for the CS paired stream, select-then-full
    forced and the word planes withheld (the byte gather)."""
    from .test_torch_fastpath_cs_paired import cs_pairs
    g, recs = cs_pairs(4, 40, "opp-in")
    gpath = tmp_path / "g.fa"
    gpath.write_text(">chrP\n" + "".join("ACGT"[c] for c in g) + "\n")
    rpath = tmp_path / "r.fa"
    rpath.write_text("".join(f">{r.name}\n{r.seq}\n" for r in recs))
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None
        sys.modules["shrimp_tpu"] = None
        sys.path.insert(0, {REPO!r})
        import torch
        torch.set_num_threads(1)
        from shrimp_tpu_torch.config import MapperConfig
        from shrimp_tpu_torch.core.encode import encode_ls
        from shrimp_tpu_torch.index.build import GenomeIndex, build_index
        from shrimp_tpu_torch.index.seeds import default_seeds
        from shrimp_tpu_torch.io.fasta import read_seqs
        from shrimp_tpu_torch import fastpath_cs
        from shrimp_tpu_torch.paired import PairedMapper
        fastpath_cs.CS_TWO_PHASE_WPR = 0
        g = next(read_seqs({str(gpath)!r}))
        idx = build_index([(g.name, encode_ls(g.seq))],
                          default_seeds(mode="cs"), mode="cs")
        reads = list(read_seqs({str(rpath)!r}))
        m = PairedMapper(idx, MapperConfig(mode="cs", pair_mode="opp-in"),
                         "cpu")
        m._cat_words_dev = m._cs_cat_words_dev = None
        sam = b"".join(fastpath_cs.map_paired_cs_sam_stream(
            m, reads, batch_size=32))
        assert "cs paired select (2ph)" in m.stats.stage_secs
        loaded = [k for k, v in sys.modules.items() if v is not None
                  and k.split(".")[0] in ("jax", "jaxlib", "shrimp_tpu")]
        assert not loaded, loaded
        print("records", sam.count(b"\\n"), "reads", m.stats.reads)
    """)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-3000:]
    n_rec, n_reads = map(int, res.stdout.split()[1::2])
    assert n_reads == 80 and n_rec >= 80


def test_rejected_batch_raises(tmp_path):
    """A batch the flat encoder rejects (here a short read) no longer
    raises: after the first batch it takes the generic mapper's slow
    tail inside the stream, with the reference stream's bytes, at 1 and
    4 lanes; a rejected first batch makes the stream return None, as the
    reference's does, and the caller runs the generic mapper."""
    from shrimp_tpu import fastpath as ref_fastpath
    from shrimp_tpu.config import MapperConfig as RefConfig
    from shrimp_tpu.index.build import build_index as ref_build
    from shrimp_tpu.index.seeds import default_seeds as ref_seeds
    from shrimp_tpu.mapper import Mapper as RefMapper
    _, _, g, reads = make_dataset(str(tmp_path), n_reads=120)
    idx = build_index([("chr_test", encode.encode_ls(g))], default_seeds())
    ridx = ref_build([("chr_test", encode.encode_ls(g))], ref_seeds())
    recs = [SeqRecord(n, s) for n, s in reads]
    recs[70] = SeqRecord(recs[70].name, recs[70].seq[:30])
    want = b"".join(ref_fastpath.map_unpaired_sam_stream(
        RefMapper(ridx, RefConfig()), recs, batch_size=32, lanes=1))
    for lanes in (1, 4):
        m = Mapper(idx, MapperConfig(), "cpu")
        got = b"".join(fastpath.map_unpaired_sam_stream(
            m, recs, batch_size=32, lanes=lanes))
        assert got == want and m.stats.vec_invocs > 0
    recs[3] = SeqRecord(recs[3].name, recs[3].seq[:20])
    assert ref_fastpath.map_unpaired_sam_stream(
        RefMapper(ridx, RefConfig()), recs, batch_size=32) is None
    assert fastpath.map_unpaired_sam_stream(Mapper(idx, None, "cpu"), recs,
                                            batch_size=32) is None


def test_cs_rejected_batch_raises(tmp_path):
    """A colour-space batch the flat encoder rejects (here a short read)
    takes the generic mapper's slow tail with the reference stream's
    bytes (the reference at one lane); a rejected first batch (a bad
    primer) makes the stream return None, as the reference's does."""
    from shrimp_tpu import fastpath_cs as ref_fastpath_cs
    from shrimp_tpu.config import MapperConfig as RefConfig
    from shrimp_tpu.index.build import build_index as ref_build
    from shrimp_tpu.index.seeds import default_seeds as ref_seeds
    from shrimp_tpu.mapper import Mapper as RefMapper
    _, _, g, reads = make_cs_dataset(str(tmp_path), n_reads=120,
                                     genome_len=20_000)
    idx = build_index([("chrC", encode.encode_ls(g))],
                      default_seeds(mode="cs"), mode="cs")
    ridx = ref_build([("chrC", encode.encode_ls(g))],
                     ref_seeds(mode="cs"), mode="cs")
    cfg = MapperConfig(mode=C.MODE_COLOUR_SPACE)
    recs = [SeqRecord(n, s) for n, s in reads]
    recs[70] = SeqRecord(recs[70].name, recs[70].seq[:30])
    want = b"".join(ref_fastpath_cs.map_unpaired_cs_sam_stream(
        RefMapper(ridx, RefConfig(mode="cs")), recs, batch_size=32,
        lanes=1))
    for lanes in (1, 4):
        m = Mapper(idx, cfg, "cpu")
        got = b"".join(fastpath_cs.map_unpaired_cs_sam_stream(
            m, recs, batch_size=32, lanes=lanes))
        assert got == want and m.stats.full_invocs > 0
    recs[3] = SeqRecord(recs[3].name, "N" + recs[3].seq[1:])
    assert ref_fastpath_cs.map_unpaired_cs_sam_stream(
        RefMapper(ridx, RefConfig(mode="cs")), recs, batch_size=32) is None
    assert fastpath_cs.map_unpaired_cs_sam_stream(
        Mapper(idx, cfg, "cpu"), recs, batch_size=32) is None


def test_index_of_2_31_bases_raises(tmp_path, monkeypatch):
    """An index of 2^31 bases or more raises, naming the batch's reads,
    in the LS and the CS streams: window starts are int32 in both flows
    (the reference's wrap there). The length is faked once filter 1 has
    run, so no such genome is built."""
    assert fastpath._check_index_len(
        SimpleNamespace(total_len=(1 << 31) - 1)) is None
    gen_cand = fastpath.generate_candidates_native

    class HugeIndex(GenomeIndex):
        total_len = property(lambda self: 1 << 31)

    def filter1(index, *a, **k):
        fh = gen_cand(index, *a, **k)
        index.__class__ = HugeIndex
        return fh
    monkeypatch.setattr(fastpath, "generate_candidates_native", filter1)
    _, _, g, reads = make_dataset(str(tmp_path), n_reads=40)
    _, _, gc, reads_cs = make_cs_dataset(str(tmp_path), n_reads=40,
                                         genome_len=20_000)
    for mode, genome, rds, stream in (
            ("ls", g, reads, fastpath.map_unpaired_sam_stream),
            (C.MODE_COLOUR_SPACE, gc, reads_cs,
             fastpath_cs.map_unpaired_cs_sam_stream)):
        idx = build_index([("chr_test", encode.encode_ls(genome))],
                          default_seeds(mode=mode), mode=mode)
        m = Mapper(idx, MapperConfig(mode=mode), "cpu")
        with pytest.raises(NotImplementedError,
                           match=r"reads 0\.\.31: an index of 2147483648 "
                                 r"bases.*2\^31"):
            stream(m, [SeqRecord(n, s) for n, s in rds], batch_size=32)
