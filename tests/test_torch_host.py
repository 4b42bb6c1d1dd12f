"""The port's own host modules (shrimp_tpu_torch.constants, config,
io.fasta, io.sam, io.shrimp_format, index (build, save, load, trim),
core.candidates, core.batch_pipeline, core.traceback, core.sw_np,
core.sw_cs_np, core.sw_cs_batch (post-SW), native, paired) against the
JAX package's originals they were copied from, on the same inputs; the
modules copied unchanged also source for source. Every output is an
integer array, a float array (the post-SW's, from the same native
code), a string or a dataclass: tolerance 0 throughout."""
import dataclasses
import os
from types import SimpleNamespace

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest

from shrimp_tpu import constants as RC
from shrimp_tpu.config import MapperConfig as RefConfig
from shrimp_tpu.core import encode as ref_encode
from shrimp_tpu.core.sw_cs_batch import cs_layers_batch as ref_layers
from shrimp_tpu.index.build import build_index as ref_build
from shrimp_tpu.index.seeds import default_seeds as ref_seeds
from shrimp_tpu.io import sam as ref_sam
from shrimp_tpu.io.fasta import SeqRecord as RefRecord
from shrimp_tpu.io.fasta import read_seqs as ref_read_seqs
from shrimp_tpu.mapper import Mapper as RefMapper
from shrimp_tpu.native.filter1_py import \
    generate_candidates_native as ref_f1
from shrimp_tpu.paired import PairedMapper as RefPairedMapper
from shrimp_tpu_torch import _build
from shrimp_tpu_torch import constants as PC
from shrimp_tpu_torch import native as port_native
from shrimp_tpu_torch.config import MapperConfig as PortConfig
from shrimp_tpu_torch.core import encode as port_encode
from shrimp_tpu_torch.core.sw_cs_batch import cs_layers_batch as port_layers
from shrimp_tpu_torch.index.build import build_index as port_build
from shrimp_tpu_torch.index.seeds import default_seeds as port_seeds
from shrimp_tpu_torch.io import sam as port_sam
from shrimp_tpu_torch.io.fasta import SeqRecord as PortRecord
from shrimp_tpu_torch.io.fasta import read_seqs as port_read_seqs
from shrimp_tpu_torch.mapper import Mapper as PortMapper
from shrimp_tpu_torch.native.filter1_py import \
    generate_candidates_native as port_f1
from shrimp_tpu_torch.paired import PairedMapper as PortPairedMapper

CS = RC.MODE_COLOUR_SPACE


def _contigs(seed=11, lens=(20_000, 9_000, 70_000)):
    """Random contigs, one of them with N runs (skipped windows)."""
    rng = np.random.default_rng(seed)
    out = []
    for k, n in enumerate(lens):
        s = rng.choice(list("ACGT"), n)
        if k == 1:
            s[100:140] = "N"
            s[rng.integers(0, n, 30)] = "N"
        out.append((f"c{k}", "".join(s)))
    return out


@pytest.fixture(scope="module")
def indexes():
    """(reference, port) indexes of the same contigs, LS and CS."""
    contigs = _contigs()
    out = {}
    for mode in (RC.MODE_LETTER_SPACE, CS):
        ref = ref_build([(n, ref_encode.encode_ls(s)) for n, s in contigs],
                        ref_seeds(mode=mode), mode=mode)
        port = port_build([(n, port_encode.encode_ls(s))
                           for n, s in contigs], port_seeds(mode=mode),
                          mode=mode)
        out[mode] = (ref, port)
    return out


@pytest.mark.parametrize("mode", ["ls", "cs"])
@pytest.mark.parametrize("what", ["planes", "contigs", "csr"])
def test_build_index_matches_reference(indexes, mode, what):
    ref, port = indexes[mode]
    assert port.mode == ref.mode and port.total_len == ref.total_len
    if what == "planes":
        names = ["codes", "codes_rc"]
        if mode == CS:
            names += ["cs_codes", "cs_codes_rc"]
        for nm in names:
            r, p = getattr(ref, nm), getattr(port, nm)
            assert p.dtype == r.dtype and np.array_equal(p, r), nm
    elif what == "contigs":
        assert port.contig_names == ref.contig_names
        for nm in ("contig_offsets", "contig_lengths"):
            r, p = getattr(ref, nm), getattr(port, nm)
            assert p.dtype == r.dtype and np.array_equal(p, r), nm
        assert port.auto_list_cutoff() == ref.auto_list_cutoff()
    else:
        assert len(port.seeds) == len(ref.seeds) >= 2
        for rs, ps in zip(ref.seeds, port.seeds):
            assert np.array_equal(ps.seed.offsets, rs.seed.offsets)
            assert ps.seed.span == rs.seed.span
            assert np.array_equal(ps.offsets, rs.offsets)
            assert ps.positions.dtype == rs.positions.dtype
            assert np.array_equal(ps.positions, rs.positions)
            assert len(ps.positions) > 50_000


@pytest.mark.parametrize("kw", [
    {}, dict(mode=CS), dict(global_alignment=False),
    dict(sam_unaligned=True, read_group_name="g1"),
    dict(pair_mode=RC.PAIR_OPP_IN)], ids=["ls", "cs", "local", "render",
                                          "paired"])
def test_config_matches_reference(kw):
    port, ref = PortConfig(**kw), RefConfig(**kw)
    assert dataclasses.is_dataclass(port)
    assert repr(port) == repr(ref)
    assert repr(port.unpaired_options()) == repr(ref.unpaired_options())
    assert port.rev_tiebreak == ref.rev_tiebreak


_TABLES = ("CHAR_TO_INT", "COMPLEMENT", "COLOUR_MAT", "LS_INT_TO_CHAR",
           "CS_INT_TO_CHAR", "CS_INT_TO_CHAR_DOT")


@pytest.mark.parametrize("name", _TABLES + ("scalars",))
def test_constants_match_reference(name):
    if name != "scalars":
        r, p = getattr(RC, name), getattr(PC, name)
        assert p.dtype == r.dtype and np.array_equal(p, r)
        return
    names = [k for k in dir(RC) if k.isupper() and k not in _TABLES]
    assert sorted(names) == sorted(k for k in dir(PC)
                                   if k.isupper() and k not in _TABLES)
    for k in names:
        r, p = getattr(RC, k), getattr(PC, k)
        if isinstance(r, np.ndarray):
            assert p.dtype == r.dtype and np.array_equal(p, r), k
        else:
            assert p == r, k


@pytest.mark.parametrize("fmt", ["fasta", "fastq"])
def test_read_seqs_matches_reference(tmp_path, fmt):
    rng = np.random.default_rng(4)
    path = os.path.join(tmp_path, f"r.{fmt}")
    with open(path, "w") as f:
        for k in range(40):
            s = "".join(rng.choice(list("ACGTN"), int(rng.integers(1, 90))))
            if fmt == "fasta":
                f.write(f">r{k} desc {k}\n")
                for i in range(0, len(s), 30):     # wrapped lines
                    f.write(s[i:i + 30] + "\n")
            else:
                q = "".join(chr(33 + int(x))
                            for x in rng.integers(0, 41, len(s)))
                f.write(f"@r{k} desc\n{s}\n+\n{q}\n")
    ref = list(ref_read_seqs(path))
    got = list(port_read_seqs(path))
    assert len(got) == 40
    assert [(r.name, r.seq, r.qual) for r in got] == \
        [(r.name, r.seq, r.qual) for r in ref]


@pytest.mark.parametrize("seed", [1, 2])
def test_cs_layers_batch_matches_reference(seed):
    rng = np.random.default_rng(seed)
    colours = rng.integers(0, 4, (300, 36)).astype(np.uint8)
    colours[rng.random((300, 36)) < 0.02] = RC.BASE_N
    initbp = rng.integers(0, 4, 300)
    want = ref_layers(colours, initbp)
    got = port_layers(colours, initbp)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("mode", ["ls", "cs"])
def test_filter1_native_matches_reference(indexes, mode):
    """generate_candidates_native: the same FlatHits from the port's
    library and the reference's, on reads drawn from the genome."""
    ref, port = indexes[mode]
    rng = np.random.default_rng(6)
    L, n = 40, 200
    pos = rng.integers(0, ref.total_len - L, n)
    plane = ref.cs_codes if mode == CS else ref.codes
    fwd = plane[pos[:, None] + np.arange(L)[None, :]].copy()
    fwd[rng.random((n, L)) < 0.03] = rng.integers(0, 4)
    codes2 = np.empty((n, 2, L), np.uint8)
    codes2[:, 0] = fwd
    codes2[:, 1] = (fwd[:, ::-1] if mode == CS
                    else RC.COMPLEMENT[fwd[:, ::-1]])
    cfg = RefConfig(mode=mode)
    opts = cfg.unpaired_options()[0]
    kw = dict(read_len=L, window_len=int(L * 1.4),
              match_mode=opts.hit_list.match_mode,
              threshold=opts.hit_list.threshold,
              match_score=cfg.scores.match,
              b_gap_open=cfg.scores.b_gap_open,
              b_gap_extend=cfg.scores.b_gap_extend,
              min_kmer_pos=1 if mode == CS else 0, threads=2)
    want = ref_f1(ref, codes2, cutoff=RefMapper(ref, cfg).cutoff, **kw)
    got = port_f1(port, codes2, cutoff=PortMapper(
        port, PortConfig(mode=mode), "cpu").cutoff, **kw)
    assert got is not None and got.n == want.n and want.n >= n
    for f in dataclasses.fields(want):
        r, p = getattr(want, f.name), getattr(got, f.name)
        if isinstance(r, np.ndarray):
            assert p.dtype == r.dtype and np.array_equal(p, r), f.name
        else:
            assert p == r, f.name


def test_native_library_is_the_ports_own():
    """The port's library is built by g++ from the port's C++ sources into
    build/ beside the package, the paired renderer included."""
    lib = port_native.get_lib()
    path = port_native.lib_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert os.path.basename(os.path.dirname(path)) == "shrimp_tpu_torch"
    assert os.path.basename(os.path.dirname(os.path.dirname(path))) == \
        "build"
    here = os.path.dirname(os.path.abspath(port_native.__file__))
    assert port_native.SRC_DIR == here
    for src in port_native.SOURCES + port_native.HEADERS:
        assert os.path.exists(os.path.join(here, src)), src
    assert "pairedpipe.cpp" in port_native.SOURCES
    assert lib.filter1_batch is not None and lib.finalize_render is not None
    assert lib.paired_finalize_render is not None


@pytest.mark.parametrize("src", ["filter1.cpp", "hostpipe.cpp",
                                 "pairedpipe.cpp", "cspost.cpp",
                                 "cspipe.cpp", "csrsort.cpp", "hostmem.cpp",
                                 "cs_eval.h"])
def test_native_sources_are_byte_copies(src):
    """Every C++ source of the port's library is a byte-for-byte copy of
    the reference's."""
    ref_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "shrimp_tpu", "native")
    with open(os.path.join(ref_dir, src), "rb") as f:
        want = f.read()
    with open(os.path.join(port_native.SRC_DIR, src), "rb") as f:
        assert f.read() == want
    assert src in port_native.SOURCES + port_native.HEADERS


def test_pair_qname_matches_reference():
    """io.sam._pair_qname on random name pairs with shared prefixes and
    ':' or '/' separators, and the edge cases."""
    rng = np.random.default_rng(4)
    alphabet = np.array(list("ab:/12"))
    cases = [("", ""), ("a", ""), ("r1/1", "r1/2"), ("r1:", "r1:"),
             ("x/1", "y/1"), ("/", "/"), ("ab", "abc")]
    for _ in range(400):
        stem = "".join(rng.choice(alphabet, int(rng.integers(0, 6))))
        cases.append((stem + "".join(rng.choice(alphabet,
                                                int(rng.integers(0, 4)))),
                      stem + "".join(rng.choice(alphabet,
                                                int(rng.integers(0, 4))))))
    for a, b in cases:
        assert port_sam._pair_qname(a, b) == ref_sam._pair_qname(a, b), \
            (a, b)


@pytest.mark.parametrize("mode", ["opp-in", "opp-out", "col-fw", "col-bw"])
def test_compute_mp_ranges_matches_reference(indexes, mode):
    """PairedMapper._compute_mp_ranges on random insert ranges, window
    and read lengths and region widths: the same deltas on both legs."""
    ref_idx, port_idx = indexes[RC.MODE_LETTER_SPACE]
    rng = np.random.default_rng(len(mode))
    for _ in range(10):
        kw = dict(pair_mode=mode,
                  min_insert_size=int(rng.integers(0, 300)),
                  max_insert_size=int(rng.integers(300, 2000)),
                  region_bits=int(rng.integers(4, 12)))
        ref = RefPairedMapper(ref_idx, RefConfig(**kw))
        port = PortPairedMapper(port_idx, PortConfig(**kw), "cpu")
        assert port.total_genome_size == ref.total_genome_size
        w1, r1, w2, r2 = (int(x) for x in rng.integers(20, 400, 4))
        legs = [(SimpleNamespace(window_len=w1, read_len=r1),
                 SimpleNamespace(window_len=w2, read_len=r2))
                for _ in (ref, port)]
        ref._compute_mp_ranges(*legs[0])
        port._compute_mp_ranges(*legs[1])
        for a, b in zip(*legs):
            assert vars(a) == vars(b), kw


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIED = ("core/sw_np.py", "core/traceback.py", "core/candidates.py",
          "core/batch_pipeline.py", "core/sw_cs_np.py",
          "core/sw_cs_batch.py", "io/sam.py", "io/shrimp_format.py",
          "utils/memmodel.py", "io/shrimp_input.py", "tools/mergesam.py",
          "tools/split.py", "tools/shrimp2sam.py", "tools/prettyprint.py",
          "tools/probcalc.py", "tools/probcalc_mp.py",
          "tools/shrimp_var.py", "tools/colorconsensus.py", "tools/dag.py")


@pytest.mark.parametrize("path", COPIED)
def test_copied_modules_are_the_originals(path):
    """The host modules copied unchanged equal their originals, but for
    the provenance paragraph that closes the module docstring."""
    with open(os.path.join(REPO, "shrimp_tpu", path)) as f:
        want = f.read()
    with open(os.path.join(REPO, "shrimp_tpu_torch", path)) as f:
        got = f.read()
    note = (f"\n\nCopied from `shrimp_tpu/{path}` unchanged: the port keeps "
            "its own\ncopy of the JAX package's host modules and imports "
            "none of them.\n")
    assert note in got
    assert got.replace(note, "\n", 1) == want


def test_candidates_match_reference(indexes):
    """candidates.read_kmers / get_anchor_list / get_hit_list on reads cut
    from the genome, both strands (through Mapper.hit_lists)."""
    ref_idx, port_idx = indexes[RC.MODE_LETTER_SPACE]
    ref = RefMapper(ref_idx, RefConfig())
    port = PortMapper(port_idx, PortConfig(), "cpu")
    rng = np.random.default_rng(9)
    codes = ref_idx.codes
    for k in range(12):
        p = int(rng.integers(0, len(codes) - 40))
        seq = "".join("ACGTN"[min(int(c), 4)] for c in codes[p:p + 36])
        rh = ref.hit_lists(ref.prepare_read(RefRecord(f"r{k}", seq)))
        ph = port.hit_lists(port.prepare_read(PortRecord(f"r{k}", seq)))
        for a, b in zip(rh, ph):
            for f in dataclasses.fields(a):
                va, vb = getattr(a, f.name), getattr(b, f.name)
                assert np.array_equal(np.asarray(va), np.asarray(vb)), f.name


def test_traceback_and_sw_np_match_reference():
    """sw_np.sw_full_ls (the scalar oracle) and traceback.traceback_batch
    on random pairs, and the op unpacking."""
    from shrimp_tpu.core import sw_np as ref_np, traceback as ref_tb
    from shrimp_tpu_torch.core import sw_np as port_np, traceback as port_tb
    rng = np.random.default_rng(21)
    for k in range(6):
        g = rng.integers(0, 4, 60).astype(np.uint8)
        r = g[10:46].copy()
        r[rng.integers(0, 36, 3)] = rng.integers(0, 4, 3)
        kw = dict(match=10, mismatch=-15, a_gap_open=-40, a_gap_ext=-7,
                  b_gap_open=-40, b_gap_ext=-7, threshscore=200,
                  maxscore=360, revcmpl=bool(k % 3),
                  local_alignment=bool(k % 2))
        a = ref_np.sw_full_ls(g, r, **kw)
        b = port_np.sw_full_ls(g, r, **kw)
        assert repr(a) == repr(b)
    pk = rng.integers(0, 256, (5, 9)).astype(np.uint8)
    assert np.array_equal(ref_tb.unpack_ops(pk), port_tb.unpack_ops(pk))


def test_post_sw_matches_reference():
    """The colour-space post-SW forward-backward (native, batched) and
    the per-hit post_sw on columns of random colour reads."""
    from shrimp_tpu.core import sw_cs_batch as ref_b, sw_cs_np as ref_cs
    from shrimp_tpu_torch.core import sw_cs_batch as port_b
    from shrimp_tpu_torch.core import sw_cs_np as port_cs
    rng = np.random.default_rng(13)
    B, L = 6, 30
    cl = rng.integers(-1, 4, (B, L))
    cc = rng.integers(0, 4, (B, L))
    ce = rng.uniform(0.001, 0.2, (B, L))
    nc = rng.integers(10, L + 1, B)
    ib = rng.integers(0, 4, B)
    for native in (True, False):
        a = ref_b.post_sw_forward_backward_batch(cl, cc, ce, nc, ib, 0.01,
                                                 allow_native=native)
        b = port_b.post_sw_forward_backward_batch(cl, cc, ce, nc, ib, 0.01,
                                                  allow_native=native)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    cols = rng.integers(0, 4, 25).astype(np.uint8)
    db = "".join("ACGT"[int(c)] for c in rng.integers(0, 4, 24))
    kw = dict(pr_snp=0.01, pr_xover=0.02, pr_del_open=1e-4,
              pr_del_extend=0.1, pr_ins_open=1e-4, pr_ins_extend=0.1,
              qual_delta=33)
    a = ref_cs.post_sw(cols, 1, None, 0, db, db, **kw)
    b = port_cs.post_sw(cols, 1, None, 0, db, db, **kw)
    assert repr(a) == repr(b)


def test_sam_header_matches_reference(indexes):
    for mode in (RC.MODE_LETTER_SPACE, CS):
        ref_idx, port_idx = indexes[mode]
        kw = dict(mode=mode, read_group_name="g1", sam_sample_name="s1")
        assert (port_sam.sam_header(port_idx, "cmd", PortConfig(**kw))
                == ref_sam.sam_header(ref_idx, "cmd", RefConfig(**kw)))


def _index_arrays(gi):
    out = {k: np.asarray(getattr(gi, k)) for k in (
        "contig_offsets", "contig_lengths", "codes", "codes_rc")}
    if gi.cs_codes is not None:
        out["cs_codes"] = np.asarray(gi.cs_codes)
        out["cs_codes_rc"] = np.asarray(gi.cs_codes_rc)
    for i, si in enumerate(gi.seeds):
        out[f"seed{i}"] = si.seed.mask_string
        out[f"off{i}"] = np.asarray(si.offsets)
        out[f"pos{i}"] = np.asarray(si.positions)
    out["meta"] = (gi.mode, list(gi.contig_names), gi.is_rna, gi.hashed)
    return out


def _same_index(a, b):
    xa, xb = _index_arrays(a), _index_arrays(b)
    assert sorted(xa) == sorted(xb)
    for k in xa:
        if isinstance(xa[k], np.ndarray):
            assert xa[k].dtype == xb[k].dtype and np.array_equal(xa[k],
                                                                 xb[k]), k
        else:
            assert xa[k] == xb[k], k


@pytest.mark.parametrize("mode", ["ls", "cs"])
@pytest.mark.parametrize("fmt", ["npz", "split", "mmap"])
def test_index_files_load_across_packages(indexes, tmp_path, mode, fmt):
    """An index saved by the port loads in shrimp_tpu, and one saved by
    shrimp_tpu loads in the port, as the same arrays."""
    from shrimp_tpu.index.build import GenomeIndex as RefGI
    from shrimp_tpu_torch.index.build import GenomeIndex as PortGI
    ref, port = indexes[mode]
    for saver, loader_cls, name in ((port, RefGI, "p"), (ref, PortGI, "r")):
        path = str(tmp_path / name)
        if fmt == "npz":
            saver.save(path + ".npz")
            got = loader_cls.load(path + ".npz")
        elif fmt == "split":
            saver.save_split(path)
            got = loader_cls.load_split(path + ".genome")
        else:
            saver.save_mmap(path)
            got = loader_cls.load_mmap(path)
        _same_index(got, ref)


def test_index_trim_and_seed_subset_match_reference(indexes, tmp_path):
    """trim (the -L x -S y -z c re-save) and the long-form -L seed
    subset give the reference's arrays; a partial split copy raises."""
    ref, port = indexes[RC.MODE_LETTER_SPACE]
    port.save(str(tmp_path / "p.npz"))
    ref.save(str(tmp_path / "r.npz"))
    from shrimp_tpu.index.build import GenomeIndex as RefGI
    from shrimp_tpu_torch.index.build import GenomeIndex as PortGI
    p, r = PortGI.load(str(tmp_path / "p.npz")), RefGI.load(
        str(tmp_path / "r.npz"))
    assert p.trim(1) == r.trim(1) > 0
    _same_index(p, r)
    p.save_split(str(tmp_path / "ps"))
    sub = [str(tmp_path / "ps.seed.1.npz"), str(tmp_path / "ps.seed.0")]
    _same_index(PortGI.load_split(str(tmp_path / "ps.genome.npz"), sub),
                RefGI.load_split(str(tmp_path / "ps.genome.npz"), sub))
    os.remove(tmp_path / "ps.seed.1.npz")
    with pytest.raises(FileNotFoundError, match="partial copy"):
        PortGI.load_split(str(tmp_path / "ps.genome"))


# ---------------------------------------------- the index memory release

def _hp_ptr(a) -> int:
    return int(a.__array_interface__["data"][0])


def test_hostmem_release_matches_reference():
    """release() unmaps a to_hugepages buffer once (True, then False) and
    refuses an array it did not map, as the reference's does."""
    from shrimp_tpu.utils import hostmem as ref_hm
    from shrimp_tpu_torch.utils import hostmem as port_hm
    a = np.arange(1 << 20, dtype=np.int32)            # 4 MB: mapped
    outcomes = []
    for hm in (ref_hm, port_hm):
        h = hm.to_hugepages(a)
        assert np.array_equal(h, a)
        mapped = _hp_ptr(h) in hm._REGISTRY
        outcomes.append((mapped, hm.release(h), hm.release(h),
                         hm.release(a), hm.release(np.zeros(8))))
        assert _hp_ptr(h) not in hm._REGISTRY
    assert outcomes[0] == outcomes[1]
    assert outcomes[1] in ((True, True, False, False, False),
                           (False, False, False, False, False))


def test_index_release_and_trim_unmap_like_reference():
    """trim unmaps the lists it replaces (the registry of mapped buffers
    does not grow, though every trimmed seed maps new lists) and
    GenomeIndex.release every hugepage buffer of an index, leaving it
    unusable (planes None, no seeds), as the reference's do."""
    from shrimp_tpu.utils import hostmem as ref_hm
    from shrimp_tpu_torch.utils import hostmem as port_hm
    contigs = _contigs()
    outcomes = []
    for build, enc, seeds, hm in ((ref_build, ref_encode, ref_seeds, ref_hm),
                                  (port_build, port_encode, port_seeds,
                                   port_hm)):
        idx = build([(n, enc.encode_ls(s)) for n, s in contigs], seeds())
        n0 = len(hm._REGISTRY)
        dropped = idx.trim(1)
        grew = len(hm._REGISTRY) - n0
        held = {_hp_ptr(a) for a in [idx.codes, idx.codes_rc] + [
            a for si in idx.seeds for a in (si.offsets, si.positions)]}
        held &= set(hm._REGISTRY)
        idx.release()
        outcomes.append((dropped, grew, len(held),
                         len(held & set(hm._REGISTRY)), idx.codes,
                         idx.codes_rc, idx.seeds))
    assert outcomes[0] == outcomes[1]
    dropped, grew, held, still = outcomes[1][:4]
    assert dropped > 0 and grew <= 0 and held > 0 and still == 0


# ---------------------------------------------- the mesh tiers' host helpers

@pytest.mark.parametrize("kw,L", [
    ({}, 36), ({}, None), (dict(longest_read_len=10000), None),
    (dict(window_len=-700.0), 250), (dict(window_len=300.0), 1200)])
def test_halo_for_matches_reference(kw, L):
    from shrimp_tpu.parallel.meshmap import halo_for as ref_halo
    from shrimp_tpu_torch.parallel.meshmap import halo_for as port_halo
    assert port_halo(PortConfig(**kw), L) == ref_halo(RefConfig(**kw), L)


@pytest.mark.parametrize("D", [1, 2, 3, 5, 8])
def test_split_contig_bins_matches_reference(D):
    from shrimp_tpu.parallel.meshmap import split_contig_bins as ref_split
    from shrimp_tpu_torch.parallel.meshmap import \
        split_contig_bins as port_split
    rng = np.random.default_rng(D)
    contigs = [(f"c{k}", np.zeros(int(n), np.uint8))
               for k, n in enumerate(rng.integers(100, 5000, 7))]
    got, want = port_split(contigs, D), ref_split(contigs, D)
    assert [[n for n, _ in b] for b in got] == \
        [[n for n, _ in b] for b in want]


@pytest.fixture
def index_memory_freed(monkeypatch):
    """Both packages' index builds copy the big arrays into hugepage
    buffers that are never unmapped (`utils/hostmem.py::to_hugepages`);
    the cases below build many small indexes, so their arrays stay in
    numpy memory, freed with the index (the copy's own fallback)."""
    from shrimp_tpu.utils import hostmem as ref_hostmem
    from shrimp_tpu_torch.index import build as port_build_mod
    monkeypatch.setattr(port_build_mod, "to_hugepages", lambda a: a)
    monkeypatch.setattr(ref_hostmem, "to_hugepages", lambda a: a)


def _sub_indexes(D, mode):
    from shrimp_tpu.parallel.meshmap import split_contig_bins
    contigs = _contigs(lens=(20_000, 9_000, 70_000, 4_096, 33_000))
    out = []
    for build, enc, seeds in ((ref_build, ref_encode, ref_seeds),
                              (port_build, port_encode, port_seeds)):
        cs = [(n, enc.encode_ls(s)) for n, s in contigs]
        out.append([build(b, seeds(mode=mode), mode=mode)
                    for b in split_contig_bins(cs, D)])
    return out


@pytest.mark.parametrize("mode", ["ls", "cs"])
@pytest.mark.parametrize("D", [2, 3])
def test_composite_index_matches_reference(mode, D, index_memory_freed):
    from shrimp_tpu.parallel.meshmap import CompositeIndex as RefComp
    from shrimp_tpu_torch.parallel.meshmap import CompositeIndex as PortComp
    ref_subs, port_subs = _sub_indexes(D, mode)
    ref, port = RefComp(ref_subs), PortComp(port_subs)
    assert port.contig_names == ref.contig_names
    for f in ("contig_offsets", "contig_lengths", "codes", "codes_rc",
              "cs_codes", "cs_codes_rc", "cn_base", "pos_base"):
        a, b = getattr(port, f), getattr(ref, f)
        assert (a is None and b is None) or (
            a.dtype == b.dtype and np.array_equal(a, b)), f
    assert port.auto_list_cutoff() == ref.auto_list_cutoff()
    assert (port.total_len, port.n_contigs, port.max_seed_span) == \
        (ref.total_len, ref.n_contigs, ref.max_seed_span)
    pos = np.array([0, 19_999, 20_000, 100_000, port.total_len - 1])
    assert np.array_equal(port.contig_of(pos), ref.contig_of(pos))
    assert not hasattr(port, "seeds")


def test_merge_shard_flathits_matches_reference(index_memory_freed):
    """Per-shard filter 1 over three sub-indexes, merged back into the
    whole-index window order: the same FlatHits and shards."""
    from shrimp_tpu.parallel.meshmap import merge_shard_flathits as ref_merge
    from shrimp_tpu_torch.parallel.meshmap import \
        merge_shard_flathits as port_merge
    ref_subs, port_subs = _sub_indexes(3, "ls")
    plane = np.concatenate([s.codes for s in ref_subs])
    rng = np.random.default_rng(4)
    L, n = 36, 120
    pos = rng.integers(0, len(plane) - L, n)
    fwd = plane[pos[:, None] + np.arange(L)[None, :]].copy()
    fwd[rng.random((n, L)) < 0.03] = rng.integers(0, 4)
    codes2 = np.stack([fwd, RC.COMPLEMENT[fwd[:, ::-1]]], axis=1)
    cfg = RefConfig()
    opts = cfg.unpaired_options()[0]
    kw = dict(read_len=L, window_len=int(L * 1.4), cutoff=1000,
              match_mode=opts.hit_list.match_mode,
              threshold=opts.hit_list.threshold,
              match_score=cfg.scores.match,
              b_gap_open=cfg.scores.b_gap_open,
              b_gap_extend=cfg.scores.b_gap_extend, threads=2)
    cn_base = np.concatenate([[0], np.cumsum([s.n_contigs
                                              for s in ref_subs])])
    want, want_sh = ref_merge([(ref_f1(s, codes2, **kw), d)
                               for d, s in enumerate(ref_subs)],
                              cn_base, 2 * n)
    got, got_sh = port_merge([(port_f1(s, codes2, **kw), d)
                              for d, s in enumerate(port_subs)],
                             cn_base, 2 * n)
    assert want.n >= n and np.array_equal(got_sh, want_sh)
    assert len(set(got_sh.tolist())) >= 2
    for f in dataclasses.fields(want):
        r, p = getattr(want, f.name), getattr(got, f.name)
        assert p.dtype == r.dtype and np.array_equal(p, r), f.name
    empty, sh = port_merge([(port_f1(port_subs[0], codes2[:0], **kw), 0)],
                           cn_base, 0)
    assert empty.n == 0 and len(sh) == 0


@pytest.mark.parametrize("mode", ["ls", "cs"])
def test_memory_tracker_matches_reference(mode, tmp_path,
                                          index_memory_freed):
    """The memory cap's counters (utils/memmodel.py) after the same
    build, save and load (one .npz, the split layout, the mmap image),
    trim and release: the port's tracker reads the reference's at every
    step, and a released index leaves nothing accounted."""
    from shrimp_tpu.index.build import GenomeIndex as RefIndex
    from shrimp_tpu.utils import memmodel as ref_mm
    from shrimp_tpu_torch.index.build import GenomeIndex as PortIndex
    from shrimp_tpu_torch.utils import memmodel as port_mm
    contigs = _contigs()
    steps = []
    try:
        for tag, mm, build, enc, seeds, gi in (
                ("ref", ref_mm, ref_build, ref_encode, ref_seeds, RefIndex),
                ("port", port_mm, port_build, port_encode, port_seeds,
                 PortIndex)):
            tr = mm.init()
            got = []

            def seen(what):
                got.append((what, tr.crt_mem, tr.peak_mem,
                            dict(tr.by_category)))
            idx = build([(n, enc.encode_ls(s)) for n, s in contigs],
                        seeds(mode=mode), mode=mode)
            seen("build")
            base = str(tmp_path / tag)
            idx.save(base + ".npz")
            idx.save_split(base)
            idx.save_mmap(base + "_mmap")
            loaded = [gi.load(base + ".npz"), gi.load_split(base + ".genome"),
                      gi.load_mmap(base + "_mmap")]
            seen("load")
            assert loaded[0].trim(1) > 0
            seen("trim")
            for x in [idx] + loaded:
                x.release()
                seen("release")
            steps.append(got)
    finally:
        ref_mm.init()
        port_mm.init()
    assert steps[0] == steps[1]
    assert steps[1][0][1] > 0 and steps[1][-1][1] == 0
    assert steps[1][2][1] < steps[1][1][1]
