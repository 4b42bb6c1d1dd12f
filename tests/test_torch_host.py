"""The port's own host modules (shrimp_tpu_torch.constants, config,
io.fasta, io.sam, index, core.sw_cs_batch, native, paired) against the
JAX package's originals they were copied from, on the same inputs.
Every output is an integer array, a string or a dataclass: tolerance 0
throughout."""
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
