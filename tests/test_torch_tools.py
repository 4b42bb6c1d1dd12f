"""The port's host tools and the CLI's last subcommands against the JAX
package's: `python -m shrimp_tpu_torch` and `python -m shrimp_tpu` called
in-process on the same files, their stdout and the files they write
compared. merge (unpaired, paired, gzipped), the split-db workflow
(split-db, project-db, split-reads, split-contigs, and split -> project
-> map -> merge against the whole genome), the small tools (temp-sink,
fasta2fastq, lineindex, shrimp2sam), the legacy SHRiMP1 tools on
SHRiMP-format output that the reference's `map --shrimp-format` wrote,
`map --shrimp-format -P`, and the memory cap (--max-mem, --strict-mem).
The tools are host code: the port's copies take no --device."""
import contextlib
import gzip
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from shrimp_tpu import cli as ref_cli
from shrimp_tpu.utils import hostmem as ref_hostmem
from shrimp_tpu.utils import memmodel as ref_memmodel
from shrimp_tpu_torch import cli as port_cli
from shrimp_tpu_torch.index import build as port_build
from shrimp_tpu_torch.utils import memmodel as port_memmodel

from .test_colorconsensus import rc as cs_rc
from .test_colorconsensus import to_cs
from .test_e2e_cs import make_cs_dataset
from .test_e2e_unpaired import make_dataset
from .test_legacy_tools import _mp_input
from .test_merge import _assert_equivalent
from .test_torch_cli import PORT_MAIN, _env

CPU = ("--device", "cpu")
COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}


def _isolate(mp):
    """Both packages' index arrays stay ordinary numpy arrays (an index
    build otherwise leaves its hugepage buffers mapped for the worker's
    life), and torch takes one thread beside the other workers."""
    mp.setattr(port_build, "to_hugepages", lambda a: a)
    mp.setattr(ref_hostmem, "to_hugepages", lambda a: a)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    return prev


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Both CLIs re-initialise their package's memory tracker; each test
    leaves both at the default cap."""
    prev = _isolate(monkeypatch)
    yield
    torch.set_num_threads(prev)
    ref_memmodel.init()
    port_memmodel.init()


def _run(main, argv, stdin=None):
    """stdout of one in-process CLI call (stdin from a string or bytes)."""
    buf = io.StringIO()
    old_in = sys.stdin
    if stdin is not None:
        raw = stdin.encode() if isinstance(stdin, str) else stdin
        sys.stdin = io.TextIOWrapper(io.BytesIO(raw))
    try:
        with contextlib.redirect_stdout(buf):
            rc = main(list(argv))
    finally:
        sys.stdin = old_in
    assert rc in (0, None), argv
    return buf.getvalue()


def _both(argv, port_extra=(), stdin=None):
    """(port's stdout, reference's stdout) on the same arguments; the
    port's `map` also takes `port_extra` (--device cpu)."""
    got = _run(port_cli.main, [argv[0], *port_extra, *argv[1:]], stdin)
    want = _run(ref_cli.main, argv, stdin)
    return got, want


def _ref_tool(name, argv, stdin=None):
    """stdout of the reference's legacy tool module called directly: its
    CLI's pass-through subparser refuses a leading option (`probcalc-mp
    -m ...` exits 2 there), and the port's CLI hands such argv through."""
    import importlib
    mod = importlib.import_module("shrimp_tpu.tools." + name)
    return _run(mod.main, argv, stdin)


def _sam(text):
    return [ln for ln in text.splitlines() if not ln.startswith("@PG")]


def _body(text):
    return sorted(ln for ln in text.splitlines()
                  if ln and not ln.startswith("@"))


def _write_fa(path, recs):
    with open(path, "w") as f:
        for name, seq in recs:
            f.write(f">{name}\n")
            for i in range(0, len(seq), 70):
                f.write(seq[i:i + 70] + "\n")
    return str(path)


def _rc(s):
    return "".join(COMP[c] for c in reversed(s))


def _two_contigs(d, paired, seed=21, n=40):
    """Two 30 kbp contigs with a repeat across them, as whole genome and
    as one file a contig, and reads (mate pairs, opp-in, where `paired`)
    cut from both, some from the repeat."""
    rng = np.random.default_rng(seed)
    g1 = "".join(rng.choice(list("ACGT"), 30_000))
    g2 = "".join(rng.choice(list("ACGT"), 30_000))
    g2 = g2[:10_000] + g1[5_000:5_400] + g2[10_400:]
    reads = []
    for k in range(n):
        src = g1 if k % 2 == 0 else g2
        isz = int(rng.integers(120, 260))
        p = int(rng.integers(0, len(src) - isz - 36))
        if k % 5 == 0:
            src, p = g1, int(rng.integers(5_000, 5_100))
        if not paired:
            r = src[p:p + 36]
            reads.append((f"m{k}", _rc(r) if k % 3 == 0 else r))
            continue
        r2 = _rc(src[p + isz:p + isz + 36])
        if k % 7 == 3:
            q = int(rng.integers(0, len(g2) - 36))
            r2 = g2[q:q + 36]
        reads += [(f"p{k}/1", src[p:p + 36]), (f"p{k}/2", r2)]
    return (_write_fa(d / "g.fa", [("c1", g1), ("c2", g2)]),
            [_write_fa(d / f"c{i + 1}.fa", [(f"c{i + 1}", s)])
             for i, s in enumerate((g1, g2))],
            _write_fa(d / "reads.fa", reads))


def _shard_sams(d, paired):
    """The reads file and one SAM a contig, mapped by the port on the
    CPU."""
    _, shards, rpath = _two_contigs(d, paired)
    pm = ("-p", "opp-in") if paired else ()
    paths = []
    for i, g in enumerate(shards):
        p = str(d / f"s{i}.sam")
        with open(p, "w") as f:
            f.write(_run(port_cli.main, ["map", *CPU, *pm, rpath, g]))
        paths.append(p)
    return rpath, paths


@pytest.mark.parametrize("paired", [False, True], ids=["unpaired", "paired"])
def test_merge_matches_reference(tmp_path, paired):
    """merge: Z-field recombination of per-contig SAM, unpaired (z1) and
    paired (z3/z6, insert renormalisation), byte-equal to the
    reference's."""
    rpath, sams = _shard_sams(tmp_path, paired)
    got, want = _both(["merge", rpath, *sams])
    assert got == want
    assert len(_body(got)) >= 30


def test_merge_gzipped_inputs_match_reference(tmp_path):
    """merge reads gzipped SAM and reads files: the same bytes as the
    reference's on them, and as merging the plain files."""
    rpath, sams = _shard_sams(tmp_path, False)
    gz = []
    for p in [rpath, *sams]:
        with open(p, "rb") as f, gzip.open(p + ".gz", "wb") as g:
            g.write(f.read())
        gz.append(p + ".gz")
    got, want = _both(["merge", *gz])
    assert got == want
    assert got == _run(port_cli.main, ["merge", rpath, *sams])


def _files(d):
    out = {}
    for f in sorted(os.listdir(d)):
        with open(os.path.join(d, f), "rb") as fh:
            out[f] = fh.read()
    return out


def _split_genome(tmp_path):
    rng = np.random.default_rng(3)
    contigs = [(f"c{i}", "".join(rng.choice(list("ACGT"), n)))
               for i, n in enumerate((5000, 12_000, 3000, 9000, 4000))]
    return _write_fa(tmp_path / "g.fa", contigs)


@pytest.mark.parametrize("extra", [
    (), ("--cs",), ("--max-contig-len", "7000", "--contig-overlap", "500")],
    ids=["ls", "cs", "max-contig-len"])
def test_split_db_matches_reference(tmp_path, extra):
    """split-db writes the reference's chunk files, with the colour-space
    RAM model and with contigs cut into name/OFFSET halo pieces."""
    g = _split_genome(tmp_path)
    # 4 seeds of weight 10: a fixed cost of 100,331,648 bytes and 18 a
    # base (20 in colour space), so a budget of 0.0938 GB holds about
    # 21 kbp a chunk
    for who, main in (("port", port_cli.main), ("ref", ref_cli.main)):
        os.makedirs(tmp_path / who)
        _run(main, ["split-db", g, "--ram-size", "0.0938", "--seed-weight",
                    "10", "--prefix", str(tmp_path / who / "chunk"),
                    *extra])
    got, want = _files(tmp_path / "port"), _files(tmp_path / "ref")
    assert got == want
    assert len(got) >= 2 and any(v.count(b">") > 1 for v in got.values())


@pytest.mark.parametrize("mode", ["ls", "cs"])
def test_project_db_indexes_load_across_packages(tmp_path, mode):
    """project-db saves one .npz a chunk; the port's loads in the
    reference and the reference's in the port, array for array."""
    from shrimp_tpu.index.build import GenomeIndex as RefIndex
    from shrimp_tpu_torch.index.build import GenomeIndex as PortIndex
    _, shards, _ = _two_contigs(tmp_path, False)
    cs = ("--cs",) if mode == "cs" else ()
    saved = {}
    for who, main in (("port", port_cli.main), ("ref", ref_cli.main)):
        os.makedirs(tmp_path / who)
        chunks = []
        for p in shards:
            q = str(tmp_path / who / os.path.basename(p))
            with open(p) as f, open(q, "w") as g:
                g.write(f.read())
            chunks.append(q)
        _run(main, ["project-db", *cs, *chunks])
        saved[who] = [c[:-3] + ".npz" for c in chunks]
    for a, b in zip(saved["port"], saved["ref"]):
        x, y = RefIndex.load(a), PortIndex.load(b)
        assert x.mode == y.mode == mode and x.contig_names == y.contig_names
        for nm in ("codes", "codes_rc", "cs_codes", "cs_codes_rc",
                   "contig_offsets", "contig_lengths"):
            u, v = getattr(x, nm), getattr(y, nm)
            assert (u is None) == (v is None) and (
                u is None or np.array_equal(u, v)), nm
        assert len(x.seeds) == len(y.seeds) >= 3
        for s, t in zip(x.seeds, y.seeds):
            assert s.seed.mask_string == t.seed.mask_string
            assert np.array_equal(s.offsets, t.offsets)
            assert np.array_equal(s.positions, t.positions)


def test_split_reads_paired_matches_reference(tmp_path):
    """split-reads --paired: the reference's chunk files, pairs kept
    together."""
    _, _, rpath = _two_contigs(tmp_path, True, n=23)
    for who, main in (("port", port_cli.main), ("ref", ref_cli.main)):
        os.makedirs(tmp_path / who)
        _run(main, ["split-reads", rpath, "-n", "4", "--paired",
                    "--prefix", str(tmp_path / who / "rs")])
    got = _files(tmp_path / "port")
    assert got == _files(tmp_path / "ref") and len(got) == 4
    assert all(v.count(b">") % 2 == 0 for v in got.values())


@pytest.mark.parametrize("source", ["file", "stdin"])
def test_split_contigs_matches_reference(tmp_path, source):
    """split-contigs from a FASTA file and from name/size pairs on
    stdin."""
    if source == "file":
        # 1.5 GB of overhead and 48 MiB of tables: about 15 kbp a chunk
        got, want = _both(["split-contigs", _split_genome(tmp_path),
                           "1.5471", "10,10,10,10"])
    else:
        sizes = "".join(f"c{i}\t{n}\n" for i, n in enumerate(
            [9_000_000, 7_000_000, 5_000_000, 3_000_000, 2_000_000,
             1_000_000, 500_000, 100_000]))
        got, want = _both(["split-contigs", "-", "1.65", "10,10,10"],
                          stdin=sizes)
    assert got == want
    assert got.count("chunk ") >= 2


def test_temp_sink_matches_reference(tmp_path):
    data = bytes(np.random.default_rng(1).integers(0, 256, 300_000,
                                                   dtype=np.uint8))
    _run(port_cli.main, ["temp-sink", str(tmp_path / "p.bin"), "-b",
                         "4096"], stdin=data)
    _run(ref_cli.main, ["temp-sink", str(tmp_path / "r.bin"), "-b",
                        "4096"], stdin=data)
    with open(tmp_path / "p.bin", "rb") as f, open(tmp_path / "r.bin",
                                                   "rb") as g:
        got, want = f.read(), g.read()
    assert got == want == data


def test_fasta2fastq_matches_reference(tmp_path):
    fa = _write_fa(tmp_path / "x.fa", [("a", "ACGTAC"), ("b", "GGTTAA")])
    with open(tmp_path / "x.qual", "w") as f:
        f.write(">a\n30 31 32 33 34 35\n>b\n2 3 4 5 6 7\n")
    got, want = _both(["fasta2fastq", fa, str(tmp_path / "x.qual")])
    assert got == want and got.splitlines()[4] == "@b"


def test_lineindex_matches_reference(tmp_path):
    _, _, rpath = _two_contigs(tmp_path, False, n=12)
    got, want = _both(["lineindex", rpath])
    assert got == want and len(got.split()) == 24


@pytest.fixture(scope="module")
def shrimp_out(tmp_path_factory):
    """SHRiMP-format output of the reference's `map --shrimp-format` on a
    small letter-space dataset: (genome, reads, output) paths."""
    d = str(tmp_path_factory.mktemp("shrimp_format"))
    gpath, rpath, _, _ = make_dataset(d, seed=77, n_reads=80)
    with pytest.MonkeyPatch.context() as mp:
        prev = _isolate(mp)
        out = _run(ref_cli.main, ["map", "--shrimp-format", rpath, gpath])
        torch.set_num_threads(prev)
    ref_memmodel.init()
    spath = os.path.join(d, "out.shrimp")
    with open(spath, "w") as f:
        f.write(out)
    return gpath, rpath, spath


def test_shrimp2sam_matches_reference(shrimp_out):
    _, rpath, spath = shrimp_out
    got, want = _both(["shrimp2sam", rpath, spath])
    assert got == want
    assert len(_body(got)) >= 60


def test_probcalc_matches_reference(shrimp_out):
    """probcalc, its positional argument first (which the reference's CLI
    passes through) and its options first (which only the port's does)."""
    _, _, spath = shrimp_out
    got, want = _both(["probcalc", "10000", "-S", spath])
    assert got == want
    assert len(got.splitlines()) >= 60
    assert _run(port_cli.main, ["probcalc", "-S", "10000", spath]) == want
    assert _ref_tool("probcalc", ["-S", "10000", spath]) == want


@pytest.mark.parametrize("extra", [(), ("-d", "-G", "0.5")],
                         ids=["default", "discordant"])
def test_probcalc_mp_matches_reference(tmp_path, extra):
    """probcalc-mp with both argument sets of the reference's golden
    test."""
    path = _mp_input(tmp_path)
    args = ["-m", path, "-f", "_F", "-b", "_R", "-g", "4600000", "-M",
            "5000", *extra]
    got = _run(port_cli.main, ["probcalc-mp", *args])
    assert got == _ref_tool("probcalc_mp", args)
    # the discordant run prints its insert statistics to stderr only
    assert (len(got.splitlines()) > 10) == (not extra)
    with pytest.raises(SystemExit):
        _run(ref_cli.main, ["probcalc-mp", *args])


def test_prettyprint_matches_reference(shrimp_out):
    gpath, rpath, spath = shrimp_out
    got, want = _both(["prettyprint", spath, gpath, rpath])
    assert got == want
    assert got.count("\nG:") >= 60


def test_shrimp_var_matches_reference(tmp_path, shrimp_out):
    """shrimp-var on the rmapper output and on probcalc-format lines with
    indels and reverse-strand edit strings."""
    _, _, spath = shrimp_out
    lines = (">ri1\tctg\t+\t100\t140\t1\t36\t36\t300\t5(AC)10-3A12\t"
             "1.0e+00\t1.0e+00\t1.0e-09\n"
             ">ri2\tctg\t-\t200\t240\t1\t36\t36\t300\t4(GT)8--6C13x2\t"
             "1.0e+00\t1.0e+00\t1.0e-09\n")
    ppath = str(tmp_path / "in.probcalc")
    with open(ppath, "w") as f:
        f.write(lines)
    for argv in (["-r", spath], ["-p", ppath]):
        got = _run(port_cli.main, ["shrimp-var", *argv])
        assert got == _ref_tool("shrimp_var", argv) and got, argv


def test_colorconsensus_matches_reference():
    """colorconsensus on stdin: random contigs, forward and reverse CS
    reads with colour errors."""
    rng = np.random.default_rng(8)
    blocks = []
    for c in range(6):
        contig = "".join(rng.choice(list("TGCA"), int(rng.integers(30, 80))))
        blocks.append(f"Contig k{c} {len(contig)}\n")
        for _ in range(int(rng.integers(4, 12))):
            n = int(rng.integers(8, 20))
            p = int(rng.integers(0, len(contig) - n + 1))
            if rng.random() < 0.4:
                read, pos = to_cs(cs_rc(contig[p:p + n])), -(p + 1)
            else:
                read, pos = to_cs(contig[p:p + n]), p + 1
            if rng.random() < 0.3:
                i = int(rng.integers(1, len(read)))
                read = read[:i] + str((int(read[i]) + 1) % 4) + read[i + 1:]
            blocks.append(f"{pos} {read}\n")
    got, want = _both(["colorconsensus"], stdin="".join(blocks))
    assert got == want
    assert got.count("\n") == 18


def test_dag_matches_reference():
    """dag (a library, no subcommand): k-mer graphs, k-mer sets and
    alignments of the port's copy equal the reference's on random
    read pairs."""
    from shrimp_tpu.tools import dag as ref_dag
    from shrimp_tpu_torch.tools import dag as port_dag
    rng = np.random.default_rng(13)
    for _ in range(12):
        r1 = "".join(rng.choice(list("ACGT"), int(rng.integers(5, 12))))
        r2 = list(r1)
        for _ in range(int(rng.integers(0, 3))):
            i = int(rng.integers(0, len(r2)))
            r2[i] = "" if rng.random() < 0.3 else str(rng.choice(list("ACGT")))
        r2 = "".join(r2)
        eps, k = int(rng.integers(0, 9)), int(rng.integers(2, 6))
        genome = ("".join(rng.choice(list("ACGT"), 6)) + r1
                  + "".join(rng.choice(list("ACGT"), 6)))
        out = []
        for mod in (ref_dag, port_dag):
            kg = mod.build_kmer_graph(r1, r2, eps)
            al = mod.build_alignment(genome, mod.build_kmer_graph(r1, r2,
                                                                  eps))
            out.append((mod.get_kmers(kg, k), al.score, al.start_index,
                        al.end_index, al.sequence, al.read1, al.read2))
        assert out[0] == out[1], (r1, r2, eps, k)


@pytest.mark.parametrize("mode", ["ls", "cs"])
def test_map_pretty_matches_reference(tmp_path, mode):
    """map --shrimp-format -P: the generic mapper's hits, each followed by
    its alignment block, LS and CS."""
    if mode == "cs":
        gpath, rpath, _, _ = make_cs_dataset(str(tmp_path), n_reads=30,
                                             genome_len=20_000)
        cs = ("--cs",)
    else:
        gpath, rpath, _, _ = make_dataset(str(tmp_path), n_reads=40)
        cs = ()
    got, want = _both(["map", *cs, "--shrimp-format", "-P", rpath, gpath],
                      port_extra=CPU)
    assert got == want
    assert got.count("\nG:") >= 25 and got.count("\nR:") >= 25
    with pytest.raises(SystemExit, match="requires --shrimp-format"):
        port_cli.main(["map", *CPU, "-P", rpath, gpath])


def test_max_mem_warns_as_reference(tmp_path):
    """--max-mem under the index's footprint warns, once for the
    prediction before the build and once when the built arrays cross it,
    and maps all the same: the SAM and the warnings are the
    reference's."""
    gpath, rpath, _, _ = make_dataset(str(tmp_path), n_reads=40)
    errs = []
    outs = []
    for main, extra in ((port_cli.main, CPU), (ref_cli.main, ())):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            outs.append(_run(main, ["map", *extra, "--max-mem", "0.1",
                                    rpath, gpath]))
        errs.append([ln for ln in err.getvalue().splitlines()
                     if ln.startswith("my_malloc")])
    assert _sam(outs[0]) == _sam(outs[1])
    assert errs[0] == errs[1] and len(errs[0]) == 2
    assert "predicted index footprint" in errs[0][0]
    assert "exceeding maximum memory" in errs[0][1]
    tr = port_memmodel.tracker()
    assert tr.max_mem == int(0.1 * (1 << 30)) and not tr.strict
    assert tr.crt_mem > tr.max_mem
    assert _sam(outs[0]) == _sam(_run(port_cli.main,
                                      ["map", *CPU, rpath, gpath]))


def test_strict_mem_raises_as_reference(tmp_path):
    """--strict-mem: an index predicted over the cap raises MemCapError
    before anything is allocated, with the reference's message."""
    gpath, rpath, _, _ = make_dataset(str(tmp_path), n_reads=10)
    msgs = []
    for main, extra, err_t in (
            (port_cli.main, CPU, port_memmodel.MemCapError),
            (ref_cli.main, (), ref_memmodel.MemCapError)):
        with pytest.raises(err_t, match="split-db --ram-size") as ei:
            _run(main, ["map", *extra, "--max-mem", "0.5", "--strict-mem",
                        rpath, gpath])
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    tr = port_memmodel.tracker()
    assert tr.strict and tr.crt_mem == 0


def _workflow(main, d, rpath, gpath, extra):
    """split-db -> project-db -> map a chunk -> merge; returns the chunk
    SAMs, the merged SAM and the whole-genome SAM."""
    os.makedirs(d)
    _run(main, ["split-db", gpath, "--ram-size", "0.0471", "--prefix",
                os.path.join(d, "chunk")])
    chunks = sorted(os.path.join(d, p) for p in os.listdir(d))
    _run(main, ["project-db", *chunks])
    sams = []
    for c in chunks:
        sams.append(c[:-3] + ".sam")
        with open(sams[-1], "w") as f:
            f.write(_run(main, ["map", *extra, rpath, c[:-3] + ".npz"]))
    merged = _run(main, ["merge", rpath, *sams])
    whole = _run(main, ["map", *extra, rpath, gpath])
    return [open(p).read() for p in sams], merged, whole


def test_split_project_map_merge_matches_reference(tmp_path):
    """The split-db workflow: two chunks of one contig each, an index a
    chunk, a map a chunk, the merge. The port's chunk SAMs and merged
    SAM equal the reference's, and the merged records the whole-genome
    run's within the reference's own rule (Z fields re-encoded through
    1/1000 neg-log integers; a repeat spans the two contigs)."""
    gpath, _, rpath = _two_contigs(tmp_path, False, seed=11, n=30)
    port = _workflow(port_cli.main, str(tmp_path / "port"), rpath, gpath,
                     CPU)
    ref = _workflow(ref_cli.main, str(tmp_path / "ref"), rpath, gpath, ())
    assert len(port[0]) == 2
    for a, b in zip(port[0], ref[0]):
        assert _sam(a) == _sam(b)
    assert port[1] == ref[1]
    merged, whole = _body(port[1]), _body(port[2])
    assert len(merged) == len(whole) >= 30
    for a, b in zip(merged, whole):
        _assert_equivalent(a, b)


def test_tools_run_with_jax_blocked(tmp_path, shrimp_out):
    """`python -m shrimp_tpu_torch` with jax and shrimp_tpu blocked runs
    split-db, merge and probcalc, and writes what the reference writes
    in-process."""
    g = _split_genome(tmp_path)
    rpath, sams = _shard_sams(tmp_path, False)
    _, _, spath = shrimp_out
    os.makedirs(tmp_path / "port")
    os.makedirs(tmp_path / "ref")

    def port(*args):
        res = subprocess.run([sys.executable, "-c", PORT_MAIN, *args],
                             capture_output=True, text=True, timeout=300,
                             env=_env(), cwd=str(tmp_path))
        assert res.returncode == 0, res.stderr[-3000:]
        return res.stdout
    split = ("split-db", g, "--ram-size", "0.0938", "--seed-weight", "10")
    port(*split, "--prefix", str(tmp_path / "port" / "chunk"))
    _run(ref_cli.main, [*split, "--prefix", str(tmp_path / "ref" / "chunk")])
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    assert port("merge", rpath, *sams) == _run(ref_cli.main,
                                               ["merge", rpath, *sams])
    got = port("probcalc", "-S", "10000", spath)
    assert got == _run(ref_cli.main, ["probcalc", "10000", "-S", spath])
    assert got.count("\n") >= 60
