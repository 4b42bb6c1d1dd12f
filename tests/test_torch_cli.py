"""`python -m shrimp_tpu_torch` (index and map, `--device cpu`), run with
JAX and the JAX package blocked, against `python -m shrimp_tpu` on the
same files: the SAM bodies and headers (without the @PG line, which
holds the command line), the --un/--al read files, and indexes saved by
one package and loaded by the other (-S then -L, `index` then a .npz)."""
import os
import subprocess
import sys

import numpy as np

from .test_e2e_cs import make_cs_dataset
from .test_e2e_paired import make_paired_dataset
from .test_e2e_unpaired import make_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the port's entry point in a process where neither jax nor shrimp_tpu
# can be imported
PORT_MAIN = ("import sys, runpy; sys.modules['jax'] = None; "
             "sys.modules['shrimp_tpu'] = None; "
             "sys.argv[0] = 'shrimp_tpu_torch'; "
             "runpy.run_module('shrimp_tpu_torch', run_name='__main__', "
             "alter_sys=True)")


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    # one thread a process: the tests run beside other workers
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return env


def _port(cwd, *args, ok=True):
    res = subprocess.run([sys.executable, "-c", PORT_MAIN, *args],
                         capture_output=True, text=True, timeout=300,
                         env=_env(), cwd=str(cwd))
    if ok:
        assert res.returncode == 0, res.stderr[-3000:]
    return res


def _ref(cwd, *args):
    env = _env()
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run([sys.executable, "-m", "shrimp_tpu", *args],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=str(cwd))
    assert res.returncode == 0, res.stderr[-3000:]
    return res


def _sam(text):
    return [ln for ln in text.splitlines() if not ln.startswith("@PG")]


def _fastq(path, seed):
    """Rewrite a FASTA read file as FASTQ (PHRED+64 qualities), one read
    in four trimmed by a few bases."""
    rng = np.random.default_rng(seed)
    lines = open(path).read().split()
    out = []
    for k in range(0, len(lines), 2):
        seq = lines[k + 1]
        if k % 8 == 0:
            seq = seq[:len(seq) - int(rng.integers(1, 5))]
        q = "".join(chr(64 + int(x)) for x in rng.integers(5, 40, len(seq)))
        out.append(f"@{lines[k][1:]}\n{seq}\n+\n{q}\n")
    fq = path[:-3] + ".fq"
    with open(fq, "w") as f:
        f.write("".join(out))
    return fq


def test_map_unpaired_matches_reference(tmp_path):
    """FASTA (the fast stream) and trimmed FASTQ with --un/--al (the
    generic mapper)."""
    gpath, rpath, _, _ = make_dataset(str(tmp_path), n_reads=80)
    got = _port(tmp_path, "map", "--device", "cpu", rpath, gpath)
    want = _ref(tmp_path, "map", rpath, gpath)
    assert _sam(got.stdout) == _sam(want.stdout)
    assert len(_sam(got.stdout)) > 60
    fq = _fastq(rpath, 3)
    for tool, run in (("port", _port), ("ref", _ref)):
        extra = ("--device", "cpu") if tool == "port" else ()
        res = run(tmp_path, "map", *extra, "--un", f"{tool}.un",
                  "--al", f"{tool}.al", fq, gpath)
        with open(tmp_path / f"{tool}.sam", "w") as f:
            f.write(res.stdout)
    for ext in ("sam", "un", "al"):
        p, r = (open(tmp_path / f"{t}.{ext}").read() for t in ("port", "ref"))
        assert _sam(p) == _sam(r), ext
    assert open(tmp_path / "port.al").read().count("@") > 40


def test_map_paired_mate_files_match_reference(tmp_path):
    """-1/-2 mate files with -X (the generic paired mapper, whose
    insert-size histogram goes to stderr)."""
    _, _, _, reads = make_paired_dataset(str(tmp_path), n_pairs=40)
    gpath = str(tmp_path / "genome.fa")
    for mate, name in ((0, "m1.fa"), (1, "m2.fa")):
        with open(tmp_path / name, "w") as f:
            for n, s in reads[mate::2]:
                f.write(f">{n}\n{s}\n")
    args = ("-X", "-p", "opp-in", "-1", "m1.fa", "-2", "m2.fa", gpath)
    got = _port(tmp_path, "map", "--device", "cpu", *args)
    want = _ref(tmp_path, "map", *args)
    assert _sam(got.stdout) == _sam(want.stdout)
    assert len(_sam(got.stdout)) > 60
    hist = [ln for ln in got.stderr.splitlines() if ln.startswith("[")]
    assert len(hist) == 100
    assert hist == [ln for ln in want.stderr.splitlines()
                    if ln.startswith("[")]


def test_save_then_load_index_matches_reference(tmp_path):
    """-S saves the split index and exits; -L loads it: the port's -S
    then -L maps what the reference's -S then -L maps. (An index saved
    by one package loads in the other: tests/test_torch_host.py.)"""
    gpath, rpath, _, _ = make_dataset(str(tmp_path), n_reads=60)
    _port(tmp_path, "map", "--device", "cpu", "-S", "pidx", gpath)
    _ref(tmp_path, "map", "-S", "ridx", gpath)
    files = sorted(os.listdir(tmp_path))
    assert "pidx.genome.npz" in files and "pidx.seed.0.npz" in files
    assert ([f[4:] for f in files if f.startswith("pidx.")]
            == [f[4:] for f in files if f.startswith("ridx.")])
    got = _port(tmp_path, "map", "--device", "cpu", "-L", "pidx", rpath)
    want = _ref(tmp_path, "map", "-L", "ridx", rpath)
    assert _sam(got.stdout) == _sam(want.stdout)
    assert len(_sam(got.stdout)) > 40


def test_cs_index_then_map_matches_reference(tmp_path):
    """Colour space: `index --cs -o x.npz`, then `map --cs reads x.npz`,
    against the reference mapping from the FASTA."""
    gpath, rpath, _, _ = make_cs_dataset(str(tmp_path), n_reads=40,
                                         genome_len=20_000)
    _port(tmp_path, "index", "--cs", "-o", "whole.npz", gpath)
    got = _port(tmp_path, "map", "--device", "cpu", "--cs", rpath,
                "whole.npz")
    want = _ref(tmp_path, "map", "--cs", rpath, gpath)
    assert _sam(got.stdout) == _sam(want.stdout)
    assert len(_sam(got.stdout)) > 30
