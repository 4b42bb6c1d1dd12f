"""Datasets and the two-rank runner of the multi-process tests
(tests/test_torch_dist*.py): tests/test_dist.py's five datasets, made
from the same seeds in the same order, in the port's own encoding (that
file's imports pull in shrimp_tpu, which a rank process must not load),
and `run_ranks`, which starts the ranks of
`shrimp_tpu_torch.parallel.dist_worker` with JAX and shrimp_tpu blocked
in them."""
import json
import os
import subprocess
import sys

import numpy as np

from shrimp_tpu_torch.core import encode
from shrimp_tpu_torch.io.fasta import SeqRecord

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLEN = 16 * 2048          # region-aligned contigs
COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}
RANK_TIMEOUT_S = 240      # both ranks are killed past it
PG_TIMEOUT_S = 120        # a collective some rank skips raises past it
BLOCKED = ("import sys, runpy; sys.modules['jax'] = None; "
           "sys.modules['jaxlib'] = None; sys.modules['shrimp_tpu'] = None; "
           "runpy.run_module('shrimp_tpu_torch.parallel.dist_worker', "
           "run_name='__main__', alter_sys=True)")


def _genome(rng):
    contigs, gs = [], []
    for c in range(8):
        g = "".join(rng.choice(list("ACGT"), CLEN))
        gs.append(g)
        contigs.append((f"chr{c}", encode.encode_ls(g)))
    return contigs, gs


def _rc(s):
    return "".join(COMP[c] for c in reversed(s))


def make_dataset():
    """8 contigs and 200 reads of 36 bp (test_dist.make_dataset)."""
    rng = np.random.default_rng(331)
    contigs, gs = _genome(rng)
    reads = []
    for k in range(200):
        src = gs[k % len(gs)]
        p = int(rng.integers(0, len(src) - 36))
        r = list(src[p:p + 36])
        for _ in range(int(rng.integers(0, 3))):
            r[int(rng.integers(0, 36))] = "ACGT"[int(rng.integers(0, 4))]
        r = "".join(r)
        if k % 3 == 0:
            r = _rc(r)
        reads.append(SeqRecord(f"dr{k}", r))
    return contigs, reads


def make_paired_dataset():
    """8 contigs and 120 opp-in pairs, 1 in 9 discordant
    (test_dist.make_paired_dataset)."""
    rng = np.random.default_rng(733)
    contigs, gs = _genome(rng)
    reads = []
    for k in range(120):
        src = gs[k % len(gs)]
        isz = int(rng.integers(90, 200))
        p = int(rng.integers(0, len(src) - isz - 1))
        r1 = src[p:p + 36]
        r2 = _rc(src[p + isz - 36:p + isz])
        if k % 9 == 0:
            q = int(rng.integers(0, len(src) - 36))
            r2 = src[q:q + 36]
        reads.append(SeqRecord(f"dp{k}/1", r1))
        reads.append(SeqRecord(f"dp{k}/2", r2))
    return contigs, reads


def make_long_dataset():
    """8 contigs and 24 reads of 800 bp, windows of G = 1120
    (test_dist.make_long_dataset)."""
    rng = np.random.default_rng(557)
    contigs, gs = _genome(rng)
    RL = 800
    reads = []
    for k in range(24):
        src = gs[k % len(gs)]
        p = int(rng.integers(0, len(src) - RL))
        r = list(src[p:p + RL])
        for _ in range(int(rng.integers(0, 6))):
            r[int(rng.integers(0, RL))] = "ACGT"[int(rng.integers(0, 4))]
        r = "".join(r)
        if k % 3 == 0:
            r = _rc(r)
        reads.append(SeqRecord(f"lr{k}", r))
    return contigs, reads


def _tocs(s):
    l2n = {c: i for i, c in enumerate("ACGT")}
    return "T" + str(l2n["T"] ^ l2n[s[0]]) + "".join(
        str(l2n[s[i]] ^ l2n[s[i + 1]]) for i in range(len(s) - 1))


def make_cs_dataset():
    """8 contigs and 160 colour-space reads of 36 colours
    (test_dist.make_cs_dataset_dist)."""
    rng = np.random.default_rng(839)
    contigs, gs = _genome(rng)
    reads = []
    for k in range(160):
        src = gs[k % len(gs)]
        p = int(rng.integers(0, len(src) - 36))
        s = list(src[p:p + 36])
        for _ in range(int(rng.integers(0, 2))):
            s[int(rng.integers(0, 36))] = "ACGT"[int(rng.integers(0, 4))]
        s = "".join(s)
        if k % 3 == 0:
            s = _rc(s)
        reads.append(SeqRecord(f"dc{k}", _tocs(s)))
    return contigs, reads


def make_cs_paired_dataset():
    """8 contigs and 100 opp-in CS pairs, 1 in 9 discordant
    (test_dist.make_cs_paired_dataset)."""
    rng = np.random.default_rng(941)
    contigs, gs = _genome(rng)
    reads = []
    for k in range(100):
        src = gs[k % len(gs)]
        isz = int(rng.integers(100, 220))
        p = int(rng.integers(0, len(src) - isz - 1))
        a = list(src[p:p + 36])
        b = list(src[p + isz - 36:p + isz])
        for s in (a, b):
            for _ in range(int(rng.integers(0, 3))):
                s[int(rng.integers(36))] = "ACGT"[int(rng.integers(4))]
        r1 = _tocs("".join(a))
        r2 = _tocs(_rc("".join(b)))
        if k % 9 == 0:
            q = int(rng.integers(0, len(src) - 36))
            r2 = _tocs(src[q:q + 36])
        reads.append(SeqRecord(f"dcp{k}/1", r1))
        reads.append(SeqRecord(f"dcp{k}/2", r2))
    return contigs, reads


def write_reads(path, reads):
    with open(path, "w") as f:
        for r in reads:
            f.write(f">{r.name}\n{r.seq}\n")


def run_ranks(tmp, genomes, jobs, world=2, timeout=RANK_TIMEOUT_S):
    """Run `jobs` on `world` rank processes (4 shards a rank on
    ["cpu"] * 4, gloo, a file:// init) over `genomes` {name: (mode,
    contigs)}, one contig a shard; each job's "reads" are records, written
    here. Returns {job name: [(SAM bytes, meta) a rank]}. Kills every rank
    if one outlives `timeout`."""
    from shrimp_tpu_torch.parallel.dist_worker import write_genome
    os.makedirs(tmp, exist_ok=True)
    spec = dict(genomes={}, jobs=[])
    for name, (mode, contigs) in genomes.items():
        write_genome(os.path.join(tmp, f"{name}.npz"),
                     [[c] for c in contigs])
        spec["genomes"][name] = dict(path=f"{name}.npz", mode=mode)
    for job in jobs:
        write_reads(os.path.join(tmp, job["name"] + ".fa"), job["reads"])
        spec["jobs"].append(dict(job, reads=job["name"] + ".fa"))
    with open(os.path.join(tmp, "jobs.json"), "w") as f:
        json.dump(spec, f)
    out = os.path.join(tmp, "out")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", BLOCKED, "--rank", str(r), "--world",
         str(world), "--init", "file://" + os.path.join(tmp, "pg"),
         "--jobs", os.path.join(tmp, "jobs.json"), "--out", out,
         "--device", "cpu", "--timeout", str(PG_TIMEOUT_S)],
        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=timeout)
            logs.append((p.returncode, so.decode(), se.decode()[-4000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (rc, so, se) in enumerate(logs):
        assert rc == 0, f"rank {r} failed, rc={rc}\n{so}\n{se}"
    res = {}
    for job in jobs:
        res[job["name"]] = []
        for r in range(world):
            stem = os.path.join(out, f"{job['name']}.r{r}")
            with open(stem + ".sam", "rb") as f, open(stem + ".json") as g, \
                    np.load(stem + ".z.npz") as z:
                res[job["name"]].append((f.read(), json.load(g), dict(z)))
    return res


PROBE = ("import sys; sys.modules['jax'] = None; "
         "sys.modules['jaxlib'] = None; sys.modules['shrimp_tpu'] = None; "
         "from tests.dist_data import probe_main; probe_main()")


def probe_rows(rank: int):
    """Rank `rank`'s rows for the exchange probe: ragged int64 and
    float64 rows (rank 1 sends none of the int64), and its shards'
    partial Z rows (z1 [2, 50], paired [2, 30, 9]) with ties and
    all-negative posteriors."""
    rng = np.random.default_rng(100 + rank)
    i64 = rng.integers(-2 ** 62, 2 ** 62, (0 if rank else 7, 3))
    f64 = rng.standard_normal((3 + 2 * rank, 2)) * 1e300
    z1 = rng.random((2, 50)) * 10.0 ** rng.integers(-300, 300, (2, 50))
    zp = np.round(rng.standard_normal((2, 30, 9)), 1)
    return i64, f64, z1, zp


def probe_main():
    """One rank of the exchange probe: argv is rank, world, init
    method, output .npz; it allgathers `probe_rows` and merges the Z
    rows as DistMapper does."""
    import torch.distributed as dist
    from shrimp_tpu_torch.parallel import dist as D
    from shrimp_tpu_torch.parallel.meshmap import (make_mesh, zmerge_psum,
                                                   zpair_merge)
    rank, world, init, out = sys.argv[1:5]
    D.init_distributed(init, int(world), int(rank), PG_TIMEOUT_S)
    try:
        i64, f64, z1, zp = probe_rows(int(rank))
        g_i64 = D._allgather_rows(i64)
        g_f64 = D._allgather_rows(f64)
        z1_all = np.concatenate(D._allgather_rows(z1))
        zp_all = np.concatenate(D._allgather_rows(zp))
        mesh = make_mesh(["cpu"] * len(z1_all))
        np.savez(out, counts=[len(a) for a in g_i64] + [len(a) for a in g_f64],
                 i64=np.concatenate(g_i64), f64=np.concatenate(g_f64),
                 z1=zmerge_psum(mesh, z1_all), zpair=zpair_merge(mesh, zp_all))
    finally:
        dist.destroy_process_group()


def run_probe(tmp, world=2):
    """Run the exchange probe on `world` ranks: [its .npz a rank]."""
    os.makedirs(tmp, exist_ok=True)
    outs = [os.path.join(tmp, f"probe{r}.npz") for r in range(world)]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", PROBE, str(r), str(world),
         "file://" + os.path.join(tmp, "probe_pg"), outs[r]], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=RANK_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (so, se) in zip(procs, logs):
        assert p.returncode == 0, se.decode()[-4000:]
    return [dict(np.load(o)) for o in outs]
