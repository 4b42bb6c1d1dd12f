"""One rank of a multi-process mapping run (`parallel/dist.py`).

    python -m shrimp_tpu_torch.parallel.dist_worker --rank R --world P \\
        --init file:///tmp/run/pg --jobs JOBS.json --out DIR \\
        [--device cpu|cuda:0] [--timeout S] [--kernel-check MOD:FN]

The caller writes the dataset and starts every rank (a twin of
`tests/dist_worker.py`, which `jax.distributed` drives). JOBS.json:

    {"genomes": {NAME: {"path": "g.npz", "mode": "ls" or "cs"}},
     "jobs": [{"name": ..., "genome": NAME, "reads": "r.fa",
               "paired": bool, "read_sharding": bool, "batch_size": N,
               "config": {MapperConfig keyword arguments},
               "capture": [kernel record names]}]}

Paths are relative to the JSON file. A genome .npz holds the contigs as
`c0`, `c1`, ... in shard order and `shards`, the JSON bytes of every
shard's contig names (each rank holds len(shards) / P of them). A rank
builds only its own shards' sub-indexes, puts them on `--device` (one
shard each: ["cuda:0"] * d_local shares one card), runs the jobs of each
genome in turn through `DistMapper` and releases the sub-indexes after
them. For every job it writes DIR/<name>.r<rank>.sam and
DIR/<name>.r<rank>.json (the run's counters, each kernel's launches in
the mapping, the peak device memory, the stage seconds) and DIR/<name>.r<rank>.z.npz (the
last batch's merged z1 or paired Z rows). With `--kernel-check MOD:FN`,
`FN(run, names, in_turn)` of module MOD is called for a job with a
`capture` list instead of mapping it directly: it maps by calling `run()`
and returns {name: record}, running any timing through `in_turn(fn)`
(fn called by one rank after another); the records go to
DIR/kernels.r<rank>.json.
"""
from __future__ import annotations

import argparse
import importlib
import itertools
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ..config import MapperConfig
from ..core import sw_cs_full, sw_full, sw_vector
from ..index.build import build_index
from ..index.seeds import default_seeds
from ..io.fasta import read_seqs
from .dist import DistMapper, init_distributed

# every kernel launch counter, by the name the job records use
COUNTERS = {"sw_vector": sw_vector.LAUNCHES,
            "sw_vector_cs": sw_vector.CS_LAUNCHES,
            "sw_full_stats": sw_full.LAUNCHES,
            "sw_full_bp": sw_full.BP_LAUNCHES,
            "ls_traceback": sw_full.TB_LAUNCHES,
            "sw_cs_full": sw_cs_full.DP_LAUNCHES,
            "cs_traceback": sw_cs_full.TB_LAUNCHES}


def write_genome(path: str, shards) -> None:
    """The genome file of a run: `shards` is [[(name, uint8 codes), ...]
    a shard] in shard order."""
    contigs = [c for s in shards for c in s]
    np.savez(path, shards=np.frombuffer(json.dumps(
        [[n for n, _ in s] for s in shards]).encode(), np.uint8),
        **{f"c{i}": np.ascontiguousarray(c, np.uint8)
           for i, (_, c) in enumerate(contigs)})


def _local_subs(path: str, mode: str, rank: int, world: int):
    """(shard metadata of every shard, this rank's sub-indexes)."""
    with np.load(path) as z:
        names = json.loads(z["shards"].tobytes().decode())
        if len(names) % world:
            raise ValueError(f"{len(names)} shards for {world} ranks")
        d_local = len(names) // world
        meta, subs, i = [], [], 0
        for d, s in enumerate(names):
            codes = [z[f"c{i + j}"] for j in range(len(s))]
            meta.append(dict(names=s, lengths=np.array(
                [len(c) for c in codes], np.uint32)))
            if rank * d_local <= d < (rank + 1) * d_local:
                subs.append(build_index(list(zip(s, codes)),
                                        default_seeds(mode=mode), mode=mode))
            i += len(s)
    return meta, subs


def _in_turn(fn):
    """fn() on one rank after another, in rank order; its result here."""
    out = None
    for r in range(dist.get_world_size()):
        if r == dist.get_rank():
            out = fn()
        dist.barrier()
    return out


def _run_job(job, base: str, meta, subs, device: str, out: str, hook,
             records: dict) -> None:
    rank = dist.get_rank()
    reads = list(read_seqs(os.path.join(base, job["reads"])))
    cuda = device.startswith("cuda")
    dm = DistMapper(meta, subs, MapperConfig(**job.get("config", {})),
                    mesh=[device] * len(subs))
    f = dm.map_paired_sam if job.get("paired") else dm.map_unpaired_sam
    for c in COUNTERS.values():
        c.reset()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
    sam, peak, launches = [], [], {}

    def run():
        sam.append(f(reads, batch_size=job.get("batch_size", 8192),
                     read_sharding=job.get("read_sharding", False)))
        if cuda:
            torch.cuda.synchronize()
        # the mapping's launches and peak memory, before any check's
        launches.update({k: c.n for k, c in COUNTERS.items()})
        peak.append(torch.cuda.max_memory_allocated(device) / 2 ** 30
                    if cuda else None)
    t0 = time.perf_counter()
    if hook is not None and job.get("capture"):
        records.update(hook(run, job["capture"], _in_turn))
    else:
        run()
    wall = time.perf_counter() - t0
    z = (dm.last_zpair_merged[:, 3] if job.get("paired")
         and dm.last_zpair_merged is not None else dm.last_z1_merged)
    res = dict(
        wall=wall, map_wall=dm.last_wall, n_reads=len(reads),
        z1_max=float(z.max()) if z is not None and z.size else 0.0,
        slice_jobs=dm.last_slice_jobs,
        f1_local_windows=dm.last_f1_local_windows,
        render_wall=dm.last_render_wall, merge_bytes=dm.merge_bytes,
        merge_secs=dm.merge_secs, plane_bytes=dm.plane_bytes,
        launches=launches,
        peak_gib=peak[0],
        windows_per_read=dm.m.stats.vec_invocs / max(dm.m.stats.reads, 1),
        stage_secs=dict(dm.m.stats.stage_secs))
    stem = os.path.join(out, f"{job['name']}.r{rank}")
    with open(stem + ".sam", "wb") as fh:
        fh.write(sam[0])
    np.savez(stem + ".z.npz", **{k: v for k, v in (
        ("z1", dm.last_z1_merged), ("zpair", dm.last_zpair_merged))
        if v is not None})
    with open(stem + ".json", "w") as fh:
        json.dump(res, fh)
    print(f"rank {rank}: {job['name']}: {len(reads)} reads, "
          f"{len(sam[0])} bytes in {wall!r} s", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True,
                    help="init_method: file:///path or tcp://host:port")
    ap.add_argument("--jobs", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--kernel-check", default=None)
    a = ap.parse_args(argv)
    hook = None
    if a.kernel_check:
        mod, fn = a.kernel_check.split(":")
        hook = getattr(importlib.import_module(mod), fn)
    with open(a.jobs) as fh:
        spec = json.load(fh)
    base = os.path.dirname(os.path.abspath(a.jobs))
    os.makedirs(a.out, exist_ok=True)
    init_distributed(a.init, a.world, a.rank, a.timeout)
    records: dict = {}
    try:
        for gname, jobs in itertools.groupby(spec["jobs"],
                                             key=lambda j: j["genome"]):
            g = spec["genomes"][gname]
            meta, subs = _local_subs(os.path.join(base, g["path"]),
                                     g["mode"], a.rank, a.world)
            for job in jobs:
                _run_job(job, base, meta, subs, a.device, a.out, hook,
                         records)
            for s in subs:
                s.release()
        if hook is not None:
            with open(os.path.join(a.out, f"kernels.r{a.rank}.json"),
                      "w") as fh:
                json.dump(records, fh)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
