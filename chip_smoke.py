#!/usr/bin/env python3
"""Smoke run of shrimp_tpu_torch's main path on one NVIDIA GPU.

Run from the repository root, with no arguments:  python3 chip_smoke.py

1. The device: requires CUDA; prints the card and its power limit.
2. The build: compiles the CUDA kernels under shrimp_tpu_torch/csrc/
   (nvcc, sm_90a) and prints the build time and ptxas's register and
   spill report.
3. Each kernel against its plain PyTorch version on the card, on seeded
   random inputs at the main path's chunk (B = 8192) with G = 64 and
   G = 256, R = 40: outputs must be bit-equal (tolerance 0; all
   integer). Times both with CUDA events.
4. The packed device step (core/sw.py) on CUDA tensors against the same
   call on CPU tensors: [B, 3] rows bit-equal.
5. The slice: bench.py's E. coli-scale workload (seed 20260816, 4.6 Mbp
   genome, 36 bp reads) mapped to SAM on the card through
   fastpath.map_unpaired_sam_stream; both kernels' launch counters must
   rise; the SAM bytes must equal the port's CPU run on the same reads.

Any failure raises, so the exit code is non-zero and no result line is
printed. The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

B_CHUNK = 8192          # mapper.FULL_BATCH: rows per fused launch
N_READS = 100_000
KW = dict(match=10, mismatch=-15, a_gap_open=-40, a_gap_ext=-7,
          b_gap_open=-40, b_gap_ext=-7)


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def _time_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _pairs(rng, B, G, R):
    """Random (window, read) pairs: half the reads copied from their
    window so real alignments occur, glen < G, revcmpl rows, and the
    main path's pad rows (glen = alen = awid = 1) at the front."""
    g = rng.integers(0, 5, (B, G)).astype(np.uint8)
    r = rng.integers(0, 5, (B, R)).astype(np.uint8)
    for k in range(1, B, 2):
        o = int(rng.integers(0, max(1, G - R)))
        n = min(R, G - o)
        r[k, :n] = g[k, o:o + n]
        flip = rng.integers(0, R, 2)
        r[k, flip] = rng.integers(0, 4, 2)
    a = dict(genome=g, glen=rng.integers(1, G + 1, B), read=r,
             rlen=rng.integers(R - 8, R + 1, B),
             ax=rng.integers(-4, G // 2, B), ay=rng.integers(-4, R, B),
             alen=rng.integers(1, 24, B), awid=rng.integers(3, 24, B),
             revcmpl=rng.integers(0, 2, B))
    for k in ("glen", "alen", "awid"):
        a[k][:256] = 1
    for k in ("ax", "ay", "revcmpl"):
        a[k][:256] = 0
    return {k: v.astype(np.int32) if v.dtype != np.uint8 else v
            for k, v in a.items()}


def check_kernels(dev):
    """Phase 3: kernels vs plain versions on the card."""
    from shrimp_tpu_torch.core import sw_full, sw_vector
    rec = {"sw_vector": dict(err=0), "sw_full_stats": dict(err=0)}
    rng = np.random.default_rng(20261016)
    for G, R in ((64, 40), (256, 40)):
        t = {k: torch.from_numpy(v).to(dev)
             for k, v in _pairs(rng, B_CHUNK, G, R).items()}
        v4 = (t["genome"], t["glen"], t["read"], t["rlen"])
        full = tuple(t[k] for k in ("genome", "glen", "read", "rlen", "ax",
                                    "ay", "alen", "awid", "revcmpl"))
        got = sw_vector.sw_vector_batch(*v4, **KW)
        torch.cuda.synchronize()
        want = sw_vector.sw_vector_batch_ref(*v4, **KW)
        err = int((got - want).abs().max())
        rec["sw_vector"]["err"] = max(rec["sw_vector"]["err"], err)
        print(f"sw_vector G={G} R={R}: max |kernel - plain| = {err} "
              f"(best score {int(want.max())})")
        for local in (False, True):
            got = sw_full.sw_full_stats(*full, local_alignment=local, **KW)
            torch.cuda.synchronize()
            want = sw_full.sw_full_stats_ref(*full, local_alignment=local,
                                             **KW)
            err = int((got - want).abs().max())
            rec["sw_full_stats"]["err"] = max(rec["sw_full_stats"]["err"],
                                              err)
            print(f"sw_full_stats G={G} R={R} local={local}: max |kernel "
                  f"- plain| = {err} (rows with score > 0: "
                  f"{int((want[:, 0] > 0).sum())})")
        times = dict(
            sw_vector=(
                _time_ms(lambda: sw_vector.sw_vector_batch(*v4, **KW)),
                _time_ms(lambda: sw_vector.sw_vector_batch_ref(*v4, **KW),
                         reps=5)),
            sw_full_stats=(
                _time_ms(lambda: sw_full.sw_full_stats(*full, **KW)),
                _time_ms(lambda: sw_full.sw_full_stats_ref(*full, **KW),
                         reps=5)))
        for name, (k_ms, p_ms) in times.items():
            print(f"{name} B={B_CHUNK} G={G} R={R}: kernel {k_ms!r} ms, "
                  f"plain {p_ms!r} ms")
            if G == 64:     # the main path's shape
                rec[name].update(ms=k_ms, plain_ms=p_ms)
    for name, r in rec.items():
        if r["err"] != 0:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version (max abs err {r['err']})")
    return rec


def check_packed_step(dev):
    """Phase 4: the fused packed step on CUDA vs the same call on CPU,
    on a synthetic plane with windows at both ends of both strands."""
    from shrimp_tpu_torch.core.sw import (cat_word_plane,
                                          sw_vec_full_stats_packed)
    from shrimp_tpu_torch.fastpath import _pack_args4, _pack_rtab
    from shrimp_tpu_torch.mapper import Mapper
    rng = np.random.default_rng(7)
    n_true, G, L, R, B = 4_000_000, 64, 36, 40, B_CHUNK
    k = B - B // 8                     # the rest are pad rows
    fp = Mapper._pad_plane(rng.integers(0, 4, n_true).astype(np.uint8))
    rp = Mapper._pad_plane(rng.integers(0, 4, n_true).astype(np.uint8))
    n = len(fp)
    cat = cat_word_plane(fp, rp)
    starts = rng.integers(-5, n + 5, k)
    starts[:64] = rng.integers(-5, 40, 64)            # plane starts
    starts[64:128] = rng.integers(n - 70, n + 5, 64)  # plane ends
    glen = rng.integers(1, G + 1, k)
    ri = rng.integers(0, 2048, k)
    rc = rng.integers(0, 2, k)
    rx = rng.integers(-8, G // 2, k)
    ry = rng.integers(-8, L, k)
    rl = rng.integers(1, 24, k)
    rw = rng.integers(1, 30, k)
    rev = rc & rng.integers(0, 2, k)
    rtab = np.full((2048, R), 254, np.uint8)
    rtab[:, :L] = rng.integers(0, 4, (2048, L))
    # plant reads that align along the band's diagonal in 512 windows
    for q in range(128, 640):
        ri[q], glen[q], rx[q], ry[q], rl[q], rw[q] = q, G, 0, 0, L, 8
        starts[q] = rng.integers(0, n_true - G)
        plane = rp if rc[q] else fp
        rtab[q, :L] = plane[starts[q]:starts[q] + L]
    args = _pack_args4(B, k, starts, glen, ri, rc, rx, ry, rl, rw, rev)
    rtab_pk = _pack_rtab(rtab)
    got, want = (sw_vec_full_stats_packed(
        torch.from_numpy(fp).to(d), torch.from_numpy(rp).to(d),
        torch.from_numpy(args).to(d), torch.from_numpy(rtab_pk).to(d),
        torch.from_numpy(cat).to(d), G=G, L=L, **KW).cpu().numpy()
        for d in (dev, torch.device("cpu")))
    same = np.array_equal(got, want)
    print(f"packed step B={B} G={G} L={L}: CUDA rows == CPU rows: {same} "
          f"(rows with score > 0: {int(((want[:, 0] >> 16) > 0).sum())})")
    if not same:
        raise AssertionError("packed step: CUDA and CPU rows differ")


def _mapper(idx, device):
    """A port Mapper: its genome planes go to `device` here, outside
    any timed span."""
    from shrimp_tpu_torch.mapper import Mapper
    return Mapper(idx, None, device)


def _map(m, reads):
    """(SAM bytes, seconds) of one run of the port's entry point."""
    from shrimp_tpu_torch import fastpath
    t0 = time.perf_counter()
    sam = b"".join(fastpath.map_unpaired_sam_stream(m, reads))
    if m.device.type == "cuda":
        torch.cuda.synchronize()
    return sam, time.perf_counter() - t0


def _device_busy_share(m, reads) -> str:
    """Device activity (kernels, then copies) over the wall time of one
    mapping run under torch.profiler; "not measured" when the profiler
    records no device events. All work runs on one stream, so device
    events do not overlap."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = _map(m, reads)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us())
    if not by_name:
        return "not measured"
    copy_us = sum(v for k, v in by_name.items() if k.startswith("Mem"))
    kern_us = sum(by_name.values()) - copy_us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return (f"kernels {kern_us / 1e6 / wall!r}, copies "
            f"{copy_us / 1e6 / wall!r} of wall {wall!r} s; top: "
            + ", ".join(f"{k[:48]} {v / 1e3:.3f} ms" for k, v in top))


def run_slice(dev, counters):
    """Phase 5: bench.py's workload through the port's entry point."""
    from shrimp_tpu_torch.dataset import ecoli_unpaired_ls
    t0 = time.perf_counter()
    idx, reads = ecoli_unpaired_ls(N_READS)
    print(f"dataset + index: {time.perf_counter() - t0:.3f} s "
          f"({idx.total_len} bp, {len(reads)} reads)")
    _map(_mapper(idx, dev), reads[:2 * B_CHUNK])      # warm-up
    m = _mapper(idx, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    for c in counters.values():
        c.reset()
    sam, secs = _map(m, reads)
    launches = {k: c.n for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"slice on {dev}: {len(reads)} reads in {secs!r} s = "
          f"{len(reads) / secs!r} reads/s; launches {launches}; "
          f"windows {m.stats.vec_invocs}; full_host_tb "
          f"{m.stats.full_host_tb}; peak device memory {peak} bytes")
    print("stage seconds (summed over lanes): " + ", ".join(
        f"{k} {v!r}" for k, v in m.stats.stage_secs.items()))
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{k}: not launched by the main path")
    lines = sam.split(b"\n")[:-1]
    if not lines or any(len(ln.split(b"\t")) < 11 for ln in lines):
        raise AssertionError("slice: malformed SAM")
    names = {f[0] for f in (ln.split(b"\t", 2) for ln in lines)
             if not int(f[1]) & 4}
    mapped = len(names) / len(reads)
    print(f"SAM: {len(lines)} records, {mapped!r} of reads mapped")
    if (m.stats.reads != len(reads) or m.stats.reads_mapped != len(names)
            or mapped < 0.95):
        raise AssertionError("slice: reads lost, miscounted or mostly "
                             "unmapped")
    print("device busy share (profiled run on the first 32768 reads): "
          + _device_busy_share(_mapper(idx, dev), reads[:4 * B_CHUNK]))
    sam_cpu, secs_cpu = _map(_mapper(idx, "cpu"), reads)
    print(f"slice on cpu (plain versions): {secs_cpu!r} s; SAM identical "
          f"to the CUDA run: {sam_cpu == sam}")
    if sam_cpu != sam:
        raise AssertionError("slice: CUDA and CPU SAM bytes differ")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from shrimp_tpu_torch import _build
    from shrimp_tpu_torch.core import sw_full, sw_vector
    from shrimp_tpu_torch.device import get_device

    dev = get_device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = _smi()
    print(f"device: {kind}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; nvidia-smi: {smi}")

    t0 = time.perf_counter()
    built = _build.load()
    print(f"build: {time.perf_counter() - t0:.3f} s (nvcc "
          f"{built.seconds:.3f} s) -> {os.path.relpath(built.path)}")
    for ln in built.log.splitlines():
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            print("  " + ln.strip())

    rec = check_kernels(dev)
    check_packed_step(dev)
    launches = run_slice(dev, {"sw_vector": sw_vector.LAUNCHES,
                               "sw_full_stats": sw_full.LAUNCHES})

    kernels = [
        dict(name="sw_vector", route="cuda",
             source="shrimp_tpu_torch/csrc/sw_vector.cu",
             replaces="shrimp_tpu/core/sw_pallas.py:155",
             launches=launches["sw_vector"],
             max_abs_err=rec["sw_vector"]["err"],
             ms=rec["sw_vector"]["ms"],
             plain_ms=rec["sw_vector"]["plain_ms"]),
        dict(name="sw_full_stats", route="cuda",
             source="shrimp_tpu_torch/csrc/sw_full.cu",
             replaces="shrimp_tpu/core/sw_full_pallas.py:298",
             launches=launches["sw_full_stats"],
             max_abs_err=rec["sw_full_stats"]["err"],
             ms=rec["sw_full_stats"]["ms"],
             plain_ms=rec["sw_full_stats"]["plain_ms"]),
    ]
    print(_smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
