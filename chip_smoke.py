#!/usr/bin/env python3
"""Smoke run of shrimp_tpu_torch's main path on one NVIDIA GPU.

Run from the repository root, with no arguments:  python3 chip_smoke.py

1. The device: requires CUDA; prints the card and its power limit.
2. The build: compiles the CUDA kernels under shrimp_tpu_torch/csrc/
   (nvcc, sm_90a) and prints the build time and ptxas's register and
   spill report.
3. The vector SW and the full-SW stats kernel against their plain
   PyTorch versions on the card, on seeded random inputs at the main
   path's chunk (B = 8192) with G = 64, 128 and 256 (the stats flow's
   buckets), R = 40, global and local, with revcmpl rows, pad rows and
   the edge bands of dataset.edge_bands: outputs must be bit-equal
   (tolerance 0; all integer). The vector SW, both modes, also at G =
   40, 96 and 200 (no bucket) with B = 8191 and the length edges of
   dataset.length_edges (glen = 1, glen = G, rlen = 1). Prints both
   kernels' launch configurations. Times kernel and plain, and the
   kernels' bounds at each G.
4. The packed device step (core/sw.py) on CUDA tensors against the same
   call on CPU tensors: [B, 3] rows bit-equal.
5. The letter-space slice: bench.py's E. coli-scale workload (seed
   20260816, 4.6 Mbp genome, 36 bp reads) mapped to SAM on the card
   through fastpath.map_unpaired_sam_stream; both kernels' launch
   counters must rise; the SAM bytes must equal the port's CPU run on
   the same reads. The geometry of the first launch of one more batch,
   recorded where the flow calls the stats kernel's wrapper, gives its
   in-band share and bound on the flow's own bands.
6. The colour-space kernels (CS-mode vector SW, the 4-layer DP, the
   traceback) against their plain versions on the card, at B = 2048 and
   8192, G = 64 and 128, R = 36, and at (B, R, G) = (2048, 36, 256) and
   (2048, 72, 128), global and local, taboo 0 and 4, with revcmpl rows,
   BASE_N cells, pad rows and the edge bands of dataset.edge_bands:
   bit-equal (tolerance 0). The traceback also on dataset.cs_walk_pairs
   (walks that reach row 0 and column 0, leave its band, start outside
   layer 0; bfrm = 0; scores below thresh), each kind present; it
   refuses G = 60, unaligned backpointers and unaligned windows. Prints
   the three kernels' launch configurations. Times kernel and plain, and
   each kernel's bound at each shape.
7. The fused colour-space step (core/sw_cs.py) on CUDA tensors against
   the same call on CPU tensors, on a synthetic plane with windows at
   both ends of both strands: all three outputs bit-equal.
8. The colour-space slice: bench_all.py's `ecoli-cs` workload (the same
   genome, 36-colour SOLiD reads) mapped to SAM on the card through
   fastpath_cs.map_unpaired_cs_sam_stream; the three CS launch counters
   must rise, at least 95 % of reads must map, and the SAM bytes of the
   first CS_CPU_READS reads must equal the port's CPU run on them. The
   geometry of the first launch of one more batch, recorded where the
   flow calls the DP's wrapper, gives the in-band share and bound of the
   4-layer DP on the flow's own bands.
9. The long-read kernels (vector SW on wide windows, the full SW with
   backpointers, the traceback) against their plain versions on the
   card at the 250 bp launch (B, R, G) = (4096, 256, 352) and the
   1000 bp one (256, 1000, 1408), global and local, with revcmpl rows,
   BASE_N cells, pad rows, the edge bands of dataset.edge_bands and
   pairs with one long insertion or deletion (walks that cross several
   of the traceback's tiles, through their left side too): bit-equal
   (tolerance 0); the full SW also at G = 360, whose backpointer rows
   leave in byte stores. The traceback refuses G = 360 and unaligned
   backpointers. Prints the launch configuration of the full SW and
   of the traceback. Times kernel and plain.
10. The fused traceback step (core/sw.py) on CUDA tensors against the
   same call on CPU tensors, on a synthetic plane with windows at both
   ends of both strands: all three outputs bit-equal.
11. The long-read slice: 100,000 reads of 250 bp (dataset.
   ecoli_unpaired_ls_long) mapped to SAM on the card through
   fastpath.map_unpaired_sam_stream, which takes the traceback flow;
   its three launch counters must rise, at least 95 % of reads must
   map, and the SAM bytes of the first LONG_CPU_READS reads must equal
   the port's CPU run on them. The first launch of one more batch,
   recorded where the flow calls each wrapper, gives the in-band share
   and bound of the full SW with backpointers on the flow's own bands,
   and the traceback's time, bound and walk lengths on the flow's own
   walks beside the test pairs'.

12. Letter space at human-genome candidate density: bin 0 of
   bench_hg.py's synthetic genome (dataset.hg_bin: SINE-, LINE- and
   satellite-like repeats) cut to HG_BIN_LEN bases, and bench_hg.py's
   HG_READS 36 bp reads, through fastpath.map_unpaired_sam_stream; every
   batch must take the two-phase dispatch (vector SW alone on every
   window, then the full SW on the pass-1 survivors); prints the list
   cutoff, windows per read, the vec-only launch rows, phase-B rows per
   read, reads/s, stage seconds, peak device memory and the card's busy
   share. The SAM of the first HG_GATE_OFF_READS reads must equal a card
   run with the gate forced off, and that of the first HG_CPU_READS the
   port's CPU run. The vector SW is held against its plain version on the
   flow's own first vec-only launch (its time and bound there are the
   `sw_vector_hg` record).
13. The same in colour space: a CS index of the bin and bench_hg.py's CS
   reads through fastpath_cs.map_unpaired_cs_sam_stream (`sw_vector_cs_hg`).
14. LS paired, E. coli: bench_all.py's `ecoli-paired` workload
   (dataset.ecoli_paired_ls, PAIRED_READS reads) through
   fastpath.map_paired_sam_stream; the SAM of the first PAIRED_CPU_READS
   reads must equal the port's CPU run.
15. LS paired at hg-like density: bench_hg.py's `ls-paired` pairs on the
   phase-12 bin; every batch must take the select-then-full dispatch;
   checks as in phase 12.
16. Long reads through two phases: the first LONG_CPU_READS reads of
   phase 11 with the two-phase threshold forced to 1 window per read; the
   full SW with backpointers and the traceback run on the selected rows
   only, and the SAM must equal the fused card run's.
17. CS paired, E. coli: bench_all.py's `ecoli-cs-paired` workload
   (dataset.ecoli_paired_cs, PAIRED_READS reads) through
   fastpath_cs.map_paired_cs_sam_stream; the three CS launch counters
   must rise, and the SAM of the first PAIRED_CPU_READS reads must equal
   the port's CPU run. The 4-layer DP and the traceback are held against
   their plain versions on the flow's own first launch (the
   `sw_cs_full_paired` and `cs_traceback_paired` records). Prints reads/s,
   stage seconds, peak device memory and the card's busy share.
18. CS paired at hg-like density: bench_hg.py's `cs-paired` pairs on the
   phase-13 bin and CS index; every batch must take select-then-full;
   checks as in phase 12, plus the paired renders (rescue rounds); the
   DP and the traceback are held against their plain versions on the
   flow's first phase-B launch (`sw_cs_full_paired_hg`,
   `cs_traceback_paired_hg`).
19. The flows the packed path refuses. (a) The packed LS stats step, the
   LS traceback step (G = 352) and the CS fused step on a synthetic
   BIG_PLANE-base plane pair, which has no word plane, so the byte gather
   runs (asserted): CUDA against CPU, bit-equal, windows at both ends of
   both strands, tails past the plane; the byte gather's device time
   there and, beside the word gather's, on a 4 Mbp plane. (b) Phase 5's
   and phase 11's first UNPACKED_READS reads in one batch (more than
   2^16 read rows: the unpacked stats and traceback flows) against the
   same reads in B_CHUNK-read batches, SAM identical. (c) The LS, LS
   paired and CS streams on E. coli with the mapper's word planes
   withheld, fused and two-phase: the SAM of the first BYTE_READS reads
   equals the run with the planes; the byte gather's device time at the
   fused runs' own launch shapes beside the word gather's and the wall.
   Prints peak device memory for (a)-(c).
20. The generic mapper, the streams' slow tails and the CLI, each run
   printing reads/s, the card's name and power limit and peak device
   memory. (a) bench_all.py's `ecoli-ls-generic`: GENERIC_READS reads
   of dataset.ecoli_unpaired_ls through Mapper.map_unpaired with
   --extra-sam-fields; SAM of the first GENERIC_CPU_READS equal to the
   CPU run's; the vector SW, the full SW with backpointers and the
   traceback held against their plain versions on the path's own first
   launches (`sw_vector_generic`, `sw_full_bp_generic`,
   `ls_traceback_generic`). (b) The E. coli LS, CS, LS-pairs and
   CS-pairs streams on TAIL_READS reads in TAIL_BATCH-read batches, one
   read in five of every other batch trimmed to 28-35 bp, so that those
   batches take the generic mapper's slow tail; SAM of the first
   TAIL_CPU_READS equal to the CPU run's. (c) Off-gate configs on
   OFFGATE_READS E. coli reads each, card against CPU: local (LS, CS),
   gapless, two --unpaired-options rounds, --shrimp-format, CS FASTQ
   (per-read crossovers from qualities: the 4-layer DP and the CS
   traceback held against plain there, `sw_cs_full_generic`,
   `cs_traceback_generic`); the full SW with backpointers held against
   plain on the local run's first launch with the local retry's band.
   (d) `python -m shrimp_tpu_torch index` and `map -S` / `map -L` as
   subprocesses on FASTA and FASTQ files, LS and CS: SAM bodies
   byte-identical to the in-process streams; wall times.

21. The mesh tiers (shrimp_tpu_torch.parallel.meshmap) on
   make_mesh(["cuda:0"] * 4) on a one-card machine (every card where
   there are more): four shards whose launches queue side by side on
   their own streams. (a) MeshMapper at E. coli density: MESH_READS
   reads each of the LS, CS, LS-pairs and CS-pairs workloads of phases
   5, 8, 14 and 17 and MESH_LONG_READS 250 bp reads of phase 11 (the
   long-read fallback: one single-device launch on mesh[0]); each SAM
   equal to the port's unsharded card stream's, the LS run's z1 partials
   summed by zmerge_psum equal to their host sum (rtol 1e-12); every
   kernel of the path held against its plain version on the path's own
   first per-shard launch (`*_mesh` records). (b) MeshMapper on phase
   12's bin and first MESH_HG_READS reads, fused on the mesh, against
   the unsharded two-phase card run. (c) ShardedIndexMapper on the
   E. coli genome cut into four contigs of ECOLI_CONTIG_LEN bases, one
   sub-index a shard: LS, LS pairs, CS, CS pairs, MESH_READS reads each,
   against the whole index's unsharded card stream; the merged Z rows
   non-zero. (d) The split-db workflow on-line: four hg-like bins of
   HG_SUB_LEN bases (dataset.hg_bin(HG_SUB_LEN, i), chr1..chr4), one
   sub-index each, MESH_HG_READS reads drawn evenly from them; the
   oracle is the same tier on a mesh of four "cpu" shards on the first
   MESH_HG_CPU_READS reads; every z1 merge equal to the host sum of its
   partials. Each run prints reads/s (the unsharded stream's beside
   it), peak device memory, each shard's plane bytes and the inner
   mapper's device planes (none unless a fallback ran).
22. The multi-process tier (shrimp_tpu_torch.parallel.dist): two rank
   processes of parallel/dist_worker.py over gloo (a file:// init),
   two shards each on cuda:0 (two ranks share the one card: the
   exchanges, not scaling across cards). (a) phase 21 (c)'s four E. coli
   contigs and reads (LS, LS pairs, CS, CS pairs; LS and LS pairs again
   with read sharding), (b) DIST_LONG_READS 250 bp reads of phase 11 (the
   per-shard traceback flow), (c) phase 21 (d)'s split-db bins and
   reads. Every SAM, on both ranks, equal to ShardedIndexMapper's on the
   same sub-indexes and reads and to the unsharded stream's ((c): the
   CPU run of the first MESH_HG_CPU_READS reads is a prefix); read
   sharding splits each rank's jobs and filter-1 windows. Each rank holds
   every kernel of the path against its plain version on its own first
   launch (`*_dist` records, dist_kernel_checks). Prints the slower
   rank's reads/s beside ShardedIndexMapper's and the stream's, the
   merge bytes and seconds, each rank's filter-1 windows, slice jobs,
   peak device memory and stage seconds. A rank that fails or outlives
   DIST_TIMEOUT_S fails the phase (both are killed).
23. The split-db workflow through the CLI: shrimp_tpu_torch.cli.main
   in-process in a temporary directory (deleted at the end), stdout to
   files, `map` on the card. (a) Phase 21 (c)'s four E. coli contigs in
   one FASTA: `split-db --ram-size` (from plan_index_ram: one contig a
   chunk, 4 chunks), `project-db` and `project-db --cs`, a `map` a chunk
   and `merge`, for SPLIT_READS reads of phase 5's LS workload and of
   phase 17's CS pairs; each chunk's SAM body equal to the in-process
   card stream's on the index project-db saved; the merged SAM of the
   first SPLIT_CPU_READS reads equal to the --device cpu workflow's; the
   LS merge equal to the whole index's card stream within the reference's
   rule (tests/test_merge.py::_assert_equivalent; the CS pairs' only
   printed); one `map` and the LS `merge` again as `python -m
   shrimp_tpu_torch` subprocesses, the same bytes. (b) Phase 21 (d)'s
   four bins and reads (two if the disk cannot hold four saved chunk
   indexes): split-db, project-db, `map --strict-mem` on the whole genome
   refused by the cap before its build, a `map` a chunk under `--max-mem`
   equal to split-db's budget with no cap warning, `merge`; the merged
   SAM of the first MESH_HG_CPU_READS reads equal to the CPU workflow's;
   reads/s over map + merge beside phase 21 (d)'s and phase 22 (c)'s on
   the same bins and reads. (c) `map --shrimp-format -P` (the generic
   mapper) on PRETTY_READS E. coli reads, LS and CS, its output's prefix
   for the first PRETTY_CPU_READS reads equal to the --device cpu run.
   Every kernel of (a)-(c) held against its plain version on the first
   launch of the first chunk's map (`*_cli` records); every map's
   launch counters must rise.

A kernel's time ("ms" in the record) is its device time per launch,
with its wrapper's calls queued behind a sleep kernel between two CUDA
events (_device_ms): a short kernel runs in less time than the host
takes to make one call, so CUDA events over calls made back to back
(printed beside it) time the host. The plain versions are timed by CUDA
events.

Each slice is driven with the launch counts set to 0 just before it and
read just after. Any failure raises, so the exit code is non-zero and
no result line is printed. The last lines are the whole run's seconds,
the card's name and power limit, the kernels' JSON record (each
kernel's launches on its slice, error, times and bound) and {"ok": true,
"device": {...}}. `--phases 12,13` runs only the phases listed (the
build always runs) and then prints no result; `--phases 20` runs the
generic mapper's phase alone, `--phases 21` the mesh tiers',
`--phases 22` the multi-process tier's (with phase 21 (c) and (d) first,
for its oracles), `--phases 23` the split-db workflow through the CLI.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

B_CHUNK = 8192          # mapper.FULL_BATCH: rows per fused launch
N_READS = 100_000
# (G, R) of the stats flow's buckets at phase 3 (G = 64: 36 bp reads)
STATS_SHAPES = ((64, 40), (128, 40), (256, 40))
KW = dict(match=10, mismatch=-15, a_gap_open=-40, a_gap_ext=-7,
          b_gap_open=-40, b_gap_ext=-7)
# colour space: gmapper-cs's default scores and crossover; the main
# path's launch (fastpath_cs._cs_chunk at E. coli density) and reads
CS_KW = dict(match=10, mismatch=-24, a_gap_open=-33, a_gap_ext=-7,
             b_gap_open=-33, b_gap_ext=-3)
XOVER = -20
CS_B_MAIN, CS_G_MAIN, CS_R = 2048, 64, 36
# reads of the CS slice mapped again on the CPU for the SAM comparison
# (two 8192-read batches: the plain 4-layer DP is slow on the host)
CS_CPU_READS = 16_384
BASE_N = 15
# long reads: the 250 bp launch (traceback-flow chunk bucket at R = 256,
# G = 352) and the --longest-read default's (1000 bp); reads of the
# long slice mapped again on the CPU for the SAM comparison
LONG_SHAPES = ((4096, 256, 352), (256, 1000, 1408))
LONG_CPU_READS = 2048
# hg-like density: one bin of bench_hg.py's 4 x 750 Mbp genome, cut to
# HG_BIN_LEN bases, and its default read count; the reads held against
# a gate-off card run (one batch) and against the CPU run
HG_BIN_LEN = 100_000_000
HG_READS = 50_000
HG_GATE_OFF_READS = 8192
HG_CPU_READS = 512
# E. coli pairs: bench_all.py's ecoli-paired workload, cut to 100,000
# reads; the reads of its CPU comparison
PAIRED_READS = 100_000
PAIRED_CPU_READS = 4096
# a two-phase threshold no batch reaches: the fused dispatch
GATE_OFF = 1 << 30
# the flows the packed path refuses: a plane pair of BIG_PLANE bases
# (no word plane: the byte gather), one batch of UNPACKED_READS reads
# (more than 2^16 read rows: the unpacked flow), the reads of the
# byte-gather streams, and the vec-only launch's rows (fastpath.
# LS_VEC_BATCH's ladder) at which the gathers are timed
BIG_PLANE = 1 << 30
UNPACKED_READS = 70_000
BYTE_READS = 8192
LS_VEC_ROWS = 3_145_728
# phase 20: bench_all.py's ecoli-ls-generic size (min(N_READS, 20000)),
# the slow-tail streams, the off-gate configs
GENERIC_READS = 20_000
GENERIC_CPU_READS = 512
TAIL_READS = 8192
TAIL_BATCH = 512
TAIL_CPU_READS = 1024
READ_LEN = 36            # letters (colours after the primer) a read
OFFGATE_READS = 4096
# two --unpaired-options rounds: a strict one that stops on a >= 92 %
# hit, then a sensitive one (tests/test_option_sets.py)
DSL_STRICT = "0;1/1,1,1/1,0,2,60.0/1,55.0,90.0,2,0,30/55.0,0,0,10/1,92.0"
DSL_LOOSE = "0;1/1,1,1/1,0,1,40.0/1,35.0,90.0,1,0,40/35.0,0,0,20/0"

# peak rates of one H100 SXM (NVIDIA's data sheet): HBM3 bytes/s, and
# int32 operations/s. The sheet's 67 TFLOP/s float32 counts an FMA as
# two operations on 128 lanes per SM; int32 issues on 64 lanes per SM,
# so a quarter of it.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
# int32 operations per DP cell (per walk step for the tracebacks),
# counted from each kernel's recurrence
OPS = dict(sw_vector=14, sw_full_stats=40, sw_full_bp=32, ls_traceback=16,
           sw_cs_full=240, cs_traceback=20)


@functools.lru_cache(maxsize=None)
def _dataset(name: str, n_reads: int):
    """(index, reads) of `shrimp_tpu_torch.dataset.<name>(n_reads)`, made
    once a run: phase 19 maps the workloads of phases 5, 8, 11 and 14
    again."""
    from shrimp_tpu_torch import dataset
    return getattr(dataset, name)(n_reads)


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


def _device_ms(fn, reps: int = 20) -> float:
    """Device time per call of fn, whose calls only enqueue CUDA work,
    with the calls queued back to back: a sleep kernel holds the stream
    while the host enqueues `reps` calls between two CUDA events, so the
    host's time to make a call (longer than a short kernel's run, which
    bounds _time_ms) does not count. If the sleep ended before the host
    had enqueued every call, it sleeps longer and measures again."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    secs = 4 * reps * (time.perf_counter() - t0) + 1e-3
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    for _ in range(4):
        torch.cuda._sleep(int(secs * 2e9))    # SM cycles, at most 2 GHz
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        queued = not e0.query()   # the sleep still runs: no gaps
        torch.cuda.synchronize()
        if queued:
            return e0.elapsed_time(e1) / reps
        secs *= 4
    raise AssertionError("the host could not enqueue the calls before "
                         "the sleep kernel ended")


def _kernel_times(fn, plain, reps=20, plain_reps=5) -> tuple:
    """(device ms per launch, CUDA-event ms per call, plain ms per call)
    of a kernel's wrapper call `fn` and its plain version."""
    return (_device_ms(fn, reps), _time_ms(fn, reps),
            _time_ms(plain, plain_reps))


def _bound(nbytes: float, ops: float, ops_all: float) -> dict:
    """The least time for the work: the larger of bytes over the memory
    rate and int32 operations over the int32 rate. `ops` counts the
    cells (walk steps) these inputs need; `ops_all` every one of the
    R x G cells (R + G steps), for `bound_all_ms` beside it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_all_ms=max(t_bytes, ops_all / INT32_OPS_PER_S * 1e3))


def _band_cells(a, nrows) -> int:
    """In-band DP cells of the pairs in `a` (numpy arrays) over rows
    i < nrows (per pair), with the kernels' band (anchor_get_x_range)."""
    from shrimp_tpu_torch.dataset import bands
    nrows = np.asarray(nrows, np.int64)
    x_min, x_max = bands(a, max(int(nrows.max()), 0))
    live = np.arange(x_min.shape[1])[None, :] < nrows[:, None]
    return int(np.where(live, np.maximum(x_max - x_min + 1, 0), 0).sum())


def _with_edge_bands(a, rng, lo, n, G, R):
    """Rows [lo, lo + n) of the pairs `a` take the band geometries of
    dataset.edge_bands."""
    from shrimp_tpu_torch.dataset import edge_bands
    for k, v in edge_bands(rng, n, G, R).items():
        a[k][lo:lo + n] = v


def _print_launch_config(name, entry, *args):
    """One line of a kernel's launch configuration, from its C entry
    point `entry` (occupancy from the CUDA runtime)."""
    from shrimp_tpu_torch import _build
    c = _build.launch_config(entry, *args)
    warps = (c["blocks_per_sm"] * c["pairs_per_block"]
             * c["threads_per_pair"] // 32)
    print(f"{name} launch {args}: {c['pairs_per_block']} pairs per block, "
          f"{c['threads_per_pair']} threads per pair, {c['smem_bytes']} B "
          f"dynamic shared memory per block, {c['blocks_per_sm']} resident "
          f"blocks per SM ({warps} warps), {c['registers']} registers and "
          f"{c['local_bytes']} B local memory per thread")


def _cs_dp_bytes(B, R, G) -> int:
    """4-layer DP: windows, 4 read layers, crossovers and 9 int32 per pair
    in; 5 int32 and the int16 backpointers [R, 4, G] per pair out."""
    return B * (G + 4 * R + 4 * R + 36 + 20 + 8 * R * G)


def _bp_bytes(B, R, G) -> int:
    """Full SW with backpointers: windows, reads and 7 int32 per pair in;
    4 int32 and the backpointer byte of every cell out."""
    return B * (G + R + 28 + 16) + B * R * G


def _first_call(m, reads, stream, module, fn, with_kw=False):
    """The tensor arguments (copies) of the first call that one batch of
    `reads` makes through `stream` to the kernel wrapper `module.<fn>`
    (module: where the flow looks the wrapper up), and with `with_kw`
    its keyword arguments too."""
    from shrimp_tpu_torch.fastpath import auto_batch_size
    seen = _first_calls(m, reads[:auto_batch_size(m)], stream,
                        {fn: (module, fn)})[fn]
    return seen if with_kw else seen[0]


def _first_launch(m, reads, stream, module, fn):
    """The band geometry (numpy glen, rlen, ax, ay, alen, awid) and
    (B, R, G) of the first launch that one batch of `reads` makes through
    `stream`: the arguments the flow passes to the DP wrapper
    `module.<fn>` (genome [B, G], glen, read [B, (4,) R], rlen, ax, ay,
    alen, awid, ...), pad rows included, copied to the host."""
    genome, glen, read, rlen, ax, ay, alen, awid = (
        x.cpu().numpy() for x in _first_call(m, reads, stream, module,
                                             fn)[:8])
    a = dict(glen=glen, rlen=rlen, ax=ax, ay=ay, alen=alen, awid=awid)
    return a, genome.shape[0], read.shape[-1], genome.shape[1]


def _print_flow_bound(name, m, reads, stream, module, fn, test_bound,
                      nbytes, by_rlen):
    """The in-band share of the first launch's windows on the flow's own
    bands (`_first_launch`), and the kernel's bound over those cells
    beside the test pairs' bound. The DP runs the rows i < rlen of each
    pair (`by_rlen`) or every row of the launch."""
    a, B, R, G = _first_launch(m, reads, stream, module, fn)
    pads = int(((a["glen"] == 1) & (a["alen"] == 1) & (a["awid"] == 1)).sum())
    cells = _band_cells(a, np.minimum(a["rlen"], R) if by_rlen
                        else np.full(B, R))
    b = _bound(nbytes(B, R, G), OPS[name] * cells, OPS[name] * B * R * G)
    print(f"{name} on the flow's bands, first launch (B, R, G) = "
          f"({B}, {R}, {G}), {B - pads} windows and {pads} pad rows (glen = "
          f"alen = awid = 1): in-band share {cells / (B * R * G)!r} of the "
          f"R x G cells; bound {b['bound_ms']!r} ms ({b['bound_by']}; all "
          f"cells {b['bound_all_ms']!r} ms); test pairs' bound "
          f"{test_bound!r} ms")


def _walks(steps) -> str:
    """The distribution of a traceback launch's walk lengths (int
    tensor of steps per pair)."""
    q = [float(x) for x in np.percentile(steps.cpu().numpy(), (50, 90, 99))]
    return (f"{int(steps.sum())} steps over {steps.numel()} walks, median "
            f"{q[0]!r}, p90 {q[1]!r}, p99 {q[2]!r}, longest "
            f"{int(steps.max())}")


def _tb_bound(steps, B, R, G) -> dict:
    """The traceback's bound over the steps its walks take: the walked
    backpointer, window and read bytes and 4 int32 in; 10 int32 and the
    op bytes of each pair out."""
    n = int(steps.sum())
    return _bound(3 * n + B * (16 + 40 + (R + G + 3) // 4),
                  OPS["ls_traceback"] * n, OPS["ls_traceback"] * B * (R + G))


def _vector_bound(a, B, G, R, cs=False) -> dict:
    """Vector SW: every cell below glen and rlen; windows, reads and
    lengths in, one int32 out (plus the row-0 colours in colour
    space)."""
    cells = int((np.minimum(a["glen"], G).astype(np.int64)
                 * np.minimum(a["rlen"], R)).sum())
    return _bound(B * (G + R + 12 + (G if cs else 0)),
                  OPS["sw_vector"] * cells, OPS["sw_vector"] * B * R * G)


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


def _stats_bytes(B, R, G) -> int:
    """Full-SW stats: windows, reads and 7 int32 per pair in; 8 int32
    out."""
    return B * (G + R + 28 + 32)


def _check_vector_edges(dev, rng, rec):
    """The narrow vector kernel, both modes, on windows that are not a
    G bucket (40, 96, 200), B = 8191 (not a multiple of the pairs per
    block) and the length edges of dataset.length_edges: bit-equal."""
    from shrimp_tpu_torch.core import sw_vector
    from shrimp_tpu_torch.dataset import length_edges
    vkw = dict(CS_KW, mismatch=CS_KW["match"] + XOVER)
    for B, G, R in ((B_CHUNK - 1, 40, 40), (B_CHUNK - 1, 96, 72),
                    (B_CHUNK - 1, 200, 40), (B_CHUNK, 64, 40)):
        for cs in (False, True):
            a = (_cs_vec_pairs if cs else _pairs)(rng, B, G, R)
            length_edges(rng, a["glen"], a["rlen"], G, R)
            keys = ("genome", "glen", "read", "rlen") + (
                ("g_row0",) if cs else ())
            v = tuple(torch.from_numpy(a[k]).to(dev) for k in keys)
            kw = vkw if cs else KW
            got = sw_vector.sw_vector_batch(*v, cs_mode=cs, **kw)
            torch.cuda.synchronize()
            want = sw_vector.sw_vector_batch_ref(*v, cs_mode=cs, **kw)
            err = _err([got], [want])
            name = "sw_vector_cs" if cs else "sw_vector"
            rec[name]["err"] = max(rec[name]["err"], err)
            print(f"{name} edges B={B} G={G} R={R}: max |kernel - plain| "
                  f"= {err} (rows with glen = 1: "
                  f"{int((a['glen'] == 1).sum())}, rlen = 1: "
                  f"{int((a['rlen'] == 1).sum())}, best {int(want.max())})")


def check_kernels(dev):
    """Phase 3: kernels vs plain versions on the card."""
    from shrimp_tpu_torch.core import sw_full, sw_vector
    rec = {"sw_vector": dict(err=0), "sw_full_stats": dict(err=0),
           "sw_vector_cs": dict(err=0)}
    rng = np.random.default_rng(20261016)
    for G, R in STATS_SHAPES:
        _print_launch_config("sw_vector", "sw_vector_config", B_CHUNK, G, R)
        _print_launch_config("sw_full_stats", "sw_full_stats_config",
                             B_CHUNK, G, R)
    for G, R in STATS_SHAPES:
        a = _pairs(rng, B_CHUNK, G, R)
        _with_edge_bands(a, rng, 256, B_CHUNK // 16, G, R)
        t = {k: torch.from_numpy(v).to(dev) for k, v in a.items()}
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
            sw_vector=_kernel_times(
                lambda: sw_vector.sw_vector_batch(*v4, **KW),
                lambda: sw_vector.sw_vector_batch_ref(*v4, **KW)),
            sw_full_stats=_kernel_times(
                lambda: sw_full.sw_full_stats(*full, **KW),
                lambda: sw_full.sw_full_stats_ref(*full, **KW)))
        bounds = dict(
            sw_vector=_vector_bound(a, B_CHUNK, G, R),
            sw_full_stats=_bound(
                _stats_bytes(B_CHUNK, R, G),
                OPS["sw_full_stats"]
                * _band_cells(a, np.minimum(a["rlen"], R)),
                OPS["sw_full_stats"] * B_CHUNK * R * G))
        for name, (k_ms, ev_ms, p_ms) in times.items():
            b = bounds[name]
            print(f"{name} B={B_CHUNK} G={G} R={R}: kernel {k_ms!r} ms "
                  f"(device; {ev_ms!r} ms a call by CUDA events), plain "
                  f"{p_ms!r} ms, bound {b['bound_ms']!r} ms "
                  f"({b['bound_by']}; all R x G cells: "
                  f"{b['bound_all_ms']!r} ms)")
            if G == 64:     # the main path's shape
                rec[name].update(ms=k_ms, plain_ms=p_ms, **b)
    _check_vector_edges(dev, rng, rec)
    for name, r in rec.items():
        if r["err"] != 0:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version (max abs err {r['err']})")
    return rec


def _ls_window_case(rng, fp, rp, n_true, B, G, L, R):
    """Packed arguments [B, 4] and the nibble-packed read table of a
    synthetic LS launch on the planes fp, rp (the first n_true bases
    real): windows at both ends of both strands, starts before 0 and
    tails past the end, 512 windows whose read aligns along the band's
    diagonal, and B // 8 pad rows."""
    from shrimp_tpu_torch.fastpath import _pack_args4, _pack_rtab
    n = len(fp)
    k = B - B // 8                     # the rest are pad rows
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
    return args, rtab_pk


def check_packed_step(dev):
    """Phase 4: the fused packed step on CUDA vs the same call on CPU,
    on a synthetic plane with windows at both ends of both strands."""
    from shrimp_tpu_torch.core.sw import (cat_word_plane,
                                          sw_vec_full_stats_packed)
    from shrimp_tpu_torch.mapper import Mapper
    rng = np.random.default_rng(7)
    n_true, G, L, R, B = 4_000_000, 64, 36, 40, B_CHUNK
    fp = Mapper._pad_plane(rng.integers(0, 4, n_true).astype(np.uint8))
    rp = Mapper._pad_plane(rng.integers(0, 4, n_true).astype(np.uint8))
    cat = cat_word_plane(fp, rp)
    args, rtab_pk = _ls_window_case(rng, fp, rp, n_true, B, G, L, R)
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
    any timed span (`Mapper.upload_planes`; they would go up on first
    use)."""
    from shrimp_tpu_torch.mapper import Mapper
    return Mapper(idx, None, device).upload_planes()


def _ls_stream(m, reads):
    from shrimp_tpu_torch import fastpath
    return fastpath.map_unpaired_sam_stream(m, reads)


def _map(m, reads, stream=_ls_stream):
    """(SAM bytes, seconds) of one run of the port's entry point."""
    sam, secs = _map_batches(m, reads, stream)
    return b"".join(sam), secs


def _map_batches(m, reads, stream):
    """([SAM bytes of each batch], seconds) of one run of an entry
    point."""
    t0 = time.perf_counter()
    out = list(stream(m, reads))
    if m.device.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _device_busy_share(m, reads, stream=_ls_stream) -> str:
    """Device activity (kernels, then copies) over the wall time of one
    mapping run under torch.profiler (`_busy_share`). All work runs on
    one stream, so device events do not overlap."""
    return _busy_share(lambda: _map(m, reads, stream)[1])


def _busy_share(run) -> str:
    """Device activity (kernels, then copies) over the wall time of
    `run()` (which maps and returns its wall seconds) under
    torch.profiler, summed over the device's streams; "not measured"
    when the profiler records no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = run()
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


def run_slice(dev, counters, test_bound):
    """Phase 5: bench.py's workload through the port's entry point."""
    t0 = time.perf_counter()
    idx, reads = _dataset("ecoli_unpaired_ls", N_READS)
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
    from shrimp_tpu_torch.core import sw
    _print_flow_bound("sw_full_stats", m, reads, _ls_stream, sw,
                      "sw_full_stats", test_bound, _stats_bytes, True)
    sam_cpu, secs_cpu = _map(_mapper(idx, "cpu"), reads)
    print(f"slice on cpu (plain versions): {secs_cpu!r} s; SAM identical "
          f"to the CUDA run: {sam_cpu == sam}")
    if sam_cpu != sam:
        raise AssertionError("slice: CUDA and CPU SAM bytes differ")
    return launches


def _cs_vec_pairs(rng, B, G, R):
    """CS-mode vector inputs: colour windows with their row-0 colours,
    colour reads (half copied from their window, with dot colours),
    lengths; the main path's pad rows (glen = rlen = 1) at the front."""
    g = rng.integers(0, 4, (B, G)).astype(np.uint8)
    g0 = rng.integers(0, 4, (B, G)).astype(np.uint8)
    r = rng.integers(0, 4, (B, R)).astype(np.uint8)
    half = np.arange(1, B, 2)
    o = rng.integers(0, G - R + 1, len(half))
    r[half] = g[half[:, None], o[:, None] + np.arange(R)[None, :]]
    r[half, 0] = g0[half, o]
    r[half[:, None], rng.integers(0, R, (len(half), 2))] = \
        rng.integers(0, 4, (len(half), 2))
    r[rng.random((B, R)) < 0.01] = BASE_N
    g[rng.random((B, G)) < 0.005] = BASE_N
    glen = rng.integers(1, G + 1, B).astype(np.int32)
    rlen = rng.integers(R - 8, R + 1, B).astype(np.int32)
    glen[:256] = rlen[:256] = 1
    return dict(genome=g, glen=glen, read=r, rlen=rlen, g_row0=g0)


def _cs_dp_pairs(rng, B, G, R):
    """4-layer DP inputs: letter windows; four letter layers per read, one
    of which follows its window (two substitutions) in half the pairs;
    BASE_N cells; per-row crossovers; both strands; pad rows (glen =
    rlen = alen = awid = 1, thresh = 1) at the front, then B / 16 pairs
    at the edge bands."""
    g = rng.integers(0, 4, (B, G)).astype(np.uint8)
    qr = rng.integers(0, 4, (B, 4, R)).astype(np.uint8)
    half = np.arange(0, B, 2)
    o = rng.integers(0, G - R + 1, len(half))
    k0 = rng.integers(0, 4, len(half))
    qr[half, k0] = g[half[:, None], o[:, None] + np.arange(R)[None, :]]
    qr[half[:, None], k0[:, None], rng.integers(0, R, (len(half), 2))] = \
        rng.integers(0, 4, (len(half), 2))
    qr[rng.random((B, 4, R)) < 0.01] = BASE_N
    g[rng.random((B, G)) < 0.01] = BASE_N
    a = dict(genome=g, glen=rng.integers(G // 2, G + 1, B), qr=qr,
             rlen=rng.integers(R - 12, R + 1, B),
             ax=rng.integers(-4, G - R, B), ay=rng.integers(-4, 15, B),
             alen=rng.integers(1, 24, B), awid=rng.integers(3, 16, B),
             revcmpl=rng.integers(0, 2, B),
             xover=rng.integers(2 * XOVER, 0, (B, R)),
             gx=np.full(B, XOVER), thresh=rng.integers(0, 200, B))
    for k in ("glen", "rlen", "alen", "awid", "thresh"):
        a[k][:256] = 1
    for k in ("ax", "ay", "revcmpl"):
        a[k][:256] = 0
    _with_edge_bands(a, rng, 256, B // 16, G, R)
    return {k: v.astype(np.int32) if v.dtype != np.uint8 else v
            for k, v in a.items()}


_DP_ORDER = ("genome", "glen", "qr", "rlen", "ax", "ay", "alen", "awid",
             "revcmpl", "xover", "gx")


def _err(got, want) -> int:
    return max(int((x.to(torch.int32) - w.to(torch.int32)).abs().max())
               for x, w in zip(got, want))


# (B, R, G) of phase 6: the main path's launch first, the wider buckets,
# 8192-row launches, windows of 256 and 72-colour reads
CS_SHAPES = ((CS_B_MAIN, CS_R, CS_G_MAIN), (CS_B_MAIN, CS_R, 2 * CS_G_MAIN),
             (4 * CS_B_MAIN, CS_R, CS_G_MAIN),
             (4 * CS_B_MAIN, CS_R, 2 * CS_G_MAIN),
             (CS_B_MAIN, CS_R, 4 * CS_G_MAIN), (CS_B_MAIN, 2 * CS_R, 128))


def _cs_tb_bound(packed, B, R, G) -> dict:
    """The CS traceback's bound over the steps its walks take: per step
    the walked backpointer (2 bytes), window and read bytes; 6 int32 per
    pair in; [12] int16 and R + G step bytes per pair out."""
    n = int(packed[:, 4].to(torch.int64).sum())
    return _bound(4 * n + B * (24 + 24 + R + G), OPS["cs_traceback"] * n,
                  OPS["cs_traceback"] * B * (R + G))


def _check_cs_tb_edges(dev, rng, rec):
    """The traceback on dataset.cs_walk_pairs at the main shape's R and G
    and at R = 72: bit-equal, and each kind of edge occurs."""
    from shrimp_tpu_torch.core import sw_cs_full
    from shrimp_tpu_torch.dataset import cs_walk_pairs
    for B, R, G in ((CS_B_MAIN // 2, CS_R, CS_G_MAIN),
                    (CS_B_MAIN // 4, 2 * CS_R, 128)):
        a = cs_walk_pairs(rng, B, R, G)
        tb = tuple(torch.from_numpy(a[k]).to(dev) for k in (
            "genome", "qr", "best", "bi", "bj", "bk", "bfrm", "bp",
            "thresh"))
        got = sw_cs_full.cs_traceback(*tb)
        torch.cuda.synchronize()
        want = sw_cs_full.cs_traceback_ref(*tb)
        err = _err(got, want)
        rec["cs_traceback"]["err"] = max(rec["cs_traceback"]["err"], err)
        pk = want[0].cpu().numpy().astype(np.int64)
        walked = pk[:, 4] > 0
        # the alignment's first op (the walk's last step) with its
        # crossover bit: the leading crossover, or one of the walk's own
        first_xo = walked & ((want[1].cpu().numpy()[
            np.arange(B), np.maximum(pk[:, 4] - 1, 0)] & 16) != 0)
        kinds = {"row 0": int((walked & (pk[:, 5] == 0)).sum()),
                 "column 0": int((walked & (pk[:, 6] == 0)).sum()),
                 "a crossover on the first op": int(first_xo.sum()),
                 "bfrm = 0": int((a["bfrm"] == 0).sum()),
                 "score below thresh": int((a["best"] < a["thresh"]).sum()),
                 "walks": int(walked.sum()),
                 "longest walk": int(pk[:, 4].max())}
        print(f"cs_traceback edge walks B={B} R={R} G={G}: max |kernel - "
              f"plain| = {err}; " + ", ".join(
                  f"{k} {v}" for k, v in kinds.items()))
        if min(kinds.values()) == 0:
            raise AssertionError("cs_traceback edge walks: a kind of edge "
                                 "did not occur")


def _check_cs_tb_refuses(dev):
    """The CS traceback's C entry point refuses what its cp.async copies
    cannot take: G = 60 (not a multiple of 8), backpointers 2 bytes off
    a 16-byte boundary, windows 1 byte off a 4-byte one; the wrapper
    raises before it."""
    from shrimp_tpu_torch import _build
    from shrimp_tpu_torch.core import sw_cs_full
    lib = _build.load().lib
    B, R = 64, CS_R
    stream = torch.cuda.current_stream().cuda_stream
    for G, off, goff in ((60, 0, 0), (64, 1, 0), (64, 0, 1)):
        buf = torch.zeros(B * R * 4 * G + 8, dtype=torch.int16, device=dev)
        bp = buf[off:off + B * R * 4 * G].view(B, R, 4, G)
        gbuf = torch.zeros(B * G + 4, dtype=torch.uint8, device=dev)
        g = gbuf[goff:goff + B * G].view(B, G)
        z = torch.zeros(B, dtype=torch.int32, device=dev)
        qr = torch.zeros((B, 4, R), dtype=torch.uint8, device=dev)
        packed = torch.empty((B, 12), dtype=torch.int16, device=dev)
        steps = torch.empty((B, R + G), dtype=torch.int8, device=dev)
        rc = lib.cs_traceback_launch(
            g.data_ptr(), qr.data_ptr(), *[z.data_ptr()] * 5, bp.data_ptr(),
            z.data_ptr(), packed.data_ptr(), steps.data_ptr(), B, G, R,
            stream)
        try:
            sw_cs_full.cs_traceback(g, qr, z, z, z, z, z, bp, z)
            raised = False
        except NotImplementedError:
            raised = True
        print(f"cs_traceback G={G}, bp offset {2 * off} B, window offset "
              f"{goff} B: launch returns cudaError {rc}, the wrapper "
              f"raises: {raised}")
        if rc != 1 or not raised:     # cudaErrorInvalidValue
            raise AssertionError("cs_traceback: an input its copies cannot "
                                 "take was not refused")
    torch.cuda.synchronize()


def check_cs_kernels(dev):
    """Phase 6: the colour-space kernels vs their plain versions."""
    from shrimp_tpu_torch.core import sw_cs_full, sw_vector
    rec = {k: dict(err=0) for k in ("sw_vector_cs", "sw_cs_full",
                                    "cs_traceback")}
    vkw = dict(CS_KW, mismatch=CS_KW["match"] + XOVER)
    rng = np.random.default_rng(20261017)
    for G in (CS_G_MAIN, 2 * CS_G_MAIN):
        _print_launch_config("sw_vector (colour space)", "sw_vector_config",
                             CS_B_MAIN, G, CS_R)
        _print_launch_config("sw_cs_full", "sw_cs_full_config", G)
    for B, R, G in CS_SHAPES[:1] + CS_SHAPES[3:]:
        _print_launch_config("cs_traceback", "cs_traceback_config", B, G, R)
    for B, R, G in CS_SHAPES:
        vn = _cs_vec_pairs(rng, B, G, R)
        v = {k: torch.from_numpy(x).to(dev) for k, x in vn.items()}
        v4 = (v["genome"], v["glen"], v["read"], v["rlen"], v["g_row0"])
        got = sw_vector.sw_vector_batch(*v4, cs_mode=True, **vkw)
        torch.cuda.synchronize()
        want = sw_vector.sw_vector_batch_ref(*v4, cs_mode=True, **vkw)
        err = _err([got], [want])
        rec["sw_vector_cs"]["err"] = max(rec["sw_vector_cs"]["err"], err)
        print(f"sw_vector_cs B={B} G={G} R={R}: max |kernel - plain| = "
              f"{err} (best score {int(want.max())})")
        an = _cs_dp_pairs(rng, B, G, R)
        a = {k: torch.from_numpy(x).to(dev) for k, x in an.items()}
        dp = tuple(a[k] for k in _DP_ORDER)
        for local in (False, True):
            for taboo in (0, 4):
                kw = dict(CS_KW, local_alignment=local,
                          indel_taboo_len=taboo)
                *st, bp = sw_cs_full.sw_full_cs_dp(*dp, **kw)
                torch.cuda.synchronize()
                *st_w, bp_w = sw_cs_full.sw_full_cs_dp_ref(*dp, **kw)
                err = _err([*st, bp], [*st_w, bp_w])
                del bp_w
                rec["sw_cs_full"]["err"] = max(rec["sw_cs_full"]["err"],
                                               err)
                tb = (a["genome"], a["qr"], *st, bp, a["thresh"])
                got = sw_cs_full.cs_traceback(*tb)
                torch.cuda.synchronize()
                want = sw_cs_full.cs_traceback_ref(*tb)
                err_tb = _err(got, want)
                rec["cs_traceback"]["err"] = max(
                    rec["cs_traceback"]["err"], err_tb)
                print(f"sw_cs_full B={B} G={G} R={R} local={local} "
                      f"taboo={taboo}: max |kernel - plain| = {err}; "
                      f"cs_traceback: {err_tb} (aligned rows "
                      f"{int((want[0][:, 0] > 0).sum())}, with "
                      f"crossovers {int((want[0][:, 11] > 0).sum())})")
        # times at the main path's modes: global, taboo 0
        st_bp = sw_cs_full.sw_full_cs_dp(*dp, **CS_KW)
        tb = (a["genome"], a["qr"], *st_bp, a["thresh"])
        times = dict(
            sw_vector_cs=_kernel_times(
                lambda: sw_vector.sw_vector_batch(
                    *v4, cs_mode=True, **vkw),
                lambda: sw_vector.sw_vector_batch_ref(
                    *v4, cs_mode=True, **vkw)),
            sw_cs_full=_kernel_times(
                lambda: sw_cs_full.sw_full_cs_dp(*dp, **CS_KW),
                lambda: sw_cs_full.sw_full_cs_dp_ref(*dp, **CS_KW),
                plain_reps=3),
            cs_traceback=_kernel_times(
                lambda: sw_cs_full.cs_traceback(*tb),
                lambda: sw_cs_full.cs_traceback_ref(*tb)))
        packed = sw_cs_full.cs_traceback(*tb)[0]
        bounds = dict(
            sw_vector_cs=_vector_bound(vn, B, G, R, cs=True),
            sw_cs_full=_bound(
                _cs_dp_bytes(B, R, G), OPS["sw_cs_full"]
                * _band_cells(an, np.minimum(an["rlen"], R)),
                OPS["sw_cs_full"] * B * R * G),
            cs_traceback=_cs_tb_bound(packed, B, R, G))
        for name, (k_ms, ev_ms, p_ms) in times.items():
            b = bounds[name]
            print(f"{name} B={B} G={G} R={R}: kernel {k_ms!r} ms (device; "
                  f"{ev_ms!r} ms a call by CUDA events), plain {p_ms!r} "
                  f"ms, bound {b['bound_ms']!r} ms ({b['bound_by']}; all "
                  f"R x G cells: {b['bound_all_ms']!r} ms)")
            if (B, R, G) == CS_SHAPES[0]:   # the main path's
                rec[name].update(ms=k_ms, plain_ms=p_ms, **b)
        print(f"cs_traceback B={B} G={G} R={R}, the test pairs' global "
              f"walks: {_walks(packed[:, 4][packed[:, 4] > 0])}")
        del a, dp, tb, st_bp, v, v4
        torch.cuda.empty_cache()
    _check_cs_tb_edges(dev, rng, rec)
    _check_cs_tb_refuses(dev)
    for name, r in rec.items():
        if r["err"] != 0:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version (max abs err {r['err']})")
    return rec


def _cs_window_case(rng, planes, n_true, B, G, R, n_reads):
    """Argument rows [B, 12], colour rows, letter layers and crossover
    penalties of a synthetic CS launch on `planes` (colour, colour rc,
    letter, letter rc; the first n_true bases real): windows at both
    ends of both strands, 512 windows whose read follows the band's
    diagonal (one colour a BASE_N), and B // 8 pad rows."""
    from shrimp_tpu_torch.fastpath_cs import cs_layers_batch
    n = len(planes[2])
    k = B - B // 8                     # the rest are pad rows
    a = np.zeros((B, 12), np.int32)
    starts = rng.integers(-5, n + 5, k)
    starts[:64] = rng.integers(-5, 40, 64)            # plane starts
    starts[64:128] = rng.integers(n - 70, n + 5, 64)  # plane ends
    rcf = rng.integers(0, 2, k)
    a[:k, 0], a[:k, 3] = starts, rcf
    a[:k, 1] = rng.integers(1, G + 1, k)
    a[:k, 2] = rng.integers(0, n_reads, k)
    a[:k, 4] = R
    a[:k, 5] = rng.integers(-8, G // 2, k)
    a[:k, 6] = rng.integers(-8, R, k)
    a[:k, 7] = rng.integers(0, 24, k)
    a[:k, 8] = rng.integers(0, 30, k)
    a[:k, 9] = rcf & rng.integers(0, 2, k)
    a[:k, 10] = rng.integers(0, 150, k)
    initbp = rng.integers(0, 4, n_reads)
    colours = rng.integers(0, 4, (n_reads, R)).astype(np.uint8)
    # plant reads that follow the band's diagonal in 512 windows
    for q in range(128, 640):
        st = int(rng.integers(0, n_true - G))
        a[q, [0, 1, 2, 5, 6, 7, 8]] = (st, G, q, 0, 0, R, 8)
        plane = planes[3] if a[q, 3] else planes[2]
        lets = np.concatenate([[initbp[q]], plane[st:st + R]])
        colours[q] = lets[:-1] ^ lets[1:]
        colours[q, rng.integers(0, R)] = BASE_N
    a[:k, 11] = initbp[a[:k, 2]]
    a[k:, [1, 4, 7, 8, 10]] = 1                       # pad rows
    qr = cs_layers_batch(colours, initbp)
    xov = rng.integers(2 * XOVER, 0, (n_reads, R)).astype(np.int32)
    return a, colours, qr, xov


def check_cs_packed_step(dev):
    """Phase 7: the fused CS step on CUDA vs the same call on CPU, on a
    synthetic plane with windows at both ends of both strands."""
    from shrimp_tpu_torch.core.sw import cat_word_plane
    from shrimp_tpu_torch.core.sw_cs import sw_vec_cs_full_from_index
    from shrimp_tpu_torch.mapper import Mapper
    rng = np.random.default_rng(8)
    n_true, G, R, B, n_reads = 4_000_000, CS_G_MAIN, CS_R, CS_B_MAIN, 2048
    fw = rng.integers(0, 4, n_true).astype(np.uint8)
    rc = (3 - fw[::-1]).astype(np.uint8)
    # lstocs of letters 0..3 is their xor
    cfw = np.concatenate([[0], fw[:-1] ^ fw[1:]]).astype(np.uint8)
    crc = np.concatenate([[0], rc[:-1] ^ rc[1:]]).astype(np.uint8)
    planes = [Mapper._pad_plane(p) for p in (cfw, crc, fw, rc)]
    cats = [cat_word_plane(*planes[:2]), cat_word_plane(*planes[2:])]
    a, colours, qr, xov = _cs_window_case(rng, planes, n_true, B, G, R,
                                          n_reads)
    args = (*planes, a, colours, qr, xov, *cats)
    kw = dict(CS_KW, G=G, xover=XOVER)
    got, want = ([x.cpu().numpy() for x in sw_vec_cs_full_from_index(
        *(torch.from_numpy(x).to(d) for x in args), **kw)]
        for d in (dev, torch.device("cpu")))
    same = all(np.array_equal(x, w) for x, w in zip(got, want))
    print(f"CS packed step B={B} G={G} R={R}: CUDA == CPU (vec, packed, "
          f"steps): {same} (vec > 100: {int((want[0] > 100).sum())}, "
          f"aligned: {int((want[1][:, 0] > 0).sum())})")
    if not same:
        raise AssertionError("CS packed step: CUDA and CPU outputs differ")


def _cs_stream(m, reads):
    from shrimp_tpu_torch import fastpath_cs
    return fastpath_cs.map_unpaired_cs_sam_stream(m, reads)


def run_cs_slice(dev, counters, test_bound):
    """Phase 8: bench_all.py's ecoli-cs workload through the port's CS
    entry point."""
    from shrimp_tpu_torch.dataset import ecoli_cs_config
    from shrimp_tpu_torch.mapper import Mapper
    t0 = time.perf_counter()
    idx, reads = _dataset("ecoli_unpaired_cs", N_READS)
    print(f"CS dataset + index: {time.perf_counter() - t0:.3f} s "
          f"({idx.total_len} bp, {len(reads)} reads)")

    def mapper(device):
        return Mapper(idx, ecoli_cs_config(), device).upload_planes()

    _map(mapper(dev), reads[:2 * B_CHUNK], _cs_stream)      # warm-up
    m = mapper(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    for c in counters.values():
        c.reset()
    batches, secs = _map_batches(m, reads, _cs_stream)
    launches = {k: c.n for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    sam = b"".join(batches)
    print(f"CS slice on {dev}: {len(reads)} reads in {secs!r} s = "
          f"{len(reads) / secs!r} reads/s; launches {launches}; windows "
          f"{m.stats.vec_invocs}; peak device memory {peak} bytes")
    print("CS stage seconds (summed over lanes): " + ", ".join(
        f"{k} {v!r}" for k, v in m.stats.stage_secs.items()))
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{k}: not launched by the CS path")
    lines = sam.split(b"\n")[:-1]
    if not lines or any(len(ln.split(b"\t")) < 11 for ln in lines):
        raise AssertionError("CS slice: malformed SAM")
    names = {f[0] for f in (ln.split(b"\t", 2) for ln in lines)
             if not int(f[1]) & 4}
    mapped = len(names) / len(reads)
    print(f"CS SAM: {len(lines)} records, {mapped!r} of reads mapped")
    if (m.stats.reads != len(reads) or m.stats.reads_mapped != len(names)
            or mapped < 0.95):
        raise AssertionError("CS slice: reads lost, miscounted or mostly "
                             "unmapped")
    print("CS device busy share (profiled run on the first 32768 reads): "
          + _device_busy_share(mapper(dev), reads[:4 * B_CHUNK],
                               _cs_stream))
    from shrimp_tpu_torch.core import sw_cs
    _print_flow_bound("sw_cs_full", m, reads, _cs_stream, sw_cs,
                      "sw_full_cs_dp", test_bound, _cs_dp_bytes, True)
    # the stream's batches hold auto_batch_size reads each
    from shrimp_tpu_torch.fastpath import auto_batch_size
    n_cpu = CS_CPU_READS // auto_batch_size(m) * auto_batch_size(m)
    sam_cpu, secs_cpu = _map(mapper("cpu"), reads[:n_cpu], _cs_stream)
    want = b"".join(batches[:n_cpu // auto_batch_size(m)])
    print(f"CS slice on cpu (plain versions), first {n_cpu} reads: "
          f"{secs_cpu!r} s; SAM identical to the CUDA run's: "
          f"{sam_cpu == want}")
    if sam_cpu != want:
        raise AssertionError("CS slice: CUDA and CPU SAM bytes differ")
    return launches


def _long_pairs(rng, B, G, R):
    """Long-read pairs: in half of them the read is copied from its
    window (4 substitutions; a 1-3 bp insertion or deletion in every
    other one) with the band along its diagonal, as filter 1 gives
    them; random bands and reads elsewhere; BASE_N cells; revcmpl rows;
    the main path's pad rows (glen = alen = awid = 1) at the front, then
    B / 32 pairs at the edge bands."""
    g = rng.integers(0, 4, (B, G)).astype(np.uint8)
    r = rng.integers(0, 4, (B, R)).astype(np.uint8)
    a = dict(genome=g, glen=rng.integers(R, G + 1, B), read=r,
             rlen=rng.integers(R - 8, R + 1, B),
             ax=rng.integers(-4, G - R, B), ay=rng.integers(-4, 20, B),
             alen=rng.integers(1, R, B), awid=rng.integers(3, 30, B),
             revcmpl=rng.integers(0, 2, B))
    for k in range(1, B, 2):
        o = int(rng.integers(0, G - R - 3))
        r[k] = g[k, o:o + R]
        r[k, rng.integers(0, R, 4)] = rng.integers(0, 4, 4)
        if k % 4 == 1:
            d = int(rng.integers(1, 4))
            cut = int(rng.integers(20, R - 20))
            if k % 8 == 1:      # deletion from the read
                r[k, cut:] = g[k, o + cut + d:o + R + d]
            else:               # insertion into the read
                r[k, cut + d:] = g[k, o + cut:o + R - d]
        a["glen"][k], a["ax"][k], a["ay"][k] = G, o, 0
        a["alen"][k], a["awid"][k] = R // 2, int(rng.integers(8, 30))
    r[rng.random((B, R)) < 0.005] = BASE_N
    g[rng.random((B, G)) < 0.005] = BASE_N
    for k in ("glen", "alen", "awid"):
        a[k][:64] = 1
    for k in ("ax", "ay", "revcmpl"):
        a[k][:64] = 0
    _with_edge_bands(a, rng, 64, B // 32, G, R)
    return {k: v.astype(np.int32) if v.dtype != np.uint8 else v
            for k, v in a.items()}


def _with_long_gaps(a, rng, lo, n):
    """Rows [lo, lo + n) of the long pairs `a` take the reads and band
    geometries of dataset.long_gaps: one gap of 33 to 120 columns each,
    so that the traceback's walks cross several tiles and leave them
    through their left side too."""
    from shrimp_tpu_torch.dataset import long_gaps
    R = a["read"].shape[1]
    for k, v in long_gaps(rng, a["genome"][lo:lo + n], R).items():
        a[k][lo:lo + n] = v


def check_long_kernels(dev):
    """Phase 9: the long-read kernels vs their plain versions on the
    card, at the 250 bp and the 1000 bp launch shapes."""
    from shrimp_tpu_torch.core import sw_full, sw_vector
    rec = {k: dict(err=0) for k in ("sw_vector_g352", "sw_full_bp",
                                    "ls_traceback")}
    rng = np.random.default_rng(20261018)
    for B, R, G in LONG_SHAPES:
        _print_launch_config("sw_full_bp", "sw_full_bp_config", B, G, R)
        _print_launch_config("ls_traceback", "ls_traceback_config", B, G, R)
    for B, R, G in LONG_SHAPES:
        a = _long_pairs(rng, B, G, R)
        _with_long_gaps(a, rng, B // 2, B // 8)
        t = {k: torch.from_numpy(v).to(dev) for k, v in a.items()}
        v4 = (t["genome"], t["glen"], t["read"], t["rlen"])
        full = tuple(t[k] for k in ("genome", "glen", "read", "rlen", "ax",
                                    "ay", "alen", "awid", "revcmpl"))
        got = sw_vector.sw_vector_batch(*v4, **KW)
        torch.cuda.synchronize()
        err = _err([got], [sw_vector.sw_vector_batch_ref(*v4, **KW)])
        rec["sw_vector_g352"]["err"] = max(rec["sw_vector_g352"]["err"], err)
        print(f"sw_vector B={B} G={G} R={R}: max |kernel - plain| = {err}")
        for local in (False, True):
            got = sw_full.sw_full_bp(*full, local_alignment=local, **KW)
            torch.cuda.synchronize()
            want = sw_full.sw_full_bp_ref(*full, local_alignment=local, **KW)
            err = _err(got, want)
            del got
            rec["sw_full_bp"]["err"] = max(rec["sw_full_bp"]["err"], err)
            tb = (t["genome"], t["read"], *want)
            got = sw_full.traceback_pack(*tb)
            torch.cuda.synchronize()
            want_tb = sw_full.traceback_pack_ref(*tb)
            err_tb = _err(got, want_tb)
            rec["ls_traceback"]["err"] = max(rec["ls_traceback"]["err"],
                                             err_tb)
            pk = want_tb[0]
            if not local:
                steps = pk[:, 3]
            print(f"sw_full_bp B={B} G={G} R={R} local={local}: max |kernel "
                  f"- plain| = {err}; ls_traceback: {err_tb} (rows with "
                  f"score > 0: {int((pk[:, 0] > 0).sum())}, with indels "
                  f"{int(((pk[:, 8] + pk[:, 9]) > 0).sum())}, with a gap "
                  f"over 32: {int(((pk[:, 8] > 32) | (pk[:, 9] > 32)).sum())}"
                  f", walk steps {int(pk[:, 3].sum())})")
            del want, tb
        # times at the main path's mode: global
        want = sw_full.sw_full_bp(*full, **KW)
        tb = (t["genome"], t["read"], *want)
        times = dict(
            sw_vector_g352=_kernel_times(
                lambda: sw_vector.sw_vector_batch(*v4, **KW),
                lambda: sw_vector.sw_vector_batch_ref(*v4, **KW),
                plain_reps=3),
            sw_full_bp=_kernel_times(
                lambda: sw_full.sw_full_bp(*full, **KW),
                lambda: sw_full.sw_full_bp_ref(*full, **KW), reps=10,
                plain_reps=2),
            ls_traceback=_kernel_times(
                lambda: sw_full.traceback_pack(*tb),
                lambda: sw_full.traceback_pack_ref(*tb), reps=10,
                plain_reps=2))
        del want, tb
        bounds = dict(
            sw_vector_g352=_vector_bound(a, B, G, R),
            sw_full_bp=_bound(
                _bp_bytes(B, R, G),
                OPS["sw_full_bp"] * _band_cells(a, np.full(B, R)),
                OPS["sw_full_bp"] * B * R * G),
            ls_traceback=_tb_bound(steps, B, R, G))
        for name, (k_ms, ev_ms, p_ms) in times.items():
            print(f"{name} B={B} G={G} R={R}: kernel {k_ms!r} ms (device; "
                  f"{ev_ms!r} ms a call by CUDA events), plain "
                  f"{p_ms!r} ms, bound {bounds[name]['bound_ms']!r} ms "
                  f"({bounds[name]['bound_by']}; all R x G cells: "
                  f"{bounds[name]['bound_all_ms']!r} ms)")
            if (B, R, G) == LONG_SHAPES[0]:     # the main path's shape
                rec[name].update(ms=k_ms, plain_ms=p_ms, **bounds[name])
        walks = _walks(steps)
        print(f"ls_traceback B={B} G={G} R={R}, the test pairs' global "
              f"walks: {walks}")
        if (B, R, G) == LONG_SHAPES[0]:
            rec["ls_traceback"]["walks"] = walks
        del t, full, v4
        torch.cuda.empty_cache()
    # the full SW's byte stores of a backpointer row: G not a multiple of
    # 16 (the flows' windows are multiples of 32)
    B, R, G = 256, 256, 360
    t = {k: torch.from_numpy(v).to(dev)
         for k, v in _long_pairs(rng, B, G, R).items()}
    full = tuple(t[k] for k in ("genome", "glen", "read", "rlen", "ax", "ay",
                                "alen", "awid", "revcmpl"))
    for local in (False, True):
        got = sw_full.sw_full_bp(*full, local_alignment=local, **KW)
        torch.cuda.synchronize()
        err = _err(got, sw_full.sw_full_bp_ref(*full, local_alignment=local,
                                               **KW))
        rec["sw_full_bp"]["err"] = max(rec["sw_full_bp"]["err"], err)
        print(f"sw_full_bp B={B} G={G} R={R} local={local}: max |kernel - "
              f"plain| = {err}")
    del t, full, got
    _check_tb_refuses(dev)
    for name, r in rec.items():
        if r["err"] != 0:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version (max abs err {r['err']})")
    return rec


def _check_tb_refuses(dev):
    """The traceback's C entry point refuses what its 16-byte tile loads
    cannot take: G = 360 (not a multiple of 16), and backpointers one
    byte off a 16-byte boundary; the wrapper raises before it."""
    from shrimp_tpu_torch import _build
    from shrimp_tpu_torch.core import sw_full
    lib = _build.load().lib
    B, R = 64, 256
    stream = torch.cuda.current_stream().cuda_stream
    for G, off in ((360, 0), (352, 1)):
        buf = torch.zeros(B * R * G + 16, dtype=torch.uint8, device=dev)
        bp = buf[off:off + B * R * G].view(B, R, G)
        z = torch.zeros(B, dtype=torch.int32, device=dev)
        g = torch.zeros((B, G), dtype=torch.uint8, device=dev)
        r = torch.zeros((B, R), dtype=torch.uint8, device=dev)
        packed = torch.empty((B, 10), dtype=torch.int32, device=dev)
        ops = torch.empty((B, (R + G + 3) // 4), dtype=torch.uint8,
                          device=dev)
        rc = lib.ls_traceback_launch(
            g.data_ptr(), r.data_ptr(), z.data_ptr(), z.data_ptr(),
            z.data_ptr(), z.data_ptr(), bp.data_ptr(), packed.data_ptr(),
            ops.data_ptr(), B, G, R, stream)
        try:
            sw_full.traceback_pack(g, r, z, z, z, z, bp)
            raised = False
        except NotImplementedError:
            raised = True
        print(f"ls_traceback G={G}, bp offset {off} B: launch returns "
              f"cudaError {rc}, the wrapper raises: {raised}")
        if rc != 1 or not raised:     # cudaErrorInvalidValue
            raise AssertionError("ls_traceback: an input its tile loads "
                                 "cannot take was not refused")
    torch.cuda.synchronize()


def check_tb_packed_step(dev):
    """Phase 10: the fused traceback step on CUDA vs the same call on
    CPU, on a synthetic plane with windows at both ends of both strands
    and long reads planted along the band's diagonal."""
    from shrimp_tpu_torch.core.sw import cat_word_plane, sw_vec_full_tb_packed
    from shrimp_tpu_torch.fastpath import _pack_args4, _pack_rtab
    from shrimp_tpu_torch.mapper import Mapper
    rng = np.random.default_rng(9)
    n_true, G, L, R, B, n_reads = 4_000_000, 352, 250, 256, 2048, 1024
    k = B - B // 8                     # the rest are pad rows
    fp = Mapper._pad_plane(rng.integers(0, 4, n_true).astype(np.uint8))
    rp = Mapper._pad_plane(rng.integers(0, 4, n_true).astype(np.uint8))
    n = len(fp)
    cat = cat_word_plane(fp, rp)
    starts = rng.integers(-5, n + 5, k)
    starts[:64] = rng.integers(-5, 40, 64)            # plane starts
    starts[64:128] = rng.integers(n - G - 8, n + 5, 64)   # plane ends
    glen = rng.integers(1, G + 1, k)
    ri = rng.integers(0, n_reads, k)
    rc = rng.integers(0, 2, k)
    rc[:128:2] = 1
    rx = rng.integers(-8, G // 2, k)
    ry = rng.integers(-8, L, k)
    rl = rng.integers(1, 40, k)
    rw = rng.integers(1, 30, k)
    rev = rc & rng.integers(0, 2, k)
    rtab = np.full((n_reads, R), 254, np.uint8)
    rtab[:, :L] = rng.integers(0, 4, (n_reads, L))
    # plant reads that align along the band's diagonal in 768 windows,
    # every third with a 2-base insertion
    for q in range(128, 896):
        r = q - 128
        ri[q], glen[q], rx[q], ry[q], rl[q], rw[q] = r, G, 20, 0, L // 2, 12
        starts[q] = rng.integers(0, n_true - G)
        plane = rp if rc[q] else fp
        rtab[r, :L] = plane[starts[q] + 20:starts[q] + 20 + L]
        rtab[r, rng.integers(0, L, 3)] = rng.integers(0, 4, 3)
        if r % 3 == 0:
            cut = int(rng.integers(30, L - 30))
            rtab[r, cut + 2:L] = rtab[r, cut:L - 2].copy()
    args = _pack_args4(B, k, starts, glen, ri, rc, rx, ry, rl, rw, rev)
    got, want = ([x.cpu().numpy() for x in sw_vec_full_tb_packed(
        *(torch.from_numpy(x).to(d) for x in (fp, rp, args,
                                              _pack_rtab(rtab), cat)),
        G=G, L=L, **KW)] for d in (dev, torch.device("cpu")))
    same = all(np.array_equal(x, w) for x, w in zip(got, want))
    print(f"traceback step B={B} G={G} L={L}: CUDA == CPU (vec, packed, "
          f"ops): {same} (aligned: {int((want[1][:, 0] > 0).sum())}, with "
          f"indels: {int(((want[1][:, 8] + want[1][:, 9]) > 0).sum())})")
    if not same:
        raise AssertionError("traceback step: CUDA and CPU outputs differ")


def run_long_slice(dev, counters, test_bound, test_walks):
    """Phase 11: 250 bp reads through the port's entry point, which takes
    the traceback flow."""
    t0 = time.perf_counter()
    idx, reads = _dataset("ecoli_unpaired_ls_long", N_READS)
    print(f"long dataset + index: {time.perf_counter() - t0:.3f} s "
          f"({idx.total_len} bp, {len(reads)} reads of "
          f"{len(reads[0].seq)} bp)")
    _map(_mapper(idx, dev), reads[:2 * B_CHUNK])      # warm-up
    m = _mapper(idx, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    for c in counters.values():
        c.reset()
    sam, secs = _map(m, reads)
    launches = {k: c.n for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"long slice on {dev}: {len(reads)} reads in {secs!r} s = "
          f"{len(reads) / secs!r} reads/s; launches {launches}; windows "
          f"{m.stats.vec_invocs}; peak device memory {peak} bytes")
    print("long stage seconds (summed over lanes): " + ", ".join(
        f"{k} {v!r}" for k, v in m.stats.stage_secs.items()))
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{k}: not launched by the long-read path")
    lines = sam.split(b"\n")[:-1]
    if not lines or any(len(ln.split(b"\t")) < 11 for ln in lines):
        raise AssertionError("long slice: malformed SAM")
    names = {f[0] for f in (ln.split(b"\t", 2) for ln in lines)
             if not int(f[1]) & 4}
    mapped = len(names) / len(reads)
    indel = sum(1 for ln in lines
                if b"I" in ln.split(b"\t", 6)[5]
                or b"D" in ln.split(b"\t", 6)[5])
    print(f"long SAM: {len(lines)} records, {mapped!r} of reads mapped, "
          f"{indel} records with an indel")
    if (m.stats.reads != len(reads) or m.stats.reads_mapped != len(names)
            or mapped < 0.95 or indel == 0):
        raise AssertionError("long slice: reads lost, miscounted, mostly "
                             "unmapped or no indel alignment")
    print("long device busy share (profiled run on the first 32768 reads): "
          + _device_busy_share(_mapper(idx, dev), reads[:4 * B_CHUNK]))
    from shrimp_tpu_torch.core import sw
    _print_flow_bound("sw_full_bp", m, reads, _ls_stream, sw, "sw_full_bp",
                      test_bound, _bp_bytes, False)
    # the traceback on the flow's own first launch: its walks, time and
    # bound
    from shrimp_tpu_torch.core import sw_full
    tb = _first_call(m, reads, _ls_stream, sw, "traceback_pack")
    B, R, G = tb[-1].shape
    steps = sw_full.traceback_pack(*tb)[0][:, 3]
    b = _tb_bound(steps, B, R, G)
    k_ms = _device_ms(lambda: sw_full.traceback_pack(*tb), 10)
    print(f"ls_traceback on the flow's first launch (B, R, G) = ({B}, {R}, "
          f"{G}): kernel {k_ms!r} ms (device), bound {b['bound_ms']!r} ms "
          f"({b['bound_by']}); walks: {_walks(steps)}; the test pairs' "
          f"walks: {test_walks}")
    del tb, steps
    first = reads[:LONG_CPU_READS]

    def stream(mm, rr):
        from shrimp_tpu_torch import fastpath
        return fastpath.map_unpaired_sam_stream(mm, rr,
                                                batch_size=LONG_CPU_READS)
    sam_gpu, _ = _map(_mapper(idx, dev), first, stream)
    sam_cpu, secs_cpu = _map(_mapper(idx, "cpu"), first, stream)
    # records come in input order, so the full run's SAM starts with
    # the first reads' records
    print(f"long slice on cpu (plain versions), first {len(first)} reads: "
          f"{secs_cpu!r} s; SAM identical to the CUDA run's: "
          f"{sam_cpu == sam_gpu}; a prefix of the full run's SAM: "
          f"{sam.startswith(sam_gpu)}")
    if sam_cpu != sam_gpu or not sam.startswith(sam_gpu):
        raise AssertionError("long slice: CUDA and CPU SAM bytes differ")
    return launches, dict(idx=idx, reads=first, fused_sam=sam_gpu)


class _Dispatches:
    """While active, records each batch's device dispatch: (windows,
    reads, took two phases, rows of each vec-only launch). `cs` picks
    the colour-space dispatch."""

    def __init__(self, cs: bool):
        from shrimp_tpu_torch import fastpath, fastpath_cs
        self.owner, self.name = ((fastpath_cs.FastCS, "_fused_dispatch_cs")
                                 if cs else (fastpath, "_fused_dispatch"))
        self.log = []

    def __enter__(self):
        orig = self.orig = getattr(self.owner, self.name)
        log = self.log

        def record(*args, **kw):
            out = orig(*args, **kw)
            futures, win = out[0], out[1]
            tp = "two_phase" in win
            log.append((int(args[1].n), kw.get("n_reads"), tp,
                        [res[0].shape[0] for _, _, res in futures]
                        if tp else []))
            return out
        setattr(self.owner, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)

    def summary(self) -> str:
        tp = sum(1 for x in self.log if x[2])
        rows = Counter(r for x in self.log for r in x[3])
        return (f"{tp} of {len(self.log)} batches took two phases; "
                f"vec-only launches (rows: count): {dict(sorted(rows.items()))}")

    def all_two_phase(self) -> bool:
        return bool(self.log) and all(x[2] for x in self.log)


class _Gate:
    """Sets the two-phase threshold (windows per read) of the LS or CS
    dispatch while active."""

    def __init__(self, cs: bool, wpr: int):
        from shrimp_tpu_torch import fastpath, fastpath_cs
        self.mod, self.name = ((fastpath_cs, "CS_TWO_PHASE_WPR") if cs
                               else (fastpath, "LS_TWO_PHASE_WPR"))
        self.wpr = wpr

    def __enter__(self):
        self.prev = getattr(self.mod, self.name)
        setattr(self.mod, self.name, self.wpr)

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.prev)


def _with_batch(stream, batch_size):
    return lambda m, reads: stream(m, reads, batch_size=batch_size)


def _peak_gib(dev) -> str:
    return f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30!r} GiB"


def _band_geometry(args) -> dict:
    """The band geometry (numpy glen, rlen, ax, ay, alen, awid) of a DP
    wrapper's arguments (genome, glen, read, rlen, ax, ay, alen, awid,
    ...)."""
    return {k: args[i].cpu().numpy() for k, i in (
        ("glen", 1), ("rlen", 3), ("ax", 4), ("ay", 5), ("alen", 6),
        ("awid", 7))}


# the bounds of one launch from its wrapper's arguments and outputs:
# ((B, R, G), _bound's dict)

def _vec_launch_bound(args, out, cs):
    (B, G), R = args[0].shape, args[2].shape[1]
    a = dict(glen=args[1].cpu().numpy(), rlen=args[3].cpu().numpy())
    return (B, R, G), _vector_bound(a, B, G, R, cs)


def _stats_launch_bound(args, out, cs):
    (B, G), R = args[0].shape, args[2].shape[1]
    a = _band_geometry(args)
    return (B, R, G), _bound(
        _stats_bytes(B, R, G),
        OPS["sw_full_stats"] * _band_cells(a, np.minimum(a["rlen"], R)),
        OPS["sw_full_stats"] * B * R * G)


def _cs_dp_launch_bound(args, out, cs):
    (B, G), R = args[0].shape, args[2].shape[-1]
    a = _band_geometry(args)
    return (B, R, G), _bound(
        _cs_dp_bytes(B, R, G),
        OPS["sw_cs_full"] * _band_cells(a, np.minimum(a["rlen"], R)),
        OPS["sw_cs_full"] * B * R * G)


def _cs_tb_launch_bound(args, out, cs):
    (B, G), R = args[0].shape, args[1].shape[-1]
    return (B, R, G), _cs_tb_bound(out[0], B, R, G)


def _check_flow_launch(name, m, reads, stream, module, fn, kernel, plain,
                       bound, cs=False, plain_reps=3):
    """A kernel against its plain version on the flow's own first launch
    of it (the first call one batch makes to the wrapper `module.<fn>`),
    with its device time, the plain version's time and its bound there
    (`bound(args, out, cs)` -> ((B, R, G), bound))."""
    args, kw = _first_call(m, reads, stream, module, fn, with_kw=True)
    return _check_captured(name, args, kw, kernel, plain, bound, cs,
                           plain_reps)


def _check_captured(name, args, kw, kernel, plain, bound, cs=False,
                    plain_reps=3, what="the flow's first launch"):
    """A kernel against its plain version on captured wrapper arguments
    `args`, `kw`: bit-equal, with its device time, the plain version's
    time and its bound there."""
    got = kernel(*args, **kw)
    torch.cuda.synchronize()
    want = plain(*args, **kw)
    err = (_err(got, want) if isinstance(got, tuple)
           else _err([got], [want]))
    k_ms = _device_ms(lambda: kernel(*args, **kw), 10)
    p_ms = _time_ms(lambda: plain(*args, **kw), plain_reps)
    (B, R, G), b = bound(args, got, cs)
    print(f"{name} on {what} (B, R, G) = ({B}, {R}, {G}): "
          f"max |kernel - plain| = {err}; kernel {k_ms!r} ms (device), "
          f"plain {p_ms!r} ms, bound {b['bound_ms']!r} ms ({b['bound_by']}; "
          f"all R x G cells {b['bound_all_ms']!r} ms)")
    if err != 0:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version on {what} ({err})")
    del args, got, want
    torch.cuda.empty_cache()
    return dict(err=err, ms=k_ms, plain_ms=p_ms, shape=(B, R, G), **b)


def run_dense_slice(title, dev, counters, mapper, reads, stream, cs):
    """Phases 12, 13, 15 and 18: a stream at hg-like candidate density. The
    gate-off card run of the first batch (which also warms the
    allocator), the timed two-phase run of every read with the launch
    counts set to 0 just before it, then the SAM checks."""
    from shrimp_tpu_torch.fastpath import auto_batch_size
    m = mapper(dev)
    bs = auto_batch_size(m)
    if bs != HG_GATE_OFF_READS:
        raise AssertionError(f"{title}: batches of {bs} reads, not "
                             f"{HG_GATE_OFF_READS}")
    with _Gate(cs, GATE_OFF), _Dispatches(cs) as off:
        sam_off, secs_off = _map(mapper(dev), reads[:HG_GATE_OFF_READS],
                                 stream)
    if off.log[0][2]:
        raise AssertionError(f"{title}: the gate-off run took two phases")
    torch.cuda.reset_peak_memory_stats(dev)
    for c in counters.values():
        c.reset()
    from shrimp_tpu_torch import fastpath
    with _Dispatches(cs) as disp, \
            _Spy([(fastpath, "_paired_render")]) as renders:
        batches, secs = _map_batches(m, reads, stream)
    launches = {k: c.n for k, c in counters.items()}
    st = m.stats
    # a select-then-full batch renders once, then once a rescue round
    # and once more for the all-rows net
    rescues = (f"; paired renders {renders.n} over {len(disp.log)} "
               f"batches: {renders.n - len(disp.log)} rescue rounds and "
               "nets" if renders.n else "")
    print(f"{title} on {dev}: {len(reads)} reads in {secs!r} s = "
          f"{len(reads) / secs!r} reads/s; list cutoff {m.cutoff}; "
          f"{st.vec_invocs / st.reads!r} windows per read; "
          f"{disp.summary()}; phase-B rows {st.full_invocs} = "
          f"{st.full_invocs / st.reads!r} per read; launches {launches}; "
          f"peak device memory {_peak_gib(dev)}{rescues}")
    print(f"{title} stage seconds (summed over lanes): " + ", ".join(
        f"{k} {v!r}" for k, v in st.stage_secs.items()))
    print(f"{title} gate-off card run of the first {HG_GATE_OFF_READS} "
          f"reads (fused dispatch): {secs_off!r} s")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{k}: not launched by the {title} path")
    if not disp.all_two_phase():
        raise AssertionError(f"{title}: not every batch took two phases")
    if st.vec_invocs < 8 * st.reads or st.reads != len(reads):
        raise AssertionError(f"{title}: under 8 windows per read, or reads "
                             "lost")
    sam = b"".join(batches)
    lines = sam.split(b"\n")[:-1]
    if not lines or any(len(ln.split(b"\t")) < 11 for ln in lines):
        raise AssertionError(f"{title}: malformed SAM")
    mapped = st.reads_mapped / st.reads
    print(f"{title} SAM: {len(lines)} records, {mapped!r} of reads mapped")
    if mapped < 0.8:
        raise AssertionError(f"{title}: mostly unmapped")
    same_off = batches[0] == sam_off
    print(f"{title}: the first {HG_GATE_OFF_READS} reads' SAM equals the "
          f"gate-off card run's: {same_off}")
    if not same_off:
        raise AssertionError(f"{title}: two-phase and fused SAM differ")
    print(f"{title} device busy share (profiled run on the first "
          f"{2 * bs} reads): "
          + _device_busy_share(mapper(dev), reads[:2 * bs], stream))
    first = reads[:HG_CPU_READS]
    small = _with_batch(stream, HG_CPU_READS)
    with _Dispatches(cs) as d_gpu:
        sam_gpu, _ = _map(mapper(dev), first, small)
    with _Dispatches(cs) as d_cpu:
        sam_cpu, secs_cpu = _map(mapper("cpu"), first, small)
    same = sam_cpu == sam_gpu and sam.startswith(sam_gpu)
    print(f"{title} on cpu (plain versions), first {HG_CPU_READS} reads: "
          f"{secs_cpu!r} s, {d_cpu.summary()}; SAM identical to the CUDA "
          f"run's and a prefix of the full run's: {same}")
    if not (same and d_gpu.all_two_phase() and d_cpu.all_two_phase()):
        raise AssertionError(f"{title}: CUDA and CPU SAM bytes differ")
    return launches


def _hg_mapper(idx, cfg):
    from shrimp_tpu_torch.mapper import Mapper
    from shrimp_tpu_torch.paired import PairedMapper
    cls = Mapper if cfg.pair_mode == "none" else PairedMapper
    return lambda device: cls(idx, cfg, device).upload_planes()


@functools.lru_cache(maxsize=None)
def _hg_ls():
    """(codes, LS index) of the hg-like bin of HG_BIN_LEN bases, made
    once a run: phase 21 maps phase 12's reads again."""
    from shrimp_tpu_torch import dataset
    t0 = time.perf_counter()
    codes = dataset.hg_bin(HG_BIN_LEN)
    t1 = time.perf_counter()
    idx = dataset.hg_index(codes)
    print(f"hg-like bin: {HG_BIN_LEN} bases generated in "
          f"{t1 - t0!r} s, LS index in {time.perf_counter() - t1!r} s")
    return codes, idx


def run_hg_slices(dev, hg):
    """Phases 12, 13, 15 and 18 on one hg-like bin (13 and 18 share its
    CS index): returns the launches of each phase's kernels, the vector
    SW's records on each flow's first vec-only launch and the CS paired
    flow's phase-B records."""
    from shrimp_tpu_torch import constants as C
    from shrimp_tpu_torch import dataset, fastpath, fastpath_cs
    from shrimp_tpu_torch.config import MapperConfig
    from shrimp_tpu_torch.core import sw, sw_cs, sw_cs_full, sw_full
    from shrimp_tpu_torch.core import sw_vector
    codes, idx = _hg_ls()
    print(f"reduced: bench_hg.py maps 4 bins of 750 Mbp (3 Gbp); here bin "
          f"0 alone, cut to {HG_BIN_LEN} bases, and {HG_READS} reads "
          f"(bench_hg.py's default)")
    launches, rec = {}, {}
    if 12 in hg:
        reads = dataset.hg_reads(codes, HG_READS)
        mk = _hg_mapper(idx, MapperConfig())
        launches.update(sw_vector_hg=run_dense_slice(
            "hg LS", dev, {"sw_vector": sw_vector.LAUNCHES,
                           "sw_full_stats": sw_full.LAUNCHES},
            mk, reads, fastpath.map_unpaired_sam_stream, False)[
                "sw_vector"])
        print(f"hg LS peak device memory over the phase: {_peak_gib(dev)}")
        flow = (mk(dev), reads, fastpath.map_unpaired_sam_stream, sw)
        rec["sw_vector_hg"] = _check_flow_launch(
            "sw_vector_hg", *flow, "sw_vector_batch",
            sw_vector.sw_vector_batch, sw_vector.sw_vector_batch_ref,
            _vec_launch_bound, plain_reps=2)
        # phase B: the stats kernel on the pass-1 survivors
        _check_flow_launch("sw_full_stats (phase B)", *flow, "sw_full_stats",
                           sw_full.sw_full_stats, sw_full.sw_full_stats_ref,
                           _stats_launch_bound)
    if 15 in hg:
        pairs = dataset.hg_pairs(codes, HG_READS)
        mk = _hg_mapper(idx, MapperConfig(pair_mode="opp-in",
                                          min_insert_size=0,
                                          max_insert_size=1000))
        run_dense_slice(
            "hg LS paired", dev, {"sw_vector": sw_vector.LAUNCHES,
                                  "sw_full_stats": sw_full.LAUNCHES},
            mk, pairs, fastpath.map_paired_sam_stream, False)
    del idx
    if hg & {13, 18}:
        t0 = time.perf_counter()
        cidx = dataset.hg_index(codes, C.MODE_COLOUR_SPACE)
        print(f"hg-like bin: CS index in {time.perf_counter() - t0!r} s")
    cs_counters = {"sw_vector_cs": sw_vector.CS_LAUNCHES,
                   "sw_cs_full": sw_cs_full.DP_LAUNCHES,
                   "cs_traceback": sw_cs_full.TB_LAUNCHES}
    if 13 in hg:
        reads = dataset.hg_reads(codes, HG_READS, C.MODE_COLOUR_SPACE)
        mk = _hg_mapper(cidx, MapperConfig(mode=C.MODE_COLOUR_SPACE))
        launches.update(sw_vector_cs_hg=run_dense_slice(
            "hg CS", dev, cs_counters, mk, reads,
            fastpath_cs.map_unpaired_cs_sam_stream, True)["sw_vector_cs"])
        flow = (mk(dev), reads, fastpath_cs.map_unpaired_cs_sam_stream,
                sw_cs)
        rec["sw_vector_cs_hg"] = _check_flow_launch(
            "sw_vector_cs_hg", *flow, "sw_vector_batch",
            sw_vector.sw_vector_batch, sw_vector.sw_vector_batch_ref,
            _vec_launch_bound, cs=True)
        # phase B: the 4-layer DP and the traceback on the survivors
        _check_flow_launch("sw_cs_full (phase B)", *flow, "sw_full_cs_dp",
                           sw_cs_full.sw_full_cs_dp,
                           sw_cs_full.sw_full_cs_dp_ref, _cs_dp_launch_bound,
                           plain_reps=1)
        _check_flow_launch("cs_traceback (phase B)", *flow, "cs_traceback",
                           sw_cs_full.cs_traceback,
                           sw_cs_full.cs_traceback_ref, _cs_tb_launch_bound,
                           plain_reps=1)
    if 18 in hg:
        pairs = dataset.hg_pairs(codes, HG_READS, C.MODE_COLOUR_SPACE)
        mk = _hg_mapper(cidx, MapperConfig(mode=C.MODE_COLOUR_SPACE,
                                           pair_mode="opp-in",
                                           min_insert_size=0,
                                           max_insert_size=1000))
        ln = run_dense_slice("hg CS paired", dev, cs_counters, mk, pairs,
                             fastpath_cs.map_paired_cs_sam_stream, True)
        launches.update(sw_cs_full_paired_hg=ln["sw_cs_full"],
                        cs_traceback_paired_hg=ln["cs_traceback"])
        # phase B of select-then-full: the DP and the traceback on the
        # rows the select pass picks
        flow = (mk(dev), pairs, fastpath_cs.map_paired_cs_sam_stream, sw_cs)
        rec["sw_cs_full_paired_hg"] = _check_flow_launch(
            "sw_cs_full_paired_hg (phase B)", *flow, "sw_full_cs_dp",
            sw_cs_full.sw_full_cs_dp, sw_cs_full.sw_full_cs_dp_ref,
            _cs_dp_launch_bound, plain_reps=1)
        rec["cs_traceback_paired_hg"] = _check_flow_launch(
            "cs_traceback_paired_hg (phase B)", *flow, "cs_traceback",
            sw_cs_full.cs_traceback, sw_cs_full.cs_traceback_ref,
            _cs_tb_launch_bound, plain_reps=1)
    return launches, rec


def run_paired_slice(dev, counters):
    """Phase 14: bench_all.py's ecoli-paired workload through the port's
    paired entry point."""
    from shrimp_tpu_torch import fastpath
    from shrimp_tpu_torch.config import MapperConfig
    from shrimp_tpu_torch.paired import PairedMapper
    t0 = time.perf_counter()
    idx, reads = _dataset("ecoli_paired_ls", PAIRED_READS)
    print(f"paired dataset + index: {time.perf_counter() - t0:.3f} s "
          f"({idx.total_len} bp, {len(reads)} reads)")
    cfg = MapperConfig(pair_mode="opp-in")

    def mapper(device):
        return PairedMapper(idx, cfg, device).upload_planes()
    stream = fastpath.map_paired_sam_stream
    _map(mapper(dev), reads[:2 * B_CHUNK], stream)      # warm-up
    m = mapper(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    for c in counters.values():
        c.reset()
    sam, secs = _map(m, reads, stream)
    launches = {k: c.n for k, c in counters.items()}
    st = m.stats
    print(f"paired slice on {dev}: {len(reads)} reads in {secs!r} s = "
          f"{len(reads) / secs!r} reads/s; launches {launches}; windows "
          f"{st.vec_invocs}; peak device memory {_peak_gib(dev)}")
    print("paired stage seconds (summed over lanes): " + ", ".join(
        f"{k} {v!r}" for k, v in st.stage_secs.items()))
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{k}: not launched by the paired path")
    lines = sam.split(b"\n")[:-1]
    mapped = st.reads_mapped / st.reads
    print(f"paired SAM: {len(lines)} records, {mapped!r} of reads mapped "
          "in pairs")
    if (not lines or any(len(ln.split(b"\t")) < 11 for ln in lines)
            or st.reads != len(reads) or mapped < 0.9):
        raise AssertionError("paired slice: malformed SAM, reads lost or "
                             "mostly unpaired")
    first = reads[:PAIRED_CPU_READS]
    small = _with_batch(stream, PAIRED_CPU_READS)
    sam_gpu, _ = _map(mapper(dev), first, small)
    sam_cpu, secs_cpu = _map(mapper("cpu"), first, small)
    same = sam_cpu == sam_gpu and sam.startswith(sam_gpu)
    print(f"paired slice on cpu (plain versions), first {len(first)} reads: "
          f"{secs_cpu!r} s; SAM identical to the CUDA run's and a prefix of "
          f"the full run's: {same}")
    if not same:
        raise AssertionError("paired slice: CUDA and CPU SAM bytes differ")
    return launches


def run_long_two_phase(dev, counters, long_ctx):
    """Phase 16: the long-read slice's first reads with the two-phase
    threshold forced to 1 window per read; the SAM must equal the fused
    card run's."""
    from shrimp_tpu_torch import fastpath
    if long_ctx is None:
        from shrimp_tpu_torch.dataset import ecoli_unpaired_ls_long
        idx, reads = ecoli_unpaired_ls_long(LONG_CPU_READS)
        with _Gate(False, GATE_OFF):
            fused, _ = _map(_mapper(idx, dev), reads, _with_batch(
                fastpath.map_unpaired_sam_stream, LONG_CPU_READS))
        long_ctx = dict(idx=idx, reads=reads, fused_sam=fused)
    m = _mapper(long_ctx["idx"], dev)
    torch.cuda.reset_peak_memory_stats(dev)
    for c in counters.values():
        c.reset()
    with _Gate(False, 1), _Dispatches(False) as disp:
        sam, secs = _map(m, long_ctx["reads"], _with_batch(
            fastpath.map_unpaired_sam_stream, LONG_CPU_READS))
    launches = {k: c.n for k, c in counters.items()}
    st = m.stats
    same = sam == long_ctx["fused_sam"]
    print(f"long reads, two phases: {st.reads} reads in {secs!r} s; "
          f"{disp.summary()}; phase-B rows {st.full_invocs} of "
          f"{st.vec_invocs} windows; launches {launches}; peak device "
          f"memory {_peak_gib(dev)}; SAM identical to the fused card "
          f"run's: {same}")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{k}: not launched by the two-phase long "
                                 "path")
    if not (same and disp.all_two_phase()
            and "device full (2ph)" in st.stage_secs):
        raise AssertionError("long reads, two phases: SAM differs from the "
                             "fused run's, or the gate did not fire")
    return launches


class _Spy:
    """While active, counts the calls of each function `module.<name>`
    of `targets` (the name the flows look it up by) and keeps
    `keep(args, kwargs)` of each call. The lanes call from their
    threads, so the count takes a lock."""

    def __init__(self, targets, keep=None):
        self.targets, self.keep = targets, keep
        self.n, self.kept = 0, []
        self.lock = threading.Lock()

    def __enter__(self):
        self.orig = [getattr(mod, name) for mod, name in self.targets]
        for (mod, name), fn in zip(self.targets, self.orig):
            def spy(*a, _fn=fn, **k):
                with self.lock:
                    self.n += 1
                    if self.keep is not None:
                        self.kept.append(self.keep(a, k))
                return _fn(*a, **k)
            setattr(mod, name, spy)
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in zip(self.targets, self.orig):
            setattr(mod, name, fn)


def _byte_gathers():
    """A _Spy on the byte gather, as the LS and the CS steps call it,
    keeping each call's (rows, G)."""
    from shrimp_tpu_torch.core import sw, sw_cs
    return _Spy([(sw, "window_gather_bytes"), (sw_cs, "window_gather_bytes")],
                keep=lambda a, k: (a[2].shape[0], a[4]))


def run_cs_paired_slice(dev, counters):
    """Phase 17: bench_all.py's ecoli-cs-paired workload through the
    port's CS paired entry point. Returns the launches and the records
    of the 4-layer DP and the traceback on the flow's first launch."""
    from shrimp_tpu_torch import constants as C
    from shrimp_tpu_torch import fastpath_cs
    from shrimp_tpu_torch.config import MapperConfig
    from shrimp_tpu_torch.core import sw_cs, sw_cs_full
    from shrimp_tpu_torch.paired import PairedMapper
    t0 = time.perf_counter()
    idx, reads = _dataset("ecoli_paired_cs", PAIRED_READS)
    print(f"CS paired dataset + index: {time.perf_counter() - t0:.3f} s "
          f"({idx.total_len} bp, {len(reads)} reads)")
    cfg = MapperConfig(mode=C.MODE_COLOUR_SPACE, pair_mode="opp-in")

    def mapper(device):
        return PairedMapper(idx, cfg, device).upload_planes()
    stream = fastpath_cs.map_paired_cs_sam_stream
    _map(mapper(dev), reads[:2 * B_CHUNK], stream)      # warm-up
    m = mapper(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    for c in counters.values():
        c.reset()
    with _Dispatches(True) as disp:
        sam, secs = _map(m, reads, stream)
    launches = {k: c.n for k, c in counters.items()}
    st = m.stats
    print(f"CS paired slice on {dev}: {len(reads)} reads in {secs!r} s = "
          f"{len(reads) / secs!r} reads/s; launches {launches}; windows "
          f"{st.vec_invocs}; {disp.summary()}; peak device memory "
          f"{_peak_gib(dev)}")
    print("CS paired stage seconds (summed over lanes): " + ", ".join(
        f"{k} {v!r}" for k, v in st.stage_secs.items()))
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{k}: not launched by the CS paired path")
    lines = sam.split(b"\n")[:-1]
    mapped = st.reads_mapped / st.reads
    print(f"CS paired SAM: {len(lines)} records, {mapped!r} of reads "
          "mapped in pairs")
    if (not lines or any(len(ln.split(b"\t")) < 11 for ln in lines)
            or st.reads != len(reads) or mapped < 0.9):
        raise AssertionError("CS paired slice: malformed SAM, reads lost "
                             "or mostly unpaired")
    print("CS paired device busy share (profiled run on the first "
          f"{2 * B_CHUNK} reads): " + _device_busy_share(
              mapper(dev), reads[:2 * B_CHUNK], stream))
    flow = (mapper(dev), reads, stream, sw_cs)
    rec = {"sw_cs_full_paired": _check_flow_launch(
        "sw_cs_full_paired", *flow, "sw_full_cs_dp",
        sw_cs_full.sw_full_cs_dp, sw_cs_full.sw_full_cs_dp_ref,
        _cs_dp_launch_bound, plain_reps=1),
        "cs_traceback_paired": _check_flow_launch(
        "cs_traceback_paired", *flow, "cs_traceback",
        sw_cs_full.cs_traceback, sw_cs_full.cs_traceback_ref,
        _cs_tb_launch_bound, plain_reps=1)}
    first = reads[:PAIRED_CPU_READS]
    small = _with_batch(stream, PAIRED_CPU_READS)
    sam_gpu, _ = _map(mapper(dev), first, small)
    sam_cpu, secs_cpu = _map(mapper("cpu"), first, small)
    same = sam_cpu == sam_gpu and sam.startswith(sam_gpu)
    print(f"CS paired slice on cpu (plain versions), first {len(first)} "
          f"reads: {secs_cpu!r} s; SAM identical to the CUDA run's and a "
          f"prefix of the full run's: {same}")
    if not same:
        raise AssertionError("CS paired slice: CUDA and CPU SAM bytes "
                             "differ")
    return {"sw_cs_full_paired": launches["sw_cs_full"],
            "cs_traceback_paired": launches["cs_traceback"]}, rec


def _time_gathers(dev, planes, cat, shapes) -> tuple:
    """Device ms of the byte gather and of the word gather (None without
    `cat`) over the (rows, G) `shapes` (a Counter of calls), random
    starts and strands over `planes`: (byte ms, word ms) summed over
    the calls."""
    from shrimp_tpu_torch.core.sw import (fast_window_gather,
                                          window_gather_bytes)
    rng = np.random.default_rng(191)
    n = planes[0].shape[0]
    t_byte = t_word = 0.0
    for (B, G), calls in shapes.items():
        gs = torch.from_numpy(rng.integers(0, n - G, B).astype(
            np.int32)).to(dev)
        rc = torch.from_numpy(rng.integers(0, 2, B).astype(np.int32)).to(dev)
        t_byte += calls * _device_ms(
            lambda: window_gather_bytes(*planes, gs, rc, G), 5)
        if cat is not None:
            t_word += calls * _device_ms(
                lambda: fast_window_gather(cat, n, gs, rc, G), 5)
    return t_byte, (t_word if cat is not None else None)


def check_byte_steps(dev):
    """Phase 19 (a): the packed LS stats step, the LS traceback step at
    G = 352 and the CS fused step on a synthetic 2^30-base plane pair,
    whose word plane would overflow int32 offsets, so the steps gather
    by byte: CUDA against CPU, bit-equal, with windows at both ends of
    both strands. Then the byte gather's device time on those planes
    and, beside the word gather's, on a 4 Mbp plane."""
    from shrimp_tpu_torch.core.sw import (cat_word_plane,
                                          sw_vec_full_stats_packed,
                                          sw_vec_full_tb_packed)
    from shrimp_tpu_torch.core.sw_cs import sw_vec_cs_full_from_index
    from shrimp_tpu_torch.mapper import Mapper
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    rng = np.random.default_rng(19)
    n_true = BIG_PLANE
    fw = rng.integers(0, 4, n_true, dtype=np.uint8)
    rc = 3 - fw[::-1]
    cfw = np.empty_like(fw)
    cfw[0] = 0
    np.bitwise_xor(fw[:-1], fw[1:], out=cfw[1:])
    crc = np.empty_like(rc)
    crc[0] = 0
    np.bitwise_xor(rc[:-1], rc[1:], out=crc[1:])
    planes = [Mapper._pad_plane(p) for p in (cfw, crc, fw, rc)]
    n = len(planes[2])
    if cat_word_plane(*planes[2:]) is not None or n != n_true:
        raise AssertionError("byte steps: the plane pair has a word plane")
    host = [torch.from_numpy(np.ascontiguousarray(p)) for p in planes]
    card = [p.to(dev) for p in host]
    print(f"byte steps: 4 planes of {n} bytes made in "
          f"{time.perf_counter() - t0!r} s; no word plane")

    cases = []
    for name, fn, G, L, R, B in (
            ("LS stats step", sw_vec_full_stats_packed, 64, 36, 40, B_CHUNK),
            ("LS traceback step", sw_vec_full_tb_packed, 352, 250, 256,
             1024)):
        args, rtab_pk = _ls_window_case(rng, planes[2], planes[3], n_true,
                                        B, G, L, R)
        cases.append((f"{name} B={B} G={G} L={L}", fn, 2, (args, rtab_pk),
                      dict(cat_words=None, G=G, L=L, **KW)))
    a, colours, qr, xov = _cs_window_case(rng, planes, n_true, CS_B_MAIN,
                                          CS_G_MAIN, CS_R, 2048)
    cases.append((f"CS fused step B={CS_B_MAIN} G={CS_G_MAIN} R={CS_R}",
                  sw_vec_cs_full_from_index, 0, (a, colours, qr, xov),
                  dict(CS_KW, G=CS_G_MAIN, xover=XOVER)))
    for title, fn, first_plane, arrays, kw in cases:
        # the LS steps take the letter planes, the CS step all four
        with _byte_gathers() as g:
            got = fn(*card[first_plane:], *(torch.from_numpy(x).to(dev)
                                            for x in arrays), **kw)
        want = fn(*host[first_plane:], *(torch.from_numpy(x)
                                         for x in arrays), **kw)
        got, want = ([x.cpu().numpy() for x in
                      (out if isinstance(out, tuple) else (out,))]
                     for out in (got, want))
        same = all(np.array_equal(x, w) for x, w in zip(got, want))
        print(f"{title} on the 2^30-base planes: CUDA == CPU: {same}; "
              f"byte gathers {g.n}; outputs "
              f"{[tuple(x.shape) for x in got]}")
        if not same or g.n == 0:
            raise AssertionError(f"{title}: CUDA and CPU differ, or the "
                                 "byte gather was not taken")
    B = LS_VEC_ROWS
    big, _ = _time_gathers(dev, card[2:], None, Counter({(B, 64): 1}))
    fp, rp = (Mapper._pad_plane(p[:4_000_000]) for p in (fw, rc))
    small = [torch.from_numpy(p).to(dev) for p in (fp, rp)]
    cat = torch.from_numpy(cat_word_plane(fp, rp)).to(dev)
    byte4, word4 = _time_gathers(dev, small, cat, Counter({(B, 64): 1}))
    print(f"gather device time, {B} rows, G = 64: byte gather {big!r} ms on "
          f"the 2^30-base planes, {byte4!r} ms on a 4 Mbp plane, beside "
          f"the word gather's {word4!r} ms there "
          f"({byte4 / word4!r}x); peak device memory {_peak_gib(dev)}")
    del card, cat, small
    torch.cuda.empty_cache()
    return dict(byte_ms=byte4, word_ms=word4, byte_big_ms=big)


def run_unpacked(dev):
    """Phase 19 (b): phase 5's and phase 11's first UNPACKED_READS reads
    in one batch (more than 2^16 read rows: the unpacked stats and
    traceback flows) against the same reads in B_CHUNK-read batches
    (packed), SAM identical."""
    from shrimp_tpu_torch import fastpath
    from shrimp_tpu_torch.core import sw_full
    for name, counter in (("ecoli_unpaired_ls", sw_full.LAUNCHES),
                          ("ecoli_unpaired_ls_long", sw_full.BP_LAUNCHES)):
        idx, reads = _dataset(name, N_READS)
        first = reads[:UNPACKED_READS]
        torch.cuda.reset_peak_memory_stats(dev)
        counter.reset()
        with _Spy([(fastpath, "_launch_args")], keep=lambda a, k: a[5]) as one:
            sam1, secs1 = _map(_mapper(idx, dev), first, _with_batch(
                fastpath.map_unpaired_sam_stream, UNPACKED_READS))
        n_launch = counter.n
        peak = _peak_gib(dev)
        with _Spy([(fastpath, "_launch_args")], keep=lambda a, k: a[5]) as bt:
            sam2, secs2 = _map(_mapper(idx, dev), first, _with_batch(
                fastpath.map_unpaired_sam_stream, B_CHUNK))
        same = sam1 == sam2
        print(f"{name}, first {len(first)} reads: one batch (unpacked IO, "
              f"{one.n} launches, full-SW kernel launches {n_launch}) in "
              f"{secs1!r} s, peak device memory {peak}; {B_CHUNK}-read "
              f"batches (packed IO) in {secs2!r} s; SAM identical: {same}")
        if not (same and one.kept and not any(one.kept) and all(bt.kept)
                and n_launch > 0):
            raise AssertionError(f"{name}: the unpacked flow's SAM differs, "
                                 "or the flows were not the ones taken")


def run_byte_streams(dev):
    """Phase 19 (c): the LS, LS paired and CS streams on E. coli with the
    mapper's word planes withheld, so the windows are gathered by byte,
    through the fused and the two-phase dispatch: the SAM of the first
    BYTE_READS reads equals the run with the planes. Prints the byte
    gather's device time in the fused runs, timed at their launches'
    own shapes, beside the word gather's and the wall."""
    from contextlib import nullcontext

    from shrimp_tpu_torch import constants as C
    from shrimp_tpu_torch import fastpath, fastpath_cs
    from shrimp_tpu_torch.config import MapperConfig
    from shrimp_tpu_torch.mapper import Mapper
    from shrimp_tpu_torch.paired import PairedMapper
    cases = (
        ("LS", "ecoli_unpaired_ls", N_READS, MapperConfig(), Mapper,
         fastpath.map_unpaired_sam_stream, False),
        ("LS paired", "ecoli_paired_ls", PAIRED_READS,
         MapperConfig(pair_mode="opp-in"), PairedMapper,
         fastpath.map_paired_sam_stream, False),
        ("CS", "ecoli_unpaired_cs", N_READS,
         MapperConfig(mode=C.MODE_COLOUR_SPACE), Mapper,
         fastpath_cs.map_unpaired_cs_sam_stream, True))
    torch.cuda.reset_peak_memory_stats(dev)
    for title, name, n, cfg, cls, stream, cs in cases:
        idx, reads = _dataset(name, n)
        first = reads[:BYTE_READS]
        ref = cls(idx, cfg, dev).upload_planes()
        want, secs_w = _map(ref, first, stream)
        for two_phase in (False, True):
            m = cls(idx, cfg, dev).upload_planes()
            m._cat_words_dev = m._cs_cat_words_dev = None
            with (_Gate(cs, 0) if two_phase else nullcontext()), \
                    _Dispatches(cs) as disp, _byte_gathers() as g:
                got, secs = _map(m, first, stream)
            ok = (got == want and g.n > 0
                  and disp.all_two_phase() == two_phase)
            line = (f"{title} by byte, {'two-phase' if two_phase else 'fused'}"
                    f", first {len(first)} reads: {secs!r} s (with the word "
                    f"planes {secs_w!r} s); {g.n} byte gathers; "
                    f"{disp.summary()}; SAM identical: {got == want}")
            if not two_phase:
                shapes = Counter(g.kept)
                # the CS step gathers from the colour and the letter planes
                planes = ((m._dev_cs_planes()[:2], m._dev_cs_planes()[2:])
                          if cs else ((m._dev_codes(), m._dev_codes_rc()),))
                cats = (ref._dev_cs_cat_words() if cs
                        else (ref._dev_cat_words(),))
                t_b = t_w = 0.0
                for pl, ct in zip(planes, cats):
                    per = Counter({k: v // len(planes)
                                   for k, v in shapes.items()})
                    b, w = _time_gathers(dev, pl, ct, per)
                    t_b, t_w = t_b + b, t_w + w
                line += (f"; byte gather device time {t_b!r} ms at the "
                         f"launches' shapes {dict(shapes)} (word gather "
                         f"{t_w!r} ms), {t_b / 1e3 / secs!r} of the wall")
            print(line)
            if not ok:
                raise AssertionError(f"{title} by byte: SAM differs from the "
                                     "run with the word planes, or the byte "
                                     "gather or the dispatch was not taken")
    print(f"phase 19 (c) peak device memory {_peak_gib(dev)}")


# ------------------------------------------------------------ phase 20

def _generic_stream(render=None, batch_size=8192):
    """An entry point (m, reads) -> SAM bytes per batch through the
    generic mapper, `Mapper.map_unpaired`, rendered with the reference's
    SAM renderer (or `render(read, hit, index, config)`)."""
    from shrimp_tpu_torch.io.sam import render_unpaired

    def stream(m, reads):
        fq = any(r.qual is not None for r in reads)
        for off in range(0, len(reads), batch_size):
            lines = [render(e, h, m.index, m.config) if render else
                     render_unpaired(e, h, m.index, m.config, fastq=fq)
                     for e, hs in m.map_unpaired(reads[off:off + batch_size])
                     for h in hs]
            yield ("\n".join(lines) + "\n").encode() if lines else b""
    return stream


def _first_calls(m, reads, stream, targets) -> dict:
    """{name: (tensor arguments (copies), keyword arguments)} of the
    first call one run of `stream` on `reads` makes to each kernel
    wrapper `module.<fn>` of `targets` ({name: (module, fn)})."""
    return _first_calls_of(lambda: _map(m, reads, stream), targets)


def _first_calls_of(run, targets) -> dict:
    """`_first_calls` of one call of `run()`, which maps and waits for
    the card."""
    seen, orig = {}, {}
    for name, (mod, fn) in targets.items():
        orig[name] = getattr(mod, fn)

        def record(*args, _w=orig[name], _name=name, **kw):
            if _name not in seen:
                seen[_name] = ([x.clone() for x in args
                                if isinstance(x, torch.Tensor)], kw)
            return _w(*args, **kw)
        setattr(mod, fn, record)
    try:
        run()
    finally:
        for name, (mod, fn) in targets.items():
            setattr(mod, fn, orig[name])
    return seen


def _bp_launch_bound(args, out, cs):
    """The full SW with backpointers: every row of the launch, in-band
    cells, windows, reads and 7 int32 in, 4 int32 and the backpointer
    byte of every cell out."""
    (B, G), R = args[0].shape, args[2].shape[1]
    a = _band_geometry(args)
    return (B, R, G), _bound(
        _bp_bytes(B, R, G),
        OPS["sw_full_bp"] * _band_cells(a, np.full(B, R)),
        OPS["sw_full_bp"] * B * R * G)


def _tb_launch_bound(args, out, cs):
    (B, G), R = args[0].shape, args[1].shape[1]
    return (B, R, G), _tb_bound(out[0][:, 3], B, R, G)


def _run_line(title, dev, n_reads, secs, smi, extra=""):
    print(f"{title} on {dev}: {n_reads} reads in {secs!r} s = "
          f"{n_reads / secs!r} reads/s; {smi}; peak device memory "
          f"{_peak_gib(dev)}{extra}")


def _cpu_check(title, mapper, reads, stream, sam_gpu):
    """The CPU run (plain versions) of `reads` must write `sam_gpu`."""
    sam_cpu, secs = _map(mapper("cpu"), reads, stream)
    print(f"{title} on cpu (plain versions), {len(reads)} reads: {secs!r} "
          f"s; SAM identical to the CUDA run's: {sam_cpu == sam_gpu}")
    if sam_cpu != sam_gpu:
        raise AssertionError(f"{title}: CUDA and CPU SAM bytes differ")


def run_generic(dev, counters, smi):
    """Phase 20 (a): bench_all.py's ecoli-ls-generic workload through
    Mapper.map_unpaired. Returns the launches and the kernel records on
    the path's own first launches."""
    from shrimp_tpu_torch.config import MapperConfig
    from shrimp_tpu_torch.core import sw_full, sw_vector
    from shrimp_tpu_torch.mapper import Mapper
    idx, reads = _dataset("ecoli_unpaired_ls", GENERIC_READS)
    cfg = MapperConfig(extra_sam_fields=True)

    def mapper(device):
        return Mapper(idx, cfg, device).upload_planes()
    stream = _generic_stream()
    _map(mapper(dev), reads[:256], stream)      # warm-up
    m = mapper(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    for c in counters.values():
        c.reset()
    sam, secs = _map(m, reads, stream)
    launches = {k: c.n for k, c in counters.items()}
    _run_line("20 (a) ecoli-ls-generic", dev, len(reads), secs, smi,
              f"; launches {launches}; windows {m.stats.vec_invocs}, "
              f"full SW {m.stats.full_invocs}")
    print("20 (a) stage seconds: " + ", ".join(
        f"{k} {v!r}" for k, v in m.stats.stage_secs.items()))
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{k}: not launched by the generic path")
    lines = sam.split(b"\n")[:-1]
    if (m.stats.reads != len(reads) or len(lines) < 0.9 * len(reads)
            or any(len(ln.split(b"\t")) < 11 for ln in lines)):
        raise AssertionError("20 (a): reads lost or malformed SAM")
    first = reads[:GENERIC_CPU_READS]
    sam_gpu, _ = _map(mapper(dev), first, stream)
    if not sam.startswith(sam_gpu):
        raise AssertionError("20 (a): the first reads' SAM is not a prefix "
                             "of the full run's")
    _cpu_check("20 (a) ecoli-ls-generic", mapper, first, stream, sam_gpu)
    calls = _first_calls(mapper(dev), reads[:B_CHUNK], stream, {
        "sw_vector_generic": (sw_vector, "sw_vector_batch"),
        "sw_full_bp_generic": (sw_full, "sw_full_bp"),
        "ls_traceback_generic": (sw_full, "traceback_pack")})
    rec = {}
    for name, kernel, plain, bound in (
            ("sw_vector_generic", sw_vector.sw_vector_batch,
             sw_vector.sw_vector_batch_ref, _vec_launch_bound),
            ("sw_full_bp_generic", sw_full.sw_full_bp,
             sw_full.sw_full_bp_ref, _bp_launch_bound),
            ("ls_traceback_generic", sw_full.traceback_pack,
             sw_full.traceback_pack_ref, _tb_launch_bound)):
        rec[name] = _check_captured(name, *calls[name], kernel, plain,
                                    bound, what="the generic path's first "
                                    "launch")
    del calls
    names = {"sw_vector_generic": "sw_vector",
             "sw_full_bp_generic": "sw_full_bp",
             "ls_traceback_generic": "ls_traceback"}
    return {k: launches[v] for k, v in names.items()}, rec


def _trim_every_other_batch(reads, batch):
    """One read in five of every odd batch cut to 28-35 bases (colours:
    after the primer), so those batches hold mixed read lengths."""
    rng = np.random.default_rng(28)
    out = list(reads)
    for k in range(len(out)):
        if (k // batch) % 2 and k % 5 == 0:
            r = out[k]
            keep = int(rng.integers(28, 36)) + (len(r.seq) - READ_LEN)
            out[k] = type(r)(r.name, r.seq[:keep],
                             None if r.qual is None else r.qual[:keep])
    return out


def run_slow_tails(dev, smi):
    """Phase 20 (b): the four E. coli streams with batches the flat
    encoder rejects mid-stream: those take the generic mapper."""
    from shrimp_tpu_torch import constants as C
    from shrimp_tpu_torch import fastpath, fastpath_cs
    from shrimp_tpu_torch.config import MapperConfig
    from shrimp_tpu_torch.mapper import Mapper
    from shrimp_tpu_torch.paired import PairedMapper
    cs = C.MODE_COLOUR_SPACE
    for title, ds, cfg, stream in (
            ("LS", "ecoli_unpaired_ls", MapperConfig(),
             fastpath.map_unpaired_sam_stream),
            ("CS", "ecoli_unpaired_cs", MapperConfig(mode=cs),
             fastpath_cs.map_unpaired_cs_sam_stream),
            ("LS pairs", "ecoli_paired_ls", MapperConfig(pair_mode="opp-in"),
             fastpath.map_paired_sam_stream),
            ("CS pairs", "ecoli_paired_cs",
             MapperConfig(mode=cs, pair_mode="opp-in"),
             fastpath_cs.map_paired_cs_sam_stream)):
        idx, reads = _dataset(ds, TAIL_READS)
        reads = _trim_every_other_batch(reads, TAIL_BATCH)
        cls = Mapper if cfg.pair_mode == C.PAIR_NONE else PairedMapper
        generic = "map_unpaired" if cls is Mapper else "map_paired"

        def mapper(device, _cls=cls, _idx=idx, _cfg=cfg):
            return _cls(_idx, _cfg, device).upload_planes()
        tails = [0]

        def counted(device, _mapper=mapper, _generic=generic):
            m = _mapper(device)
            orig = getattr(m, _generic)

            def run(batch):
                tails[0] += 1
                return orig(batch)
            setattr(m, _generic, run)
            return m
        s = _with_batch(stream, TAIL_BATCH)
        _map(mapper(dev), reads[:2 * TAIL_BATCH], s)      # warm-up
        torch.cuda.reset_peak_memory_stats(dev)
        tails[0] = 0
        sam, secs = _map(counted(dev), reads, s)
        n_tail = tails[0]
        _run_line(f"20 (b) {title} stream with slow tails", dev, len(reads),
                  secs, smi, f"; slow-tail batches {n_tail} of "
                  f"{-(-len(reads) // TAIL_BATCH)}")
        if n_tail != len(reads) // TAIL_BATCH // 2:
            raise AssertionError(f"20 (b) {title}: {n_tail} slow-tail "
                                 "batches")
        first = reads[:TAIL_CPU_READS]
        sam_gpu, _ = _map(mapper(dev), first, s)
        if not sam.startswith(sam_gpu) or not sam_gpu:
            raise AssertionError(f"20 (b) {title}: the first reads' SAM is "
                                 "not a prefix of the full run's")
        _cpu_check(f"20 (b) {title} stream with slow tails", mapper, first,
                   s, sam_gpu)


def _with_cs_quals(reads, seed=3):
    from shrimp_tpu_torch.io.fasta import SeqRecord
    rng = np.random.default_rng(seed)
    return [SeqRecord(r.name, r.seq, "".join(
        chr(33 + int(q)) for q in rng.integers(3, 41, len(r.seq) - 1)))
        for r in reads]


def _retry_band(args):
    """The local retry's band (mapper._pass2_local_retry) for the rows
    of a full-SW launch: the threshold-derived rectangle
    (sw-full-ls.c:395-398) at the default 50 % threshold."""
    from shrimp_tpu_torch.core.sw_np import _join2_rect
    genome, glen, read, rlen = args[:4]
    match = KW["match"]
    rect = np.array([_join2_rect(
        (0, y0, 1, 1), (int(g) - 1, int(r) - 1 - y0, 1, 1))
        for g, r in zip(glen.tolist(), rlen.tolist())
        for y0 in [(r * match - (r * match) // 2) // match]], np.int32)
    out = list(args)
    for c in range(4):
        out[4 + c] = torch.from_numpy(rect[:, c].copy()).to(genome.device)
    return out


def run_offgate(dev, counters, smi):
    """Phase 20 (c): the configs outside the streams' gates, card
    against CPU. Returns the launches and records of the CS kernels on
    the crossover-from-qualities run."""
    from shrimp_tpu_torch import constants as C
    from shrimp_tpu_torch.config import MapperConfig
    from shrimp_tpu_torch.core import sw_cs, sw_cs_full, sw_full
    from shrimp_tpu_torch.io import shrimp_format
    from shrimp_tpu_torch.mapper import Mapper
    cs = C.MODE_COLOUR_SPACE
    ls_idx, ls_reads = _dataset("ecoli_unpaired_ls", OFFGATE_READS)
    cs_idx, cs_reads = _dataset("ecoli_unpaired_cs", OFFGATE_READS)
    cs_fq = _with_cs_quals(cs_reads)
    retries = [0]
    orig_retry = Mapper._pass2_local_retry

    def retry(self, entries, jobs, job_thresh, rows):
        retries[0] += len(rows)
        return orig_retry(self, entries, jobs, job_thresh, rows)
    Mapper._pass2_local_retry = retry
    launches, rec = {}, {}
    try:
        for title, idx, reads, kw, render in (
                ("LS local", ls_idx, ls_reads,
                 dict(global_alignment=False), None),
                ("CS local", cs_idx, cs_reads,
                 dict(mode=cs, global_alignment=False), None),
                ("LS gapless", ls_idx, ls_reads,
                 dict(gapless=True, global_alignment=False), None),
                ("LS two option sets", ls_idx, ls_reads,
                 dict(custom_unpaired_options=(DSL_STRICT, DSL_LOOSE)),
                 None),
                ("LS --shrimp-format", ls_idx, ls_reads,
                 dict(shrimp_format=True),
                 lambda e, h, i, c: shrimp_format.output_normal(e, h, i)),
                ("CS FASTQ", cs_idx, cs_fq, dict(mode=cs), None)):
            cfg = MapperConfig(**kw)

            def mapper(device, _idx=idx, _cfg=cfg):
                return Mapper(_idx, _cfg, device).upload_planes()
            stream = _generic_stream(render)
            _map(mapper(dev), reads[:256], stream)      # warm-up
            torch.cuda.reset_peak_memory_stats(dev)
            for c in counters.values():
                c.reset()
            retries[0] = 0
            sam, secs = _map(mapper(dev), reads, stream)
            n = {k: c.n for k, c in counters.items()}
            n_rec = sam.count(b"\n")
            _run_line(f"20 (c) {title}", dev, len(reads), secs, smi,
                      f"; launches {n}; local retry rows {retries[0]}; "
                      f"{n_rec} records")
            if n_rec < 0.8 * len(reads):
                raise AssertionError(f"20 (c) {title}: mostly unmapped")
            _cpu_check(f"20 (c) {title}", mapper, reads, stream, sam)
            if title == "CS FASTQ":
                launches = {"sw_cs_full_generic": n["sw_cs_full"],
                            "cs_traceback_generic": n["cs_traceback"]}
                calls = _first_calls(mapper(dev), reads, stream, {
                    "sw_cs_full_generic": (sw_cs, "sw_full_cs_dp"),
                    "cs_traceback_generic": (sw_cs, "cs_traceback")})
                for name, kernel, plain, bound in (
                        ("sw_cs_full_generic", sw_cs_full.sw_full_cs_dp,
                         sw_cs_full.sw_full_cs_dp_ref, _cs_dp_launch_bound),
                        ("cs_traceback_generic", sw_cs_full.cs_traceback,
                         sw_cs_full.cs_traceback_ref, _cs_tb_launch_bound)):
                    rec[name] = _check_captured(
                        name, *calls[name], kernel, plain, bound, cs=True,
                        plain_reps=1, what="the crossover-from-qualities "
                        "launch")
                del calls
            if title == "LS local":
                args, kw = _first_calls(mapper(dev), reads, stream, {
                    "bp": (sw_full, "sw_full_bp")})["bp"]
                _check_captured("sw_full_bp (local retry band)",
                                _retry_band(args), kw, sw_full.sw_full_bp,
                                sw_full.sw_full_bp_ref, _bp_launch_bound,
                                what="the local run's first launch with "
                                "the retry's band")
    finally:
        Mapper._pass2_local_retry = orig_retry
    return launches, rec


def _write_fasta(path, records, fastq=False):
    with open(path, "w") as f:
        for r in records:
            if fastq:
                f.write(f"@{r.name}\n{r.seq}\n+\n{r.qual}\n")
            else:
                f.write(f">{r.name}\n{r.seq}\n")


def run_cli(dev, smi):
    """Phase 20 (d): `python -m shrimp_tpu_torch` as subprocesses on
    files in a temporary directory, against the in-process streams."""
    import tempfile
    from shrimp_tpu_torch import fastpath, fastpath_cs
    from shrimp_tpu_torch.config import MapperConfig
    from shrimp_tpu_torch.core.encode import decode_ls
    from shrimp_tpu_torch.index.build import GenomeIndex
    from shrimp_tpu_torch.io.fasta import SeqRecord
    from shrimp_tpu_torch.mapper import Mapper
    ls_idx, ls_reads = _dataset("ecoli_unpaired_ls", B_CHUNK)
    _, cs_reads = _dataset("ecoli_unpaired_cs", B_CHUNK)
    rng = np.random.default_rng(5)
    ls_fq = [SeqRecord(r.name, r.seq, "".join(
        chr(64 + int(q)) for q in rng.integers(5, 41, len(r.seq))))
        for r in ls_reads]
    cs_fq = _with_cs_quals(cs_reads)
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    # `map` runs on the card by default
    dv = () if torch.device(dev).type == "cuda" else ("--device", "cpu")

    def cli(tmp, *args):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "shrimp_tpu_torch",
                              *args], capture_output=True, text=True,
                             cwd=tmp, env=env, timeout=600)
        secs = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"20 (d) {' '.join(args)}: exit "
                                 f"{res.returncode}\n{res.stderr[-3000:]}")
        return res.stdout, secs

    def body(text):
        return "".join(ln + "\n" for ln in text.splitlines()
                       if not ln.startswith("@"))

    with tempfile.TemporaryDirectory() as tmp:
        g = decode_ls(ls_idx.codes)
        with open(os.path.join(tmp, "genome.fa"), "w") as f:
            f.write(">" + ls_idx.contig_names[0] + "\n")
            for i in range(0, len(g), 70):
                f.write(g[i:i + 70] + "\n")
        _write_fasta(os.path.join(tmp, "ls.fa"), ls_reads)
        _write_fasta(os.path.join(tmp, "ls.fq"), ls_fq, fastq=True)
        _write_fasta(os.path.join(tmp, "cs.fq"), cs_fq, fastq=True)
        runs = []
        _, secs = cli(tmp, "map", *dv, "-S", "ecoli", "genome.fa")
        runs.append(("map -S ecoli genome.fa", secs))
        # the in-process streams map with the indexes the CLI saved
        saved = GenomeIndex.load_split(os.path.join(tmp, "ecoli.genome"))
        for name, recs, cfg, stream in (
                ("ls.fa", ls_reads, MapperConfig(),
                 fastpath.map_unpaired_sam_stream),
                ("ls.fq", ls_fq, MapperConfig(),
                 fastpath.map_unpaired_sam_stream)):
            out, secs = cli(tmp, "map", *dv, "-L", "ecoli", name)
            runs.append((f"map -L ecoli {name}", secs))
            want = b"".join(stream(Mapper(saved, cfg, dev), recs)).decode()
            if body(out) != want or not want:
                raise AssertionError(f"20 (d) map -L ecoli {name}: SAM "
                                     "body differs from the stream's")
        _, secs = cli(tmp, "index", "--cs", "-o", "ecoli_cs.npz",
                      "genome.fa")
        runs.append(("index --cs -o ecoli_cs.npz genome.fa", secs))
        out, secs = cli(tmp, "map", *dv, "--cs", "cs.fq", "ecoli_cs.npz")
        runs.append(("map --cs cs.fq ecoli_cs.npz", secs))
        saved = GenomeIndex.load(os.path.join(tmp, "ecoli_cs.npz"))
        want = b"".join(fastpath_cs.map_unpaired_cs_sam_stream(
            Mapper(saved, MapperConfig(mode="cs"), dev), cs_fq)).decode()
        if body(out) != want or not want:
            raise AssertionError("20 (d) map --cs cs.fq: SAM body differs "
                                 "from the stream's")
    print(f"20 (d) CLI on {dev} ({smi}), {B_CHUNK} reads a map, SAM bodies "
          "identical to the in-process streams: " + "; ".join(
              f"{a} {s!r} s" for a, s in runs))


# ------------------------------------------------------------ phase 21

MESH_READS = 20_000
MESH_LONG_READS = 2048
MESH_HG_READS = 16_384
MESH_HG_CPU_READS = 512
# E. coli cut into four region-aligned contigs (a multiple of 32,768
# bases each), and the four hg-like bins of the split-db run
ECOLI_CONTIG_LEN = 35 * 32_768
HG_SUB_LEN = 763 * 32_768


def _mesh():
    """make_mesh(["cuda:0"] * 4) on a one-card machine, every card where
    there are more."""
    from shrimp_tpu_torch.parallel.meshmap import make_mesh
    one = torch.cuda.device_count() == 1
    mesh = make_mesh(["cuda:0"] * 4 if one else None)
    print(f"21: a mesh of {len(mesh)} shards, "
          + ("four on the one card (their launches queue side by side on "
             "one H100: routing, per-shard launches and collectives, no "
             "scaling across cards)" if one else "one on every card")
          + ": " + ", ".join(map(str, mesh)))
    return mesh


def _tier_run(tier, reads, paired, **kw):
    """(SAM bytes, seconds) of one run of a mesh tier."""
    f = tier.map_paired_sam if paired else tier.map_unpaired_sam
    t0 = time.perf_counter()
    sam = f(reads, **kw)
    torch.cuda.synchronize()
    return sam, time.perf_counter() - t0


def _stream_of(cs, paired):
    from shrimp_tpu_torch import fastpath, fastpath_cs
    return {(False, False): fastpath.map_unpaired_sam_stream,
            (False, True): fastpath.map_paired_sam_stream,
            (True, False): fastpath_cs.map_unpaired_cs_sam_stream,
            (True, True): fastpath_cs.map_paired_cs_sam_stream}[(cs, paired)]


def _mapper_cls(paired):
    from shrimp_tpu_torch.mapper import Mapper
    from shrimp_tpu_torch.paired import PairedMapper
    return PairedMapper if paired else Mapper


def _against_unsharded(title, dev, tier, idx, cfg, reads, paired, sam, secs):
    """The tier's SAM against the port's unsharded card stream on the
    same reads (and its reads/s beside the tier's)."""
    stream = _stream_of(cfg.mode == "cs", paired)
    m = _mapper_cls(paired)(idx, cfg, dev).upload_planes()
    _map(m, reads[:2 * B_CHUNK], stream)                 # warm-up
    want, secs_u = _map(m, reads, stream)
    lines = sam.count(b"\n")
    print(f"21 {title}: {len(reads)} reads on the mesh in {secs!r} s = "
          f"{len(reads) / secs!r} reads/s; unsharded card stream "
          f"{secs_u!r} s = {len(reads) / secs_u!r} reads/s; {lines} "
          f"records; SAM identical to the unsharded run's: {sam == want}")
    if sam != want or lines < 0.8 * len(reads):
        raise AssertionError(f"21 {title}: the mesh's SAM differs from the "
                             "unsharded run's, or mostly unmapped")
    return want, secs_u


def _flow_kernels(suffix):
    """The kernels of the sharded tiers' flows, each {record name: (the
    module whose wrapper the flow calls, the wrapper's name there, kernel,
    plain version, launch bound, launch counter, colour space)}: the LS
    stats flow's, the CS flow's and the long-read traceback flow's."""
    from shrimp_tpu_torch.core import sw, sw_cs, sw_cs_full, sw_full
    from shrimp_tpu_torch.core import sw_vector
    vec = (sw_vector.sw_vector_batch, sw_vector.sw_vector_batch_ref,
           _vec_launch_bound)
    ls_k = {"sw_vector" + suffix: (sw, "sw_vector_batch", *vec,
                                   sw_vector.LAUNCHES, False),
            "sw_full_stats" + suffix: (sw, "sw_full_stats",
                                       sw_full.sw_full_stats,
                                       sw_full.sw_full_stats_ref,
                                       _stats_launch_bound, sw_full.LAUNCHES,
                                       False)}
    cs_k = {"sw_vector_cs" + suffix: (sw_cs, "sw_vector_batch", *vec,
                                      sw_vector.CS_LAUNCHES, True),
            "sw_cs_full" + suffix: (sw_cs, "sw_full_cs_dp",
                                    sw_cs_full.sw_full_cs_dp,
                                    sw_cs_full.sw_full_cs_dp_ref,
                                    _cs_dp_launch_bound,
                                    sw_cs_full.DP_LAUNCHES, True),
            "cs_traceback" + suffix: (sw_cs, "cs_traceback",
                                      sw_cs_full.cs_traceback,
                                      sw_cs_full.cs_traceback_ref,
                                      _cs_tb_launch_bound,
                                      sw_cs_full.TB_LAUNCHES, True)}
    long_k = {"sw_vector_g352" + suffix: (sw, "sw_vector_batch", *vec,
                                          sw_vector.LAUNCHES, False),
              "sw_full_bp" + suffix: (sw, "sw_full_bp", sw_full.sw_full_bp,
                                      sw_full.sw_full_bp_ref,
                                      _bp_launch_bound, sw_full.BP_LAUNCHES,
                                      False),
              "ls_traceback" + suffix: (sw, "traceback_pack",
                                        sw_full.traceback_pack,
                                        sw_full.traceback_pack_ref,
                                        _tb_launch_bound,
                                        sw_full.TB_LAUNCHES, False)}
    return ls_k, cs_k, long_k


def run_mesh_ecoli(dev, mesh, smi):
    """Phase 21 (a): MeshMapper at E. coli density, the workloads of
    phases 5, 8, 14, 17 and 11. Returns the launches of its main path
    and the kernel records on its first per-shard launches."""
    from shrimp_tpu_torch import constants as C
    from shrimp_tpu_torch.config import MapperConfig
    from shrimp_tpu_torch.dataset import ecoli_cs_config
    from shrimp_tpu_torch.parallel.meshmap import MeshMapper, zmerge_psum
    cs = C.MODE_COLOUR_SPACE
    ls_k, cs_k, long_k = _flow_kernels("_mesh")
    launches, rec = {}, {}
    for title, name, n_all, cfg, paired, kernels, n in (
            ("(a) LS", "ecoli_unpaired_ls", N_READS, MapperConfig(), False,
             ls_k, MESH_READS),
            ("(a) CS", "ecoli_unpaired_cs", N_READS, ecoli_cs_config(),
             False, cs_k, MESH_READS),
            ("(a) LS pairs", "ecoli_paired_ls", PAIRED_READS,
             MapperConfig(pair_mode="opp-in"), True, {}, MESH_READS),
            ("(a) CS pairs", "ecoli_paired_cs", PAIRED_READS,
             MapperConfig(mode=cs, pair_mode="opp-in"), True, {},
             MESH_READS),
            ("(a) 250 bp (the long-read fallback on mesh[0])",
             "ecoli_unpaired_ls_long", N_READS, MapperConfig(), False,
             long_k, MESH_LONG_READS)):
        idx, reads = _dataset(name, n_all)
        reads = reads[:n]
        kw = (dict(collect_z=True)
              if title == "(a) LS" else {})
        _tier_run(MeshMapper(idx, cfg, mesh=mesh), reads[:2 * B_CHUNK],
                  paired)                                 # warm-up
        mm = MeshMapper(idx, cfg, mesh=mesh)
        torch.cuda.reset_peak_memory_stats(dev)
        for k in kernels.values():
            k[5].reset()
        sam, secs = _tier_run(mm, reads, paired, **kw)
        n_k = {name: k[5].n for name, k in kernels.items()}
        print(f"21 {title}: launches {n_k}; peak device memory "
              f"{_peak_gib(dev)}; shards' plane bytes {mm.plane_bytes}; "
              f"inner mapper's planes {mm.m.device_planes()}; {smi}")
        for k, v in n_k.items():
            if v <= 0:
                raise AssertionError(f"{k}: not launched by the mesh path")
        launches.update(n_k)
        if kw:
            zp = mm.last_zpart
            merged = zmerge_psum(mesh, zp)
            ok = np.allclose(merged, zp.sum(axis=0), rtol=1e-12, atol=0)
            print(f"21 {title}: z1 partials [{zp.shape[0]}, {zp.shape[1]}]"
                  f", shards with posteriors "
                  f"{int((zp.sum(axis=1) > 0).sum())}; zmerge_psum equals "
                  f"their host sum (rtol 1e-12): {ok}")
            if not ok or not merged.max() > 0:
                raise AssertionError("21 (a): zmerge_psum differs from the "
                                     "host sum")
            print(f"21 {title} card busy share (profiled run of the first "
                  f"{4 * B_CHUNK} reads), summed over the shards' streams: "
                  + _busy_share(lambda: _tier_run(
                      MeshMapper(idx, cfg, mesh=mesh), reads[:4 * B_CHUNK],
                      paired)[1]))
        _against_unsharded(title, dev, mm, idx, cfg, reads, paired, sam,
                           secs)
        if kernels:
            calls = _first_calls_of(
                lambda: _tier_run(MeshMapper(idx, cfg, mesh=mesh),
                                  reads[:B_CHUNK], paired),
                {k: v[:2] for k, v in kernels.items()})
            for k, v in kernels.items():
                rec[k] = _check_captured(
                    k, *calls[k], v[2], v[3], v[4], cs=v[6],
                    plain_reps=1, what="the mesh path's first per-shard "
                    "launch")
            del calls
    return launches, rec


def run_mesh_hg(dev, mesh, smi):
    """Phase 21 (b): MeshMapper on phase 12's bin and reads, fused on the
    mesh, against the unsharded two-phase card run."""
    from shrimp_tpu_torch import dataset
    from shrimp_tpu_torch.config import MapperConfig
    from shrimp_tpu_torch.parallel.meshmap import MeshMapper
    codes, idx = _hg_ls()
    reads = dataset.hg_reads(codes, HG_READS)[:MESH_HG_READS]
    cfg = MapperConfig()
    mm = MeshMapper(idx, cfg, mesh=mesh)
    torch.cuda.reset_peak_memory_stats(dev)
    sam, secs = _tier_run(mm, reads, False)
    st = mm.m.stats
    print(f"21 (b) hg LS: {st.vec_invocs / st.reads!r} windows per read, "
          f"every one in a fused per-shard launch; peak device memory "
          f"{_peak_gib(dev)}; shards' plane bytes {mm.plane_bytes}; {smi}")
    print("21 (b) stage seconds: " + ", ".join(
        f"{k} {v!r}" for k, v in st.stage_secs.items()))
    with _Dispatches(False) as disp:
        _against_unsharded("(b) hg LS (unsharded: two-phase)", dev, mm, idx,
                           cfg, reads, False, sam, secs)
    if not disp.all_two_phase():
        raise AssertionError("21 (b): the unsharded run was not two-phase")


# phase 21 (c) and (d)'s indexes, reads and SAM, phase 22's oracles
_SHARDED: dict = {}


def _region_contigs(codes, n, clen):
    return [(f"chr{i + 1}", np.ascontiguousarray(codes[i * clen:
                                                       (i + 1) * clen]))
            for i in range(n)]


def run_sharded_ecoli(dev, mesh, smi):
    """Phase 21 (c): ShardedIndexMapper on E. coli cut into four
    region-aligned contigs, one sub-index a shard (split_contig_bins),
    against the whole index's unsharded card stream."""
    from shrimp_tpu_torch import constants as C
    from shrimp_tpu_torch.config import MapperConfig
    from shrimp_tpu_torch.dataset import ecoli_cs_config
    from shrimp_tpu_torch.index.build import build_index
    from shrimp_tpu_torch.index.seeds import default_seeds
    from shrimp_tpu_torch.parallel.meshmap import (ShardedIndexMapper,
                                                   split_contig_bins)
    cs = C.MODE_COLOUR_SPACE
    t0 = time.perf_counter()
    contigs = _region_contigs(_dataset("ecoli_unpaired_ls", N_READS)[0].codes,
                              4, ECOLI_CONTIG_LEN)
    jobs = [(mode, b) for mode in ("ls", cs)
            for b in [contigs] + split_contig_bins(contigs, len(mesh))]
    with ThreadPoolExecutor(8) as ex:
        idxs = list(ex.map(lambda j: build_index(
            j[1], default_seeds(mode=j[0]), mode=j[0]), jobs))
    n = len(mesh) + 1
    built = {"ls": (idxs[0], idxs[1:n]), cs: (idxs[n], idxs[n + 1:])}
    _SHARDED.update(ecoli_contigs=contigs, ecoli_indexes=built)
    print(f"21 (c) E. coli in 4 contigs of {ECOLI_CONTIG_LEN} bases: whole "
          f"and sub-indexes, LS and CS, in {time.perf_counter() - t0!r} s")
    for title, name, n_all, cfg, paired in (
            ("(c) LS", "ecoli_unpaired_ls", N_READS, MapperConfig(), False),
            ("(c) LS pairs", "ecoli_paired_ls", PAIRED_READS,
             MapperConfig(pair_mode="opp-in"), True),
            ("(c) CS", "ecoli_unpaired_cs", N_READS, ecoli_cs_config(),
             False),
            ("(c) CS pairs", "ecoli_paired_cs", PAIRED_READS,
             MapperConfig(mode=cs, pair_mode="opp-in"), True)):
        reads = _dataset(name, n_all)[1][:MESH_READS]
        whole, subs = built[cfg.mode]
        sim = ShardedIndexMapper(subs, cfg, mesh=mesh)
        torch.cuda.reset_peak_memory_stats(dev)
        sam, secs = _tier_run(sim, reads, paired)
        z = sim.last_zpair_merged if paired else sim.last_z1_merged
        print(f"21 {title}: peak device memory {_peak_gib(dev)}; shards' "
              f"plane bytes {sim.plane_bytes}; inner mapper's planes "
              f"{sim.m.device_planes()}; last merged Z rows "
              f"{None if z is None else z.shape}, max "
              f"{None if z is None else float(z.max())!r}; {smi}")
        if sim.m.device_planes() or (cfg.mode == "ls" and not (
                z is not None and z.max() > 0)) or (paired and not (
                z is not None and z.max() > 0)):
            raise AssertionError(f"21 {title}: a whole-genome plane on the "
                                 "device, or no merged Z rows")
        want, secs_u = _against_unsharded(title, dev, sim, whole, cfg, reads,
                                          paired, sam, secs)
        _SHARDED[name] = dict(reads=reads, cfg=cfg, paired=paired, sam=sam,
                              secs=secs, want=want, secs_u=secs_u)


def _hg_split_data():
    """(bins, reads) of the split-db runs (phases 21 (d), 22 (c), 23
    (b)): four hg-like bins of HG_SUB_LEN bases (chr1..chr4) and
    MESH_HG_READS reads drawn evenly from them, made once a run."""
    from shrimp_tpu_torch import dataset
    from shrimp_tpu_torch.io.fasta import SeqRecord
    if "hg_data" not in _SHARDED:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(4) as ex:
            bins = list(ex.map(lambda i: dataset.hg_bin(HG_SUB_LEN, i),
                               range(4)))
        per = MESH_HG_READS // 4
        drawn = [dataset.hg_reads(b, per) for b in bins]
        reads = [SeqRecord(f"chr{i + 1}_{drawn[i][k].name}",
                           drawn[i][k].seq)
                 for k in range(per) for i in range(4)]
        print(f"4 bins of {HG_SUB_LEN} bases (chr1..chr4) and "
              f"{len(reads)} reads, a quarter from each, generated in "
              f"{time.perf_counter() - t0!r} s")
        _SHARDED["hg_data"] = (bins, reads)
    return _SHARDED["hg_data"]


def run_sharded_hg(dev, mesh, smi):
    """Phase 21 (d): the split-db workflow on-line: four hg-like bins of
    HG_SUB_LEN bases, one sub-index each, ShardedIndexMapper on
    MESH_HG_READS reads drawn evenly from them; the oracle is the CPU run
    of the same tier on the first MESH_HG_CPU_READS reads."""
    from shrimp_tpu_torch.config import MapperConfig
    from shrimp_tpu_torch.index.build import build_index
    from shrimp_tpu_torch.index.seeds import default_seeds
    from shrimp_tpu_torch.parallel import meshmap
    bins, reads = _hg_split_data()
    t1 = time.perf_counter()
    with ThreadPoolExecutor(4) as ex:
        subs = list(ex.map(lambda i: build_index(
            [(f"chr{i + 1}", bins[i])], default_seeds()), range(4)))
    print(f"21 (d) the 4 bins' sub-indexes in {time.perf_counter() - t1!r} "
          "s")
    cfg = MapperConfig()
    merges = []
    orig = meshmap.zmerge_psum

    def recorded(mesh_, zp):
        merged = orig(mesh_, zp)
        merges.append((zp, merged))
        return merged
    torch.cuda.reset_peak_memory_stats(dev)
    meshmap.zmerge_psum = recorded
    try:
        sim = meshmap.ShardedIndexMapper(subs, cfg, mesh=mesh)
        sam, secs = _tier_run(sim, reads, False)
    finally:
        meshmap.zmerge_psum = orig
    st = sim.m.stats
    z_ok = bool(merges) and all(
        np.allclose(mg, zp.sum(axis=0), rtol=1e-12, atol=0)
        for zp, mg in merges)
    n_rec = sam.count(b"\n")
    print(f"21 (d) split-db on-line: {len(reads)} reads in {secs!r} s = "
          f"{len(reads) / secs!r} reads/s; list cutoff {sim.m.cutoff}; "
          f"{st.vec_invocs / st.reads!r} windows per read; "
          f"{n_rec} records; peak device memory "
          f"{_peak_gib(dev)}; shards' plane bytes {sim.plane_bytes} "
          f"(sum {sum(sim.plane_bytes)}); inner mapper's planes "
          f"{sim.m.device_planes()}; {smi}")
    print("21 (d) stage seconds: " + ", ".join(
        f"{k} {v!r}" for k, v in st.stage_secs.items()))
    print(f"21 (d) z1 merges {len(merges)}: each equals the host sum of "
          f"its partials (rtol 1e-12): {z_ok}")
    if not z_ok or sim.m.device_planes() or st.reads_mapped < 0.8 * len(
            reads):
        raise AssertionError("21 (d): z1 merge off, a whole-genome plane on "
                             "the device, or mostly unmapped")
    first = reads[:MESH_HG_CPU_READS]
    sam_gpu, _ = _tier_run(sim, first, False)
    cpu = meshmap.ShardedIndexMapper(subs, cfg,
                                     mesh=meshmap.make_mesh(["cpu"] * 4))
    sam_cpu, secs_cpu = _tier_run(cpu, first, False)
    same = sam_cpu == sam_gpu and sam.startswith(sam_gpu)
    print(f"21 (d) on a mesh of 4 cpu shards (plain versions), first "
          f"{len(first)} reads: {secs_cpu!r} s; SAM identical to the card "
          f"run's and a prefix of the full run's: {same}")
    if not same:
        raise AssertionError("21 (d): CUDA and CPU SAM bytes differ")
    _SHARDED["hg"] = dict(bins=bins, reads=reads, cfg=cfg, paired=False,
                          sam=sam, secs=secs, cpu=sam_cpu)


# ------------------------------------------------------------ phase 22

DIST_RANKS = 2            # of phase 21's four shards, two a rank
DIST_LONG_READS = 2048
DIST_TIMEOUT_S = 300      # both ranks are killed past it
DIST_WARM_READS = 4096
DIST_DEVICE = "cuda:0"
DIST_HOOK = "chip_smoke:dist_kernel_checks"
DIST_DIR = os.path.join("build", "dist22")
# the dist path's kernel records: (launch counter, the jobs of its path)
_DIST_LS_JOBS = ("a_ls", "a_ls_rs", "a_pairs", "a_pairs_rs", "c_hg")
_DIST_CS_JOBS = ("a_cs", "a_cs_pairs")
DIST_LAUNCHES = {
    "sw_vector_dist": ("sw_vector", _DIST_LS_JOBS),
    "sw_full_stats_dist": ("sw_full_stats", _DIST_LS_JOBS),
    "sw_vector_cs_dist": ("sw_vector_cs", _DIST_CS_JOBS),
    "sw_cs_full_dist": ("sw_cs_full", _DIST_CS_JOBS),
    "cs_traceback_dist": ("cs_traceback", _DIST_CS_JOBS),
    "sw_vector_g352_dist": ("sw_vector", ("b_long",)),
    "sw_full_bp_dist": ("sw_full_bp", ("b_long",)),
    "ls_traceback_dist": ("ls_traceback", ("b_long",))}


def dist_kernel_checks(run, names, in_turn):
    """`parallel/dist_worker.py --kernel-check chip_smoke:dist_kernel_checks`,
    called in every rank: `run()` maps, and each kernel of `names`
    (`_flow_kernels("_dist")`) is held against its plain version on this
    rank's first launch of it in that run, with its device time, plain
    time and bound; the ranks take turns (`in_turn`) so that their
    timings do not overlap on the card."""
    ks = {k: v for d in _flow_kernels("_dist") for k, v in d.items()
          if k in names}
    calls = _first_calls_of(run, {k: v[:2] for k, v in ks.items()})
    missing = sorted(set(ks) - set(calls))
    if missing:
        raise AssertionError(f"{missing}: not launched on this rank's dist "
                             "path")
    rank = torch.distributed.get_rank()
    return in_turn(lambda: {k: _check_captured(
        k, *calls[k], v[2], v[3], v[4], cs=v[6], plain_reps=1,
        what=f"rank {rank}'s first launch on the dist path")
        for k, v in ks.items()})


def _dist_cases():
    """Phase 22's jobs: (job, genome, phase 21's workload (its reads
    and oracles), MapperConfig keywords, paired, read sharding, kernel
    records captured in it)."""
    pairs, cs = {"pair_mode": "opp-in"}, {"mode": "cs"}
    return (("a_ls", "ecoli_ls", "ecoli_unpaired_ls", {}, False, False,
             ["sw_vector_dist", "sw_full_stats_dist"]),
            ("a_ls_rs", "ecoli_ls", "ecoli_unpaired_ls", {}, False, True, []),
            ("a_pairs", "ecoli_ls", "ecoli_paired_ls", pairs, True, False, []),
            ("a_pairs_rs", "ecoli_ls", "ecoli_paired_ls", pairs, True, True,
             []),
            ("b_long", "ecoli_ls", "long", {}, False, False,
             ["sw_vector_g352_dist", "sw_full_bp_dist", "ls_traceback_dist"]),
            ("a_cs", "ecoli_cs", "ecoli_unpaired_cs", cs, False, False,
             ["sw_vector_cs_dist", "sw_cs_full_dist", "cs_traceback_dist"]),
            ("a_cs_pairs", "ecoli_cs", "ecoli_paired_cs",
             dict(cs, **pairs), True, False, []),
            ("c_hg", "hg", "hg", {}, False, False, []))


def _dist_long_oracle(dev, mesh):
    """Phase 22 (b)'s oracles: ShardedIndexMapper on phase 21 (c)'s four
    LS sub-indexes and the unsharded card stream on their whole index,
    DIST_LONG_READS of phase 11's 250 bp reads."""
    from shrimp_tpu_torch.config import MapperConfig
    from shrimp_tpu_torch.parallel.meshmap import ShardedIndexMapper
    whole, subs = _SHARDED["ecoli_indexes"]["ls"]
    reads = _dataset("ecoli_unpaired_ls_long", N_READS)[1][:DIST_LONG_READS]
    cfg = MapperConfig()
    sam, secs = _tier_run(ShardedIndexMapper(subs, cfg, mesh=mesh), reads,
                          False)
    m = _mapper_cls(False)(whole, cfg, dev).upload_planes()
    _map(m, reads[:B_CHUNK // 4], _ls_stream)             # warm-up
    want, secs_u = _map(m, reads, _ls_stream)
    return dict(reads=reads, cfg=cfg, paired=False, sam=sam, secs=secs,
                want=want, secs_u=secs_u)


def _run_ranks(jobs_path, out) -> None:
    """DIST_RANKS rank processes of parallel/dist_worker.py over gloo (a
    file:// init), their shards on DIST_DEVICE; all are
    killed if either outlives DIST_TIMEOUT_S, and a rank that exits
    non-zero fails the phase. Their output is printed after them."""
    pg = os.path.abspath(os.path.join(DIST_DIR, "pg"))
    logs = [os.path.join(DIST_DIR, f"rank{r}.log") for r in range(DIST_RANKS)]
    procs = []
    for r in range(DIST_RANKS):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "shrimp_tpu_torch.parallel.dist_worker",
                 "--rank", str(r), "--world", str(DIST_RANKS), "--init",
                 "file://" + pg, "--jobs", jobs_path, "--out", out,
                 "--device", DIST_DEVICE, "--timeout", str(DIST_TIMEOUT_S),
                 "--kernel-check", DIST_HOOK],
                cwd=os.path.dirname(os.path.abspath(__file__)), stdout=log,
                stderr=subprocess.STDOUT))
    deadline = time.monotonic() + DIST_TIMEOUT_S
    timed_out = False
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        timed_out = True
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, path in enumerate(logs):
        with open(path) as f:
            for ln in f.read().splitlines()[-60:]:
                print(f"22 rank {r}| {ln}")
    if timed_out or any(p.returncode != 0 for p in procs):
        raise AssertionError(f"22: a rank timed out ({timed_out}) or failed "
                             f"(exit codes {[p.returncode for p in procs]})")


def _report_diff(job, got: bytes, want: bytes) -> None:
    """Print how two SAM texts differ (the first differing records) and
    write both beside the phase's inputs for a closer look."""
    a, b = got.split(b"\n"), want.split(b"\n")
    bad = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
    print(f"22 {job}: {len(a)} / {len(b)} lines, {len(bad)} differ; first:")
    for i in bad[:4]:
        print(f"  got  {a[i][:300]!r}\n  want {b[i][:300]!r}")
    for tag, text in (("got", got), ("want", want)):
        with open(os.path.join(DIST_DIR, f"{job}.{tag}.sam"), "wb") as f:
            f.write(text)


def run_dist(dev, smi):
    """Phase 22: the multi-process tier, two ranks on the one card, two
    shards each (["cuda:0"] * 2), over gloo: (a) phase 21 (c)'s E. coli
    contigs and workloads (LS and LS pairs again with read sharding),
    (b) DIST_LONG_READS 250 bp reads (the per-shard traceback flow),
    (c) phase 21 (d)'s split-db bins and reads. Every SAM must equal, on
    both ranks, ShardedIndexMapper's on the same four sub-indexes and
    reads and the unsharded stream's (for (c) the CPU run of the first
    MESH_HG_CPU_READS reads). Returns the launches of the dist path and
    the kernel records of the ranks' first launches."""
    import shutil
    from shrimp_tpu_torch.parallel.dist_worker import write_genome
    t0 = time.perf_counter()
    if "ecoli_unpaired_ls" not in _SHARDED or "hg" not in _SHARDED:
        mesh = _mesh()          # phase 21 did not run: its oracles now
        run_sharded_ecoli(dev, mesh, smi)
        run_sharded_hg(dev, mesh, smi)
    oracles = dict(_SHARDED)
    oracles["long"] = _dist_long_oracle(dev, _mesh())
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    os.makedirs(DIST_DIR)
    write_genome(os.path.join(DIST_DIR, "ecoli.npz"),
                 [[c] for c in _SHARDED["ecoli_contigs"]])
    write_genome(os.path.join(DIST_DIR, "hg.npz"),
                 [[(f"chr{i + 1}", b)] for i, b in
                  enumerate(_SHARDED["hg"]["bins"])])
    cases = _dist_cases()
    warm = ("warm", "ecoli_ls", "ecoli_unpaired_ls", {}, False, False, [])
    spec = dict(genomes=dict(ecoli_ls=dict(path="ecoli.npz", mode="ls"),
                             ecoli_cs=dict(path="ecoli.npz", mode="cs"),
                             hg=dict(path="hg.npz", mode="ls")), jobs=[])
    for job, genome, wl, cfg, paired, rs, capture in (warm,) + cases:
        reads = oracles[wl]["reads"]
        if job == "warm":
            reads = reads[:DIST_WARM_READS]
        _write_fasta(os.path.join(DIST_DIR, job + ".fa"), reads)
        spec["jobs"].append(dict(name=job, genome=genome, reads=job + ".fa",
                                 paired=paired, read_sharding=rs,
                                 batch_size=B_CHUNK, config=cfg,
                                 capture=capture))
    jobs_path = os.path.join(DIST_DIR, "jobs.json")
    with open(jobs_path, "w") as f:
        json.dump(spec, f)
    out = os.path.join(DIST_DIR, "out")
    t1 = time.perf_counter()
    print(f"22: {DIST_RANKS} ranks on one card ({smi}), "
          f"{len(_SHARDED['ecoli_contigs']) // DIST_RANKS} shards each on "
          f"{DIST_DEVICE}, over gloo; oracles and inputs ready in "
          f"{t1 - t0!r} s. Two ranks sharing one card show the exchanges, "
          "not scaling across cards")
    _run_ranks(jobs_path, out)
    print(f"22: the ranks ran in {time.perf_counter() - t1!r} s")
    launches = {}
    for job, genome, wl, cfg, paired, rs, capture in cases:
        o = oracles[wl]
        got = []
        for r in range(DIST_RANKS):
            stem = os.path.join(out, f"{job}.r{r}")
            with open(stem + ".sam", "rb") as f, open(stem + ".json") as g:
                got.append((f.read(), json.load(g)))
        metas = [m for _, m in got]
        for counter, jobs in DIST_LAUNCHES.values():
            if job in jobs:
                launches[counter, job] = sum(m["launches"][counter]
                                             for m in metas)
        wall = max(m["map_wall"] for m in metas)
        n = len(o["reads"])
        n_rec = got[0][0].count(b"\n")
        same = all(sam == o["sam"] for sam, _ in got)
        if wl == "hg":
            _SHARDED["hg"]["dist_rps"] = n / wall
            same_u = all(sam.startswith(o["cpu"]) for sam, _ in got)
            unsharded = (f"CPU run of the first {MESH_HG_CPU_READS} reads a "
                         f"prefix of both: {same_u}")
        else:
            same_u = all(sam == o["want"] for sam, _ in got)
            unsharded = (f"unsharded stream {n / o['secs_u']!r} reads/s, "
                         f"identical: {same_u}")
        print(f"22 {job}: {n} reads, the slower rank's wall {wall!r} s = "
              f"{n / wall!r} reads/s; ShardedIndexMapper {n / o['secs']!r} "
              f"reads/s, identical on both ranks: {same}; {unsharded}; "
              f"{n_rec} records; merge bytes "
              f"{[m['merge_bytes'] for m in metas]}, merge s "
              f"{[m['merge_secs'] for m in metas]}; f1_local_windows "
              f"{[m['f1_local_windows'] for m in metas]}; slice_jobs "
              f"{[m['slice_jobs'] for m in metas]}; windows a read "
              f"{metas[0]['windows_per_read']!r}; peak device memory "
              f"{[m['peak_gib'] for m in metas]} GiB; launches "
              f"{[m['launches'] for m in metas]}")
        for r, m in enumerate(metas):
            print(f"22 {job} rank {r} stage seconds: " + ", ".join(
                f"{k} {v!r}" for k, v in m["stage_secs"].items()))
        if not (same and same_u) or n_rec < 0.8 * n:
            _report_diff(job, got[0][0], o["sam"])
            raise AssertionError(f"22 {job}: a rank's SAM differs from its "
                                 "oracles, or mostly unmapped")
        if rs:
            for key in ("slice_jobs", "f1_local_windows"):
                v = [m[key] for m in metas]
                if not (min(v) > 0 and max(v) <= 0.75 * sum(v)):
                    raise AssertionError(f"22 {job}: {key} {v} not split")
    rec = {}
    recs = []
    for r in range(DIST_RANKS):
        with open(os.path.join(out, f"kernels.r{r}.json")) as f:
            recs.append(json.load(f))
    n_k = {}
    for name, (counter, jobs) in DIST_LAUNCHES.items():
        n_k[name] = sum(launches[counter, j] for j in jobs)
        if n_k[name] <= 0:
            raise AssertionError(f"{name}: not launched by the dist path")
        if any(name not in rr for rr in recs):
            raise AssertionError(f"{name}: a rank left no kernel record")
        rec[name] = dict(recs[0][name],
                         err=max(rr[name]["err"] for rr in recs))
        if rec[name]["err"] != 0:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 "version on a rank's first launch")
    print(f"22: launches of the dist path, both ranks: {n_k}; kernel "
          f"records: rank 0 {recs[0]}; rank 1 {recs[1]}")
    return n_k, rec


# ------------------------------------------------------------ phase 23

SPLIT_READS = 20_000          # (a): reads of each workload
SPLIT_CPU_READS = 2048        # (a): the CPU workflow's reads
PRETTY_READS = 4096           # (c)
PRETTY_CPU_READS = 512
# (b) keeps four saved chunk indexes of about 0.7 GB on disk, two below it
SPLIT_MIN_FREE = 8 << 30


def _launch_counters() -> dict:
    from shrimp_tpu_torch.core import sw_cs_full, sw_full, sw_vector
    return {"sw_vector": sw_vector.LAUNCHES,
            "sw_vector_cs": sw_vector.CS_LAUNCHES,
            "sw_full_stats": sw_full.LAUNCHES,
            "sw_full_bp": sw_full.BP_LAUNCHES,
            "ls_traceback": sw_full.TB_LAUNCHES,
            "sw_cs_full": sw_cs_full.DP_LAUNCHES,
            "cs_traceback": sw_cs_full.TB_LAUNCHES}


class _CLI:
    """shrimp_tpu_torch.cli.main called in-process in one directory, each
    call's stdout to a file (or nowhere) and its stderr to another. Each
    call returns (seconds, [seconds of each GenomeIndex.load it made],
    stderr text, {counter: launches it added})."""

    def __init__(self, tmp):
        # imported before any redirect: split_db and its kin bind
        # `out=sys.stderr` when their module is first imported
        from shrimp_tpu_torch.tools import split  # noqa: F401
        self.tmp = tmp
        self.calls = 0

    def path(self, *parts):
        return os.path.join(self.tmp, *parts)

    def __call__(self, *argv, out=None):
        import contextlib
        from shrimp_tpu_torch import cli
        from shrimp_tpu_torch.index.build import GenomeIndex
        self.calls += 1
        err_path = self.path(f"call{self.calls}.err")
        loads, load = [], GenomeIndex.load

        def timed_load(p):
            t = time.perf_counter()
            idx = load(p)
            loads.append(time.perf_counter() - t)
            return idx
        counters = _launch_counters()
        before = {k: c.n for k, c in counters.items()}
        GenomeIndex.load = staticmethod(timed_load)
        t0 = time.perf_counter()
        try:
            with open(out or os.devnull, "w") as f, \
                    open(err_path, "w") as e, \
                    contextlib.redirect_stdout(f), \
                    contextlib.redirect_stderr(e):
                # as sys.stdout's: `map` writes the header as text and
                # the streams' SAM bytes to the binary buffer under it
                f.reconfigure(write_through=True)
                rc = cli.main(list(argv))
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
        finally:
            GenomeIndex.load = staticmethod(load)
        secs = time.perf_counter() - t0
        with open(err_path) as f:
            err = f.read()
        if rc != 0:
            raise AssertionError(f"23: {' '.join(argv)}: exit {rc}\n"
                                 f"{err[-3000:]}")
        return secs, loads, err, {k: c.n - before[k]
                                  for k, c in counters.items()}


def _sam_body(data) -> bytes:
    b = data if isinstance(data, bytes) else data.encode()
    return b"".join(ln + b"\n" for ln in b.split(b"\n")
                    if ln and not ln.startswith(b"@"))


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _merge_equivalent(gl: str, wl: str) -> bool:
    """The reference's rule for a merged record against the whole-genome
    run's (tests/test_merge.py::_assert_equivalent): equal but for the
    mapq (a merged mapq under 4 counts as 0, then within 1) and Z fields
    (within 2 of 1/1000 neg-log units)."""
    gf, wf = gl.split("\t"), wl.split("\t")
    if len(gf) != len(wf):
        return False
    for i, (a, b) in enumerate(zip(gf, wf)):
        if a == b:
            continue
        if i == 4:
            ga = int(a)
            if abs((0 if ga < 4 else ga) - int(b)) > 1:
                return False
        elif a.startswith("Z") and b.startswith("Z"):
            if a[:5] != b[:5] or abs(int(a[5:]) - int(b[5:])) > 2:
                return False
        else:
            return False
    return True


def _norm_unmapped(lines):
    """The whole-genome run's unmapped records in mergesam's form: both
    unmapped bits, mate fields cleared (tests/test_merge.py:154-167)."""
    out = []
    for ln in lines:
        f = ln.split("\t")
        if int(f[1]) & 0x4:
            f = [f[0], str(int(f[1]) | 0xC), "*", "0", "0", "*", "*", "0",
                 "0", f[9], f[10]] + [t for t in f[11:]
                                     if t[:2] in ("CQ", "CS", "RG", "R2")]
        out.append("\t".join(f))
    return out


def _against_whole(title, merged: bytes, whole: bytes, paired: bool,
                   gate: bool) -> None:
    """Sorted merged records against the whole-index run's: how many are
    byte-equal, how many need the reference's rule, how many fail it."""
    got = sorted(merged.decode().splitlines())
    want = sorted(whole.decode().splitlines())
    if paired:
        got, want = sorted(_norm_unmapped(got)), sorted(_norm_unmapped(want))
    same = sum(a == b for a, b in zip(got, want))
    rule = sum(a != b and _merge_equivalent(a, b) for a, b in zip(got, want))
    bad = len(got) - same - rule if len(got) == len(want) else None
    for a, b in [(a, b) for a, b in zip(got, want)
                 if not _merge_equivalent(a, b)][:3]:
        print(f"23 {title}, outside the rule:\n  merged {a[:300]}\n  "
              f"whole  {b[:300]}")
    print(f"23 {title}: merged {len(got)} records, whole index "
          f"{len(want)}; byte-equal {same}, equal within the reference's "
          f"rule (mapq, Z fields) {rule}, outside it {bad}"
          + ("" if gate else " (printed only: the reference asserts no "
             "such merge)"))
    if gate and bad != 0:
        raise AssertionError(f"23 {title}: the merged records differ from "
                             "the whole index's beyond the reference's rule")


def _prefix_of(cpu: bytes, card: bytes, first) -> bool:
    """`cpu` (a run on the `first` reads) is the prefix of `card` (the run
    on all reads) that those reads own: the next record of `card`, if
    any, belongs to a later read."""
    names = {r.name for r in first} | {r.name.rsplit("/", 1)[0]
                                       for r in first}
    if not cpu or not card.startswith(cpu):
        return False
    rest = card[len(cpu):]
    return not rest or rest.split(b"\t", 1)[0].decode() not in names


def _kernel_records(suffix, calls, kernels, launches) -> dict:
    """Each kernel of `kernels` ({name: (module, wrapper, kernel, plain,
    bound, counter, cs)}, `_flow_kernels`' form) against its plain
    version on the arguments `calls` captured, with its launches."""
    rec = {}
    for name, k in kernels.items():
        if launches[name] <= 0:
            raise AssertionError(f"{name}: not launched by phase 23's maps")
        rec[name] = _check_captured(
            name, *calls[name], k[2], k[3], k[4], cs=k[6], plain_reps=1,
            what=f"the first launch of the first {suffix} map")
    return rec


def _check_rise(title, added, kernels) -> None:
    names = {k[5] for k in kernels.values()}
    keys = [n for n, c in _launch_counters().items() if c in names]
    low = [n for n in keys if added[n] <= 0]
    if low:
        raise AssertionError(f"23 {title}: the map launched no {low}")


def _split_ecoli(dev, smi, cli):
    """Phase 23 (a): E. coli in four contigs, split-db into four chunks,
    project-db (LS and CS), a map a chunk and the merge, for phase 5's LS
    reads and phase 17's CS pairs."""
    from shrimp_tpu_torch import constants as C
    from shrimp_tpu_torch import fastpath, fastpath_cs
    from shrimp_tpu_torch.config import MapperConfig
    from shrimp_tpu_torch.core.encode import decode_ls
    from shrimp_tpu_torch.index.build import GenomeIndex, build_index
    from shrimp_tpu_torch.index.seeds import default_seeds
    from shrimp_tpu_torch.io.fasta import SeqRecord
    from shrimp_tpu_torch.mapper import Mapper
    from shrimp_tpu_torch.paired import PairedMapper
    from shrimp_tpu_torch.utils.memmodel import plan_index_ram
    contigs = _SHARDED.get("ecoli_contigs") or _region_contigs(
        _dataset("ecoli_unpaired_ls", N_READS)[0].codes, 4, ECOLI_CONTIG_LEN)
    _write_fasta(cli.path("ecoli.fa"), [
        SeqRecord(n, decode_ls(c)) for n, c in contigs])
    # a budget that holds one contig a chunk, not two, in either space
    fixed = plan_index_ram(0, 4, 12)
    ram = (plan_index_ram(ECOLI_CONTIG_LEN, 4, 12, colour_space=True)
           + (plan_index_ram(ECOLI_CONTIG_LEN, 4, 12) - fixed) // 2) / 2 ** 30
    steps = []
    for space in ("ls", "cs"):
        os.makedirs(cli.path(space))
        cs = ("--cs",) if space == "cs" else ()
        secs = cli("split-db", cli.path("ecoli.fa"), "--ram-size", repr(ram),
                   "--prefix", cli.path(space, "chunk"), *cs)[0]
        chunks = sorted(cli.path(space, f) for f in os.listdir(cli.path(space))
                        if f.endswith(".fa"))
        if len(chunks) != 4:
            raise AssertionError(f"23 (a): split-db --ram-size {ram!r} made "
                                 f"{len(chunks)} chunks, not 4")
        steps.append((f"split-db{' --cs' if cs else ''}", secs))
        steps.append((f"project-db{' --cs' if cs else ''}",
                      cli("project-db", *cs, *chunks)[0]))
    print(f"23 (a) E. coli in 4 contigs of {ECOLI_CONTIG_LEN} bases, "
          f"split-db --ram-size {ram!r} (one contig a chunk): "
          + ", ".join(f"{a} {s!r} s" for a, s in steps))
    ls_k, cs_k, _ = _flow_kernels("_cli")
    cs_mode = C.MODE_COLOUR_SPACE
    launches, rec = {}, {}
    for title, space, wl, n_all, cfg, flags, kernels, stream in (
            ("(a) LS", "ls", "ecoli_unpaired_ls", N_READS, MapperConfig(),
             (), ls_k, fastpath.map_unpaired_sam_stream),
            ("(a) CS pairs", "cs", "ecoli_paired_cs", PAIRED_READS,
             MapperConfig(mode=cs_mode, pair_mode="opp-in"),
             ("--cs", "-p", "opp-in"), cs_k,
             fastpath_cs.map_paired_cs_sam_stream)):
        reads = _dataset(wl, n_all)[1][:SPLIT_READS]
        paired = cfg.pair_mode != "none"
        rpath = cli.path(f"{space}.fa")
        _write_fasta(rpath, reads)
        npzs = [cli.path(space, f"chunk-{i:04d}.npz") for i in range(4)]
        sams = [p[:-4] + ".sam" for p in npzs]
        for c in kernels.values():
            c[5].reset()
        runs, calls = [], None
        for i, (npz, sam) in enumerate(zip(npzs, sams)):
            if i == 0:
                out = []
                calls = _first_calls_of(
                    lambda: out.append(cli("map", *flags, rpath, npz,
                                           out=sam)),
                    {k: v[:2] for k, v in kernels.items()})
                run = out[0]
            else:
                run = cli("map", *flags, rpath, npz, out=sam)
            _check_rise(f"{title} chunk {i}", run[3], kernels)
            runs.append(run)
        merged = cli.path(space, "merged.sam")
        m_secs = cli("merge", rpath, *sams, out=merged)[0]
        n_k = {k: v[5].n for k, v in kernels.items()}
        launches.update(n_k)
        map_secs = sum(r[0] for r in runs)
        print(f"23 {title}: {len(reads)} reads, 4 maps on {dev} "
              f"{[r[0] for r in runs]} s (index loads "
              f"{[r[1] for r in runs]} s), merge {m_secs!r} s of "
              f"{sum(os.path.getsize(p) for p in sams)} SAM bytes: "
              f"{len(reads) / (map_secs + m_secs)!r} reads/s over map + "
              f"merge; launches {n_k}; {smi}")
        # each chunk's SAM is the in-process card stream's on its index
        for i, (npz, sam) in enumerate(zip(npzs, sams)):
            m = (PairedMapper if paired else Mapper)(GenomeIndex.load(npz),
                                                      cfg, dev)
            want = b"".join(stream(m, reads))
            if _sam_body(_read(sam)) != want or not want:
                raise AssertionError(f"23 {title} chunk {i}: SAM body "
                                     "differs from the in-process stream's")
        # the CPU workflow on the first reads: the merged prefix
        first = reads[:SPLIT_CPU_READS]
        fpath = cli.path(f"{space}_first.fa")
        _write_fasta(fpath, first)
        t0 = time.perf_counter()
        cpu_sams = [p[:-4] + ".cpu.sam" for p in npzs]
        for npz, sam in zip(npzs, cpu_sams):
            cli("map", "--device", "cpu", *flags, fpath, npz, out=sam)
        cpu_merged = cli.path(space, "merged.cpu.sam")
        cli("merge", fpath, *cpu_sams, out=cpu_merged)
        merged_b = _sam_body(_read(merged))
        same = _prefix_of(_sam_body(_read(cpu_merged)), merged_b, first)
        print(f"23 {title}: the --device cpu workflow on the first "
              f"{len(first)} reads in {time.perf_counter() - t0!r} s; its "
              f"merged SAM is the card workflow's prefix for them: {same}")
        if not same:
            raise AssertionError(f"23 {title}: the CPU workflow's merged "
                                 "SAM differs from the card's")
        # the merged records against the whole index's card stream
        o = _SHARDED.get(wl)
        if o is None or o["reads"] != reads or o["cfg"] != cfg:
            whole = build_index(contigs, default_seeds(mode=cfg.mode),
                                mode=cfg.mode)
            m = (PairedMapper if paired else Mapper)(whole, cfg, dev)
            want = b"".join(stream(m, reads))
            del whole, m
        else:
            want = o["want"]
        _against_whole(f"{title} merged vs the whole index", merged_b,
                       want, paired, gate=not paired)
        if not paired:
            # one map and one merge as `python -m shrimp_tpu_torch`
            _subprocess_twins(cli, flags, rpath, npzs[0], sams, merged)
        rec.update(_kernel_records(title[4:] + " chunk", calls, kernels,
                                   n_k))
        del calls
    return launches, rec


def _subprocess_twins(cli, flags, rpath, npz, sams, merged) -> None:
    """`map` of the first chunk and `merge` as subprocesses: the bytes of
    the in-process calls (the map's @PG line holds its own argv)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)

    def run(*args):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "shrimp_tpu_torch",
                              *args], capture_output=True, cwd=cli.tmp,
                             env=env, timeout=600)
        if res.returncode != 0:
            raise AssertionError(f"23 {' '.join(args)}: exit "
                                 f"{res.returncode}\n"
                                 f"{res.stderr.decode()[-3000:]}")
        return res.stdout, time.perf_counter() - t0

    def no_pg(b):
        return [ln for ln in b.split(b"\n") if not ln.startswith(b"@PG")]
    got_map, s_map = run("map", *flags, rpath, npz)
    got_merge, s_merge = run("merge", rpath, *sams)
    same = (no_pg(got_map) == no_pg(_read(sams[0])),
            got_merge == _read(merged))
    print(f"23 (a) `python -m shrimp_tpu_torch map` of chunk 0 "
          f"{s_map!r} s and `merge` {s_merge!r} s (process start "
          f"included): the in-process calls' bytes: {same}")
    if not all(same):
        for tag, got, want in (("map", got_map, _read(sams[0])),
                               ("merge", got_merge, _read(merged))):
            a, b = got.split(b"\n"), want.split(b"\n")
            bad = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
            print(f"23 (a) {tag}: {len(a)} / {len(b)} lines, first "
                  f"differing: {[(a[i][:200], b[i][:200]) for i in bad[:2]]}")
        raise AssertionError("23 (a): a subprocess wrote other bytes than "
                             "the in-process call")


def _split_hg(dev, smi, cli):
    """Phase 23 (b): the hg-like split-db run, bench_hg.py's workflow:
    split-db, project-db, a map a chunk on the card under a memory cap
    equal to split-db's budget, the merge."""
    from shrimp_tpu_torch.core.encode import decode_ls
    from shrimp_tpu_torch.io.fasta import SeqRecord
    from shrimp_tpu_torch.utils import memmodel
    import shutil
    bins, reads = _hg_split_data()
    free = shutil.disk_usage(cli.tmp).free
    n_bins = 4 if free >= SPLIT_MIN_FREE else 2
    if n_bins < 4:
        keep = tuple(f"chr{i + 1}_" for i in range(n_bins))
        reads = [r for r in reads if r.name.startswith(keep)]
    print(f"23 (b) {free} bytes free on the temporary directory's disk: "
          f"{n_bins} bins of {HG_SUB_LEN} bases, {len(reads)} reads"
          + ("" if n_bins == 4 else " (cut from 4 bins: the disk cannot "
             "hold four saved chunk indexes)"))
    t0 = time.perf_counter()
    gpath = cli.path("hg.fa")
    _write_fasta(gpath, [SeqRecord(f"chr{i + 1}", decode_ls(bins[i]))
                         for i in range(n_bins)])
    rpath = cli.path("hg_reads.fa")
    _write_fasta(rpath, reads)
    fixed = memmodel.plan_index_ram(0, 4, 12)
    cost = memmodel.plan_index_ram(HG_SUB_LEN, 4, 12) - fixed
    ram = repr((fixed + cost + cost // 2) / 2 ** 30)
    os.makedirs(cli.path("hg"))
    s_split = cli("split-db", gpath, "--ram-size", ram, "--prefix",
                  cli.path("hg", "chunk"))[0]
    chunks = sorted(cli.path("hg", f) for f in os.listdir(cli.path("hg"))
                    if f.endswith(".fa"))
    if len(chunks) != n_bins:
        raise AssertionError(f"23 (b): split-db made {len(chunks)} chunks")
    s_proj = cli("project-db", *chunks)[0]
    saved = sum(os.path.getsize(c[:-3] + ".npz") for c in chunks)
    print(f"23 (b) inputs written, split-db --ram-size {ram} {s_split!r} "
          f"s, project-db {s_proj!r} s ({saved} bytes of saved indexes); "
          f"{time.perf_counter() - t0!r} s in all")
    # the whole genome under the same cap: the pre-check refuses it
    # before anything is built
    t0 = time.perf_counter()
    refused = None
    try:
        cli("map", "--strict-mem", "--max-mem", ram, rpath, gpath)
    except memmodel.MemCapError as exc:
        refused = str(exc)
    tr = memmodel.tracker()
    print(f"23 (b) map --strict-mem --max-mem {ram} on the whole genome: "
          f"{refused!r} after {time.perf_counter() - t0!r} s; bytes "
          f"accounted then {tr.crt_mem}")
    if refused is None or "split-db" not in refused or tr.crt_mem != 0:
        raise AssertionError("23 (b): the whole genome was not refused by "
                             "the memory cap before its build")
    kernels = {k: v for k, v in _flow_kernels("_hg_cli")[0].items()}
    for c in kernels.values():
        c[5].reset()
    runs, calls = [], None
    sams = [c[:-3] + ".sam" for c in chunks]
    for i, (c, sam) in enumerate(zip(chunks, sams)):
        args = ("map", "--max-mem", ram, rpath, c[:-3] + ".npz")
        if i == 0:
            out = []
            calls = _first_calls_of(
                lambda: out.append(cli(*args, out=sam)),
                {k: v[:2] for k, v in kernels.items()})
            run = out[0]
        else:
            run = cli(*args, out=sam)
        warned = [ln for ln in run[2].splitlines() if "my_malloc" in ln]
        if warned:
            raise AssertionError(f"23 (b) chunk {i}: a cap warning {warned}")
        _check_rise(f"(b) chunk {i}", run[3], kernels)
        runs.append(run)
    merged = cli.path("hg", "merged.sam")
    m_secs = cli("merge", rpath, *sams, out=merged)[0]
    n_k = {k: v[5].n for k, v in kernels.items()}
    map_secs = sum(r[0] for r in runs)
    rps = len(reads) / (map_secs + m_secs)
    merged_b = _sam_body(_read(merged))
    n_rec = merged_b.count(b"\n")
    o = _SHARDED.get("hg")
    print(f"23 (b) split-db workflow, {len(reads)} reads: "
          f"{rps!r} reads/s over map + merge (bench_hg.py's span); maps on "
          f"{dev} {[r[0] for r in runs]} s, their index loads "
          f"{[r[1] for r in runs]} s; merge {m_secs!r} s of "
          f"{sum(os.path.getsize(p) for p in sams)} SAM bytes; "
          f"{n_rec} merged records; no cap warning under "
          f"--max-mem {ram}; launches {n_k}; {smi}")
    print("23 (b) beside it, the same bins and reads in this run: "
          "ShardedIndexMapper (phase 21 (d)) "
          + (f"{len(reads) / o['secs']!r} reads/s" if o and n_bins == 4
             else "not in this run")
          + ", DistMapper's slower rank (phase 22 (c)) "
          + (f"{o['dist_rps']!r} reads/s" if o and "dist_rps" in o
             and n_bins == 4 else "not in this run"))
    if o and n_bins == 4:
        got = Counter(merged_b.split(b"\n"))
        want = Counter(_sam_body(o["sam"]).split(b"\n"))
        print(f"23 (b) merged records byte-equal to ShardedIndexMapper's "
              f"(information only): {sum((got & want).values()) - 1} of "
              f"{sum(got.values()) - 1} (it has {sum(want.values()) - 1})")
    first = reads[:MESH_HG_CPU_READS]
    fpath = cli.path("hg_first.fa")
    _write_fasta(fpath, first)
    t0 = time.perf_counter()
    cpu_sams = [p[:-4] + ".cpu.sam" for p in sams]
    for c, sam in zip(chunks, cpu_sams):
        cli("map", "--device", "cpu", "--max-mem", ram, fpath,
            c[:-3] + ".npz", out=sam)
    cpu_merged = cli.path("hg", "merged.cpu.sam")
    cli("merge", fpath, *cpu_sams, out=cpu_merged)
    same = _prefix_of(_sam_body(_read(cpu_merged)), merged_b, first)
    print(f"23 (b) the --device cpu workflow on the first {len(first)} "
          f"reads in {time.perf_counter() - t0!r} s; its merged SAM is the "
          f"card workflow's prefix for them: {same}")
    if not same:
        raise AssertionError("23 (b): the CPU workflow's merged SAM differs "
                             "from the card's")
    rec = _kernel_records("hg chunk", calls, kernels, n_k)
    del calls
    return n_k, rec, rps


def _pretty(dev, smi, cli):
    """Phase 23 (c): map --shrimp-format -P, LS and CS, on E. coli: the
    generic mapper on the card, against the --device cpu run."""
    from shrimp_tpu_torch.core import sw_cs, sw_cs_full, sw_full, sw_vector
    vec = (sw_vector.sw_vector_batch, sw_vector.sw_vector_batch_ref,
           _vec_launch_bound)
    launches, rec = {}, {}
    for title, wl, flags, kernels in (
            ("(c) LS -P", "ecoli_unpaired_ls", (), {
                "sw_vector_pretty_cli": (sw_vector, "sw_vector_batch", *vec,
                                         sw_vector.LAUNCHES, False),
                "sw_full_bp_pretty_cli": (
                    sw_full, "sw_full_bp", sw_full.sw_full_bp,
                    sw_full.sw_full_bp_ref, _bp_launch_bound,
                    sw_full.BP_LAUNCHES, False),
                "ls_traceback_pretty_cli": (
                    sw_full, "traceback_pack", sw_full.traceback_pack,
                    sw_full.traceback_pack_ref, _tb_launch_bound,
                    sw_full.TB_LAUNCHES, False)}),
            ("(c) CS -P", "ecoli_unpaired_cs", ("--cs",), {
                "sw_vector_cs_pretty_cli": (sw_vector, "sw_vector_batch",
                                            *vec, sw_vector.CS_LAUNCHES,
                                            True),
                "sw_cs_full_pretty_cli": (
                    sw_cs, "sw_full_cs_dp", sw_cs_full.sw_full_cs_dp,
                    sw_cs_full.sw_full_cs_dp_ref, _cs_dp_launch_bound,
                    sw_cs_full.DP_LAUNCHES, True),
                "cs_traceback_pretty_cli": (
                    sw_cs, "cs_traceback", sw_cs_full.cs_traceback,
                    sw_cs_full.cs_traceback_ref, _cs_tb_launch_bound,
                    sw_cs_full.TB_LAUNCHES, True)})):
        reads = _dataset(wl, N_READS)[1][:PRETTY_READS]
        tag = wl.split("_")[-1]
        rpath = cli.path(f"pretty_{tag}.fa")
        _write_fasta(rpath, reads)
        args = ("map", *flags, "--shrimp-format", "-P", rpath,
                cli.path("ecoli.fa"))
        for c in kernels.values():
            c[5].reset()
        out, card = [], cli.path(f"pretty_{tag}.txt")
        calls = _first_calls_of(lambda: out.append(cli(*args, out=card)),
                                {k: v[:2] for k, v in kernels.items()})
        run = out[0]
        _check_rise(title, run[3], kernels)
        n_k = {k: v[5].n for k, v in kernels.items()}
        launches.update(n_k)
        text = _read(card)
        first = reads[:PRETTY_CPU_READS]
        fpath = cli.path(f"pretty_{tag}_first.fa")
        _write_fasta(fpath, first)
        cpu = cli.path(f"pretty_{tag}.cpu.txt")
        s_cpu = cli("map", "--device", "cpu", *flags, "--shrimp-format",
                    "-P", fpath, cli.path("ecoli.fa"), out=cpu)[0]
        cpu_text = _read(cpu)
        same = _prefix_of(cpu_text, text, first)
        hits, blocks = text.count(b"\n>"), text.count(b"\nG:")
        print(f"23 {title}: {len(reads)} reads in {run[0]!r} s on {dev} "
              f"(the genome's index built in the call) = "
              f"{len(reads) / run[0]!r} reads/s; {hits} hits, {blocks} "
              f"alignment blocks; launches {n_k}; the --device cpu run of "
              f"the first {len(first)} reads ({s_cpu!r} s) is its prefix: "
              f"{same}; {smi}")
        if not same or blocks < 0.8 * len(reads):
            raise AssertionError(f"23 {title}: the card's output differs "
                                 "from the CPU run's, or mostly unmapped")
        rec.update(_kernel_records(title[4:], calls, kernels, n_k))
        del calls
    return launches, rec


def run_split_workflow(dev, smi):
    """Phase 23: the split-db workflow and `map -P` through the CLI,
    in-process, in a temporary directory deleted at the end. Returns the
    launches of its maps and the `*_cli` kernel records."""
    import tempfile
    launches, rec = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        cli = _CLI(tmp)
        t0 = time.perf_counter()
        ln, r = _split_ecoli(dev, smi, cli)
        launches.update(ln)
        rec.update(r)
        t1 = time.perf_counter()
        # the E. coli chunk indexes go before the hg ones are written
        for space in ("ls", "cs"):
            for f in os.listdir(cli.path(space)):
                if f.endswith(".npz"):
                    os.remove(cli.path(space, f))
        ln, r, _ = _split_hg(dev, smi, cli)
        launches.update(ln)
        rec.update(r)
        t2 = time.perf_counter()
        ln, r = _pretty(dev, smi, cli)
        launches.update(ln)
        rec.update(r)
        print(f"23: (a) {t1 - t0!r} s, (b) {t2 - t1!r} s, (c) "
              f"{time.perf_counter() - t2!r} s")
    return launches, rec



def _phases(argv) -> set:
    """The phases to run: all without arguments, else `--phases 12,13`."""
    if not argv:
        return set(range(1, 24))
    if len(argv) != 2 or argv[0] != "--phases":
        raise SystemExit("usage: chip_smoke.py [--phases N,N,...]")
    return {int(x) for x in argv[1].split(",")}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from shrimp_tpu_torch import _build
    from shrimp_tpu_torch.core import sw_cs_full, sw_full, sw_vector
    from shrimp_tpu_torch.device import get_device

    t_start = time.perf_counter()
    dev = get_device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = _smi()
    print(f"device: {kind}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; nvidia-smi: {smi}")

    t0 = time.perf_counter()
    built = _build.load()
    print(f"build: {time.perf_counter() - t0:.3f} s (nvcc, one per source "
          f"in parallel, {built.seconds:.3f} s) -> "
          + ", ".join(os.path.relpath(p) for p in built.paths))
    for ln in built.log.splitlines():
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            print("  " + ln.strip())

    phases = _phases(sys.argv[1:])
    rec, launches, long_ctx = {}, {}, None
    if 3 in phases:
        rec.update(check_kernels(dev))
    if 4 in phases:
        check_packed_step(dev)
    if 5 in phases:
        launches.update(run_slice(dev, {"sw_vector": sw_vector.LAUNCHES,
                                        "sw_full_stats": sw_full.LAUNCHES},
                                  rec["sw_full_stats"]["bound_ms"]))
    if 6 in phases:
        rec.update(check_cs_kernels(dev))
    if 7 in phases:
        check_cs_packed_step(dev)
    if 8 in phases:
        launches.update(run_cs_slice(dev, {
            "sw_vector_cs": sw_vector.CS_LAUNCHES,
            "sw_cs_full": sw_cs_full.DP_LAUNCHES,
            "cs_traceback": sw_cs_full.TB_LAUNCHES},
            rec["sw_cs_full"]["bound_ms"]))
    if 9 in phases:
        rec.update(check_long_kernels(dev))
    if 10 in phases:
        check_tb_packed_step(dev)
    if 11 in phases:
        ln, long_ctx = run_long_slice(dev, {
            "sw_vector_g352": sw_vector.LAUNCHES,
            "sw_full_bp": sw_full.BP_LAUNCHES,
            "ls_traceback": sw_full.TB_LAUNCHES},
            rec["sw_full_bp"]["bound_ms"], rec["ls_traceback"]["walks"])
        launches.update(ln)
    hg = phases & {12, 13, 15, 18}
    if hg:
        ln, r = run_hg_slices(dev, hg)
        launches.update(ln)
        rec.update(r)
    if 14 in phases:
        run_paired_slice(dev, {"sw_vector": sw_vector.LAUNCHES,
                               "sw_full_stats": sw_full.LAUNCHES})
    if 16 in phases:
        run_long_two_phase(dev, {"sw_vector": sw_vector.LAUNCHES,
                                 "sw_full_bp": sw_full.BP_LAUNCHES,
                                 "ls_traceback": sw_full.TB_LAUNCHES},
                           long_ctx)
    if 17 in phases:
        ln, r = run_cs_paired_slice(dev, {
            "sw_vector_cs": sw_vector.CS_LAUNCHES,
            "sw_cs_full": sw_cs_full.DP_LAUNCHES,
            "cs_traceback": sw_cs_full.TB_LAUNCHES})
        launches.update(ln)
        rec.update(r)
    if 19 in phases:
        check_byte_steps(dev)
        run_unpacked(dev)
        run_byte_streams(dev)
    if 20 in phases:
        t20 = time.perf_counter()
        ln, r = run_generic(dev, {"sw_vector": sw_vector.LAUNCHES,
                                  "sw_full_bp": sw_full.BP_LAUNCHES,
                                  "ls_traceback": sw_full.TB_LAUNCHES}, smi)
        launches.update(ln)
        rec.update(r)
        run_slow_tails(dev, smi)
        ln, r = run_offgate(dev, {
            "sw_vector": sw_vector.LAUNCHES,
            "sw_vector_cs": sw_vector.CS_LAUNCHES,
            "sw_full_bp": sw_full.BP_LAUNCHES,
            "ls_traceback": sw_full.TB_LAUNCHES,
            "sw_cs_full": sw_cs_full.DP_LAUNCHES,
            "cs_traceback": sw_cs_full.TB_LAUNCHES}, smi)
        launches.update(ln)
        rec.update(r)
        run_cli(dev, smi)
        print(f"phase 20: {time.perf_counter() - t20!r} s")
    if 21 in phases:
        t21 = time.perf_counter()
        mesh = _mesh()
        ln, r = run_mesh_ecoli(dev, mesh, smi)
        launches.update(ln)
        rec.update(r)
        run_mesh_hg(dev, mesh, smi)
        run_sharded_ecoli(dev, mesh, smi)
        run_sharded_hg(dev, mesh, smi)
        print(f"phase 21: {time.perf_counter() - t21!r} s")
    if 22 in phases:
        t22 = time.perf_counter()
        ln, r = run_dist(dev, smi)
        launches.update(ln)
        rec.update(r)
        print(f"phase 22: {time.perf_counter() - t22!r} s")
    if 23 in phases:
        t23 = time.perf_counter()
        ln, r = run_split_workflow(dev, smi)
        launches.update(ln)
        rec.update(r)
        print(f"phase 23: {time.perf_counter() - t23!r} s")
    print(f"whole run: {time.perf_counter() - t_start!r} s")
    if phases != set(range(1, 24)):
        print(f"phases {sorted(phases)} only: no result")
        return

    kernels = [
        dict(name=name, route="cuda", source=f"shrimp_tpu_torch/csrc/{src}",
             replaces=replaces, launches=launches[name],
             max_abs_err=rec[name]["err"], ms=rec[name]["ms"],
             plain_ms=rec[name]["plain_ms"],
             bound_ms=rec[name]["bound_ms"], bound_by=rec[name]["bound_by"],
             # no single PyTorch call computes any of these functions
             library_ms=None)
        for name, src, replaces in (
            ("sw_vector", "sw_vector.cu", "shrimp_tpu/core/sw_pallas.py:155"),
            ("sw_vector_cs", "sw_vector.cu",
             "shrimp_tpu/core/sw_pallas.py:155"),
            ("sw_full_stats", "sw_full.cu",
             "shrimp_tpu/core/sw_full_pallas.py:298"),
            ("sw_cs_full", "sw_cs_full.cu",
             "shrimp_tpu/core/sw_cs_full_pallas.py:357"),
            ("cs_traceback", "cs_traceback.cu",
             "shrimp_tpu/core/sw_cs_jax.py:261"),
            ("sw_vector_g352", "sw_vector.cu",
             "shrimp_tpu/core/sw_pallas.py:155"),
            ("sw_full_bp", "sw_full_bp.cu",
             "shrimp_tpu/core/sw_full_pallas.py:298"),
            ("ls_traceback", "ls_traceback.cu",
             "shrimp_tpu/core/sw_jax.py:785"),
            ("sw_vector_hg", "sw_vector.cu",
             "shrimp_tpu/core/sw_pallas.py:155"),
            ("sw_vector_cs_hg", "sw_vector.cu",
             "shrimp_tpu/core/sw_pallas.py:155"),
            ("sw_cs_full_paired", "sw_cs_full.cu",
             "shrimp_tpu/core/sw_cs_full_pallas.py:357"),
            ("cs_traceback_paired", "cs_traceback.cu",
             "shrimp_tpu/core/sw_cs_jax.py:261"),
            ("sw_cs_full_paired_hg", "sw_cs_full.cu",
             "shrimp_tpu/core/sw_cs_full_pallas.py:357"),
            ("cs_traceback_paired_hg", "cs_traceback.cu",
             "shrimp_tpu/core/sw_cs_jax.py:261"),
            ("sw_vector_generic", "sw_vector.cu",
             "shrimp_tpu/core/sw_pallas.py:155"),
            ("sw_full_bp_generic", "sw_full_bp.cu",
             "shrimp_tpu/core/sw_full_pallas.py:298"),
            ("ls_traceback_generic", "ls_traceback.cu",
             "shrimp_tpu/core/sw_jax.py:785"),
            ("sw_cs_full_generic", "sw_cs_full.cu",
             "shrimp_tpu/core/sw_cs_full_pallas.py:357"),
            ("cs_traceback_generic", "cs_traceback.cu",
             "shrimp_tpu/core/sw_cs_jax.py:261"),
            ("sw_vector_mesh", "sw_vector.cu",
             "shrimp_tpu/core/sw_pallas.py:155"),
            ("sw_full_stats_mesh", "sw_full.cu",
             "shrimp_tpu/core/sw_full_pallas.py:298"),
            ("sw_vector_cs_mesh", "sw_vector.cu",
             "shrimp_tpu/core/sw_pallas.py:155"),
            ("sw_cs_full_mesh", "sw_cs_full.cu",
             "shrimp_tpu/core/sw_cs_full_pallas.py:357"),
            ("cs_traceback_mesh", "cs_traceback.cu",
             "shrimp_tpu/core/sw_cs_jax.py:261"),
            ("sw_vector_g352_mesh", "sw_vector.cu",
             "shrimp_tpu/core/sw_pallas.py:155"),
            ("sw_full_bp_mesh", "sw_full_bp.cu",
             "shrimp_tpu/core/sw_full_pallas.py:298"),
            ("ls_traceback_mesh", "ls_traceback.cu",
             "shrimp_tpu/core/sw_jax.py:785"),
            ("sw_vector_dist", "sw_vector.cu",
             "shrimp_tpu/core/sw_pallas.py:155"),
            ("sw_full_stats_dist", "sw_full.cu",
             "shrimp_tpu/core/sw_full_pallas.py:298"),
            ("sw_vector_cs_dist", "sw_vector.cu",
             "shrimp_tpu/core/sw_pallas.py:155"),
            ("sw_cs_full_dist", "sw_cs_full.cu",
             "shrimp_tpu/core/sw_cs_full_pallas.py:357"),
            ("cs_traceback_dist", "cs_traceback.cu",
             "shrimp_tpu/core/sw_cs_jax.py:261"),
            ("sw_vector_g352_dist", "sw_vector.cu",
             "shrimp_tpu/core/sw_pallas.py:155"),
            ("sw_full_bp_dist", "sw_full_bp.cu",
             "shrimp_tpu/core/sw_full_pallas.py:298"),
            ("ls_traceback_dist", "ls_traceback.cu",
             "shrimp_tpu/core/sw_jax.py:785"),
            ("sw_vector_cli", "sw_vector.cu",
             "shrimp_tpu/core/sw_pallas.py:155"),
            ("sw_full_stats_cli", "sw_full.cu",
             "shrimp_tpu/core/sw_full_pallas.py:298"),
            ("sw_vector_cs_cli", "sw_vector.cu",
             "shrimp_tpu/core/sw_pallas.py:155"),
            ("sw_cs_full_cli", "sw_cs_full.cu",
             "shrimp_tpu/core/sw_cs_full_pallas.py:357"),
            ("cs_traceback_cli", "cs_traceback.cu",
             "shrimp_tpu/core/sw_cs_jax.py:261"),
            ("sw_vector_hg_cli", "sw_vector.cu",
             "shrimp_tpu/core/sw_pallas.py:155"),
            ("sw_full_stats_hg_cli", "sw_full.cu",
             "shrimp_tpu/core/sw_full_pallas.py:298"),
            ("sw_vector_pretty_cli", "sw_vector.cu",
             "shrimp_tpu/core/sw_pallas.py:155"),
            ("sw_full_bp_pretty_cli", "sw_full_bp.cu",
             "shrimp_tpu/core/sw_full_pallas.py:298"),
            ("ls_traceback_pretty_cli", "ls_traceback.cu",
             "shrimp_tpu/core/sw_jax.py:785"),
            ("sw_vector_cs_pretty_cli", "sw_vector.cu",
             "shrimp_tpu/core/sw_pallas.py:155"),
            ("sw_cs_full_pretty_cli", "sw_cs_full.cu",
             "shrimp_tpu/core/sw_cs_full_pallas.py:357"),
            ("cs_traceback_pretty_cli", "cs_traceback.cu",
             "shrimp_tpu/core/sw_cs_jax.py:261"))]
    for name in rec:
        print(f"{name}: bound {rec[name]['bound_ms']!r} ms "
              f"({rec[name]['bound_by']}), over all R x G cells "
              f"{rec[name]['bound_all_ms']!r} ms")
    print(_smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
