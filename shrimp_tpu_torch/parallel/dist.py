"""On-line sharded mapping across processes over torch.distributed.

Port of `shrimp_tpu/parallel/dist.py`. SHRiMP2 scales past one machine
by running gmapper per genome chunk on different machines and merging
SAM and mapping qualities offline with mergesam
(SPLITTING_AND_MERGING:1-160, README:281-303, mergesam/sam_reader.c:
417-520). Here that workflow is one on-line run of P processes (ranks):

- `init_distributed` joins the ranks in one process group. Every rank
  holds the same number of shards, each on a device of its local mesh
  (`meshmap.make_mesh`), so ownership is contiguous: shard d belongs to
  rank d // d_local (`global_mesh`).
- Each rank builds or loads only its own shards' sub-indexes
  (`DistIndex` holds the global contig table from every shard's names
  and lengths, and the planes and CSR of its local shards; no rank holds
  a remote shard's genome, README:128-150).
- Every rank reads the whole read stream and runs filter 1 against its
  local sub-indexes only; the window descriptors are allgathered and
  merged into the whole-index window order (`_dist_filter1`).
- Each local shard with windows makes one fused launch on its own
  device and CUDA stream (`DistMapper._dispatch`; colour space:
  `meshmap._MeshFastCS._fused_dispatch_cs`), and the ragged exchange
  gives every rank every shard's rows in window order
  (`DistMapper._exchange`). Windows past the stats kernel (G > MAX_G:
  long reads) run the traceback flow per shard, and its alignment rows
  and ops go through the same exchange.
- Selection runs identically on every rank. Alignments whose indel path
  needs genome bytes are re-run by the native banded DP on the rank that
  owns the window's shard and exchanged (`_DistFastLS._expand_need`);
  colour space's post-SW eval reads an arena of window bytes that each
  owner rank extracts (`_window_arena`).
- The MQV denominators merge across ranks: z1 (`DistMapper._z1_hook`)
  and the paired class statistics (`DistMapper._zpair_hook`) are
  allgathered per shard and reduced in shard order with the algebra of
  `meshmap.zmerge_psum` and `meshmap.zpair_merge`, so every rank holds
  the same bits.
- `read_sharding` splits the host work by reads: each rank selects,
  expands and renders only its slice of every batch (`FastLS.read_slice`
  with `slice_select`), and the slices' SAM bytes are exchanged in rank
  order. Every rank joins every exchange, with no rows where its slice
  has none (shrimp_tpu's early returns skip the expansion exchange there
  and leave the other ranks waiting).

Every exchanged item is a host array, so the exchanges run on a gloo
group (`_group`). The output is byte-identical to the single-process
whole-index run, under the two caveats of `meshmap.ShardedIndexMapper`
(local list cutoffs, region-boundary straddle), which the reference's
own split-db workflow carries. Two ranks may share one card (each with
its own shards on it): that shows the exchanges, not scaling across
cards.
"""
from __future__ import annotations

import ctypes
import datetime
import functools
import time
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import constants as C
from ..config import MapperConfig
from ..core.batch_pipeline import FlatHits, _empty_flat
from ..core.sw import sw_vec_full_stats_packed, sw_vec_full_tb_packed
from ..fastpath import (FastLS, FastPaired, _check_index_len, _chunk_bucket,
                        _config_supported, _filter1_paired, _FSWJobs,
                        _FSWParams, _launch_args, _normalize_win, _pack_rtab,
                        _paired_config_supported, _stats_flow_enabled,
                        _tb_batch, _vp)
from ..fastpath_cs import _config_supported as _cs_config_supported
from ..fastpath_cs import _cs_paired_config_supported
from ..io.fasta import SeqRecord
from ..mapper import _round_up
from .meshmap import (CompositeIndex, _MeshFastCS, _MeshFastPairedCS,
                      _MeshTier, make_mesh, zmerge_psum, zpair_merge)

# every collective of a process group made by init_distributed raises
# after this many seconds instead of waiting for a rank that never comes
DEFAULT_TIMEOUT_S = 300.0
_GLOO = []     # the gloo group beside a non-gloo default group, made once


def init_distributed(init_method: str, world_size: int, rank: int,
                     timeout: float = DEFAULT_TIMEOUT_S) -> None:
    """Join this process to the ranks' gloo process group
    (`torch.distributed.init_process_group`): `init_method` is
    "tcp://host:port" or "file:///path" (a file every rank can reach,
    which needs no port), `timeout` the seconds after which a collective
    that some rank never joins raises."""
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))


def _group():
    """The group every exchange runs on: the default group where it is
    gloo (init_distributed's), else a gloo group over the same ranks."""
    if dist.get_backend() == "gloo":
        return None
    if not _GLOO:
        _GLOO.append(dist.new_group(backend="gloo"))
    return _GLOO[0]


def _allgather_rows(arr: np.ndarray) -> List[np.ndarray]:
    """Every rank's `arr` (equal trailing dims, any first dim), in rank
    order: the counts first, then the rows padded to the longest, trimmed
    again. The dtype passes through bit for bit (int64, float64, uint8,
    ...); nothing is pickled."""
    g = _group()
    arr = np.ascontiguousarray(arr)
    P = dist.get_world_size(g)
    counts = [torch.zeros(1, dtype=torch.int64) for _ in range(P)]
    dist.all_gather(counts, torch.tensor([arr.shape[0]], dtype=torch.int64),
                    group=g)
    counts = [int(c) for c in counts]
    pad = np.zeros((max(max(counts), 1),) + arr.shape[1:], arr.dtype)
    pad[:arr.shape[0]] = arr
    t = torch.from_numpy(pad)
    out = [torch.empty_like(t) for _ in range(P)]
    dist.all_gather(out, t, group=g)
    return [o.numpy()[:c] for o, c in zip(out, counts)]


def _allgather_bytes(b: bytes) -> List[bytes]:
    """One byte string from every rank, in rank order (mergesam's
    concatenation of the per-machine SAM chunks in read order)."""
    parts = _allgather_rows(np.frombuffer(b, np.uint8).copy())
    return [p.tobytes() for p in parts]


def _slice_for(pid: int, P: int, n: int):
    """Rank pid's contiguous slice [lo, hi) of n items (utils/
    splitreads.py recast: contiguous slices keep the assembled stream in
    read order with one concatenation). A copy of
    `shrimp_tpu/parallel/dist.py::_slice_for`."""
    per = -(-n // P)
    lo = min(pid * per, n)
    return lo, min(lo + per, n)


def global_mesh(devices=None) -> List[tuple]:
    """Every rank's shards in rank order: [(rank, device name)], this
    rank's from `make_mesh(devices)`. Raises unless every rank holds the
    same number, so that shard d belongs to rank d // d_local. Every rank
    must call it."""
    local = make_mesh(devices)
    parts = _allgather_bytes(",".join(map(str, local)).encode())
    names = [p.decode().split(",") for p in parts]
    if len({len(n) for n in names}) != 1:
        raise ValueError("every rank must hold the same number of shards, "
                         f"not {[len(n) for n in names]}")
    return [(r, nm) for r, ns in enumerate(names) for nm in ns]


class DistIndex(CompositeIndex):
    """CompositeIndex of one rank: the global contig table from every
    shard's metadata ({"names": [...], "lengths": [...]} a shard, the
    split manifest every rank has), the planes and CSR sub-indexes of the
    LOCAL shards only. `codes` and `codes_rc` are None: remote genome
    bytes are not addressable here. A copy of
    `shrimp_tpu/parallel/dist.py::DistIndex`."""

    def __init__(self, shard_meta: Sequence[dict], local_subs: Sequence,
                 local_shard0: int):
        if not local_subs:
            raise ValueError("each rank owns at least one shard")
        self.subs = list(local_subs)
        self.local_shard0 = local_shard0
        ref = local_subs[0]
        self.mode = ref.mode
        self.hashed = ref.hashed
        self.is_rna = ref.is_rna
        self.contig_names: List[str] = []
        offs, lens = [], []
        base = 0
        D = len(shard_meta)
        self.cn_base = np.zeros(D + 1, np.int64)
        self.pos_base = np.zeros(D + 1, np.int64)
        for d, mt in enumerate(shard_meta):
            self.contig_names += list(mt["names"])
            ln = np.asarray(mt["lengths"], np.uint32)
            off = np.zeros(len(ln), np.int64)
            if len(ln) > 1:
                off[1:] = np.cumsum(ln[:-1])
            offs.append(off + base)
            lens.append(ln)
            self.cn_base[d + 1] = self.cn_base[d] + len(ln)
            self.pos_base[d + 1] = self.pos_base[d] + int(ln.sum())
            base += int(ln.sum())
        self.contig_offsets = np.concatenate(offs).astype(np.uint32)
        self.contig_lengths = np.concatenate(lens)
        self.codes = self.codes_rc = None
        self.cs_codes = self.cs_codes_rc = None
        self._total = base
        self._max_weight = max(si.seed.weight for si in ref.seeds)
        self._max_span = max(si.seed.span for si in ref.seeds)

    @property
    def total_len(self) -> int:
        return self._total


_DESC = ("g_off", "w_len", "score_window_gen", "matches", "score_max", "ax",
         "ay", "alen", "awid")
_DESC_DT = (np.int64, np.int32, np.int64, np.int32, np.int64, np.int64,
            np.int64, np.int64, np.int64)


def _dist_filter1(tier: "DistMapper", n_owners: int, run):
    """Filter 1 across ranks: `run(sub)` -> FlatHits (None: the batch is
    refused) on every local sub-index, the [n, 12] int64 window
    descriptors (owner, shard, global contig, the nine FlatHits fields)
    allgathered and sorted stably by owner * D + shard: the whole-index
    window order (mergesam reading every chunk's SAM, on-line). Sets the
    tier's `_win_shard` and counts `last_f1_local_windows`; returns the
    merged FlatHits."""
    comp = tier.comp
    descs = []
    for i, sub in enumerate(comp.subs):
        d = comp.local_shard0 + i
        fh = run(sub)
        if fh is None:
            raise ValueError("batch shape outside fast-path support")
        desc = np.empty((fh.n, 12), np.int64)
        desc[:, 0] = fh.owner
        desc[:, 1] = d
        desc[:, 2] = fh.cn.astype(np.int64) + comp.cn_base[d]
        for c, k in enumerate(_DESC):
            desc[:, 3 + c] = getattr(fh, k)
        descs.append(desc)
    desc = np.concatenate(descs)
    tier.last_f1_local_windows += len(desc)
    allw = np.concatenate(_allgather_rows(desc))
    if not len(allw):
        tier._win_shard = np.zeros(0, np.int64)
        return _empty_flat(n_owners)
    allw = allw[np.argsort(allw[:, 0] * tier.D + allw[:, 1], kind="stable")]
    tier._win_shard = allw[:, 1].copy()
    owner = allw[:, 0].copy()
    fields = {k: np.ascontiguousarray(allw[:, 3 + c].astype(dt))
              for c, (k, dt) in enumerate(zip(_DESC, _DESC_DT))}
    return FlatHits(owner=owner, cn=allw[:, 2].astype(np.int32),
                    seg_start=np.searchsorted(
                        owner, np.arange(n_owners + 1)).astype(np.int64),
                    **fields)


def _window_arena(comp: DistIndex, shard, starts, w_len, gen_st, G: int):
    """The letter-plane bytes the colour-space post-SW eval reads, made by
    the owner ranks: each rank copies [start, start + w_len) of its LOCAL
    shards' forward or reverse plane (`gen_st`) into rows of G bytes, the
    rows are allgathered, and every rank ends with the [n, G] arena.
    Returns (arena, each row's start in it). A copy of
    `shrimp_tpu/parallel/dist.py::_window_arena`."""
    n = len(starts)
    lo = comp.local_shard0
    sh = np.asarray(shard, np.int64)
    mine = np.nonzero((sh >= lo) & (sh < lo + len(comp.subs)))[0]
    rows = np.zeros((mine.size, G), np.uint8)
    for i, t in enumerate(mine):
        sub = comp.subs[int(sh[t]) - lo]
        ls = int(starts[t] - comp.pos_base[sh[t]])
        src = sub.codes_rc if gen_st[t] else sub.codes
        k = max(0, min(int(w_len[t]), sub.total_len - ls, G))
        if k:
            rows[i, :k] = src[ls:ls + k]
    arena = np.zeros((n, G), np.uint8)
    for p_ids, p_rows in zip(_allgather_rows(mine.reshape(-1, 1)),
                             _allgather_rows(rows)):
        arena[p_ids[:, 0]] = p_rows
    return arena, np.arange(n, dtype=np.int64) * G


class _DistFastLS(FastLS):
    """FastLS across ranks: filter 1 on the local sub-indexes, merged by
    `_dist_filter1`, and the owner-rank alignment expansion. The stage
    refers to the tier and not back."""

    def __init__(self, mapper, tier) -> None:
        super().__init__(mapper)
        self.mm = tier

    def _filter1(self, codes2, L: int, wlen: int, min_kmer_pos: int = 0,
                 index=None):
        return _dist_filter1(self.mm, codes2.shape[0] * 2, lambda sub:
                             FastLS._filter1(self, codes2, L, wlen,
                                             min_kmer_pos, index=sub))

    def _expand_local(self, ctx2, sh, starts, rc, ri, glen, ax, ay, alen,
                      awid, rev):
        """The native banded DP (sw_full_tb_host) on windows of LOCAL
        shards, their bytes from this rank's sub-indexes: (packed [k, 10],
        ops [k, W]). Every argument is a per-row array."""
        comp = self.mm.comp
        R, G = ctx2["R"], ctx2["G"]
        W = (R + G + 3) // 4
        k = len(sh)
        pk = np.zeros((k, 10), np.int32)
        ops = np.zeros((k, W), np.uint8)
        if k == 0:
            return pk, ops
        gpos = np.clip((starts - comp.pos_base[sh])[:, None]
                       + np.arange(G, dtype=np.int64)[None, :], 0, None)
        gwin = np.empty((k, G), np.uint8)
        for i in range(k):
            sub = comp.subs[int(sh[i]) - comp.local_shard0]
            src = sub.codes_rc if rc[i] else sub.codes
            gwin[i] = src[np.clip(gpos[i], 0, sub.total_len - 1)]
        sc = self.m.config.scores
        read = np.ascontiguousarray(ctx2["read_tab"][ri])
        p = _FSWParams(k, G, R, W, sc.match, sc.mismatch, sc.a_gap_open,
                       sc.a_gap_extend, sc.b_gap_open, sc.b_gap_extend, 0)
        # every array the native call reads is held here through it
        i32 = [np.ascontiguousarray(a, np.int32)
               for a in (glen, np.full(k, ctx2["L"]), ax, ay, alen, awid)]
        rev8 = np.ascontiguousarray(rev, np.uint8)
        jb = _FSWJobs(_vp(gwin), _vp(i32[0]), _vp(read), _vp(i32[1]),
                      *(_vp(a) for a in i32[2:]), _vp(rev8))
        rv = self.lib.sw_full_tb_host(ctypes.byref(p), ctypes.byref(jb),
                                      _vp(pk), _vp(ops))
        if rv != 0:
            raise RuntimeError(f"sw_full_tb_host failed ({rv})")
        return pk, ops

    def _expand_need(self, need, ctx2, packed, ops_pk) -> None:
        """FastLS._expand_need by the owner ranks: the rows of the jobs
        `need` are re-run by the banded DP on the rank that owns the
        window's shard and exchanged. With identical job lists on every
        rank the expansions go out by job index; with rank-local jobs
        (read_slice with slice_select) each rank sends requests for
        remote shards' rows, the owners answer, and only the asker
        applies an answer. Every rank joins both exchanges, with no rows
        if it has none."""
        tier = self.mm
        jobs = ctx2["jobs"]
        W = ops_pk.shape[1]
        job_shard = tier._win_shard[ctx2["rows"]]
        lo = tier.local_shard0
        hi = lo + len(tier.comp.subs)
        local = (job_shard[need] >= lo) & (job_shard[need] < hi)
        mine = need[local]
        pk2, op2 = self._expand_local(
            ctx2, job_shard[mine], ctx2["starts"][mine], ctx2["rcmask"][mine],
            jobs["ri"][mine], jobs["w_len"][mine], ctx2["rx"][mine],
            ctx2["ry"][mine], ctx2["rl_"][mine], ctx2["rw_"][mine],
            ctx2["rev"][mine])
        if not ctx2["rank_local_jobs"]:
            # identical job lists on every rank: each rank's expansions
            # go to all, by job index
            res = np.zeros((len(mine), 11 + W), np.int64)
            res[:, 0] = mine
            res[:, 1:11] = pk2
            res[:, 11:] = op2
            for part in _allgather_rows(res):
                packed[part[:, 0]] = part[:, 1:11]
                ops_pk[part[:, 0]] = part[:, 11:]
            return
        # rank-local jobs: requests carry the window descriptor and the
        # asker's job index (reads are on every rank, so `ri`, not bytes)
        packed[mine] = pk2
        ops_pk[mine] = op2
        remote = need[~local]
        req = np.stack([np.full(len(remote), tier.pid), remote,
                        jobs["ri"][remote], ctx2["starts"][remote],
                        job_shard[remote], ctx2["rcmask"][remote],
                        jobs["w_len"][remote], ctx2["rx"][remote],
                        ctx2["ry"][remote], ctx2["rl_"][remote],
                        ctx2["rw_"][remote], ctx2["rev"][remote]],
                       axis=1).astype(np.int64).reshape(-1, 12)
        req = np.concatenate(_allgather_rows(req))
        fr = req[(req[:, 4] >= lo) & (req[:, 4] < hi)]
        pk3, op3 = self._expand_local(
            ctx2, fr[:, 4], fr[:, 3], fr[:, 5].astype(bool), fr[:, 2],
            fr[:, 6], fr[:, 7], fr[:, 8], fr[:, 9], fr[:, 10], fr[:, 11])
        resp = np.zeros((len(fr), 12 + W), np.int64)
        resp[:, :2] = fr[:, :2]
        resp[:, 2:12] = pk3
        resp[:, 12:] = op3
        for part in _allgather_rows(resp):
            own = part[part[:, 0] == tier.pid]
            packed[own[:, 1]] = own[:, 2:12]
            ops_pk[own[:, 1]] = own[:, 12:]


class _DistFastPaired(FastPaired):
    """FastPaired across ranks: filter 1 (the mate-pair region filter
    included) on the local sub-indexes, merged by `_dist_filter1`; the
    dispatch and the owner-rank expansion of the `_DistFastLS` it
    carries."""

    def __init__(self, mapper, tier) -> None:
        super().__init__(mapper)
        self.fls = _DistFastLS(mapper, tier)
        self.lib = self.fls.lib
        self.mm = tier

    def _filter1_paired(self, codes2, L: int, wlen: int, ro):
        return _dist_filter1(self.mm, codes2.shape[0] * 2, lambda sub:
                             _filter1_paired(self.m, self.fls.f1_threads,
                                             codes2, L, wlen, ro,
                                             min_kmer_pos=0, index=sub))


class _DistCSMixin:
    """The colour-space stages across ranks: filter 1 on the local
    sub-indexes (`_dist_filter1`), the fused launch per local shard
    (`_MeshFastCS._fused_dispatch_cs`, whose gather is the tier's ragged
    exchange) and the owner-rank window arena for the native post-SW
    eval."""

    def _filter1_cs(self, codes2, R: int, wlen: int):
        return _dist_filter1(self.mm, codes2.shape[0] * 2, lambda sub:
                             self.fls._filter1(codes2, R, wlen,
                                               min_kmer_pos=1, index=sub))

    def _filter1_cs_paired(self, codes2, R: int, wlen: int, ro):
        return _dist_filter1(self.mm, codes2.shape[0] * 2, lambda sub:
                             _filter1_paired(self.m, self.fls.f1_threads,
                                             codes2, R, wlen, ro,
                                             min_kmer_pos=1, index=sub))

    def _arena(self, rows, ctx):
        win = ctx["win"]
        return _window_arena(self.m.index, self.mm._win_shard[rows],
                             win["starts"][rows], ctx["fh"].w_len[rows],
                             np.asarray(win["rcmask"])[rows], ctx["G"])

    def _cs_genome_view(self, rows, ctx):
        """Unpaired: the arena of the pass-1 survivors."""
        arena, sabs = self._arena(rows, ctx)
        self._arena_keep = arena    # alive through the native call
        return arena, arena, sabs, int(arena.size)

    def _cs_genome_view_paired(self, ctx):
        """Paired: the arena of every window (pair rescoring may eval any
        of them)."""
        arena, sabs = self._arena(slice(None), ctx)
        self._arena_keep = arena
        return arena, arena, sabs


class _DistFastCS(_DistCSMixin, _MeshFastCS):
    """The colour-space unpaired stream across ranks. The windows are
    allgathered before selection, so each read's z1 (Part 1c) is the
    whole sum on every rank: no z1 merge."""


class _DistFastPairedCS(_DistCSMixin, _MeshFastPairedCS):
    """The colour-space paired stream across ranks; the paired class
    statistics merge through `DistMapper._zpair_hook`."""


class DistMapper(_MeshTier):
    """One rank of a multi-process mapping run over `shard_meta` (every
    shard's {"names", "lengths"}, in shard order): `local_subs` are this
    rank's sub-indexes, shards [rank * d_local, (rank + 1) * d_local), one
    on each device of `mesh` (its local mesh: `make_mesh(mesh)`; by
    default every visible card, and without one this raises; two ranks
    of a one-card machine pass ["cuda:0"] * d_local, the plain versions
    ["cpu"] * d_local). The process group must be up (`init_distributed`).
    Every rank returns the same SAM bytes, those of the single-process
    whole-index fast path. Configs and batches outside the fused fast
    paths raise ValueError on every rank: no rank holds the genome the
    generic mapper would need.

    After a run: `last_f1_local_windows` (filter 1's windows from local
    shards), `last_slice_jobs` (read_sharding: jobs this rank selected),
    `merge_bytes` / `merge_secs` (the ragged exchanges of the device
    rows), `last_z1_merged` / `last_zpair_merged`, `last_wall`,
    `last_render_wall`."""

    sharded_index = True

    def __init__(self, shard_meta: Sequence[dict], local_subs: Sequence,
                 config: Optional[MapperConfig] = None, mesh=None,
                 halo: Optional[int] = None):
        if not dist.is_initialized():
            raise RuntimeError("DistMapper: no process group; call "
                               "init_distributed first")
        self.P = dist.get_world_size()
        self.pid = dist.get_rank()
        local = make_mesh(mesh)
        global_mesh(local)         # every rank holds as many shards
        d_local = len(local)
        if len(local_subs) != d_local:
            raise ValueError(f"{len(local_subs)} sub-indexes for {d_local} "
                             "local devices")
        if len(shard_meta) != self.P * d_local:
            raise ValueError(f"{len(shard_meta)} shards for {self.P} ranks "
                             f"of {d_local}")
        self.local_shard0 = self.pid * d_local
        self.comp = DistIndex(shard_meta, local_subs, self.local_shard0)
        super().__init__(self.comp, config or MapperConfig(), local, halo)
        self.D = len(shard_meta)
        rows = []
        for s in local_subs:
            n = _round_up(int(s.total_len) + self.halo, 256)
            r = {}
            for f in ("codes", "codes_rc", "cs_codes", "cs_codes_rc"):
                if getattr(s, f) is not None:
                    r[f] = np.full(n, 254, np.uint8)
                    r[f][:s.total_len] = getattr(s, f)
            rows.append(r)
        self._make_shards(rows)
        # shard d at index d; the other ranks' shards launch there
        self.shards = ([None] * self.local_shard0 + self.shards
                       + [None] * (self.D - self.local_shard0 - d_local))
        self._cpu_mesh = make_mesh(["cpu"] * self.D)
        self._win_shard: Optional[np.ndarray] = None
        self.last_z1_merged: Optional[np.ndarray] = None
        self.last_zpair_merged: Optional[np.ndarray] = None
        self.merge_bytes = 0
        self.merge_secs = 0.0
        self.last_f1_local_windows = 0
        self.last_slice_jobs = 0
        self.last_wall = self.last_render_wall = 0.0

    def _route(self, starts):
        shard = self._win_shard
        return shard, starts - self.comp.pos_base[shard]

    # ------------------------------------------------------------ exchange
    def _exchange(self, parts, spec, order) -> tuple:
        """The ragged exchange of device rows: `parts` are this rank's
        shards' row tuples (numpy, shard by shard), laid out as `spec`
        [(dtype, trailing shape)], the last trailing shape None for
        "the rest of the row" (the width of the colour-space steps); each
        rank's rows go to all as one byte string, concatenated in rank
        order (= shard order), and are put back in window order (`order`
        lists the windows shard by shard). Counts `merge_bytes` and
        `merge_secs`."""
        t0 = time.perf_counter()
        mine = [np.concatenate([np.ascontiguousarray(a, dt).reshape(
            len(a), -1).view(np.uint8) for (dt, _), a in zip(spec, p)],
            axis=1).ravel() for p in parts]
        allb = np.concatenate(_allgather_rows(
            np.concatenate(mine) if mine else np.zeros(0, np.uint8)))
        self.merge_bytes += int(allb.nbytes)
        n = len(order)
        if n == 0 or len(allb) % n:
            raise RuntimeError(f"exchange: {len(allb)} bytes for {n} rows")
        full = np.empty((n, len(allb) // n), np.uint8)
        full[order] = allb.reshape(n, -1)
        out, c = [], 0
        for dt, tail in spec:
            w = (full.shape[1] - c if tail is None else
                 int(np.prod(tail, dtype=np.int64)) * np.dtype(dt).itemsize)
            shape = (n,) + (tuple(tail) if tail is not None else (-1,))
            out.append(np.ascontiguousarray(full[:, c:c + w]).view(dt)
                       .reshape(shape))
            c += w
        self.merge_secs += time.perf_counter() - t0
        return tuple(out)

    def _local_rows(self, results) -> list:
        """The local shards' results on the host, shard by shard: each
        shard's chunks [(k, tensor or tuple)] as one tuple of numpy
        arrays of its rows."""
        parts = []
        for sh, chunks in zip(self.shards, results):
            if chunks is None:
                continue
            with sh.on():
                got = [tuple(t[:k].cpu().numpy() for t in
                             (res if isinstance(res, tuple) else (res,)))
                       for k, res in chunks]
            parts.append(tuple(np.concatenate(col) for col in zip(*got)))
        return parts

    def _gather(self, parts, order):
        """`_MeshFastCS._fused_dispatch_cs`'s gather: the local shards'
        (vec, packed, steps) through the ragged exchange, as CPU tensors
        in window order."""
        rows = self._local_rows([None if res is None else
                                 [(len(res[0]), res)] for res in parts])
        spec = [(np.int32, ()), (np.int16, (12,)), (np.int8, None)]
        return tuple(torch.from_numpy(a)
                     for a in self._exchange(rows, spec, order))

    # ------------------------------------------------------------ dispatch
    def _dispatch(self, m, fh, read_tab: np.ndarray, L: int, R: int,
                  rcf: np.ndarray, n_reads=None):
        """fastpath._fused_dispatch's drop-in: each local shard with
        windows makes one fused vector + stats launch on its own device
        and stream (the traceback flow, `sw_vec_full_tb_packed`, for
        windows past the stats kernel: long reads, in chunks of at most
        2^28 backpointer cells); `win["fetch"]` brings every shard's rows
        through the ragged exchange, in window order. The dispatch stays
        fused (`n_reads` is ignored). Shapes past the packed IO raise
        ValueError on every rank: no rank holds a remote shard's genome
        for a single-device launch."""
        _check_index_len(m.index)
        n = int(fh.n)
        win, G = _normalize_win(m, fh, L, rcf)
        self._check_halo(G)
        if G > 4095 or R > 4095 or int(fh.w_len.max()) >= (1 << 14):
            raise ValueError(f"window/read shape (G={G}, R={R}) outside the "
                             "packed-IO envelope; the multi-process tier "
                             "maps no wider windows")
        shard, local = self._route(win["starts"])
        order = np.argsort(shard, kind="stable")
        counts = np.bincount(shard, minlength=self.D)
        stats_flow = _stats_flow_enabled(G)
        sc = m.config.scores
        kw = dict(G=G, L=L, match=sc.match, mismatch=sc.mismatch,
                  a_gap_open=sc.a_gap_open, a_gap_ext=sc.a_gap_extend,
                  b_gap_open=sc.b_gap_open, b_gap_ext=sc.b_gap_extend,
                  local_alignment=False, phase="fused")
        fn = sw_vec_full_stats_packed if stats_flow else sw_vec_full_tb_packed
        step = None if stats_flow else _tb_batch(R, G)
        rtab = _pack_rtab(read_tab)
        lwin = dict(win, starts=local)
        results = []
        off = 0
        for sh, k in zip(self.shards, counts.tolist()):
            sl = order[off:off + k]
            off += k
            if k == 0 or sh is None:     # another rank's shard runs there
                results.append(None)
                continue
            chunks = []
            with sh.on():
                dev = sh.device
                rt = torch.from_numpy(rtab).to(dev)
                for c in range(0, k, step or k):
                    kc = min(k - c, step or k)
                    args = _launch_args(lwin, sl[c:c + kc], kc,
                                        _chunk_bucket(kc, step) if step
                                        else kc, L, True)
                    chunks.append((kc, fn(sh.ls[0], sh.ls[1],
                                          torch.from_numpy(args).to(dev),
                                          rt, sh.ls[2], **kw)))
            results.append(chunks)
        if stats_flow:
            spec = [(np.int32, (3,))]
        else:
            spec = [(np.int64, ()), (np.int32, (10,)),
                    (np.uint8, ((R + G + 3) // 4,))]
        win["packed_io"] = True
        win["shard"] = shard
        win["fetch"] = functools.partial(self._fetch_rows, results, spec,
                                         order, stats_flow)
        cells = int(fh.w_len.astype(np.int64).sum()) * L
        m.tally(vec_invocs=n, vec_cells=cells, full_invocs=n,
                full_cells=cells)
        return [], win, G, stats_flow

    def _fetch_rows(self, results, spec, order, stats_flow: bool):
        """`win["fetch"]`: every shard's rows in window order, the packed
        [n, 3] stats rows or the traceback flow's (vec, packed, ops)."""
        out = self._exchange(self._local_rows(results), spec, order)
        return out[0] if stats_flow else out

    # ------------------------------------------------------------ Z merges
    def _local_part(self, rows: np.ndarray) -> np.ndarray:
        """This rank's shards' rows of a [D, ...] array."""
        return np.ascontiguousarray(
            rows[self.local_shard0:self.local_shard0 + len(self.mesh)])

    def _z1_hook(self, posteriors, job_ri, job_rows, B):
        """The MQV denominator z1 across ranks (Part 1c): each rank puts
        its local shards' [d_local, B] partials into the allgather and
        every rank sums the [D, B] rows in shard order
        (`meshmap.zmerge_psum`); the render divides by the result."""
        zp = np.zeros((self.D, B), np.float64)
        sh = self._win_shard[job_rows]
        mine = (sh >= self.local_shard0) & (
            sh < self.local_shard0 + len(self.mesh))
        np.add.at(zp, (sh[mine], job_ri[mine].astype(np.int64)),
                  posteriors[mine])
        zall = np.concatenate(_allgather_rows(self._local_part(zp)))
        self.last_z1_merged = zmerge_psum(self._cpu_mesh, zall)
        return self.last_z1_merged

    def _zpair_hook(self, part: np.ndarray) -> np.ndarray:
        """The paired class statistics across ranks (Part 2c): each rank
        puts its local shards' rows of `part` [n_pairs, D, 9] into the
        allgather, and every rank merges the [D, n_pairs, 9] rows with
        `meshmap.zpair_merge` (sums, a min, the first-max argmax)."""
        zall = np.concatenate(_allgather_rows(
            self._local_part(part.transpose(1, 0, 2))))
        self.last_zpair_merged = zpair_merge(self._cpu_mesh, zall)
        return self.last_zpair_merged

    # ------------------------------------------------------------ the runs
    def _run(self, fast, records: Sequence[SeqRecord], batch_size: int,
             read_sharding: bool, pairs: bool) -> bytes:
        """SAM bytes of `records` in batches through `fast`; with
        `read_sharding` each rank finishes its slice of every batch and
        the slices' bytes are exchanged in rank order."""
        self.last_f1_local_windows = 0
        self.last_render_wall = 0.0
        t0 = time.perf_counter()
        out: List[bytes] = []
        for off in range(0, len(records), batch_size):
            batch = records[off:off + batch_size]
            ctx = fast.stage_prepare(batch, batch_cap=batch_size)
            if ctx is None:
                raise ValueError("batch shape outside fast-path support")
            if pairs:
                fast.zpair_win_shard = self._win_shard
            if not read_sharding:
                out.append(fast.stage_finish(ctx)[0])
                continue
            fast.read_slice = _slice_for(self.pid, self.P,
                                         len(batch) // (2 if pairs else 1))
            fast.slice_select = True
            t1 = time.perf_counter()
            mine = fast.stage_finish(ctx)[0]
            self.last_render_wall += time.perf_counter() - t1
            out.append(b"".join(_allgather_bytes(mine)))
        self.last_slice_jobs = getattr(fast, "last_slice_jobs", 0)
        self.last_wall = time.perf_counter() - t0
        return b"".join(out)

    def map_unpaired_sam(self, records: Sequence[SeqRecord],
                         batch_size: int = 8192,
                         read_sharding: bool = False) -> bytes:
        """Unpaired mapping; every rank returns the same SAM bytes. In
        letter space the render divides by the z1 merged across ranks,
        and `read_sharding` has each rank select, expand and render only
        its 1/P slice of every batch (each sliced read's windows span
        every shard, so its z1 is whole without a merge). Colour space
        ignores `read_sharding`, as the reference does."""
        cfg = self.m.config
        if cfg.mode == C.MODE_COLOUR_SPACE:
            if not (_cs_config_supported(cfg)
                    and self.comp.subs[0].cs_codes is not None):
                raise ValueError("config outside the CS fast-path envelope")
            return self._run(_DistFastCS(self.m, self), records, batch_size,
                             False, False)
        if not _config_supported(cfg) or cfg.extra_sam_fields:
            raise ValueError("config outside the fast-path envelope")
        fast = _DistFastLS(self.m, self)
        fast.dispatch_fn = self._dispatch
        if cfg.compute_mapping_qualities and not read_sharding:
            fast.z1_merge_hook = self._z1_hook
        return self._run(fast, records, batch_size, read_sharding, False)

    def map_paired_sam(self, records: Sequence[SeqRecord],
                       batch_size: int = 8192,
                       read_sharding: bool = False) -> bytes:
        """Paired mapping (interleaved mates; an odd batch size is rounded
        up); every rank returns the same SAM bytes, the paired class
        statistics merged across ranks (`_zpair_hook`). `read_sharding`
        has the native paired brain run per rank on its 1/P pair slice
        only (each pair's windows span every shard: no merge). Colour
        space ignores `read_sharding`, as the reference does."""
        cfg = self.m.config
        batch_size += batch_size % 2
        if cfg.mode == C.MODE_COLOUR_SPACE:
            if not (_cs_paired_config_supported(cfg)
                    and self.comp.subs[0].cs_codes is not None):
                raise ValueError("config outside the CS paired fast-path "
                                 "envelope")
            fp = _DistFastPairedCS(self.m, self)
            read_sharding = False
        else:
            if not _paired_config_supported(cfg):
                raise ValueError("config outside the paired fast-path "
                                 "envelope")
            fp = _DistFastPaired(self.m, self)
            fp.fls.dispatch_fn = self._dispatch
        if cfg.compute_mapping_qualities and not read_sharding:
            fp.zpair_n_shards = self.D
            fp.zpair_merge_hook = self._zpair_hook
        return self._run(fp, records, batch_size, read_sharding, True)
