"""On-line sharded mapping over a mesh of torch devices.

Port of `shrimp_tpu/parallel/meshmap.py`. SHRiMP2 scales out by splitting
the genome into RAM-sized chunks, mapping each chunk in its own process,
and recombining SAM and mapping qualities offline with mergesam
(SPLITTING_AND_MERGING:1-160, mergesam/sam_reader.c:417-520). Here the
chunks are the shards of a mesh, a tuple of torch devices
(`make_mesh`), and the recombination is on-line:

- `MeshMapper` range-shards the genome planes over the devices (shard d
  holds [d*S, d*S + S + halo) of each plane) and routes every candidate
  window to the shard that owns its start; filter 1 runs on the host
  over the whole index, as unsharded.
- `ShardedIndexMapper` gives each device one sub-index of its own
  (`split_contig_bins`): its planes on the device, its CSR on the host.
  Filter 1 runs per shard against that shard's sub-index and
  `merge_shard_flathits` puts the windows back in the whole-index
  order; no whole-genome CSR exists anywhere (`CompositeIndex` has no
  `seeds`).

Each batch makes one launch of the fused device step per shard with
windows (`core/sw.py::sw_vec_full_stats_packed` in letter space,
`core/sw_cs.py::sw_vec_cs_full_from_index` in colour space), each on its
shard's device and its own CUDA stream, so that the shards of one card
queue side by side; every shard's launch is queued before any result is
fetched. The rows come back in window order (letter space: on the host,
`_MeshTier._fetch`; colour space: gathered to mesh[0] and permuted there,
`_MeshTier._gather`), and the streams' own host stages then run as
unsharded, so the SAM bytes equal the single-device fast path's. A row's
result does not depend on its launch, so the mesh, which always takes
the fused launch, also equals the two-phase single-device run. Batches
whose windows the stats kernel does not take (G > MAX_G, long reads) or
whose read rows outgrow the packed IO run one single-device launch on
mesh[0] (`fastpath._fused_dispatch`: the traceback flow); MeshMapper
maps configs and batches outside the fast paths with the generic mapper
on mesh[0]; ShardedIndexMapper refuses them (the generic mapper would
need the whole-genome CSR).

The Z statistics of the mapping qualities recombine with collectives
(not_in_dist/MAPPING_QUALITIES Parts 1c/2c): z1 is a float64 sum over
the shards (`zmerge_psum`), the paired class statistics merge with
`zpair_merge` (sums, a min, and the z4 priors of the shard with the best
posterior). Each shard's rows are copied to mesh[0] and reduced there in
shard order. In the sharded-index tier their output is what the render
divides by (`FastLS.z1_merge_hook`, `FastPaired.zpair_merge_hook`).

A mesh may repeat a device: D shards on one card, or "cpu" D times
(the plain versions of the kernels). Shards on one card show the
routing, the per-shard launches and the collectives, not a speed-up
across cards.
"""
from __future__ import annotations

import functools
import sys
from contextlib import nullcontext
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import constants as C
from ..config import MapperConfig, abs_or_pct
from ..core.batch_pipeline import FlatHits, _empty_flat
from ..core.sw import PAD, cat_word_plane, sw_vec_full_stats_packed
from ..core.sw_cs import sw_vec_cs_full_from_index
from ..device import get_device
from ..fastpath import (FastLS, FastPaired, _check_index_len,
                        _config_supported, _filter1_paired, _fused_dispatch,
                        _launch_args, _normalize_win, _pack_rtab, _packed_io,
                        _paired_config_supported, _stats_flow_enabled)
from ..fastpath_cs import FastCS, FastPairedCS
from ..fastpath_cs import _config_supported as _cs_config_supported
from ..fastpath_cs import _cs_paired_config_supported
from ..io.fasta import SeqRecord
from ..mapper import Mapper, _round_up
from ..paired import PairedMapper


def make_mesh(devices=None) -> Tuple[torch.device, ...]:
    """The mesh: a tuple of torch devices, one a shard. `devices` are
    names or torch.devices and may repeat ("cuda:0" four times: four
    shards on one card; "cpu" D times: the plain versions); by default
    every visible CUDA card, and without one this raises."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "the devices, e.g. ['cpu'] * D")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    mesh = tuple(get_device(d) for d in devices)
    if not mesh:
        raise ValueError("make_mesh: no devices")
    return mesh


# ------------------------------------------------------------ collectives

def _rows_on_first(mesh, zrows) -> List[torch.Tensor]:
    """Shard d's rows of `zrows` [D, ...] placed on mesh[d], then copied
    to mesh[0] (a peer copy between cards), float64."""
    z = np.asarray(zrows, np.float64)
    if z.shape[0] != len(mesh):
        raise ValueError(f"{z.shape[0]} rows of partials for a mesh of "
                         f"{len(mesh)} shards")
    return [torch.from_numpy(np.ascontiguousarray(z[d])).to(dev).to(mesh[0])
            for d, dev in enumerate(mesh)]


def zmerge_psum(mesh, zrows: np.ndarray) -> np.ndarray:
    """The additive Z recombination: `zrows` [D, ...] holds each shard's
    partial rows (z1, z3 or the insert-size denominator: the literal sums
    of MAPPING_QUALITIES Parts 1c/2c, sam_reader.c:456-509); returns
    their float64 sum, taken on mesh[0] in shard order 0..D-1."""
    rows = _rows_on_first(mesh, zrows)
    acc = rows[0].clone()
    for r in rows[1:]:
        acc += r
    return acc.cpu().numpy()


def zpair_merge(mesh, zrows: np.ndarray) -> np.ndarray:
    """The paired Z recombination (MAPPING_QUALITIES Part 2c,
    pairedpipe.cpp PPParams tail): `zrows` [D, n_pairs, 9] holds each
    shard's partial rows [z1a, z1b, ins_denom, z3, best_post_a, z4a,
    best_post_b, z4b, pr2_min]. Columns 0-3 sum, pr2 takes the min ("the
    min becomes a max" in neg-log space), each leg's z4 prior comes from
    the shard with the largest best posterior (the first such shard on
    ties: the whole run's first-max rule, output.c:796), 1.0 where every
    best posterior is below 0. Taken on mesh[0] in shard order; returns
    the merged [n_pairs, 7]: [z1a, z1b, ins_denom, z3, z4a, z4b,
    pr2_pre]. The algebra of the reference's `zpair_collective_body`."""
    rows = _rows_on_first(mesh, zrows)
    add = rows[0][:, :4].clone()
    pr2 = rows[0][:, 8].clone()
    best = [rows[0][:, 4].clone(), rows[0][:, 6].clone()]
    z4 = [rows[0][:, 5].clone(), rows[0][:, 7].clone()]
    for r in rows[1:]:
        add += r[:, :4]
        pr2 = torch.minimum(pr2, r[:, 8])
        for leg in (0, 1):
            take = r[:, 4 + 2 * leg] > best[leg]
            best[leg] = torch.where(take, r[:, 4 + 2 * leg], best[leg])
            z4[leg] = torch.where(take, r[:, 5 + 2 * leg], z4[leg])
    z4 = [torch.where(b < 0.0, torch.ones_like(z), z)
          for b, z in zip(best, z4)]
    return torch.cat([add, z4[0][:, None], z4[1][:, None], pr2[:, None]],
                     dim=1).cpu().numpy()


# ------------------------------------------------------------ host helpers

def halo_for(cfg: MapperConfig, read_len: Optional[int] = None) -> int:
    """Shard halo derived from the config's maximum window length: the
    least power of two from 2048 that covers it plus 8. A copy of
    `shrimp_tpu/parallel/meshmap.py::halo_for`."""
    L = read_len if read_len is not None else cfg.longest_read_len
    wl = int(abs_or_pct(cfg.window_len, L)) + 8
    h = 2048
    while h < wl:
        h *= 2
    return h


def split_contig_bins(contigs: Sequence[tuple], D: int) -> List[List]:
    """Contiguous greedy split of [(name, codes)] into D bins balanced
    by length (split-db bin packing, utils/split-db.py recast): bin d
    gets a consecutive contig range, so global contig numbering is the
    concatenation of the bins'. A copy of
    `shrimp_tpu/parallel/meshmap.py::split_contig_bins`."""
    total = sum(len(c) for _, c in contigs)
    per = -(-total // D)
    bins: List[List] = [[] for _ in range(D)]
    d = 0
    acc = 0
    for item in contigs:
        if acc >= per and d < D - 1 and bins[d]:
            d += 1
            acc = 0
        bins[d].append(item)
        acc += len(item[1])
    return bins


class CompositeIndex:
    """Duck-typed GenomeIndex over per-shard sub-indexes: the contig
    table and the concatenated genome planes the host stages read, while
    the CSR inverted indexes (the dominant RAM cost, README:128-150) stay
    per shard. `seeds` is absent: a path that would touch a whole-genome
    CSR fails instead of rebuilding one. A copy of
    `shrimp_tpu/parallel/meshmap.py::CompositeIndex`."""

    def __init__(self, subs: Sequence):
        if not subs:
            raise ValueError("need at least one sub-index")
        self.subs = list(subs)
        self.mode = subs[0].mode
        self.hashed = subs[0].hashed
        self.is_rna = subs[0].is_rna
        self.contig_names: List[str] = []
        offs = []
        lens = []
        base = 0
        for s in subs:
            self.contig_names += list(s.contig_names)
            offs.append(s.contig_offsets.astype(np.int64) + base)
            lens.append(s.contig_lengths)
            base += int(s.total_len)
        self.contig_offsets = np.concatenate(offs).astype(np.uint32)
        self.contig_lengths = np.concatenate(lens)
        self.codes = np.concatenate([s.codes for s in subs])
        self.codes_rc = np.concatenate([s.codes_rc for s in subs])
        self.cs_codes = None
        self.cs_codes_rc = None
        if subs[0].cs_codes is not None:
            self.cs_codes = np.concatenate([s.cs_codes for s in subs])
            self.cs_codes_rc = np.concatenate(
                [s.cs_codes_rc for s in subs])
        # shard routing tables
        self.cn_base = np.zeros(len(subs) + 1, np.int64)
        self.pos_base = np.zeros(len(subs) + 1, np.int64)
        for d, s in enumerate(subs):
            self.cn_base[d + 1] = self.cn_base[d] + s.n_contigs
            self.pos_base[d + 1] = self.pos_base[d] + s.total_len
        self._max_weight = max(si.seed.weight for si in subs[0].seeds)
        self._max_span = max(si.seed.span for si in subs[0].seeds)

    @property
    def total_len(self) -> int:
        return int(self.codes.shape[0])

    @property
    def n_contigs(self) -> int:
        return len(self.contig_names)

    @property
    def max_seed_span(self) -> int:
        return self._max_span

    def contig_of(self, pos):
        return np.searchsorted(self.contig_offsets, pos, side="right") - 1

    def auto_list_cutoff(self) -> int:
        """Whole-genome auto cutoff (gmapper.c:2830-2834): the GLOBAL
        length sets the value, as unsharded; per-key decisions use each
        shard's local list lengths (the reference's split-db
        behaviour)."""
        max_w = C.HASH_TABLE_POWER if self.hashed else self._max_weight
        return max(1000, int((100 * self.total_len) // (4 ** max_w)))


def merge_shard_flathits(parts, cn_base, n_owners: int):
    """Order-preserving merge of per-shard FlatHits [(hits, shard)]: per
    owner, shard-major (ascending global contig number), within a shard
    the filter's own (cn, g_off) order: the whole-index window order.
    Returns (merged FlatHits, global shard of each row). A copy of
    `shrimp_tpu/parallel/meshmap.py::merge_shard_flathits`."""
    tot = sum(p.n for p, _ in parts)
    if tot == 0:
        return _empty_flat(n_owners), np.zeros(0, np.int64)
    owner = np.concatenate([p.owner for p, _ in parts])
    shard = np.concatenate([np.full(p.n, d, np.int64) for p, d in parts])
    D = int(max(d for _, d in parts)) + 1
    order = np.argsort(owner * D + shard, kind="stable")
    owner_s = owner[order]

    def cat(field):
        return np.concatenate([getattr(p, field) for p, _ in parts])[order]

    cn = np.concatenate([p.cn.astype(np.int64) + cn_base[d]
                         for p, d in parts])[order].astype(np.int32)
    seg = np.searchsorted(owner_s, np.arange(n_owners + 1))
    fh = FlatHits(owner=owner_s, cn=cn, g_off=cat("g_off"),
                  w_len=cat("w_len"),
                  score_window_gen=cat("score_window_gen"),
                  matches=cat("matches"), score_max=cat("score_max"),
                  ax=cat("ax"), ay=cat("ay"), alen=cat("alen"),
                  awid=cat("awid"), seg_start=seg.astype(np.int64))
    return fh, shard[order]


# ------------------------------------------------------------ the shards

def _plane_pair(dev, fwd: np.ndarray, rc: np.ndarray):
    """(fwd, rc, cat words) on `dev` for two equal-length uint8 planes:
    the word plane (core.sw.cat_word_plane) goes up once and the two
    planes are views of its bytes; where its offsets would overflow
    int32, the two planes go up alone and cat words is None (the byte
    gather)."""
    cat = cat_word_plane(fwd, rc)
    if cat is None:
        return (torch.from_numpy(fwd).to(dev), torch.from_numpy(rc).to(dev),
                None)
    by = torch.from_numpy(cat.view(np.uint8)).to(dev)
    n = len(fwd)
    return by[:n], by[n + PAD:2 * n + PAD], by.view(torch.int32)


class _Shard:
    """One shard: its device, its CUDA stream (None on the CPU) and its
    planes: `ls` = (fwd, rc, cat words) and, for a colour-space index,
    `cs` = (colour fwd, colour rc, colour cat words)."""

    def __init__(self, device: torch.device, rows: dict):
        self.device = device
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)
        self.ls = _plane_pair(device, rows["codes"], rows["codes_rc"])
        self.cs = None
        if "cs_codes" in rows:
            self.cs = _plane_pair(device, rows["cs_codes"],
                                  rows["cs_codes_rc"])
        stores = {p.untyped_storage().data_ptr():
                  p.untyped_storage().nbytes()
                  for p in self.ls + (self.cs or ()) if p is not None}
        self.nbytes = sum(stores.values())

    def on(self):
        """The context in which this shard's work is queued."""
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else nullcontext())

    def hand_over(self, tensors) -> None:
        """Make `tensors`, made on this shard's stream, safe to use on
        the device's current stream."""
        if self.stream is None:
            return
        cur = torch.cuda.current_stream(self.device)
        cur.wait_stream(self.stream)
        for t in tensors:
            t.record_stream(cur)


def _filter1_per_shard(comp: CompositeIndex, n_owners: int, run):
    """`run(sub)` -> FlatHits (None: the batch is refused) on every
    sub-index, merged into the whole-index order: (FlatHits, shard of
    each window), or (None, None)."""
    parts = []
    for d, sub in enumerate(comp.subs):
        fh = run(sub)
        if fh is None:
            return None, None
        parts.append((fh, d))
    return merge_shard_flathits(parts, comp.cn_base, n_owners)


class _ShardedFastLS(FastLS):
    """FastLS whose filter 1 runs per shard against that shard's own
    sub-index; the tier `mm` keeps each window's shard (`_win_shard`)
    for the dispatch (the tier maps batch after batch). The stage refers
    to the tier and not back, so no cycle holds the indexes."""

    def __init__(self, mapper, tier) -> None:
        super().__init__(mapper)
        self.mm = tier

    def _filter1(self, codes2, L: int, wlen: int, min_kmer_pos: int = 0,
                 index=None):
        fh, self.mm._win_shard = _filter1_per_shard(
            self.m.index, codes2.shape[0] * 2,
            lambda sub: FastLS._filter1(self, codes2, L, wlen, min_kmer_pos,
                                        index=sub))
        return fh


class _ShardedFastPaired(FastPaired):
    """FastPaired whose filter 1 (the mate-pair region filter included)
    runs per shard against that shard's own sub-index. Pairs are
    insert-size local, so every pairing decision is intra-shard."""

    def __init__(self, mapper, tier) -> None:
        super().__init__(mapper)
        self.mm = tier

    def _filter1_paired(self, codes2, L: int, wlen: int, ro):
        fh, self.mm._win_shard = _filter1_per_shard(
            self.m.index, codes2.shape[0] * 2,
            lambda sub: _filter1_paired(self.m, self.fls.f1_threads, codes2,
                                        L, wlen, ro, min_kmer_pos=0,
                                        index=sub))
        return fh


class _MeshFastCS(FastCS):
    """FastCS whose fused colour-space launch runs per shard over the
    tier's planes, the results gathered to mesh[0] in window order, so
    stage_finish reads them unchanged. In the sharded-index tier filter 1
    also runs per shard. The dispatch stays fused: it ignores
    `n_reads`, as the reference's does."""

    def __init__(self, mapper, tier) -> None:
        super().__init__(mapper)
        self.mm = tier

    def _filter1_cs(self, codes2, R: int, wlen: int):
        if not self.mm.sharded_index:
            return super()._filter1_cs(codes2, R, wlen)
        fh, self.mm._win_shard = _filter1_per_shard(
            self.m.index, codes2.shape[0] * 2,
            lambda sub: self.fls._filter1(codes2, R, wlen, min_kmer_pos=1,
                                          index=sub))
        return fh

    def _fused_dispatch_cs(self, fh, codes0, qr_tab, initbp, R, Bcap,
                           xover_tab=None, rcf=None, thresh_override=None,
                           n_reads=None):
        m = self.m
        cfg = m.config
        sc = cfg.scores
        mm = self.mm
        n = int(fh.n)
        args_all, win, G = self._cs_args(fh, R, rcf, thresh_override,
                                         initbp)
        mm._check_halo(G)
        shard, local = mm._route(win["starts"])
        order = np.argsort(shard, kind="stable")
        counts = np.bincount(shard, minlength=mm.D)
        rows = _round_up(max(Bcap, 1), 1024)
        rtab = np.full((rows, R), C.BASE_N, np.uint8)
        rtab[:codes0.shape[0]] = codes0
        qr = np.full((rows, 4, R), C.BASE_N, np.uint8)
        qr[:qr_tab.shape[0]] = qr_tab
        xov = np.full((rows, R), sc.crossover, np.int32)
        if xover_tab is not None:
            xov[:xover_tab.shape[0]] = xover_tab
        kw = dict(G=G, xover=sc.crossover, match=sc.match,
                  mismatch=sc.mismatch, a_gap_open=sc.a_gap_open,
                  a_gap_ext=sc.a_gap_extend, b_gap_open=sc.b_gap_open,
                  b_gap_ext=sc.b_gap_extend,
                  local_alignment=not cfg.global_alignment,
                  indel_taboo_len=cfg.indel_taboo_len, phase="fused")
        parts = []
        off = 0
        for sh, k in zip(mm.shards, counts.tolist()):
            sl = order[off:off + k]
            off += k
            if k == 0 or sh is None:    # None: another process's shard
                parts.append(None)
                continue
            a = args_all[sl]
            a[:, 0] = local[sl]             # shard-local starts
            with sh.on():
                dev = sh.device
                parts.append(sw_vec_cs_full_from_index(
                    sh.cs[0], sh.cs[1], sh.ls[0], sh.ls[1],
                    torch.from_numpy(a).to(dev),
                    *(torch.from_numpy(x).to(dev) for x in (rtab, qr, xov)),
                    sh.cs[2], sh.ls[2], **kw))
        res = mm._gather(parts, order)
        cells = int(fh.w_len.astype(np.int64).sum()) * R
        m.tally(vec_invocs=n, vec_cells=cells, full_invocs=n,
                full_cells=cells * 4)
        return [(0, n, res)], win, G


class _MeshFastPairedCS(_MeshFastCS, FastPairedCS):
    """The colour-space paired pipeline over the mesh: `_MeshFastCS`'s
    dispatch (and, in the sharded-index tier, its per-shard filter 1,
    the mate-pair region filter included) on `FastPairedCS`."""

    def _filter1_cs_paired(self, codes2, R: int, wlen: int, ro):
        if not self.mm.sharded_index:
            return super()._filter1_cs_paired(codes2, R, wlen, ro)
        fh, self.mm._win_shard = _filter1_per_shard(
            self.m.index, codes2.shape[0] * 2,
            lambda sub: _filter1_paired(self.m, self.fls.f1_threads, codes2,
                                        R, wlen, ro, min_kmer_pos=1,
                                        index=sub))
        return fh


# ------------------------------------------------------------ the tiers

class _MeshTier:
    """What both tiers share: the mesh and its shards, the inner mapper
    on mesh[0] (its planes go up only if a fallback asks for them), the
    per-shard letter-space dispatch, the fetch and the gather. A
    subclass uploads its shards' planes (`_make_shards`) and routes the
    windows (`_route`)."""

    sharded_index = False

    def __init__(self, index, cfg: MapperConfig, mesh, halo: Optional[int]):
        self.mesh = tuple(mesh) if mesh is not None else make_mesh()
        self.D = len(self.mesh)
        self.halo = halo if halo is not None else halo_for(cfg)
        cls = PairedMapper if cfg.pair_mode != C.PAIR_NONE else Mapper
        self.m = cls(index, cfg, self.mesh[0])

    def _make_shards(self, rows: Sequence[dict]) -> None:
        """Each shard's planes from its numpy `rows` ({plane name: uint8
        row}) on its device."""
        self.shards = [_Shard(dev, r) for dev, r in zip(self.mesh, rows)]
        for dev in set(self.mesh):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)   # the planes are up

    @property
    def plane_bytes(self) -> List[int]:
        """The device bytes of each of this process's shards' planes."""
        return [sh.nbytes for sh in self.shards if sh is not None]

    def _check_halo(self, G: int) -> None:
        if G > self.halo:
            raise ValueError(f"window {G} exceeds shard halo {self.halo}; "
                             "construct with halo=halo_for(cfg, read_len)")

    def _route(self, starts: np.ndarray):
        """(shard of each window, its start in that shard's planes)."""
        raise NotImplementedError

    def _dispatch(self, m, fh, read_tab: np.ndarray, L: int, R: int,
                  rcf: np.ndarray, n_reads=None):
        """fastpath._fused_dispatch's drop-in: every window goes to its
        shard, and each
        shard with windows makes one fused vector + stats launch of its
        rows on its own device and stream; `win["fetch"]` brings the rows
        back in window order. Windows the stats kernel does not take
        (G > MAX_G: the traceback flow) and batches over the packed IO's
        read rows run one single-device launch on mesh[0] instead
        (`_fused_dispatch`, which takes `n_reads`), with the same
        bytes."""
        _check_index_len(m.index)
        n = int(fh.n)
        win, G = _normalize_win(m, fh, L, rcf)
        self._check_halo(G)
        if not (_stats_flow_enabled(G) and _packed_io(
                G, R, int(fh.w_len.max()), read_tab.shape[0])):
            return _fused_dispatch(m, fh, read_tab, L, R, rcf,
                                   n_reads=n_reads)
        shard, local = self._route(win["starts"])
        order = np.argsort(shard, kind="stable")
        counts = np.bincount(shard, minlength=self.D)
        sc = m.config.scores
        kw = dict(G=G, L=L, match=sc.match, mismatch=sc.mismatch,
                  a_gap_open=sc.a_gap_open, a_gap_ext=sc.a_gap_extend,
                  b_gap_open=sc.b_gap_open, b_gap_ext=sc.b_gap_extend,
                  local_alignment=False, phase="fused")
        rtab = _pack_rtab(read_tab)
        lwin = dict(win, starts=local)
        results = []
        off = 0
        for sh, k in zip(self.shards, counts.tolist()):
            sl = order[off:off + k]
            off += k
            if k == 0:
                results.append(None)
                continue
            args = _launch_args(lwin, sl, k, k, L, True)
            with sh.on():
                dev = sh.device
                results.append(sw_vec_full_stats_packed(
                    sh.ls[0], sh.ls[1], torch.from_numpy(args).to(dev),
                    torch.from_numpy(rtab).to(dev), sh.ls[2], **kw))
        win["packed_io"] = True
        win["shard"] = shard
        win["fetch"] = functools.partial(self._fetch, results, order,
                                         counts, n)
        cells = int(fh.w_len.astype(np.int64).sum()) * L
        m.tally(vec_invocs=n, vec_cells=cells, full_invocs=n,
                full_cells=cells)
        return [], win, G, True

    def _fetch(self, results, order, counts, n: int) -> np.ndarray:
        """The shards' [k, 3] stats rows on the host, in window order."""
        out = np.empty((n, 3), np.int32)
        off = 0
        for sh, res, k in zip(self.shards, results, counts.tolist()):
            if res is not None:
                with sh.on():
                    out[order[off:off + k]] = res.cpu().numpy()
            off += k
        return out

    def _gather(self, parts, order: np.ndarray):
        """The shards' result tuples copied to mesh[0] and put back in
        window order (`order` lists the windows shard by shard): the job
        of the reference's in-program all_gather and `inv`."""
        dev0 = self.mesh[0]
        n = len(order)
        inv = np.empty(n, np.int64)
        inv[order] = np.arange(n)
        inv_t = torch.from_numpy(inv).to(dev0)    # before the waits below
        for sh, res in zip(self.shards, parts):
            if res is not None:
                sh.hand_over(res)
        cols = zip(*[res for res in parts if res is not None])
        return tuple(torch.cat([t.to(dev0) for t in col])[inv_t]
                     for col in cols)

    def _batches(self, fast, records, batch_size: int, rejected,
                 before_finish=None) -> bytes:
        """SAM bytes of `records` in batches through `fast`; a batch its
        stage_prepare rejects goes to `rejected(batch)`."""
        out: List[bytes] = []
        for off in range(0, len(records), batch_size):
            batch = records[off:off + batch_size]
            ctx = fast.stage_prepare(batch, batch_cap=batch_size)
            if ctx is None:
                out.append(rejected(batch))
                continue
            if before_finish is not None:
                before_finish(ctx)
            out.append(fast.stage_finish(ctx)[0])
        return b"".join(out)


def _range_rows(index, D: int, halo: int) -> Tuple[int, list]:
    """(S, per-shard plane rows) of `index` range-sharded over D shards:
    shard d holds [d*S, d*S + S + halo) of each plane, 254 past the
    genome's end."""
    S = _round_up(-(-index.total_len // D), 256)
    fields = ["codes", "codes_rc"]
    if getattr(index, "cs_codes", None) is not None:
        fields += ["cs_codes", "cs_codes_rc"]
    out = []
    for d in range(D):
        rows = {}
        for f in fields:
            seg = getattr(index, f)[d * S:d * S + S + halo]
            r = np.full(S + halo, 254, np.uint8)
            r[:len(seg)] = seg
            rows[f] = r
        out.append(rows)
    return S, out


class MeshMapper(_MeshTier):
    """Maps reads against a genome range-sharded over a mesh; the SAM
    bytes equal the unsharded fast path's. The index stays on the host
    once (its CSR, and filter 1 over it, as unsharded: on a card its
    front half runs on mesh[0], `core/filter1_front.py`); each device
    holds its 1/D slice of the planes plus the halo. Configs and batches outside
    the fused fast paths go to the generic mapper on mesh[0]."""

    def __init__(self, index, config: Optional[MapperConfig] = None,
                 mesh=None, halo: Optional[int] = None):
        super().__init__(index, config or MapperConfig(), mesh, halo)
        self.S, rows = _range_rows(index, self.D, self.halo)
        self._make_shards(rows)
        self.last_zpart: Optional[np.ndarray] = None   # [D, B] z1 partials

    def _route(self, starts):
        shard = np.clip(starts // self.S, 0, self.D - 1).astype(np.int64)
        return shard, starts - shard * self.S

    def map_unpaired_sam(self, records: Sequence[SeqRecord],
                         batch_size: int = 8192,
                         collect_z: bool = False) -> bytes:
        """Unpaired mapping to SAM bytes, equal to the unsharded fast
        path's. With `collect_z`, `last_zpart` keeps the per-shard z1
        partials [D, n_reads] that `zmerge_psum` recombines. Colour space
        takes the CS fast path over the mesh."""
        cfg = self.m.config
        if cfg.mode == C.MODE_COLOUR_SPACE:
            if not _cs_config_supported(cfg) or self.shards[0].cs is None:
                return self._generic_fallback(records)
            return self._batches(_MeshFastCS(self.m, self), records,
                                 batch_size, self._generic_fallback)
        if not _config_supported(cfg):
            return self._generic_fallback(records)
        fast = FastLS(self.m)
        fast.dispatch_fn = self._dispatch
        out: List[bytes] = []
        zparts = []
        for off in range(0, len(records), batch_size):
            batch = records[off:off + batch_size]
            if collect_z:
                fast.surv_post = np.zeros(0, np.float64)    # asks for them
            ctx = fast.stage_prepare(batch, batch_cap=batch_size)
            if ctx is None:
                out.append(self._generic_fallback(batch))
                if collect_z:
                    zparts.append(np.zeros((self.D, len(batch))))
                continue
            out.append(fast.stage_finish(ctx)[0])
            if collect_z:
                zp = np.zeros((self.D, len(batch)), np.float64)
                if ctx.get("fh") is not None and ctx["fh"].n \
                        and len(fast.surv_post):
                    win = ctx["win"]
                    shard = win.get("shard")
                    if shard is None:     # a single-device launch
                        shard = self._route(win["starts"])[0]
                    np.add.at(zp, (shard[fast.last_rows],
                                   fast.last_ri.astype(np.int64)),
                              fast.surv_post)
                zparts.append(zp)
        if collect_z:
            self.last_zpart = (np.concatenate(zparts, axis=1) if zparts
                               else np.zeros((self.D, 0)))
        return b"".join(out)

    def map_paired_sam(self, records: Sequence[SeqRecord],
                       batch_size: int = 8192) -> bytes:
        """Paired mapping to SAM bytes, equal to the unsharded paired
        fast path's: the same whole-index filter 1 and pair-up, the fused
        launch per shard. Colour space takes the CS paired fast path over
        the mesh."""
        cfg = self.m.config
        batch_size += batch_size % 2
        if cfg.mode == C.MODE_COLOUR_SPACE:
            if (not _cs_paired_config_supported(cfg)
                    or self.shards[0].cs is None):
                return self._generic_fallback(records)
            return self._batches(_MeshFastPairedCS(self.m, self), records,
                                 batch_size, self._generic_fallback)
        if not _paired_config_supported(cfg):
            return self._generic_fallback(records)
        fp = FastPaired(self.m)
        fp.fls.dispatch_fn = self._dispatch
        return self._batches(fp, records, batch_size,
                             self._generic_fallback)

    def _generic_fallback(self, records: Sequence[SeqRecord]) -> bytes:
        """The generic mapper on mesh[0] for configs and batches outside
        the fused fast paths: the same bytes, no sharding."""
        from ..io.sam import render_pair_entry, render_unpaired
        print("meshmap: config/batch outside the fused fast path; "
              "falling back to the generic mapper for this run",
              file=sys.stderr)
        cfg = self.m.config
        fq = any(r.qual is not None for r in records)
        lines: List[str] = []
        if cfg.pair_mode != C.PAIR_NONE:
            for pe in self.m.map_paired(list(records)):
                p_out, u_out = self.m.select_output(pe)
                lines += render_pair_entry(pe, self.m.index, cfg, p_out,
                                           u_out, fastq=fq)
        else:
            for re_, hits in self.m.map_unpaired(list(records)):
                for h in hits:
                    lines.append(render_unpaired(re_, h, self.m.index, cfg,
                                                 fastq=fq))
                if not hits and cfg.sam_unaligned:
                    lines.append(render_unpaired(re_, None, self.m.index,
                                                 cfg, fastq=fq))
        return ("\n".join(lines) + "\n").encode() if lines else b""


class ShardedIndexMapper(_MeshTier):
    """Index-sharded mapping: shard d owns sub-index d (`sub_indexes`,
    one a device, e.g. from `split_contig_bins`): its planes on its
    device and its CSR on the host. Filter 1 runs per shard against its
    own sub-index only, and the MQV denominators recombine across shards
    with `zmerge_psum` (LS unpaired: `last_z1_merged`) and `zpair_merge`
    (pairs, LS and CS: `last_zpair_merged`), whose output the render
    divides by.

    The output equals the whole-index run's, with the two caveats of the
    reference's own split-db workflow: per-key list cutoffs apply to each
    shard's local list lengths (README:1280-1305), and the region
    prefilter loses cross-contig mark bleed where a contig boundary
    straddles a region. Both vanish where cutoffs do not trip and contigs
    are region-aligned. Configs and batches outside the fused fast paths
    raise ValueError: the generic mapper would need the whole-genome CSR.
    """

    sharded_index = True

    def __init__(self, sub_indexes: Sequence, config=None, mesh=None,
                 halo: Optional[int] = None):
        self.comp = CompositeIndex(sub_indexes)
        super().__init__(self.comp, config or MapperConfig(), mesh, halo)
        if len(sub_indexes) != self.D:
            raise ValueError(f"need {self.D} sub-indexes for a {self.D}-"
                             f"device mesh, not {len(sub_indexes)}")
        rows = []
        for s in sub_indexes:
            # each shard's own planes, 254 past its end
            n = _round_up(int(s.total_len) + self.halo, 256)
            r = {}
            for f in ("codes", "codes_rc", "cs_codes", "cs_codes_rc"):
                if getattr(s, f) is not None:
                    r[f] = np.full(n, 254, np.uint8)
                    r[f][:s.total_len] = getattr(s, f)
            rows.append(r)
        self._make_shards(rows)
        # each window's shard, from the current batch's filter 1
        self._win_shard: Optional[np.ndarray] = None
        self.last_z1_merged: Optional[np.ndarray] = None
        self.last_zpair_merged: Optional[np.ndarray] = None

    def _route(self, starts):
        shard = self._win_shard
        return shard, starts - self.comp.pos_base[shard]

    @staticmethod
    def _refuse(batch):
        raise ValueError("batch shape outside fast-path support")

    def _zpair_hook(self, part: np.ndarray) -> np.ndarray:
        self.last_zpair_merged = zpair_merge(
            self.mesh, np.ascontiguousarray(part.transpose(1, 0, 2)))
        return self.last_zpair_merged

    def map_unpaired_sam(self, records: Sequence[SeqRecord],
                         batch_size: int = 8192) -> bytes:
        """Unpaired mapping to SAM bytes; in letter space the MQV of
        every alignment divides by the collective-merged z1."""
        cfg = self.m.config
        if cfg.mode == C.MODE_COLOUR_SPACE:
            if not (_cs_config_supported(cfg) and self.comp.cs_codes
                    is not None):
                raise ValueError("config outside the CS fast-path envelope")
            return self._batches(_MeshFastCS(self.m, self), records,
                                 batch_size, self._refuse)
        if not _config_supported(cfg):
            raise ValueError("config outside the fast-path envelope")
        fast = _ShardedFastLS(self.m, self)
        fast.dispatch_fn = self._dispatch

        def z1_hook(posteriors, job_ri, job_rows, B):
            """Per-shard z1 partials of the alignments that enter z1,
            merged by the collective (MAPPING_QUALITIES Part 1c: z1 is a
            literal sum of per-shard terms)."""
            zp = np.zeros((self.D, B), np.float64)
            np.add.at(zp, (self._win_shard[job_rows],
                           job_ri.astype(np.int64)), posteriors)
            self.last_z1_merged = zmerge_psum(self.mesh, zp)
            return self.last_z1_merged
        fast.z1_merge_hook = z1_hook
        return self._batches(fast, records, batch_size, self._refuse)

    def map_paired_sam(self, records: Sequence[SeqRecord],
                       batch_size: int = 8192) -> bytes:
        """Paired mapping with per-shard sub-indexes: filter 1 and the
        mate-pair region filter per shard, the fused launch per shard,
        the paired class statistics merged by `zpair_merge` (pairs never
        span shards: insert-size windows are intra-contig,
        mapping.c:405-456). Colour space takes the CS paired fast
        path."""
        cfg = self.m.config
        batch_size += batch_size % 2
        if cfg.mode == C.MODE_COLOUR_SPACE:
            if not (_cs_paired_config_supported(cfg)
                    and self.comp.cs_codes is not None):
                raise ValueError("config outside the CS paired fast-path"
                                 " envelope")
            fp = _MeshFastPairedCS(self.m, self)
        else:
            if not _paired_config_supported(cfg):
                raise ValueError("config outside the paired fast-path"
                                 " envelope")
            fp = _ShardedFastPaired(self.m, self)
            fp.fls.dispatch_fn = self._dispatch
        fp.zpair_n_shards = self.D
        fp.zpair_merge_hook = self._zpair_hook

        def before_finish(ctx):
            # each window's shard, from this batch's filter 1
            fp.zpair_win_shard = self._win_shard
        return self._batches(fp, records, batch_size, self._refuse,
                             before_finish)
