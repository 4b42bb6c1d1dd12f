"""Filter 1's front half on the device: the plain PyTorch version and the
wrapper of the CUDA kernel `csrc/filter1_front.cu`.

For each owner (a read strand: a row of `codes` [n_owners, L] uint8) the
front half takes the spaced k-mer keys of every seed at every start from
`min_pos` (base `codes & 3` at included offset o_j in bits 2j, the
layout of `native/filter1.cpp`'s unhashed keys), looks each key up in its
seed's CSR offsets, skips lists longer than `cutoff` or empty, gathers the
postings as packed keys pos << 32 | stream (stream = seed * L + i) and
sorts them. With `use_region`, a posting survives where its region
(pos >> region_bits) has 2 or more marks, or where it lies in the first
`region_overlap` bases of a region whose predecessor has; region q's
marks are the postings in [q << bits, (q + 1) << bits + min(overlap,
2^bits)), counted up to 2 (read_get_region_counts, mapping.c:459-542).
The survivors are exactly the part of filter1.cpp's sorted pos_keys that
its anchor walk keeps, in the same order.

`front_ref` (the plain version, on any device) returns (keys int64
[total], base int64 [n_owners], count int64 [n_owners]) tensors: owner
o's survivors are keys[base[o]:][:count[o]]; count -1 marks an owner with
more than `cap` postings, which the host's own front half takes
(`native/filter1_py.generate_candidates_survivors`). `front` returns the
same as numpy arrays: the plain version on the CPU, the kernel on a card
(it launches the kernel or raises).

`engages` decides where filter 1's front half runs: on the mapper's card
for its own index, with seeds the kernel takes, where a block holds an
owner. `generate_candidates_device` is filter 1 with this front half on
the mapper's card: the batch's codes go up, the kernel runs and its
survivors come back on a CUDA stream that the call holds alone (its wait
is on that stream, not behind other lanes' kernels), and the native back
half turns them into the FlatHits of `generate_candidates_native`.
"""
from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from functools import lru_cache
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import _build
from ..native.filter1_py import generate_candidates_survivors

MAX_SEEDS = 16
MAX_SPAN = 32
# filter1_front_config's answer where a block cannot hold an owner
NO_FIT = -1
# launches of the CUDA kernel (the plain version is not counted)
LAUNCHES = _build.LaunchCount()
_M32 = 0xFFFFFFFF


class _Seeds(ctypes.Structure):
    """The kernel's `Seeds`: the seeds and their device tables."""
    _fields_ = [("n_seeds", ctypes.c_int32),
                ("span", ctypes.c_int32 * MAX_SEEDS),
                ("weight", ctypes.c_int32 * MAX_SEEDS),
                ("offs", (ctypes.c_uint8 * MAX_SPAN) * MAX_SEEDS),
                ("offsets", ctypes.c_uint64 * MAX_SEEDS),
                ("positions", ctypes.c_uint64 * MAX_SEEDS)]


@dataclass
class SeedTables:
    """An index's seeds and CSR tables on one device: `offsets[s]`
    (4^weight + 1 uint32) and `positions[s]` (uint32), held as int32
    tensors of the same bits, and on a card the kernel's `Seeds` block
    (`struct`, uint8)."""
    spans: List[int]
    offs: List[List[int]]
    offsets: List[torch.Tensor]
    positions: List[torch.Tensor]
    struct: Optional[torch.Tensor]


def supported(index) -> bool:
    """The front half takes unhashed seeds of span 32 or less with
    ascending offsets (filter1.cpp's PEXT key path), at most MAX_SEEDS."""
    if index.hashed or not 0 < len(index.seeds) <= MAX_SEEDS:
        return False
    for si in index.seeds:
        o = np.asarray(si.seed.offsets)
        if si.seed.span > MAX_SPAN or np.any(np.diff(o) <= 0):
            return False
    return True


def engages(m, L: Optional[int] = None, min_pos: int = 0,
            index=None) -> bool:
    """Filter 1's front half runs on mapper `m`'s card: on its own index
    (`index` None), on a CUDA device, with seeds the kernel takes
    (`supported`) and, for reads of L bases (None: whatever the length), a
    block that holds an owner (`fits`). Everywhere else all of filter 1
    runs on the host."""
    if index is not None or m.device.type != "cuda" or not supported(
            m.index):
        return False
    return L is None or fits(n_keys([si.seed.span for si in m.index.seeds],
                                    L, min_pos), L)


def n_keys(spans, L: int, min_pos: int) -> int:
    """The keys of an owner: every seed's starts from min_pos."""
    return sum(max(0, L - s + 1 - min_pos) for s in spans)


def capacity(K: int) -> int:
    """The postings an owner may have on the card (a power of two): twice
    its keys, at least 1,024; an owner with more goes to the host."""
    cap = 1024
    while cap < 2 * K:
        cap *= 2
    return cap


def seed_tables(index, device: torch.device, upload: Callable
                ) -> SeedTables:
    """The index's tables on `device`, each array through `upload(array)`
    (a Mapper's `_upload`). Offsets stored as int64 go up as uint32 (they
    always fit: positions are uint32)."""
    spans, offs, offsets, positions = [], [], [], []
    for si in index.seeds:
        spans.append(int(si.seed.span))
        offs.append([int(o) for o in si.seed.offsets])
        off = si.offsets
        if off.dtype != np.uint32:
            off = off.astype(np.uint32)
        offsets.append(upload(off.view(np.int32)))
        positions.append(upload(np.ascontiguousarray(
            si.positions, np.uint32).view(np.int32)))
    struct = None
    if device.type == "cuda":
        st = _Seeds()
        st.n_seeds = len(spans)
        for s, (sp, o) in enumerate(zip(spans, offs)):
            st.span[s] = sp
            st.weight[s] = len(o)
            for j, v in enumerate(o):
                st.offs[s][j] = v
            st.offsets[s] = offsets[s].data_ptr()
            st.positions[s] = positions[s].data_ptr()
        struct = upload(np.frombuffer(bytes(st), np.uint8))
    return SeedTables(spans, offs, offsets, positions, struct)


def _u32(t: torch.Tensor) -> torch.Tensor:
    """The uint32 values of an int32 tensor of their bits, as int64."""
    return t.to(torch.int64) & _M32


def front_ref(codes: torch.Tensor, tables: SeedTables, min_pos: int,
              cutoff: int, region_bits: int, region_overlap: int,
              use_region: bool, cap: int):
    """Plain version, on any device: (keys, base, count) as the module
    docstring says, owners in order."""
    dev = codes.device
    n, L = codes.shape
    c = (codes & 3).to(torch.int64)
    owners, keys = [], []
    for s, (span, offs) in enumerate(zip(tables.spans, tables.offs)):
        ni = L - span + 1 - min_pos
        if ni <= 0:
            continue
        i = torch.arange(min_pos, min_pos + ni, device=dev)
        key = torch.zeros((n, ni), dtype=torch.int64, device=dev)
        for j, o in enumerate(offs):
            key |= c[:, i + o] << (2 * j)
        off = tables.offsets[s]
        lo = _u32(off[key]).reshape(-1)
        cnt = _u32(off[key + 1]).reshape(-1) - lo
        cnt = torch.where((cnt > cutoff) | (cnt <= 0), 0, cnt)
        list_id = torch.repeat_interleave(
            torch.arange(n * ni, device=dev), cnt)
        first = torch.cumsum(cnt, 0) - cnt
        within = torch.arange(len(list_id), device=dev) - first[list_id]
        pos = _u32(tables.positions[s][lo[list_id] + within])
        owners.append(list_id // ni)
        keys.append(pos << 32 | (s * L + min_pos + list_id % ni))
    owner = torch.cat(owners) if owners else torch.zeros(
        0, dtype=torch.int64, device=dev)
    key = torch.cat(keys) if keys else owner.clone()
    spill = torch.bincount(owner, minlength=n) > cap
    take = ~spill[owner]
    owner, key = owner[take], key[take]
    order = torch.sort(key, stable=True).indices
    order = order[torch.sort(owner[order], stable=True).indices]
    owner, key = owner[order], key[order]
    if use_region:
        x = key >> 32
        comp = (owner << 32) + x

        def marks2(lo, hi):
            """2 or more of the owner's postings lie in [lo, hi)."""
            a = torch.searchsorted(comp, (owner << 32) + lo)
            b = torch.searchsorted(comp, (owner << 32) + hi)
            return b - a >= 2
        ov = min(region_overlap, 1 << region_bits)
        r = x >> region_bits
        rm1 = (r - 1).clamp(min=0)
        ok = marks2(r << region_bits, ((r + 1) << region_bits) + ov)
        ok |= (((x & ((1 << region_bits) - 1)) < region_overlap) & (r > 0)
               & marks2(rm1 << region_bits, (r << region_bits) + ov))
        owner, key = owner[ok], key[ok]
    count = torch.bincount(owner, minlength=n)
    base = torch.cumsum(count, 0) - count
    count = torch.where(spill, -1, count)
    base = torch.where(spill, 0, base)
    return key, base, count


def _launch(codes: torch.Tensor, tables: SeedTables, min_pos: int, K: int,
            cutoff: int, region_bits: int, region_overlap: int,
            use_region: bool, cap: int, surv_cap: Optional[int] = None):
    """The kernel over `codes` [n, L] uint8 on a card: (survivors int64
    [surv_cap] of which meta[0] are written, meta int64 [1 + 2n]: the
    total, each owner's offset, each owner's count or -1). `surv_cap`
    (None: n * cap, room for any batch) bounds the survivors; where
    meta[0] exceeds it, some owners' survivors were not written."""
    n, L = codes.shape
    dev = codes.device
    if codes.dtype != torch.uint8 or not codes.is_contiguous():
        raise ValueError("filter1_front: codes must be contiguous uint8")
    surv_cap = n * cap if surv_cap is None else surv_cap
    surv = torch.empty(surv_cap, dtype=torch.int64, device=dev)
    meta = torch.zeros(1 + 2 * n, dtype=torch.int64, device=dev)
    lib = _build.load().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.filter1_front_launch(
            codes.data_ptr(), tables.struct.data_ptr(), surv.data_ptr(),
            meta.data_ptr(), surv_cap, n, L, min_pos, K, cap,
            max(-1, min(int(cutoff), (1 << 31) - 1)), region_bits,
            region_overlap, int(use_region), stream)
    _build.check(rc, "filter1_front_launch")
    LAUNCHES.add()
    return surv, meta


def front(codes: np.ndarray, tables: SeedTables, device: torch.device,
          min_pos: int, cutoff: int, region_bits: int, region_overlap: int,
          use_region: bool, cap: Optional[int] = None,
          surv_cap: Optional[int] = None):
    """(keys uint64, base int64, count int64) as numpy arrays for the
    owners of `codes` [n_owners, L] uint8, on `device` (where `tables`
    lie): the plain version on the CPU; on a card the kernel, on a CUDA
    stream that this call holds alone (`_take_stream`), whose copies back
    this call waits for alone. `cap` (None: `capacity`) bounds an owner's
    postings; the kernel's first launch has room for `surv_cap` survivors
    (None: a survivor a key, n_owners * K), and a batch with more runs
    again with room for all."""
    n, L = codes.shape
    K = n_keys(tables.spans, L, min_pos)
    cap = capacity(K) if cap is None else cap
    if device.type == "cpu":
        keys, base, count = front_ref(
            torch.from_numpy(codes), tables, min_pos, cutoff, region_bits,
            region_overlap, use_region, cap)
        return keys.numpy().view(np.uint64), base.numpy(), count.numpy()
    stream = _take_stream(device)
    try:
        with torch.cuda.stream(stream):
            codes_dev = torch.from_numpy(codes).to(device)
            args = (tables, min_pos, K, cutoff, region_bits, region_overlap,
                    use_region, cap)
            surv, meta = _launch(codes_dev, *args, max(
                1, n * K if surv_cap is None else surv_cap))
            meta = meta.cpu().numpy()
            if meta[0] > len(surv):
                surv, meta = _launch(codes_dev, *args)
                meta = meta.cpu().numpy()
            keys = surv[:int(meta[0])].cpu().numpy().view(np.uint64)
    finally:
        _give_stream(device, stream)
    return keys, meta[1:1 + n], meta[1 + n:]


# the streams of the calls: a call takes one that no other call holds and
# gives it back, so there are only as many as calls ever ran at once (the
# lanes), each keeping its own cached buffers in PyTorch's allocator
_STREAMS_LOCK = threading.Lock()
_FREE_STREAMS: dict = {}


def _take_stream(device: torch.device) -> torch.cuda.Stream:
    """A stream of `device` at the highest priority, held by no other
    call (its short kernel goes ahead of the SW kernels' waiting
    blocks)."""
    with _STREAMS_LOCK:
        free = _FREE_STREAMS.setdefault(device, [])
        if free:
            return free.pop()
    return torch.cuda.Stream(device, priority=-1)


def _give_stream(device: torch.device, stream: torch.cuda.Stream) -> None:
    with _STREAMS_LOCK:
        _FREE_STREAMS[device].append(stream)


@lru_cache(maxsize=None)
def fits(K: int, L: int) -> bool:
    """A block of the kernel holds an owner of K keys and L bases on the
    current card. Any answer of the card but that one (NO_FIT) raises."""
    out = (ctypes.c_int * len(_build.CONFIG_KEYS))()
    rc = _build.load().lib.filter1_front_config(
        K, L, capacity(K), ctypes.addressof(out))
    if rc == NO_FIT:
        return False
    _build.check(rc, "filter1_front_config")
    return True


def generate_candidates_device(m, codes: np.ndarray, read_len: int,
                               window_len: int, cutoff: int,
                               match_mode: int, threshold: float,
                               match_score: int, b_gap_open: int,
                               b_gap_extend: int, min_kmer_pos: int = 0,
                               use_region_counts: bool = True,
                               region_bits: int = 11,
                               region_overlap: int = 50,
                               collapse: bool = True, gapless: bool = False,
                               search_strands=(True, True),
                               threads: Optional[int] = None):
    """`native.filter1_py.generate_candidates_native` over mapper `m`'s
    own index, with the front half on `m.device` (a card; on the CPU its
    plain version): the same FlatHits, or None where that gives None.
    The front half is the stage `filter1 lookup` (the codes' copy, the
    kernel, the wait, the survivors' copy back; `bytes` the copies'), the
    native back half `filter1 windows`; the owners are counted as
    `filter1 device owners` and, those over the block's capacity,
    `filter1 host owners`."""
    n_owners = 2 * codes.shape[0]
    flat = np.ascontiguousarray(codes.reshape(n_owners, read_len),
                                dtype=np.uint8)
    tables = m._dev_f1_tables()
    with m.span("filter1 lookup", bytes=0) as sp:
        keys, base, count = front(flat, tables, m.device, min_kmer_pos,
                                  cutoff, region_bits, region_overlap,
                                  use_region_counts)
        sp.attrs["bytes"] = flat.nbytes + 16 * n_owners + 8 + keys.nbytes
    spilled = int(np.count_nonzero(count < 0))
    m.count("filter1 device owners", n_owners - spilled)
    if spilled:
        m.count("filter1 host owners", spilled)
    return generate_candidates_survivors(
        m.index, codes, keys, base, count, read_len, window_len, cutoff,
        match_mode, threshold, match_score, b_gap_open, b_gap_extend,
        min_kmer_pos=min_kmer_pos, use_region_counts=use_region_counts,
        region_bits=region_bits, region_overlap=region_overlap,
        collapse=collapse, gapless=gapless, search_strands=search_strands,
        threads=threads, tally=m.tally)
