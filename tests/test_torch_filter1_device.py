"""Filter 1 with its front half on the device (`core/filter1_front.py`):
the wrapper's CPU route (the plain PyTorch version of the kernel, then
the native back half, filter1.cpp's filter1_survivors) and the port's
host path (`filter1_batch`) against the JAX package's `filter1_batch`
(`shrimp_tpu.native.filter1_py.generate_candidates_native`), FlatHits
array for array; the kernel itself is held against the plain version on
the card by chip_smoke.py's phase 25. And the rule that sends a call to
the device path or keeps it on the host."""
import dataclasses
from types import SimpleNamespace

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from shrimp_tpu.index.build import build_index as ref_build_index
from shrimp_tpu.index.seeds import default_seeds as ref_seeds
from shrimp_tpu.native.filter1_py import \
    generate_candidates_native as ref_f1
from shrimp_tpu_torch import _build
from shrimp_tpu_torch import constants as C
from shrimp_tpu_torch import dataset, fastpath, fastpath_cs
from shrimp_tpu_torch.config import MapperConfig
from shrimp_tpu_torch.core import filter1_front
from shrimp_tpu_torch.index import build as build_mod
from shrimp_tpu_torch.index.build import build_index
from shrimp_tpu_torch.index.seeds import default_seeds
from shrimp_tpu_torch.mapper import Mapper
from shrimp_tpu_torch.native.filter1_py import generate_candidates_native
from shrimp_tpu_torch.paired import PairedMapper

CS = C.MODE_COLOUR_SPACE
LS = C.MODE_LETTER_SPACE
# contigs of several lengths (the last shorter than a 250 bp read's
# window), the first with a 1 kbp tandem repeat whose k-mers have long
# posting lists
CONTIG_LENS = (150_000, 40_000, 6_000, 300)


@pytest.fixture(scope="module")
def genome():
    rng = np.random.default_rng(2024)
    out = []
    for k, n in enumerate(CONTIG_LENS):
        c = rng.integers(0, 4, n).astype(np.uint8)
        if k == 0:
            c[50_000:51_000] = np.tile(c[50_000:50_025], 40)
        out.append((f"c{k}", c))
    return out


@pytest.fixture(scope="module")
def indexes(genome):
    """LS and CS indexes of the genome; the hugepage copy skipped (the
    buffers are never unmapped)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(build_mod, "to_hugepages", lambda a: a)
    try:
        yield {mode: build_index(genome, default_seeds(mode=mode),
                                 mode=mode) for mode in (LS, CS)}
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def ref_indexes(genome):
    """The JAX package's LS and CS indexes of the genome."""
    return {mode: ref_build_index(genome, ref_seeds(mode=mode), mode=mode)
            for mode in (LS, CS)}


def _reads(idx, mode, L, n, rng, near=None):
    """codes2 [n, 2, L]: reads drawn from the index's plane with 0-4
    substitutions, one in five with an indel of 1-3 bases; `near` a list
    of genome positions to draw from (around which the reads start)."""
    plane = idx.cs_codes if mode == CS else idx.codes
    out = np.empty((n, 2, L), np.uint8)
    for k in range(n):
        if near is not None:
            p = int(near[k % len(near)]) + int(rng.integers(-L, 8))
        else:
            p = int(rng.integers(0, len(plane) - L - 8))
        p = min(max(p, 0), len(plane) - L - 8)
        seq = plane[p:p + L + 8].copy()
        if rng.random() < 0.2:
            at, ln = int(rng.integers(5, L - 5)), int(rng.integers(1, 4))
            if rng.random() < 0.5:
                seq = np.concatenate([seq[:at], seq[at + ln:]])
            else:
                seq = np.concatenate([seq[:at], rng.integers(
                    0, 4, ln).astype(np.uint8), seq[at:]])
        seq = seq[:L]
        for _ in range(int(rng.integers(0, 5))):
            seq[int(rng.integers(0, L))] = rng.integers(0, 4)
        out[k, 0] = seq
        out[k, 1] = seq[::-1] if mode == CS else C.COMPLEMENT[seq[::-1]]
    return out


def _counts(m):
    c = m.stats.counts
    return (c.get("filter1 device owners", 0),
            c.get("filter1 host owners", 0))


def _assert_same(want, got):
    assert got is not None and want is not None
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        assert b.dtype == a.dtype and np.array_equal(b, a), f.name


# name -> (mode, L, reads, extra arguments); the reads: "plain" from
# anywhere, "boundary" around multiples of 2^region_bits (region 0
# included), "ends" around the contigs' ends, "random" of no position
CASES = {
    "ls36": (LS, 36, "plain", {}),
    "ls250": (LS, 250, "plain", {}),
    "cs36": (CS, 36, "plain", {}),
    "cs250": (CS, 250, "plain", {}),
    "cutoff": (LS, 60, "repeat", dict(cutoff=3)),
    "overlap": (LS, 50, "boundary", dict(region_bits=8, region_overlap=60)),
    "overlap_wide": (LS, 40, "boundary",
                     dict(region_bits=5, region_overlap=50)),
    "contig_ends": (LS, 250, "ends", {}),
    "no_postings": (LS, 40, "random", {}),
    "no_regions": (LS, 36, "plain", dict(use_region_counts=False)),
    "spill": (LS, 100, "repeat", dict(cap=256)),
    "threads": (LS, 36, "plain", dict(threads=3, n=1600)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_route_matches_filter1_batch(indexes, ref_indexes,
                                            monkeypatch, case):
    """generate_candidates_device on a CPU mapper (the plain version of
    the front half, then filter1_survivors) and the port's host path
    (filter1_batch) give the JAX package's filter1_batch FlatHits, array
    for array; owners over the block's capacity go to the host's front
    half and are counted."""
    mode, L, draw, extra = CASES[case]
    extra = dict(extra)
    idx = indexes[mode]
    cfg = MapperConfig(mode=mode)
    m = Mapper(idx, cfg, "cpu")
    rng = np.random.default_rng(len(case) * 7 + L)
    n = extra.pop("n", 96)
    near = {"plain": None, "repeat": [50_000, 50_500, 10_000],
            "boundary": [0, 2 ** extra.get("region_bits", 11), 4096,
                         3 * 2 ** extra.get("region_bits", 11), 70_000],
            "ends": list(np.cumsum(CONTIG_LENS)[:-1]) + [0, 196_000],
            "random": None}[draw]
    codes2 = _reads(idx, mode, L, n, rng, near)
    if draw == "random":
        codes2[::2] = rng.integers(0, 4, codes2[::2].shape)
    cap = extra.pop("cap", None)
    if cap is not None:
        monkeypatch.setattr(filter1_front, "capacity", lambda K: cap)
    opts = cfg.unpaired_options()[0]
    args = (codes2, L, int(L * 1.4), extra.pop("cutoff", m.cutoff),
            opts.hit_list.match_mode, opts.hit_list.threshold,
            cfg.scores.match, cfg.scores.b_gap_open, cfg.scores.b_gap_extend)
    kw = dict(min_kmer_pos=1 if mode == CS else 0,
              region_bits=extra.pop("region_bits", cfg.region_bits),
              region_overlap=extra.pop("region_overlap", cfg.region_overlap),
              **extra)
    want = ref_f1(ref_indexes[mode], *args, **kw)
    got = filter1_front.generate_candidates_device(m, *args, **kw)
    _assert_same(want, got)
    _assert_same(want, generate_candidates_native(idx, *args, **kw))
    assert want.n > 0
    device, host = _counts(m)
    assert device + host == 2 * n
    if case == "spill":
        assert host > 0
    if case == "no_postings":
        assert np.any(np.diff(got.seg_start) == 0)
    secs = m.stats.stage_secs
    assert secs["filter1 lookup"] > 0 and secs["filter1 windows"] > 0


def test_front_ref_keeps_the_region_filters_survivors(indexes):
    """The plain front half's survivors of an owner are its sorted
    postings (keys pos << 32 | seed * L + i) that pass the region test:
    held on a few owners against a direct count of the marks."""
    idx = indexes[LS]
    m = Mapper(idx, MapperConfig(), "cpu")
    tables = m._dev_f1_tables()
    rng = np.random.default_rng(5)
    L, rb, ro = 40, 6, 20
    codes = _reads(idx, LS, L, 24, rng, [0, 64, 128, 50_000]).reshape(
        48, L)
    keys, base, count = filter1_front.front(
        codes, tables, torch.device("cpu"), 0, m.cutoff, rb, ro, True)
    cap = filter1_front.capacity(filter1_front.n_keys(tables.spans, L, 0))
    for o in range(48):
        post = []
        for s, si in enumerate(idx.seeds):
            for i in range(L - si.seed.span + 1):
                key = sum(int(codes[o, i + off]) << (2 * j)
                          for j, off in enumerate(si.seed.offsets))
                lo, hi = int(si.offsets[key]), int(si.offsets[key + 1])
                if 0 < hi - lo <= m.cutoff:
                    post += [int(p) << 32 | (s * L + i)
                             for p in si.positions[lo:hi]]
        post.sort()
        if count[o] < 0:
            assert len(post) > cap
            continue
        marks = {}
        for k in post:
            x = k >> 32
            marks[x >> rb] = marks.get(x >> rb, 0) + 1
            if x % (1 << rb) < ro and x >> rb > 0:
                marks[(x >> rb) - 1] = marks.get((x >> rb) - 1, 0) + 1
        keep = [k for k in post
                if marks[(k >> 32) >> rb] >= 2
                or ((k >> 32) % (1 << rb) < ro and (k >> 32) >> rb > 0
                    and marks.get(((k >> 32) >> rb) - 1, 0) >= 2)]
        got = keys[base[o]:base[o] + count[o]].tolist()
        assert got == keep, o




@pytest.mark.parametrize("case", ["hashed", "mp_mode", "index_tiers",
                                  "cpu_mapper", "engaged"])
def test_engagement_rule(genome, indexes, monkeypatch, case):
    """FastLS._filter1 takes the device path only on the mapper's own
    index, on a card, with unhashed seeds the kernel takes; hashed seeds,
    the paired streams' mate-pair filter, the tiers that pass `index=`
    and a CPU mapper keep the host path, with `filter1 device owners` at
    0 and every owner counted as a host owner. The card is stood in for
    by the mapper's device name and a spy on the device path."""
    calls = []

    def spy(m, *args, **kw):
        calls.append(1)
        return generate_candidates_native(m.index, *args, **kw)
    monkeypatch.setattr(filter1_front, "generate_candidates_device", spy)
    monkeypatch.setattr(filter1_front, "fits", lambda K, L: True)
    rng = np.random.default_rng(3)
    L, n = 40, 32
    if case == "hashed":
        monkeypatch.setattr(build_mod, "to_hugepages", lambda a: a)
        idx = build_index(genome[1:3], default_seeds(), hashed=True)
    else:
        idx = indexes[LS]
    codes2 = _reads(idx, LS, L, n, rng)
    if case == "mp_mode":
        m = PairedMapper(idx, MapperConfig(pair_mode="opp-in",
                                           half_paired=False), "cpu")
    else:
        m = Mapper(idx, MapperConfig(), "cpu")
    if case != "cpu_mapper":
        m.device = torch.device("cuda")
    if case == "mp_mode":
        fp = fastpath.FastPaired(m)
        ro = m._paired_opts[0].read[0]
        assert ro.anchor_list.use_mp_region_counts
        fh = fp._filter1_paired(codes2, L, 56, ro)
    else:
        fls = fastpath.FastLS(m)
        fh = fls._filter1(codes2, L, 56,
                          index=idx if case == "index_tiers" else None)
    assert fh is not None
    if case == "engaged":
        assert calls and _counts(m) == (0, 0)   # counted by the real path
    else:
        assert not calls and _counts(m) == (0, 2 * n)


@pytest.mark.parametrize("mode", [LS, CS])
def test_streams_through_the_device_route(monkeypatch, mode):
    """The LS and CS unpaired streams with filter 1's front half taken
    (its CPU route) give the host path's SAM bytes."""
    monkeypatch.setattr(build_mod, "to_hugepages", lambda a: a)
    if mode == LS:
        idx, reads = dataset.ecoli_unpaired_ls(96)
        run = fastpath.map_unpaired_sam_stream
    else:
        idx, reads = dataset.ecoli_unpaired_cs(96)
        run = fastpath_cs.map_unpaired_cs_sam_stream
    cfg = MapperConfig(mode=mode)
    want = b"".join(run(Mapper(idx, cfg, "cpu"), reads, batch_size=48,
                        lanes=1))
    monkeypatch.setattr(filter1_front, "engages",
                        lambda m, L=None, min_pos=0, index=None:
                        index is None)
    m = Mapper(idx, cfg, "cpu")
    got = b"".join(run(m, reads, batch_size=48, lanes=1))
    assert got == want and want.count(b"\n") > 48
    assert _counts(m) == (2 * len(reads), 0)


@pytest.mark.parametrize("rc", [0, filter1_front.NO_FIT, 2])
def test_fits_reads_the_cards_answer(indexes, monkeypatch, rc):
    """`fits` takes the launch configuration's answer: 0 sends the call to
    the device path, NO_FIT (a block cannot hold an owner) to the host
    path with every owner counted there, and any other code (a CUDA
    error, here cudaErrorMemoryAllocation) raises instead of quietly
    taking the host path."""
    calls = []

    def spy(m, *args, **kw):
        calls.append(1)
        return generate_candidates_native(m.index, *args, **kw)
    lib = SimpleNamespace(filter1_front_config=lambda K, L, cap, out: rc)
    monkeypatch.setattr(_build, "load", lambda: SimpleNamespace(lib=lib))
    monkeypatch.setattr(filter1_front, "generate_candidates_device", spy)
    monkeypatch.setattr(filter1_front, "fits",
                        filter1_front.fits.__wrapped__)
    idx = indexes[LS]
    m = Mapper(idx, MapperConfig(), "cpu")
    m.device = torch.device("cuda")
    L, n = 40, 16
    codes2 = _reads(idx, LS, L, n, np.random.default_rng(9))
    fls = fastpath.FastLS(m)
    if rc not in (0, filter1_front.NO_FIT):
        with pytest.raises(RuntimeError, match="filter1_front_config"):
            fls._filter1(codes2, L, 56)
        return
    assert fls._filter1(codes2, L, 56) is not None
    if rc == 0:
        assert calls and _counts(m) == (0, 0)
    else:
        assert not calls and _counts(m) == (0, 2 * n)
