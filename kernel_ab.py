#!/usr/bin/env python3
"""A/B timing of six of shrimp_tpu_torch's CUDA kernels against other
builds of the same entry points, on one NVIDIA GPU: the vector SW
(csrc/sw_vector.cu, its narrow kernel in letter and colour space and its
tiled kernel for windows over 256 columns), the full-SW stats kernel
(csrc/sw_full.cu), the full SW with backpointers (csrc/sw_full_bp.cu),
the long-read traceback (csrc/ls_traceback.cu), the colour-space
traceback (csrc/cs_traceback.cu) and the 4-layer colour-space DP's wide
kernel (csrc/sw_cs_full.cu, windows over 256 columns).

Run from the repository root:

    python3 kernel_ab.py [--src NAME=DIR ...] [--scaling] [--kernels K ...]

It builds, with nvcc for sm_90a (shrimp_tpu_torch._build.build: one
process per library, all started together), the package's six
sources ("new") and those of each --src DIR (a directory holding the
six sources and the headers they include: a parent commit's
`shrimp_tpu_torch/csrc` unpacked with `git archive`, or an edited copy
of the package's, under a gitignored directory such as `build/`). On
seeded inputs from chip_smoke.py's generators (edge bands, pad rows,
revcmpl rows, long gaps, colour-space pairs with BASE_N cells and the
4-layer DP's own backpointers) at the main paths' shapes and the extra
ones, every build's output must equal the plain PyTorch version bit for
bit, global and local; then the builds are timed in turns (A B ... B A),
global mode, by their device time per launch (chip_smoke._device_ms:
calls queued behind a sleep kernel) and by CUDA events over calls made
back to back: the vector SW in letter space at (B, R, G) = (8192, 40,
64 / 128 / 256) and in colour space at (2048, 36, 64), the colour-space
traceback at (2048, 36, 64) and (8192, 36, 128). The
long-read traceback is also timed on the long-read flow's own first
launch (8192 reads of dataset.ecoli_unpaired_ls_long, recorded where the
flow calls the wrapper). The `wide` group times the two wide kernels at
the long-read launches: the vector SW in letter space at (B, R, G) =
(1024, 3000, 4224) (the 3,000 bp slice's vec-only launch), (32, 3000,
4224) and (4096, 256, 352), in colour space at (1024, 256, 352), (47,
1000, 1408) (the 1,000-colour generic mapper's launch) and (64, 1000,
1408), and the 4-layer DP at those three colour-space shapes, global and
local. --scaling adds the time of 1, 132 and 1056 pairs (one pair is the
latency floor; the wide group at (R, G) = (3000, 4224) for the vector SW
and (256, 352) for the DP). --kernels picks the groups to run (vector,
stats, long, flow, cs_traceback, wide; all by default). Prints
one line per kernel, shape and build, each build's launch
configurations, the card's name and power limit, and a JSON line of
every time.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("sw_vector.cu", "sw_full.cu", "sw_full_bp.cu",
           "ls_traceback.cu", "cs_traceback.cu", "sw_cs_full.cu")
# (B, R, G, colour space) of the vector SW
VEC_SHAPES = ((8192, 40, 64, False), (8192, 40, 128, False),
              (8192, 40, 256, False), (2048, 36, 64, True))
CS_TB_SHAPES = ((2048, 36, 64), (8192, 36, 128))
STATS_SHAPES = ((8192, 40, 64), (8192, 40, 128), (8192, 40, 256))
LONG_SHAPES = ((4096, 256, 352), (256, 1000, 1408))
# (B, R, G) of the wide group: the vector SW in letter space; the vector
# SW in colour space and the 4-layer DP
WIDE_LS_SHAPES = ((1024, 3000, 4224), (32, 3000, 4224), (4096, 256, 352))
WIDE_CS_SHAPES = ((1024, 256, 352), (47, 1000, 1408), (64, 1000, 1408))
# pairs per launch of --scaling, below the main shapes' B
SCALING_N = (1, 132, 1056)


def _stream():
    return torch.cuda.current_stream().cuda_stream


# The launches below pass no device-memory scratch (the last argument,
# None) but the wide group's, which asks each build for its size: the
# other shapes this script times fit shared memory.


def _scratch(lib, kernel, B, G, R, dev):
    """A build's device-memory scratch for a launch, or None."""
    out = ctypes.c_longlong(0)
    rc = getattr(lib, f"{kernel}_scratch")(B, G, R, ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"{kernel}_scratch: cudaError {rc}")
    return (None if out.value == 0
            else torch.empty(out.value, dtype=torch.uint8, device=dev))


def _stats_call(lib, full, out, local, kw):
    B, G = full[0].shape
    R = full[2].shape[1]
    rc = lib.sw_full_stats_launch(
        *(x.data_ptr() for x in full), out.data_ptr(), B, G, R,
        kw["match"], kw["mismatch"], -kw["a_gap_open"], -kw["a_gap_ext"],
        -kw["b_gap_open"], -kw["b_gap_ext"], int(local), _stream())
    if rc != 0:
        raise RuntimeError(f"sw_full_stats_launch: cudaError {rc}")


def _bp_call(lib, full, st, bp, local, kw):
    B, G = full[0].shape
    R = full[2].shape[1]
    rc = lib.sw_full_bp_launch(
        *(x.data_ptr() for x in full), st.data_ptr(), bp.data_ptr(), B, G,
        R, kw["match"], kw["mismatch"], -kw["a_gap_open"],
        -kw["a_gap_ext"], -kw["b_gap_open"], -kw["b_gap_ext"], int(local),
        _stream(), None)
    if rc != 0:
        raise RuntimeError(f"sw_full_bp_launch: cudaError {rc}")


def _tb_call(lib, tb, packed, ops):
    B, R, G = tb[-1].shape
    rc = lib.ls_traceback_launch(*(x.data_ptr() for x in tb),
                                 packed.data_ptr(), ops.data_ptr(), B, G, R,
                                 _stream(), None)
    if rc != 0:
        raise RuntimeError(f"ls_traceback_launch: cudaError {rc}")


def _vec_call(lib, v, out, kw, scratch=None):
    B, G = v[0].shape
    R = v[2].shape[1]
    rc = lib.sw_vector_launch(
        v[0].data_ptr(), None if len(v) < 5 else v[4].data_ptr(),
        v[1].data_ptr(), v[2].data_ptr(), v[3].data_ptr(), out.data_ptr(),
        B, G, R, kw["match"], kw["mismatch"],
        -kw["a_gap_open"] - kw["a_gap_ext"], -kw["a_gap_ext"],
        -kw["b_gap_open"] - kw["b_gap_ext"], -kw["b_gap_ext"], _stream(),
        None if scratch is None else scratch.data_ptr())
    if rc != 0:
        raise RuntimeError(f"sw_vector_launch: cudaError {rc}")


def _dp_call(lib, dp, st, bp, kw, scratch):
    """The 4-layer DP on the inputs of chip_smoke._DP_ORDER."""
    g, glen, qr, rlen, ax, ay, alen, awid, rev, xover, gx = dp
    B, G = g.shape
    R = qr.shape[2]
    rc = lib.sw_cs_full_launch(
        g.data_ptr(), qr.data_ptr(), xover.data_ptr(), gx.data_ptr(),
        glen.data_ptr(), rlen.data_ptr(), ax.data_ptr(), ay.data_ptr(),
        alen.data_ptr(), awid.data_ptr(), rev.data_ptr(), bp.data_ptr(),
        st.data_ptr(), B, G, R, kw["match"], kw["mismatch"],
        -kw["a_gap_open"], -kw["a_gap_ext"], -kw["b_gap_open"],
        -kw["b_gap_ext"], int(kw["local_alignment"]),
        int(kw["indel_taboo_len"]), _stream(),
        None if scratch is None else scratch.data_ptr())
    if rc != 0:
        raise RuntimeError(f"sw_cs_full_launch: cudaError {rc}")


def _cs_tb_call(lib, tb, packed, steps):
    B, G = tb[0].shape
    R = tb[1].shape[2]
    rc = lib.cs_traceback_launch(*(x.data_ptr() for x in tb),
                                 packed.data_ptr(), steps.data_ptr(), B, G,
                                 R, _stream())
    if rc != 0:
        raise RuntimeError(f"cs_traceback_launch: cudaError {rc}")


def _turns(libs, fn, reps):
    """{build: [(event ms, device ms), ...]}: each build timed twice, in
    the order A B .. B A, by CUDA events over calls made back to back
    (chip_smoke._time_ms) and over calls queued behind a sleep kernel
    (chip_smoke._device_ms: the host's time per call hidden)."""
    import chip_smoke as cs
    names = list(libs)
    t = {n: [] for n in names}
    for n in names + names[::-1]:
        t[n].append((cs._time_ms(lambda: fn(libs[n]), reps=reps),
                     cs._device_ms(lambda: fn(libs[n]), reps)))
    return t


def _report(kernel, shape, t, rec):
    for n, turns in t.items():
        ev = [x[0] for x in turns]
        dv = [x[1] for x in turns]
        mean, dmean = sum(ev) / len(ev), sum(dv) / len(dv)
        print(f"{kernel} {shape} {n}: device {dmean!r} ms (turns "
              f"{dv[0]!r}, {dv[1]!r}); events {mean!r} ms a call (turns "
              f"{ev[0]!r}, {ev[1]!r})")
        rec.append(dict(kernel=kernel, shape=list(shape), build=n,
                        dev_ms=dmean, dev_turns=dv, ms=mean, turns=ev))


def _full(a, dev):
    t = {k: torch.from_numpy(v).to(dev) for k, v in a.items()}
    return t, tuple(t[k] for k in ("genome", "glen", "read", "rlen", "ax",
                                   "ay", "alen", "awid", "revcmpl"))


def ab_vector(dev, libs, rec, scaling):
    """The vector SW's narrow kernel, letter and colour space."""
    import chip_smoke as cs
    from shrimp_tpu_torch.core import sw_vector
    rng = np.random.default_rng(20261021)
    for B, R, G, cmode in VEC_SHAPES:
        if cmode:
            a = cs._cs_vec_pairs(rng, B, G, R)
            kw = dict(cs.CS_KW, mismatch=cs.CS_KW["match"] + cs.XOVER)
            keys = ("genome", "glen", "read", "rlen", "g_row0")
        else:
            a = cs._pairs(rng, B, G, R)
            kw = cs.KW
            keys = ("genome", "glen", "read", "rlen")
        v = tuple(torch.from_numpy(a[k]).to(dev) for k in keys)
        want = sw_vector.sw_vector_batch_ref(*v, cs_mode=cmode, **kw)
        out = torch.empty(B, dtype=torch.int32, device=dev)
        for n, lib in libs.items():
            out.fill_(-7)
            _vec_call(lib, v, out, kw)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"sw_vector {n} {(B, R, G)} cs={cmode}:"
                                     f" {int((out != want).sum())} differ")
        name = "sw_vector_cs" if cmode else "sw_vector"
        print(f"{name} {(B, R, G)}: every build equals the plain version")
        _report(name, (B, R, G), _turns(
            libs, lambda lib: _vec_call(lib, v, out, kw), 20), rec)
        if scaling and G == 64:
            # n pairs past the pad rows: one pair's rows are the latency
            # floor; the full launch adds the throughput
            for n in SCALING_N:
                sub = tuple(x[256:256 + n] for x in v)
                _report(f"{name}[{n} pairs]", (n, R, G), _turns(
                    libs, lambda lib: _vec_call(lib, sub, out, kw), 20),
                    rec)


def ab_cs_traceback(dev, libs, rec, scaling):
    """The colour-space traceback on the 4-layer DP's own backpointers."""
    import chip_smoke as cs
    from shrimp_tpu_torch.core import sw_cs_full
    rng = np.random.default_rng(20261022)
    for B, R, G in CS_TB_SHAPES:
        an = cs._cs_dp_pairs(rng, B, G, R)
        a = {k: torch.from_numpy(x).to(dev) for k, x in an.items()}
        dp = tuple(a[k] for k in cs._DP_ORDER)
        tb = (a["genome"], a["qr"], *sw_cs_full.sw_full_cs_dp(*dp, **cs.CS_KW),
              a["thresh"])
        want = sw_cs_full.cs_traceback_ref(*tb)
        packed = torch.empty((B, 12), dtype=torch.int16, device=dev)
        steps = torch.empty((B, R + G), dtype=torch.int8, device=dev)
        for n, lib in libs.items():
            packed.fill_(-7)
            steps.fill_(99)
            _cs_tb_call(lib, tb, packed, steps)
            torch.cuda.synchronize()
            if not (torch.equal(packed, want[0])
                    and torch.equal(steps, want[1])):
                raise AssertionError(f"cs_traceback {n} {(B, R, G)}: "
                                     f"differs")
        nops = want[0][:, 4].to(torch.int32)
        print(f"cs_traceback {(B, R, G)}: every build equals the plain "
              f"version; walks: {cs._walks(nops[nops > 0])}")
        _report("cs_traceback", (B, R, G), _turns(
            libs, lambda lib: _cs_tb_call(lib, tb, packed, steps), 20), rec)
        if scaling and (B, R, G) == CS_TB_SHAPES[0]:
            order = torch.argsort(nops, descending=True)
            for n in SCALING_N:
                sub = tuple(x.index_select(0, order[:n]).contiguous()
                            for x in tb)
                _report(f"cs_traceback[{n} longest walks]", (n, R, G),
                        _turns(libs, lambda lib: _cs_tb_call(
                            lib, sub, packed, steps), 20), rec)
        del tb, want, dp, a
        torch.cuda.empty_cache()


def ab_stats(dev, libs, rec, scaling):
    import chip_smoke as cs
    from shrimp_tpu_torch.core import sw_full
    rng = np.random.default_rng(20261019)
    for B, R, G in STATS_SHAPES:
        a = cs._pairs(rng, B, G, R)
        cs._with_edge_bands(a, rng, 256, B // 16, G, R)
        _, full = _full(a, dev)
        out = torch.empty((B, 8), dtype=torch.int32, device=dev)
        for local in (False, True):
            want = sw_full.sw_full_stats_ref(*full, local_alignment=local,
                                             **cs.KW)
            for n, lib in libs.items():
                out.fill_(-7)
                _stats_call(lib, full, out, local, cs.KW)
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    bad = int((out != want).any(1).sum())
                    raise AssertionError(f"sw_full_stats {n} {(B, R, G)} "
                                         f"local={local}: {bad} rows differ")
        print(f"sw_full_stats {(B, R, G)}: every build equals the plain "
              f"version, global and local")
        _report("sw_full_stats", (B, R, G), _turns(
            libs, lambda lib: _stats_call(lib, full, out, False, cs.KW),
            20), rec)
        if scaling and G == 64:
            # n pairs past the pad rows: the time of one pair's rows is
            # the latency floor; the full launch adds the throughput
            for n in SCALING_N:
                sub = tuple(x[256:256 + n] for x in full)
                _report(f"sw_full_stats[{n} pairs]", (n, R, G), _turns(
                    libs, lambda lib: _stats_call(lib, sub, out, False,
                                                  cs.KW), 20), rec)


def ab_long(dev, libs, rec, scaling):
    """sw_full_bp and the traceback at the long-read shapes."""
    import chip_smoke as cs
    from shrimp_tpu_torch.core import sw_full
    rng = np.random.default_rng(20261020)
    for B, R, G in LONG_SHAPES:
        a = cs._long_pairs(rng, B, G, R)
        cs._with_long_gaps(a, rng, B // 2, B // 8)
        t, full = _full(a, dev)
        W = (R + G + 3) // 4
        st = torch.empty((4, B), dtype=torch.int32, device=dev)
        bp = torch.empty((B, R, G), dtype=torch.uint8, device=dev)
        packed = torch.empty((B, 10), dtype=torch.int32, device=dev)
        ops = torch.empty((B, W), dtype=torch.uint8, device=dev)
        for local in (True, False):     # global last: it is timed
            want = sw_full.sw_full_bp_ref(*full, local_alignment=local,
                                          **cs.KW)
            for n, lib in libs.items():
                st.fill_(-7)
                bp.fill_(0xEE)
                _bp_call(lib, full, st, bp, local, cs.KW)
                torch.cuda.synchronize()
                if not (torch.equal(st, torch.stack(want[:4]))
                        and torch.equal(bp, want[4])):
                    raise AssertionError(f"sw_full_bp {n} {(B, R, G)} "
                                         f"local={local}: differs")
            tb = (t["genome"], t["read"], *want)
            want_tb = sw_full.traceback_pack_ref(*tb)
            for n, lib in libs.items():
                packed.fill_(-7)
                ops.fill_(0xEE)
                _tb_call(lib, tb, packed, ops)
                torch.cuda.synchronize()
                if not (torch.equal(packed, want_tb[0])
                        and torch.equal(ops, want_tb[1])):
                    raise AssertionError(f"ls_traceback {n} {(B, R, G)} "
                                         f"local={local}: differs")
            del want
        pk = want_tb[0]
        print(f"sw_full_bp and ls_traceback {(B, R, G)}: every build equals "
              f"the plain version, global and local; global walks: "
              f"{cs._walks(pk[:, 3])}, most insertions "
              f"{int(pk[:, 8].max())}, most deletions {int(pk[:, 9].max())}")
        _report("sw_full_bp", (B, R, G), _turns(
            libs, lambda lib: _bp_call(lib, full, st, bp, False, cs.KW),
            10), rec)
        _report("ls_traceback", (B, R, G), _turns(
            libs, lambda lib: _tb_call(lib, tb, packed, ops), 10), rec)
        if scaling and (B, R, G) == LONG_SHAPES[0]:
            # the n pairs with the longest walks: one walk is the latency
            # floor; the full launch adds the throughput
            order = torch.argsort(pk[:, 3], descending=True)
            for n in SCALING_N:
                sub = tuple(x.index_select(0, order[:n]).contiguous()
                            for x in tb)
                _report(f"ls_traceback[{n} longest walks]", (n, R, G),
                        _turns(libs, lambda lib: _tb_call(
                            lib, sub, packed, ops), 10), rec)
                del sub
        del tb, want_tb, t, full, st, bp
        torch.cuda.empty_cache()


def ab_flow_traceback(dev, libs, rec):
    """The traceback on the long-read flow's own first launch."""
    import chip_smoke as cs
    from shrimp_tpu_torch.core import sw, sw_full
    from shrimp_tpu_torch.dataset import ecoli_unpaired_ls_long
    idx, reads = ecoli_unpaired_ls_long(cs.B_CHUNK)
    tb = cs._first_call(cs._mapper(idx, dev), reads, cs._ls_stream, sw,
                        "traceback_pack")
    B, R, G = tb[-1].shape
    want = sw_full.traceback_pack_ref(*tb)
    packed = torch.empty((B, 10), dtype=torch.int32, device=dev)
    ops = torch.empty_like(want[1])
    for n, lib in libs.items():
        packed.fill_(-7)
        ops.fill_(0xEE)
        _tb_call(lib, tb, packed, ops)
        torch.cuda.synchronize()
        if not (torch.equal(packed, want[0]) and torch.equal(ops, want[1])):
            raise AssertionError(f"ls_traceback {n} on the flow's launch: "
                                 f"differs")
    print(f"ls_traceback on the flow's first launch {(B, R, G)}: every "
          f"build equals the plain version; walks: "
          f"{cs._walks(want[0][:, 3])}")
    _report("ls_traceback[flow]", (B, R, G), _turns(
        libs, lambda lib: _tb_call(lib, tb, packed, ops), 10), rec)


def _wide_vec(dev, libs, rec, name, v, kw, cmode, shape):
    """Checks every build's tiled vector SW on `v` against the plain
    version, then times them."""
    from shrimp_tpu_torch.core import sw_vector
    B, R, G = shape
    want = sw_vector.sw_vector_batch_ref(*v, cs_mode=cmode, **kw)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    # each build's scratch, by the identity of its library
    scr = {id(lib): _scratch(lib, "sw_vector", B, G, R, dev)
           for lib in libs.values()}
    for n, lib in libs.items():
        out.fill_(-7)
        _vec_call(lib, v, out, kw, scr[id(lib)])
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"{name} {n} {shape}: "
                                 f"{int((out != want).sum())} differ")
    print(f"{name} {shape}: every build equals the plain version")
    _report(name, shape, _turns(
        libs, lambda lib: _vec_call(lib, v, out, kw, scr[id(lib)]), 5), rec)


def ab_wide(dev, libs, rec, scaling):
    """The tiled vector SW (letter and colour space) and the 4-layer DP's
    wide kernel at the long-read launches, global and local."""
    import chip_smoke as cs
    from shrimp_tpu_torch.core import sw_cs_full
    rng = np.random.default_rng(20261023)
    keys = ("genome", "glen", "read", "rlen")
    ls_shapes = list(WIDE_LS_SHAPES)
    if scaling:
        ls_shapes += [(n, 3000, 4224) for n in SCALING_N]
    for B, R, G in ls_shapes:
        a = cs._long_pairs(rng, B, G, R, pads=max(1, B // 16))
        cs._with_long_gaps(a, rng, B // 2, max(1, B // 8))
        v = tuple(torch.from_numpy(a[k]).to(dev) for k in keys)
        _wide_vec(dev, libs, rec, "sw_vector_wide", v, cs.KW, False,
                  (B, R, G))
        del v, a
    vkw = dict(cs.CS_KW, mismatch=cs.CS_KW["match"] + cs.XOVER)
    dp_shapes = list(WIDE_CS_SHAPES)
    if scaling:
        dp_shapes += [(n, 256, 352) for n in SCALING_N]
    for B, R, G in dp_shapes:
        pads = max(1, B // 16)
        if (B, R, G) in WIDE_CS_SHAPES:
            vn = cs._cs_vec_pairs(rng, B, G, R, pads=pads)
            v = tuple(torch.from_numpy(vn[k]).to(dev)
                      for k in keys + ("g_row0",))
            _wide_vec(dev, libs, rec, "sw_vector_cs_wide", v, vkw, True,
                      (B, R, G))
            del v, vn
        an = cs._cs_dp_pairs(rng, B, G, R, pads=pads)
        cs._with_cs_long_gaps(an, rng, B // 2, max(1, B // 8))
        dp = tuple(torch.from_numpy(an[k]).to(dev) for k in cs._DP_ORDER)
        st = torch.empty((5, B), dtype=torch.int32, device=dev)
        bp = torch.empty((B, R, 4, G), dtype=torch.int16, device=dev)
        scr = {id(lib): _scratch(lib, "sw_cs_full", B, G, R, dev)
               for lib in libs.values()}
        for local, taboo in ((True, 4), (False, 0)):   # global last
            kw = dict(cs.CS_KW, local_alignment=local,
                      indel_taboo_len=taboo)
            want = sw_cs_full.sw_full_cs_dp_ref(*dp, **kw)
            for n, lib in libs.items():
                st.fill_(-7)
                bp.fill_(0x3EE)
                _dp_call(lib, dp, st, bp, kw, scr[id(lib)])
                torch.cuda.synchronize()
                if not (torch.equal(st, torch.stack(want[:5]))
                        and torch.equal(bp, want[5])):
                    raise AssertionError(f"sw_cs_full_wide {n} {(B, R, G)} "
                                         f"local={local}: differs")
            del want
            print(f"sw_cs_full_wide {(B, R, G)} local={local} taboo={taboo}:"
                  f" every build equals the plain version")
            _report(f"sw_cs_full_wide[{'local' if local else 'global'}]",
                    (B, R, G), _turns(libs, lambda lib: _dp_call(
                        lib, dp, st, bp, kw, scr[id(lib)]), 3),
                    rec)
        del dp, st, bp, scr, an
        torch.cuda.empty_cache()


GROUPS = ["vector", "cs_traceback", "stats", "long", "flow", "wide"]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", action="append", default=[],
                    help="NAME=DIR: the six sources in DIR as one more "
                         "build")
    ap.add_argument("--scaling", action="store_true",
                    help="also time every build on the first pairs of the "
                         "main shapes (sw_vector, sw_full_stats), on the "
                         "pairs with the longest walks (ls_traceback, "
                         "cs_traceback) and on launches of that many "
                         "wide pairs: 1, 132, 1056")
    ap.add_argument("--kernels", nargs="+", choices=GROUPS, default=GROUPS,
                    help="the groups to run (all by default)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from shrimp_tpu_torch import _build
    dev = torch.device("cuda", 0)
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{cs._smi()}")
    specs = [("new", _build.SRC_DIR)]
    specs += [tuple(v.split("=", 1)) for v in args.src]
    out = os.path.join(os.path.dirname(_build.BUILD_DIR), "kernel_ab")
    libs = {}
    for name, src_dir in specs:
        built = _build.build(os.path.abspath(src_dir),
                             os.path.join(out, name), SOURCES)
        libs[name] = built.lib
        for ln in built.log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  {name}: {ln.strip()}")
    for n, lib in libs.items():
        for group, entry, shapes in (
                ("vector", "sw_vector_config", [s[:3] for s in VEC_SHAPES]),
                ("cs_traceback", "cs_traceback_config", CS_TB_SHAPES),
                ("stats", "sw_full_stats_config", STATS_SHAPES),
                ("long", "sw_full_bp_config", LONG_SHAPES),
                ("long", "ls_traceback_config", LONG_SHAPES),
                ("wide", "sw_vector_config", WIDE_LS_SHAPES + WIDE_CS_SHAPES),
                ("wide", "sw_cs_full_config", WIDE_CS_SHAPES)):
            if group not in args.kernels or not hasattr(lib, entry):
                continue
            for B, R, G in shapes:
                c = (ctypes.c_int * len(_build.CONFIG_KEYS))()
                _build.check(getattr(lib, entry)(B, G, R, ctypes.addressof(c)),
                             entry)
                print(f"{n} {entry} {(B, R, G)}: "
                      f"{dict(zip(_build.CONFIG_KEYS, c))}")
    rec = []
    for g in GROUPS:
        if g in args.kernels:
            if g == "flow":
                ab_flow_traceback(dev, libs, rec)
            else:
                globals()[f"ab_{g}"](dev, libs, rec, args.scaling)
    print(cs._smi())
    print(json.dumps({"ab": rec}))


if __name__ == "__main__":
    main()
