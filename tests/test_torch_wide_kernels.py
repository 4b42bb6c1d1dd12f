"""Numpy models of how the two wide CUDA kernels cut their work, on the
CPU, held at tolerance 0 against the JAX package and the port's plain
versions.

The tiled vector SW (csrc/sw_vector.cu, windows over 256 columns) runs a
window in column tiles, left to right, each over every row of its pair,
and carries only two values of each row across a tile border: c, the E
chain's running max, and H at the tile's last column. `vec_tiles` is that
decomposition at any tile width; tiles wholly at or past glen and rows at
or past rlen are not run. It must equal sw_jax.sw_vector_batch and
core/sw_vector.py's plain version, letter and colour space (g_row0), with
glen inside and on tile borders.

The wide 4-layer DP (csrc/sw_cs_full.cu) computes each row only over the
chunks of 32 columns that meet [lo, hi]: the row's band and the columns
the next row reads (its band and one column to the left of it). Those
columns outside the band hold the row's init values, which in local mode
depend on the row's crossover; every other column of the row buffers is
never read, and its backpointers are 0. The chunks are split among column
groups; the W chain crosses a group border as each group's maximum of the
terms a_j + j*gea, with a group's first column (whose left nw only the
group to its left computes) added when the groups to its right take their
carry. The best cell is the largest value, then the first row, column and
layer. `cs_dp_bands` is that decomposition at any chunk width and group
count, with the columns outside [lo, hi] poisoned after each row. It must
equal core/sw_cs_full.py's plain version (stats and backpointers), and its
traceback sw_cs_jax.sw_full_cs_tpu's packed rows and steps; global and
local, taboo 0 and 4, a quarter of the pairs at dataset.edge_bands.
"""
from functools import lru_cache

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from shrimp_tpu.core import sw_jax
from shrimp_tpu.core.sw_cs_jax import sw_full_cs_tpu
from shrimp_tpu_torch import constants as C
from shrimp_tpu_torch.core import sw_cs_full, sw_vector

from .test_torch_sw_cs import (_DP_ORDER, KW as CS_KW, XOVER, _dp_inputs, _t,
                               _vec_cs_inputs)
from .test_torch_sw_tb import KW as LS_KW

FILL = -(2 ** 28)
NEG_VEC = -(2 ** 30)
NEG_CS = -(2 ** 25)
POISON = 10 ** 9
NN, NNW, WNW, WW, NWN, NWNW, NWW = range(1, 8)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def vec_tiles(g, glen, r, rlen, g0, tw, *, match, mismatch, a_gap_open,
              a_gap_ext, b_gap_open, b_gap_ext):
    """[B] int32 vector-SW scores by column tiles of `tw` columns: a tile
    runs every row of its pairs from (c, H at the last column) of the
    tile to its left, row by row; g0 (row-0 colours) or None."""
    goa, gea = -a_gap_open - a_gap_ext, -a_gap_ext
    gob, geb = -b_gap_open - b_gap_ext, -b_gap_ext
    g = g.astype(np.int64)
    g0 = g if g0 is None else g0.astype(np.int64)
    r = r.astype(np.int64)
    B, G = g.shape
    R = r.shape[1]
    nj, ni = np.minimum(glen, G), np.minimum(rlen, R)
    best = np.zeros(B, np.int64)
    # the tile to the left's c and H at its last column, per row: the pad
    # column's at tile 0
    c_in = np.full((B, R), FILL, np.int64)
    h_in = np.zeros((B, R), np.int64)
    zero = np.zeros((B, 1), np.int64)
    for t0 in range(0, G, tw):
        run = t0 < nj                       # tiles past glen do not run
        j = np.arange(t0, min(t0 + tw, G))
        h = np.zeros((B, len(j)), np.int64)
        f = np.full((B, len(j)), NEG_VEC, np.int64)
        c_out, h_out = np.full_like(c_in, FILL), np.zeros_like(h_in)
        for i in range(R):
            s = np.where((g0 if i == 0 else g)[:, j] == r[:, i:i + 1], match,
                         mismatch)
            hdiag = np.concatenate([h_in[:, i - 1:i] if i else zero,
                                    h[:, :-1]], 1)
            f = np.maximum(h - gob, f - geb)
            h0 = np.maximum(np.maximum(hdiag + s, 0), f)
            c = np.maximum.accumulate(
                np.concatenate([c_in[:, i:i + 1], h0 + j * gea], 1), 1)
            h = np.maximum(h0, c[:, :-1] - (goa - gea) - j * gea)
            c_out[:, i], h_out[:, i] = c[:, -1], h[:, -1]
            keep = (run & (i < ni))[:, None] & (j[None, :] < nj[:, None])
            best = np.maximum(best, np.where(keep, h, 0).max(1))
        c_in, h_in = c_out, h_out
    return best.astype(np.int32)


def _vec_case(cs_mode):
    """24 pairs of G = 300, R = 40: reads copied from their windows, glen
    on and around the borders of 32-, 96- and 256-column tiles."""
    B, G, R = 24, 300, 40
    g, glen, r, rlen, g0 = _vec_cs_inputs(301 + cs_mode, B, G, R)
    glen[:14] = (1, 31, 32, 33, 95, 96, 97, 192, 255, 256, 257, 288, 299,
                 G)
    rlen[14:18] = (1, R - 1, R, 17)
    kw = (dict(CS_KW, mismatch=CS_KW["match"] + XOVER) if cs_mode
          else LS_KW)
    return g, glen, r, rlen, (g0 if cs_mode else None), kw


@lru_cache(maxsize=None)
def _vec_want(cs_mode):
    g, glen, r, rlen, g0, kw = _vec_case(cs_mode)
    xla = np.asarray(sw_jax.sw_vector_batch(g, glen, r, rlen, g0,
                                            cs_mode=cs_mode, **kw))
    plain = sw_vector.sw_vector_batch(
        *_t(*(x for x in (g, glen, r, rlen, g0) if x is not None)),
        cs_mode=cs_mode, **kw).numpy()
    return xla, plain


@pytest.mark.parametrize("cs_mode", [False, True], ids=["ls", "cs"])
@pytest.mark.parametrize("tw", [32, 96, 256])
def test_vector_column_tiles_match_jax_and_plain(tw, cs_mode):
    """The tiled kernel's decomposition at tile widths 32, 96 and 256 (the
    kernel's: 32 lanes x 8 columns) equals sw_jax.sw_vector_batch and the
    port's plain version."""
    g, glen, r, rlen, g0, kw = _vec_case(cs_mode)
    xla, plain = _vec_want(cs_mode)
    got = vec_tiles(g, glen, r, rlen, g0, tw, **kw)
    assert np.array_equal(got, xla)
    assert np.array_equal(got, plain)
    assert got.max() >= 200


def _band(i, ax, ay, alen, awid, gl):
    """anchor_get_x_range for row i, clipped to [0, glen - 1]."""
    lo = np.where(i < ay, 0, np.where(i <= ay + alen - 1, ax + (i - ay),
                                      ax + alen))
    ay2 = ay - (awid - 1)
    hi = np.where(i < ay2, ax + awid - 2,
                  np.where(i <= ay2 + alen - 1, ax + (awid - 1) + (i - ay2),
                           gl - 1))
    return (int(np.minimum(np.maximum(lo, 0), gl - 1)),
            int(np.minimum(np.maximum(hi, 0), gl - 1)))


def _scan(cands):
    """The strict-> scan over (value [n], code) candidates in order."""
    vals = np.stack([v for v, _ in cands])
    pick = vals.argmax(0)
    return vals.max(0), np.array([c for _, c in cands])[pick]


def cs_dp_bands(a, *, chunk, groups, next_row=True, match, mismatch,
                a_gap_open, a_gap_ext, b_gap_open, b_gap_ext,
                local_alignment=False, indel_taboo_len=0):
    """(best, bi, bj, bk, bfrm [B] int32, bp [B, R, 4, G] int16) of the
    4-layer DP as the wide kernel cuts it, pair by pair: each row over
    the chunks of `chunk` columns that meet [lo, hi] (without the next
    row's columns when `next_row` is False), split among `groups` column
    groups, the row buffers outside [lo, hi] poisoned."""
    goa, gea, gob, geb = -a_gap_open, -a_gap_ext, -b_gap_open, -b_gap_ext
    local, taboo = bool(local_alignment), int(indel_taboo_len)
    geno = a["genome"].astype(np.int64)
    B, G = geno.shape
    R = a["qr"].shape[2]
    stats = np.zeros((5, B), np.int64)
    bp = np.zeros((B, R, 4, G), np.int64)
    for b in range(B):
        gl, rl, rv = int(a["glen"][b]), int(a["rlen"][b]), a["revcmpl"][b]
        geo = [int(a[k][b]) for k in ("ax", "ay", "alen", "awid")]
        q = a["qr"][b].astype(np.int64)
        # row -1: layer 0 at 0, layers 1..3 at the global crossover
        off = np.repeat(np.array([[0], [1], [1], [1]]) * int(a["gx"][b]),
                        G + 1, 1)
        prev = np.stack([off, off - gob, off - goa])      # [3, 4, G + 1]
        best = (0, -1, 0, 0, 0)                    # value, i, j, k, frm
        for i in range(R):
            x_min, x_max = _band(i, *geo, gl)
            n_min, n_max = _band(i + 1, *geo, gl) if next_row else (
                x_min, x_max)
            lo, hi = max(min(x_min, n_min - 1), 0), min(max(x_max, n_max),
                                                        G - 1)
            xc = int(a["xover"][b, i])
            no_taboo = taboo == 0 or i < rl - taboo
            rec = i < rl if local else i == rl - 1
            init_nw = [0, xc, xc, xc] if local else [NEG_CS] * 4
            cur = np.full_like(prev, POISON)
            cur[:, :, 0] = np.array([[v, v - gob if local else NEG_CS,
                                      v - goa if local else NEG_CS]
                                     for v in init_nw]).T
            if hi < lo:
                prev = cur
                continue
            c_lo, nc = lo // chunk, hi // chunk - lo // chunk + 1
            j = np.arange(c_lo * chunk, min((c_lo + nc) * chunk, G))
            inb = (j >= x_min) & (j <= x_max)
            d, u = prev[:, :, j], prev[:, :, j + 1]
            gch = geno[b, j]
            for k in range(4):
                inw, inn = init_nw[k], (init_nw[k] - gob if local
                                        else NEG_CS)
                inw_w = init_nw[k] - goa if local else NEG_CS
                order = [k] + [ll for ll in range(4) if ll != k]
                nwc, nc_ = [], []
                for ll in order:
                    x = 0 if ll == k else xc
                    mid = d[1, ll] + x if no_taboo else np.full(
                        len(j), 2 * NEG_CS)
                    trio = [(d[0, ll] + x, NWNW << 2 | ll), (mid, NWN << 2 | ll),
                            (d[2, ll] + x, NWW << 2 | ll)]
                    nwc += trio[::-1] if rv else trio
                    op = (u[0, ll] - gob - geb + x if no_taboo
                          else np.full(len(j), 2 * NEG_CS))
                    duo = [(op, NNW << 2 | ll), (u[1, ll] - geb + x,
                                                 NN << 2 | ll)]
                    nc_ += duo[::-1] if rv else duo
                qk = q[k, i]
                sc = np.where((gch == C.BASE_N) | (qk == C.BASE_N), 0,
                              np.where(gch == qk, match, mismatch))
                nw, nw_bk = _scan(nwc)
                nw = nw + sc
                n, n_bk = _scan(nc_)
                if local:
                    nw_bk = np.where(nw <= inw, 0, nw_bk)
                    nw = np.maximum(nw, inw)
                    n_bk = np.where(n <= inw, 0, n_bk)
                    n = np.maximum(n, inw)
                nw, nw_bk = np.where(inb, nw, inw), np.where(inb, nw_bk, 0)
                n, n_bk = np.where(inb, n, inn), np.where(inb, n_bk, 0)

                def term(left_nw, jj):
                    t = (left_nw - goa - gea if no_taboo
                         else np.full_like(jj, 2 * NEG_CS))
                    if local:
                        t = np.maximum(t, inw)
                    t = np.where(jj == x_min, np.maximum(t, inw_w - gea), t)
                    return t + jj * gea
                left = np.concatenate([[inw], nw[:-1]])
                # the groups' chunks, as positions in j; pass 1's terms
                cuts = [c_lo + g_ * nc // groups for g_ in range(groups + 1)]
                sl = [slice((c0 - c_lo) * chunk, min((c1 - c_lo) * chunk,
                                                     len(j)))
                      for c0, c1 in zip(cuts, cuts[1:])]
                first = [c0 == c_lo for c0 in cuts[:-1]]
                tall = np.where(inb, term(left, j), FILL)
                aggs = []
                for s_, f_ in zip(sl, first):
                    t = tall[s_].copy()
                    if not f_ and len(t):
                        t[0] = FILL     # its left nw is the left group's
                    aggs.append(t.max(initial=FILL))
                w_raw = np.empty(len(j), np.int64)
                w_left = np.empty(len(j), np.int64)
                for g_, (s_, f_) in enumerate(zip(sl, first)):
                    if s_.start >= s_.stop:
                        continue
                    carry, c_w = FILL, inw_w
                    if not f_:
                        carry = max(max(aggs[h_], tall[sl[h_].start]
                                        if not first[h_]
                                        and sl[h_].start < sl[h_].stop
                                        else FILL) for h_ in range(g_))
                        js = j[s_.start]
                        c_w = (carry - (js - 1) * gea
                               if x_min <= js - 1 <= x_max else inw_w)
                    cc = np.maximum(carry, np.maximum.accumulate(tall[s_]))
                    w_raw[s_] = np.where(inb[s_], cc - j[s_] * gea, inw_w)
                    w_left[s_] = np.concatenate([[c_w], w_raw[s_][:-1]])
                c_open = (left - goa - gea if no_taboo
                          else np.full(len(j), 2 * NEG_CS))
                c_ext = w_left - gea
                ext = ~(c_open > c_ext) if rv else c_ext > c_open
                w_bk = np.where(ext, WW, WNW) << 2 | k
                w = w_raw
                if local:
                    w_bk = np.where(w_raw <= inw, 0, w_bk)
                    w = np.maximum(w_raw, inw)
                w_bk = np.where(inb, w_bk, 0)
                cur[:, k, j + 1] = np.stack([nw, n, w])
                bp[b, i, k, j] = nw_bk | n_bk << 5 | w_bk << 10
                if rec and inb.any():
                    cm = np.where(inb, np.maximum(np.maximum(nw, n), w),
                                  np.iinfo(np.int64).min)
                    p = int(cm.argmax())
                    cand = (int(cm[p]), i, int(j[p]), k)
                    if cand[0] > best[0] or (cand[0] == best[0]
                                             and cand[1:] < best[1:4]):
                        nwc_, nc2, wc = (max(int(v), NEG_CS)
                                         for v in (nw[p], n[p], w[p]))
                        frm, fs = int(nw_bk[p]), nwc_
                        if wc > fs:
                            frm = int(w_bk[p])
                        fs = max(fs, wc)
                        if nc2 > fs:
                            frm = int(n_bk[p])
                        best = (*cand, frm)
            # the columns no later row reads
            outside = np.ones(G + 1, bool)
            outside[0] = False
            outside[lo + 1:hi + 2] = False
            cur[:, :, outside] = POISON
            prev = cur
        if best[1] >= 0:
            stats[:, b] = best[0], best[1], best[2], best[3], best[4]
    return (*stats.astype(np.int32), bp.astype(np.int16))


def _dp_case():
    """8 pairs of G = 160, R = 40, two at the edge bands."""
    B, G, R = 8, 160, 40
    return _dp_inputs(1414, B, G, R, edge=True)


def _next_row_reads_outside(a) -> int:
    """Rows whose next row reads columns outside their band."""
    R = a["qr"].shape[2]
    n = 0
    for b in range(len(a["glen"])):
        geo = [int(a[k][b]) for k in ("ax", "ay", "alen", "awid")]
        gl = int(a["glen"][b])
        for i in range(R - 1):
            x0, x1 = _band(i, *geo, gl)
            n0, n1 = _band(i + 1, *geo, gl)
            n += max(n0 - 1, 0) < x0 or n1 > x1
    return n


@pytest.mark.parametrize("local,taboo", [(False, 0), (False, 4), (True, 0),
                                         (True, 4)])
@pytest.mark.parametrize("chunk,groups", [(32, 1), (32, 3), (8, 4)])
def test_cs_dp_band_rows_and_groups_match_plain(chunk, groups, local,
                                                taboo):
    """Band-only rows (the next row's columns kept at this row's init
    values, the rest poisoned, backpointers 0 outside the band) and the W
    chain carried across column groups equal the plain 4-layer DP: stats
    and every backpointer."""
    a = _dp_case()
    kw = dict(CS_KW, local_alignment=local, indel_taboo_len=taboo)
    want = sw_cs_full.sw_full_cs_dp_ref(*_t(*(a[k] for k in _DP_ORDER)),
                                        **kw)
    got = cs_dp_bands(a, chunk=chunk, groups=groups, **kw)
    for x, w in zip(got, want):
        assert np.array_equal(x.astype(np.int32), w.numpy().astype(np.int32))
    assert got[0].max() > 0 and _next_row_reads_outside(a) > 0


def test_cs_dp_needs_the_next_rows_columns():
    """A row that writes only its band leaves poisoned some columns that
    the next row reads (in local mode their init values depend on the
    row's crossover, so no earlier row's values would do), and the DP
    changes: the rows must write the next row's columns too."""
    a = _dp_case()
    kw = dict(CS_KW, local_alignment=True, indel_taboo_len=0)
    want = sw_cs_full.sw_full_cs_dp_ref(*_t(*(a[k] for k in _DP_ORDER)),
                                        **kw)
    got = cs_dp_bands(a, chunk=32, groups=1, next_row=False, **kw)
    assert not all(np.array_equal(x.astype(np.int32), w.numpy())
                   for x, w in zip(got, want))


@lru_cache(maxsize=None)
def _xla(local, taboo):
    a = _dp_case()
    args = [a[k] for k in _DP_ORDER] + [a["thresh"]]
    jargs = args[:8] + [args[8] != 0] + args[9:]
    kw = dict(CS_KW, local_alignment=local, indel_taboo_len=taboo)
    return [np.asarray(x) for x in sw_full_cs_tpu(*jargs, **kw)]


@pytest.mark.parametrize("local,taboo", [(False, 0), (True, 4)])
def test_cs_dp_band_rows_match_xla_scan(local, taboo):
    """The decomposition's stats and backpointers, walked by the port's
    plain traceback, give sw_cs_jax.sw_full_cs_tpu's packed rows and step
    strings."""
    a = _dp_case()
    kw = dict(CS_KW, local_alignment=local, indel_taboo_len=taboo)
    st = cs_dp_bands(a, chunk=32, groups=2, **kw)
    packed, steps = sw_cs_full.cs_traceback_ref(
        *_t(a["genome"], a["qr"]), *_t(*st), *_t(a["thresh"]))
    want = _xla(local, taboo)
    assert np.array_equal(packed.numpy(), want[0])
    assert np.array_equal(steps.numpy(), want[1])
    assert (st[0] > 0).sum() >= 2
