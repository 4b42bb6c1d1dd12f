"""The letter-space traceback flow of shrimp_tpu_torch against the JAX
package, on the CPU.

The plain full SW with backpointers (`sw_full.sw_full_bp_ref`) is held
against the Pallas kernel in interpret mode on every backpointer cell
and on score, max_i, max_j and plane; the plain traceback
(`sw_full.traceback_pack_ref`) against `sw_jax._traceback_pack` on the
same backpointers; the port's fused traceback step against
`sw_jax.sw_vec_full_tb_packed` (XLA formulation) at the long-read
launch's G = 352, R = 256. Inputs are numpy arrays from a seed, handed
to both packages. Tolerance 0 everywhere: every output is an integer.
Tests marked `cuda` hold the CUDA kernels against the plain versions
and skip without a card.
"""
import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shrimp_tpu.core import sw_jax
from shrimp_tpu.core.sw_full_pallas import sw_full_batch_pallas
from shrimp_tpu_torch.core import sw as port_sw
from shrimp_tpu_torch.core import sw_full, sw_vector
from shrimp_tpu_torch.core.sw import cat_word_plane
from shrimp_tpu_torch.dataset import bands, edge_bands, long_gaps
from shrimp_tpu_torch.fastpath import _pack_args4, _pack_rtab
from shrimp_tpu_torch.mapper import Mapper

KW = dict(match=10, mismatch=-15, a_gap_open=-33, a_gap_ext=-7,
          b_gap_open=-33, b_gap_ext=-3)
ORDER = ("genome", "glen", "read", "rlen", "ax", "ay", "alen", "awid",
         "revcmpl")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mk(seed, B=1024, G=32, R=16, edge=False):
    """tests/test_full_pallas.py's inputs, plus reads copied from their
    windows (with substitutions and a gap) so that long walks occur.
    `edge` gives the first quarter of the pairs the band geometries of
    dataset.edge_bands (bands clipped to one column at either edge, pad
    rows, awid = 1, a band that jumps at the anchor's end)."""
    rng = np.random.default_rng(seed)
    a = dict(
        genome=rng.integers(0, 5, (B, G)).astype(np.uint8),
        glen=rng.integers(8, G + 1, B).astype(np.int32),
        read=rng.integers(0, 5, (B, R)).astype(np.uint8),
        rlen=rng.integers(6, R + 1, B).astype(np.int32),
        ax=rng.integers(-4, G // 2, B).astype(np.int32),
        ay=rng.integers(-4, R, B).astype(np.int32),
        alen=rng.integers(1, 12, B).astype(np.int32),
        awid=rng.integers(3, 20, B).astype(np.int32),
        revcmpl=rng.integers(0, 2, B).astype(np.int32))
    for k in range(1, B, 2):
        o = int(rng.integers(0, G - R + 1))
        a["read"][k] = a["genome"][k, o:o + R]
        a["read"][k, rng.integers(0, R, 2)] = rng.integers(0, 4, 2)
        if k % 4 == 1 and o + R < G:    # a one-base deletion
            cut = int(rng.integers(2, R - 2))
            a["read"][k, cut:] = a["genome"][k, o + cut + 1:o + R + 1]
        a["ax"][k], a["ay"][k], a["alen"][k] = o, 0, R // 2
        a["glen"][k] = G
    if edge:
        for k, v in edge_bands(rng, B // 4, G, R).items():
            a[k][:B // 4] = v
    return a


def _t(a):
    return [torch.from_numpy(np.ascontiguousarray(a[k])) for k in ORDER]


@pytest.mark.parametrize("G,R", [(32, 16), (64, 24), (352, 256)])
def test_edge_bands_reach_the_special_cases(G, R):
    """dataset.edge_bands gives the bands the banded kernels special-case:
    one-column bands at the last column and at column 0, pad rows, awid =
    1, a band that widens in one step at the anchor's end, glen = 1."""
    e = edge_bands(np.random.default_rng(G), 96, G, R)
    x_min, x_max = bands(e, R)
    one = x_min == x_max
    k = np.arange(96) % 6
    glen = e["glen"][:, None]
    assert (one & (x_min == glen - 1) & (glen > 1))[k == 0].any()
    assert (one & (x_min == 0) & (glen > 1))[k == 1].any()
    assert (e["glen"][k == 2] == 1).all() and (e["awid"][k == 2] == 1).all()
    assert (e["awid"][k == 3] == 1).all()
    jump = np.diff(x_max, axis=1) > 1
    assert jump[k == 4].any(axis=1).all()
    assert (x_max[k == 5] == 0).all()
    assert ((x_min >= 0) & (x_max < G) & (x_min <= x_max)).all()


@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("seed,G,R,edge", [
    pytest.param(seed, G, R, edge,
                 id=("edge-" if edge else "") + f"{seed}-{G}-{R}")
    for edge in (False, True) for seed, G, R in ((1, 32, 16), (2, 32, 16),
                                                 (1, 64, 24), (2, 64, 24))])
def test_sw_full_bp_ref_matches_pallas(local, seed, G, R, edge):
    a = _mk(seed, 1024, G, R, edge)
    want = [np.asarray(x) for x in sw_full_batch_pallas(
        *[a[k] for k in ORDER], local_alignment=local, interpret=True,
        **KW)]
    got = [x.numpy() for x in sw_full.sw_full_bp(*_t(a),
                                                 local_alignment=local, **KW)]
    assert got[4].dtype == np.uint8 and got[4].shape == (1024, R, G)
    for name, g, w in zip(("score", "max_i", "max_j", "plane", "bp"), got,
                          want):
        assert np.array_equal(g, w), name
    assert (got[0] > 0).sum() > 100
    # every from-code of all three planes occurs
    bp = got[4]
    assert set(np.unique(bp & 3)) == {0, 1, 2, 3}
    assert set(np.unique((bp >> 2) & 3)) == {0, 1, 2}
    assert set(np.unique((bp >> 4) & 3)) == {0, 1, 2}


def _with_long_gaps(a, lo, seed):
    """Rows [lo, B) of `a` take the reads and bands of dataset.long_gaps:
    one gap of 33 or more columns each, insertions and deletions."""
    rng = np.random.default_rng(seed)
    R = a["read"].shape[1]
    for k, v in long_gaps(rng, a["genome"][lo:], R).items():
        a[k][lo:] = v
    return a


@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("seed,G,R,case", [
    pytest.param(seed, G, R, case,
                 id=(f"{case}-" if case else "") + f"{seed}-{G}-{R}")
    for seed, G, R, case in ((1, 32, 16, None), (2, 64, 24, None),
                             (3, 32, 16, "edge"), (4, 160, 64, "gaps"))])
def test_traceback_ref_matches_jax(local, seed, G, R, case):
    """Every row, score-0 rows included (their walk starts at (0, 0),
    as the reference's does). `edge` gives a quarter of the pairs the
    band geometries of dataset.edge_bands; `gaps` gives half of them one
    gap longer than 32 columns (the CUDA walk's tiles are 32 rows high),
    so that walks run long straight stretches of W or N moves."""
    B = 256 if case == "gaps" else 1024
    a = _mk(seed, B, G, R, edge=case == "edge")
    if case == "gaps":
        _with_long_gaps(a, B // 2, seed)
    score, mi, mj, plane, bp = sw_full.sw_full_bp(*_t(a),
                                                  local_alignment=local, **KW)
    want_pk, want_ops = (np.asarray(x) for x in sw_jax._traceback_pack(
        *(jnp.asarray(x) for x in (a["genome"], a["read"], score.numpy(),
                                   mi.numpy(), mj.numpy(), plane.numpy(),
                                   bp.numpy()))))
    got_pk, got_ops = sw_full.traceback_pack(
        torch.from_numpy(a["genome"]), torch.from_numpy(a["read"]), score,
        mi, mj, plane, bp)
    assert got_pk.dtype == torch.int32 and got_ops.dtype == torch.uint8
    assert got_ops.shape == (B, (R + G + 3) // 4)
    assert np.array_equal(got_pk.numpy(), want_pk)
    assert np.array_equal(got_ops.numpy(), want_ops)
    pk = want_pk
    assert (pk[:, 3] > R // 2).sum() > 50           # long walks
    assert (pk[:, 8] + pk[:, 9] > 0).sum() > 10     # walks with gaps
    if not local:   # a local DP clamps (0, 0) to no backpointer
        assert ((pk[:, 0] == 0) & (pk[:, 3] > 0)).sum() > 0   # score-0 walks
    if case == "gaps" and not local:    # a local alignment skips the gap
        assert (pk[:, 8] > 32).sum() > 5 and (pk[:, 9] > 32).sum() > 5


def _long_plane_case(seed, G, L, B, k, n_reads=256):
    """A synthetic plane and packed args with windows at both ends of
    both strands and reads planted along the band's diagonal."""
    rng = np.random.default_rng(seed)
    fp = Mapper._pad_plane(rng.integers(0, 4, 100_000).astype(np.uint8))
    rp = Mapper._pad_plane(rng.integers(0, 4, 100_000).astype(np.uint8))
    n = len(fp)
    starts = rng.integers(-5, n + 5, k)
    starts[:16] = rng.integers(-5, 40, 16)                # plane starts
    starts[16:32] = rng.integers(n - G - 8, n + 5, 16)    # plane ends
    glen = rng.integers(1, G + 1, k)
    ri = rng.integers(0, n_reads, k)
    rc = rng.integers(0, 2, k)
    rc[:32:2] = 1
    rx = rng.integers(-8, G // 2, k)
    ry = rng.integers(-8, L, k)
    rl = rng.integers(1, 40, k)
    rw = rng.integers(1, 30, k)
    rev = rc & rng.integers(0, 2, k)
    R = -(-L // 8) * 8
    rtab = np.full((n_reads, R), 254, np.uint8)
    rtab[:, :L] = rng.integers(0, 4, (n_reads, L))
    for q in range(32, 32 + n_reads):
        r = q - 32
        ri[q], glen[q], rx[q], ry[q], rl[q], rw[q] = r, G, 20, 0, L // 2, 8
        starts[q] = rng.integers(0, 90_000)
        plane = rp if rc[q] else fp
        rtab[r, :L] = plane[starts[q] + 20:starts[q] + 20 + L]
        rtab[r, rng.integers(0, L, 3)] = rng.integers(0, 4, 3)
        if r % 3 == 0:       # a 2-base insertion in the read
            cut = int(rng.integers(30, L - 30))
            rtab[r, cut + 2:L] = rtab[r, cut:L - 2].copy()
    args = _pack_args4(B, k, starts, glen, ri, rc, rx, ry, rl, rw, rev)
    return fp, rp, cat_word_plane(fp, rp), args, _pack_rtab(rtab)


def test_tb_packed_step_matches_jax():
    """The long-read launch shape (G = 352, R = 256) against
    sw_jax.sw_vec_full_tb_packed (XLA DP): vec and score on every row;
    packed rows and ops where the score is positive (the XLA DP's
    backpointers may differ from the Pallas kernel's on cells below
    -2^26, tests/test_full_pallas.py:3-8)."""
    G, L, B = 352, 250, 512
    fp, rp, cat, args, rtab_pk = _long_plane_case(5, G, L, B, 480)
    kw = dict(G=G, L=L, **KW)
    want = [np.asarray(x) for x in sw_jax.sw_vec_full_tb_packed(
        fp, rp, args, rtab_pk, cat, use_pallas=False, **kw)]
    got = [x.numpy() for x in port_sw.sw_vec_full_tb_packed(
        *(torch.from_numpy(x) for x in (fp, rp, args, rtab_pk, cat)), **kw)]
    assert got[0].dtype == np.int16 and got[1].shape == (B, 10)
    assert got[2].shape == (B, (256 + G + 3) // 4)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1][:, 0], want[1][:, 0])
    pos = want[1][:, 0] > 0
    assert pos.sum() > 200
    assert np.array_equal(got[1][pos], want[1][pos])
    assert np.array_equal(got[2][pos], want[2][pos])
    assert (want[1][pos, 3] > 200).sum() > 200          # long walks
    assert (want[1][pos, 8] > 0).sum() > 30             # insertions


def test_long_wrappers_raise_off_cpu_without_kernel():
    a = [t.to("meta") for t in _t(_mk(1, 8, 32, 16))]
    with pytest.raises(ValueError, match="no kernel"):
        sw_full.sw_full_bp(*a, **KW)
    bp = torch.zeros((8, 16, 32), dtype=torch.uint8, device="meta")
    z = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        sw_full.traceback_pack(a[0], a[2], z, z, z, z, bp)


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,G", [(4096, 256, 352), (256, 1000, 1408),
                                   (32, 3000, 4224), (4, 256, 182_272),
                                   (1, 3000, 4224), (47, 1000, 1408),
                                   (2, 4000, 5632)])
def test_cuda_long_kernels_match_plain(B, R, G):
    """sw_vector, sw_full_bp and the traceback on the card against their
    plain versions (tolerance 0) at the long-read launch shapes (250,
    1000 and 3000 bp: past the packed flow's 4,095 columns), at one and
    47 pairs (the tiled vector SW spreads a pair over several warps), at a
    width past the full SW's and the traceback's shared-memory fit, and
    at a length past the vector SW's (its edge buffers grow with R: 8
    warps x 4,000 rows), where their device-memory paths run; with edge
    bands and, in the last eighth of the pairs, gaps longer than 32
    columns."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from shrimp_tpu_torch import _build
    dev = torch.device("cuda", 0)
    with torch.cuda.device(dev):
        for k in ("sw_vector", "sw_full_bp", "ls_traceback"):
            past = ((B, R, G) == (2, 4000, 5632) if k == "sw_vector"
                    else G > 100_000)
            assert (_build.scratch(k, B, G, R, dev) is not None) == past, k
    a = _with_long_gaps(_mk(G + R, B, G, R, edge=True),
                        B - max(1, B // 8), G)
    t = [x.to(dev) for x in _t(a)]
    assert torch.equal(sw_vector.sw_vector_batch(*t[:4], **KW),
                       sw_vector.sw_vector_batch_ref(*t[:4], **KW))
    for local in (False, True):
        got = sw_full.sw_full_bp(*t, local_alignment=local, **KW)
        want = sw_full.sw_full_bp_ref(*t, local_alignment=local, **KW)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        tb = (t[0], t[2], *want)
        for g, w in zip(sw_full.traceback_pack(*tb),
                        sw_full.traceback_pack_ref(*tb)):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("G,off", [(360, 0), (352, 1)])
def test_cuda_traceback_refuses_unaligned(G, off):
    """The traceback kernel loads its tiles of backpointers in 16-byte
    pieces: a G that is not a multiple of 16, or backpointers off a
    16-byte boundary, raise instead of launching."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    B, R = 8, 64
    buf = torch.zeros(B * R * G + 16, dtype=torch.uint8, device=dev)
    bp = buf[off:off + B * R * G].view(B, R, G)
    z = torch.zeros(B, dtype=torch.int32, device=dev)
    g = torch.zeros((B, G), dtype=torch.uint8, device=dev)
    r = torch.zeros((B, R), dtype=torch.uint8, device=dev)
    with pytest.raises(NotImplementedError, match="16-byte"):
        sw_full.traceback_pack(g, r, z, z, z, z, bp)


@pytest.mark.cuda
def test_cuda_sw_full_bp_byte_rows():
    """sw_full_bp at G = 360, whose backpointer rows leave in byte stores
    (G not a multiple of 16), against its plain version (tolerance 0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    t = [x.to(dev) for x in _t(_mk(7, 256, 360, 256, edge=True))]
    for local in (False, True):
        got = sw_full.sw_full_bp(*t, local_alignment=local, **KW)
        want = sw_full.sw_full_bp_ref(*t, local_alignment=local, **KW)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
