"""shrimp_tpu_torch's device step against the JAX package, on the CPU.

The plain PyTorch versions of both kernels are held against the Pallas
kernels in interpret mode and against the XLA formulations; the packed
fused step against sw_jax.sw_vec_full_stats_packed; the port's genome
planes against the reference Mapper's. Inputs are numpy arrays from a
seed, handed to both packages. Tolerance 0 everywhere: every output is
an integer. Tests marked `cuda` hold the CUDA kernels against the plain
versions and skip without a card.
"""
import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from shrimp_tpu.core import sw_jax
from shrimp_tpu.core.sw_full_pallas import sw_full_stats_pallas
from shrimp_tpu.core.sw_pallas import sw_vector_batch_pallas
from shrimp_tpu.core.encode import encode_ls
from shrimp_tpu.fastpath import _pack_args4 as ref_pack_args4
from shrimp_tpu.index.build import build_index
from shrimp_tpu.index.seeds import default_seeds
from shrimp_tpu.mapper import Mapper as RefMapper
from shrimp_tpu_torch.core import sw as port_sw
from shrimp_tpu_torch.core import sw_full, sw_vector
from shrimp_tpu_torch.dataset import bands, edge_bands, length_edges
from shrimp_tpu_torch.device import get_device
from shrimp_tpu_torch.fastpath import _pack_args4, _pack_rtab
from shrimp_tpu_torch.index import build as port_index
from shrimp_tpu_torch.index import seeds as port_seeds
from shrimp_tpu_torch.mapper import Mapper

KW = dict(match=10, mismatch=-15, a_gap_open=-33, a_gap_ext=-7,
          b_gap_open=-33, b_gap_ext=-3)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _vec_inputs(seed, B, G, R):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 5, (B, G)).astype(np.uint8)
    r = rng.integers(0, 5, (B, R)).astype(np.uint8)
    # half the reads copy their window (two substitutions) so the
    # scores span real alignments, not only noise
    for k in range(1, B, 2):
        o = int(rng.integers(0, max(1, G - R)))
        n = min(R, G - o)
        r[k, :n] = g[k, o:o + n]
        r[k, rng.integers(0, R, 2)] = rng.integers(0, 4, 2)
    glen = rng.integers(1, G + 1, B).astype(np.int32)
    rlen = rng.integers(1, R + 1, B).astype(np.int32)
    return g, glen, r, rlen


def _full_inputs(seed, B, G, R):
    """Anchor rectangles drawn as tests/test_full_pallas.py draws them."""
    g, glen, r, rlen = _vec_inputs(seed, B, G, R)
    rng = np.random.default_rng(seed + 100)
    glen = rng.integers(8, G + 1, B).astype(np.int32)
    rlen = rng.integers(6, R + 1, B).astype(np.int32)
    return dict(
        genome=g, glen=glen, read=r, rlen=rlen,
        ax=rng.integers(-4, G // 2, B).astype(np.int32),
        ay=rng.integers(-4, R, B).astype(np.int32),
        alen=rng.integers(1, 12, B).astype(np.int32),
        awid=rng.integers(3, 20, B).astype(np.int32),
        revcmpl=rng.integers(0, 2, B).astype(np.int32))


_FULL_ORDER = ("genome", "glen", "read", "rlen", "ax", "ay", "alen", "awid",
               "revcmpl")


@pytest.mark.parametrize("G,R", [(32, 24), (32, 40), (64, 24), (64, 40),
                                 (128, 40), (256, 40)])
def test_sw_vector_ref_matches_pallas_and_xla(G, R):
    a = _vec_inputs(G * 100 + R, 1024, G, R)
    pallas = np.asarray(sw_vector_batch_pallas(*a, interpret=True, **KW))
    xla = np.asarray(sw_jax.sw_vector_batch(*a, **KW))
    got = sw_vector.sw_vector_batch(*_t(*a), **KW).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, pallas)
    assert np.array_equal(got, xla)
    assert got.max() >= 100      # real alignments, not only noise


@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("seed,G,R,edge", [
    pytest.param(seed, G, R, edge,
                 id=("edge-" if edge else "") + f"{seed}-{G}-{R}")
    for edge in (False, True) for seed, G, R in ((1, 32, 16), (2, 64, 40))])
def test_sw_full_stats_ref_matches_pallas(local, seed, G, R, edge):
    """`edge` gives a quarter of the pairs the band geometries of
    dataset.edge_bands, and checks that some best cells chain from an
    out-of-band cell: deq runs along the whole diagonal, band or not, so
    their base is that cell's deq."""
    a = _full_inputs(seed, 1024, G, R)
    if edge:
        rng = np.random.default_rng(seed + 200)
        for k, v in edge_bands(rng, 256, G, R).items():
            a[k][:256] = v
    args = [a[k] for k in _FULL_ORDER]
    assert 0 < a["revcmpl"].sum() < len(a["revcmpl"])   # both ways
    want = np.asarray(sw_full_stats_pallas(*args, local_alignment=local,
                                           interpret=True, **KW))
    got = sw_full.sw_full_stats(*_t(*args), local_alignment=local,
                                **KW).numpy()
    assert got.shape == (1024, 8) and got.dtype == np.int32
    assert np.array_equal(got, want)
    assert (got[:, 0] > 0).sum() > 10
    if edge:
        # the cell before each best cell's chain, and whether it lies
        # outside its row's band (row -1 and column -1 excluded)
        score, bi, bj, _, run, _, deq, base = got.T
        ci, cj = bi - run, bj - run
        x_min, x_max = (x[np.arange(1024), np.maximum(ci, 0)]
                        for x in bands(a, R))
        out = (score > 0) & (ci >= 0) & (cj >= 0) & ((cj < x_min)
                                                     | (cj > x_max))
        assert out.sum() > 0
        assert (base[out] > 0).any() and (deq >= base).all()


@pytest.mark.parametrize("local", [False, True])
def test_sw_full_stats_ref_matches_xla_where_positive(local):
    """sw_jax.sw_full_batch leaks decayed W values across band gaps
    (tests/test_full_pallas.py), so it is compared on score, max_i and
    max_j only, where the score is positive."""
    a = _full_inputs(3, 1024, 64, 40)
    args = [a[k] for k in _FULL_ORDER]
    args[-1] = args[-1] != 0
    score, mi, mj, _, _ = (np.asarray(x) for x in sw_jax.sw_full_batch(
        *args, local_alignment=local, **KW))
    got = sw_full.sw_full_stats(*_t(*[a[k] for k in _FULL_ORDER]),
                                local_alignment=local, **KW).numpy()
    pos = score > 0
    assert pos.sum() > 10
    assert np.array_equal(got[:, 0], np.maximum(score, 0))
    assert np.array_equal(got[pos, 1], mi[pos])
    assert np.array_equal(got[pos, 2], mj[pos])


def _small_codes(seed=5, n=30_000):
    rng = np.random.default_rng(seed)
    return encode_ls("".join(rng.choice(list("ACGT"), n)))


def _small_index(seed=5, n=30_000):
    return build_index([("chr_small", _small_codes(seed, n))],
                       default_seeds())


def test_mapper_planes_match_reference():
    idx = _small_index()
    ref = RefMapper(idx)
    m = Mapper(port_index.build_index([("chr_small", _small_codes())],
                                      port_seeds.default_seeds()),
               None, "cpu")
    fp = RefMapper._pad_plane(idx.codes)
    rp = RefMapper._pad_plane(idx.codes_rc)
    assert len(fp) == 1 << 22 and fp[-1] == 254
    assert np.array_equal(m._dev_codes().numpy(), fp)
    assert np.array_equal(m._dev_codes_rc().numpy(), rp)
    want = np.asarray(ref._dev_cat_words())
    got = m._dev_cat_words()
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    # the pad bucketing past 256M and the int32 guard, on plane lengths
    assert Mapper._pad_plane(np.zeros(5, np.uint8)).shape == (1 << 22,)
    big = (1 << 30) + 1
    fake = np.broadcast_to(np.uint8(0), (big,))
    assert port_sw.cat_word_plane(fake, fake) is None


def _packed_case(seed, fp, rp, G, L, B, k):
    n_gen = len(fp)
    rng = np.random.default_rng(seed)
    starts = rng.integers(-5, n_gen + 5, k)
    starts[:32] = rng.integers(-5, 40, 32)               # plane starts
    starts[32:64] = rng.integers(n_gen - 70, n_gen + 5, 32)  # plane ends
    glen = rng.integers(1, G + 1, k)
    ri = rng.integers(0, 64, k)
    rc = rng.integers(0, 2, k)
    rc[:64:2] = 1
    rx = rng.integers(-8, G // 2, k)
    ry = rng.integers(-8, L, k)
    rl = rng.integers(1, 24, k)
    rw = rng.integers(1, 30, k)
    rev = rc & rng.integers(0, 2, k)
    R = -(-L // 8) * 8
    rtab = np.full((64, R), 254, np.uint8)
    rtab[:, :L] = rng.integers(0, 4, (64, L))
    # 64 windows whose read aligns along the band's diagonal
    for q in range(64, 128):
        ri[q], glen[q], rx[q], ry[q], rl[q], rw[q] = q - 64, G, 0, 0, L, 8
        starts[q] = rng.integers(0, 20_000)
        plane = rp if rc[q] else fp
        rtab[q - 64, :L] = plane[starts[q]:starts[q] + L]
        rtab[q - 64, rng.integers(0, L)] = rng.integers(0, 4)
    args = _pack_args4(B, k, starts, glen, ri, rc, rx, ry, rl, rw, rev)
    return args, _pack_rtab(rtab)


@pytest.mark.parametrize("local", [False, True])
def test_packed_step_matches_jax(local):
    idx = _small_index()
    ref = RefMapper(idx)
    codes = RefMapper._pad_plane(idx.codes)
    codes_rc = RefMapper._pad_plane(idx.codes_rc)
    cat = np.asarray(ref._dev_cat_words())
    G, L, B = 64, 36, 2048
    args, rtab_pk = _packed_case(11, codes, codes_rc, G, L, B, 1800)
    kw = dict(G=G, L=L, local_alignment=local, **KW)
    (want,) = sw_jax.sw_vec_full_stats_packed(
        codes, codes_rc, args, rtab_pk, cat, use_pallas=False,
        interpret=True, **kw)
    want = np.asarray(want)
    got = port_sw.sw_vec_full_stats_packed(
        *_t(codes, codes_rc, args, rtab_pk, cat), **kw).numpy()
    assert got.shape == (B, 3) and got.dtype == np.int32
    # w0 (vec score | full score << 16) is compared on every row; w1 and
    # w2 are equal on every row too, including the score-0 rows whose
    # fields the host never reads
    assert np.array_equal(got, want)
    assert ((got[:, 0] & 0xFFFF) > 0).sum() > 100
    assert ((got[:, 0] >> 16) > 0).sum() >= 64


def test_pack_args4_matches_reference_and_guards_ranges():
    rng = np.random.default_rng(2)
    k = 500
    f = dict(starts=rng.integers(0, 1 << 30, k),
             glen=rng.integers(1, 1 << 14, k), ri=rng.integers(0, 1 << 16, k),
             rc=rng.integers(0, 2, k), rx=rng.integers(-(1 << 15), 1 << 15, k),
             ry=rng.integers(-(1 << 15), 1 << 15, k),
             rl=rng.integers(0, 1 << 16, k), rw=rng.integers(0, 1 << 15, k),
             rev=rng.integers(0, 2, k))
    got = _pack_args4(1024, k, **f)
    assert np.array_equal(got, ref_pack_args4(1024, k, **f))
    w0, glen, ri, rc, rx, ry, rl, rw, rev = (
        x.numpy() for x in port_sw._unpack_args4(torch.from_numpy(got)))
    for name, v in (("starts", w0), ("glen", glen), ("ri", ri), ("rc", rc),
                    ("rx", rx), ("ry", ry), ("rl", rl), ("rw", rw),
                    ("rev", rev)):
        assert np.array_equal(v[:k], f[name]), name
    assert (glen[k:] == 1).all() and (rl[k:] == 1).all()
    with pytest.raises(ValueError, match="read row"):
        _pack_args4(8, 1, *(np.array([v]) for v in
                            (0, 5, 1 << 16, 0, 0, 0, 1, 1, 0)))
    with pytest.raises(ValueError, match="window length"):
        _pack_args4(8, 1, *(np.array([v]) for v in
                            (0, 1 << 14, 0, 0, 0, 0, 1, 1, 0)))


def test_window_gather_needs_g_multiple_of_4():
    cat = torch.zeros(64, dtype=torch.int32)
    z = torch.zeros(2, dtype=torch.int32)
    assert port_sw.fast_window_gather(cat, 100, z, z, 8).shape == (2, 8)
    with pytest.raises(ValueError, match="multiple of 4"):
        port_sw.fast_window_gather(cat, 100, z, z, 10)


def test_get_device_never_falls_back():
    assert get_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert get_device("cuda") == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            get_device("cuda")
    with pytest.raises(ValueError):
        get_device("mps")


def test_wrappers_raise_off_cpu_without_kernel():
    """A tensor that is not on the CPU never takes the plain version:
    without a kernel for its device the wrapper raises."""
    a = [t.to("meta") for t in _t(*_vec_inputs(1, 8, 32, 16))]
    with pytest.raises(ValueError, match="no kernel"):
        sw_vector.sw_vector_batch(*a, **KW)
    f = [t.to("meta") for t in _t(*[_full_inputs(1, 8, 32, 16)[k]
                                    for k in _FULL_ORDER])]
    with pytest.raises(ValueError, match="no kernel"):
        sw_full.sw_full_stats(*f, **KW)


@pytest.mark.cuda
@pytest.mark.parametrize("G,R,B", [
    pytest.param(64, 40, 8192, id="64-40"),
    pytest.param(128, 40, 8192, id="128-40"),
    pytest.param(256, 40, 8192, id="256-40"),
    # windows that are no G bucket; B not a multiple of the pairs a block
    pytest.param(40, 40, 8191, id="40-40-8191"),
    pytest.param(96, 72, 8191, id="96-72-8191"),
    pytest.param(200, 40, 8191, id="200-40-8191")])
def test_cuda_kernels_match_plain(G, R, B):
    """The stats flow's G buckets and windows between them, a quarter of
    the pairs at the edge bands of dataset.edge_bands, the vector SW's
    pairs also at the length edges of dataset.length_edges (tolerance
    0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    a = _full_inputs(G, B, G, R)
    rng = np.random.default_rng(G)
    for k, v in edge_bands(rng, 2048, G, R).items():
        a[k][:2048] = v
    full = [torch.from_numpy(a[k]).to(dev) for k in _FULL_ORDER]
    glen, rlen = a["glen"].copy(), a["rlen"].copy()
    length_edges(rng, glen, rlen, G, R)
    vec = [full[0], torch.from_numpy(glen).to(dev), full[2],
           torch.from_numpy(rlen).to(dev)]
    n0 = sw_vector.LAUNCHES.n
    assert torch.equal(sw_vector.sw_vector_batch(*vec, **KW),
                       sw_vector.sw_vector_batch_ref(*vec, **KW))
    assert sw_vector.LAUNCHES.n == n0 + 1
    for local in (False, True):
        assert torch.equal(
            sw_full.sw_full_stats(*full, local_alignment=local, **KW),
            sw_full.sw_full_stats_ref(*full, local_alignment=local, **KW))
