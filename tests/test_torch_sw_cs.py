"""shrimp_tpu_torch's colour-space device step against the JAX package,
on the CPU.

The plain PyTorch versions of the colour-space vector SW, the 4-layer
DP and the traceback are held against the Pallas kernels in interpret
mode and the XLA formulations; the fused step against
sw_cs_jax.sw_vec_cs_full_from_index. Inputs are numpy arrays from a
seed, handed to both packages. Tolerance 0 everywhere: every output is
an integer. Tests marked `cuda` hold the CUDA kernels against the plain
versions and skip without a card.
"""
import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from shrimp_tpu import constants as C
from shrimp_tpu.core import sw_jax
from shrimp_tpu.core.sw_cs_batch import cs_layers_batch
from shrimp_tpu.core.sw_cs_full_pallas import sw_full_cs_dp_pallas
from shrimp_tpu.core.sw_cs_jax import (sw_full_cs_tpu, sw_full_cs_tpu_pallas,
                                       sw_vec_cs_full_from_index as
                                       ref_vec_cs_full)
from shrimp_tpu.core.sw_pallas import sw_vector_batch_pallas
from shrimp_tpu_torch.core import sw_cs, sw_cs_full, sw_vector
from shrimp_tpu_torch.core.sw import cat_word_plane
from shrimp_tpu_torch.dataset import cs_walk_pairs, edge_bands, length_edges
from shrimp_tpu_torch.mapper import Mapper

# gmapper-cs's default scores (constants.DEF_CS_*)
KW = dict(match=10, mismatch=-24, a_gap_open=-33, a_gap_ext=-7,
          b_gap_open=-33, b_gap_ext=-3)
XOVER = -20
_DP_ORDER = ("genome", "glen", "qr", "rlen", "ax", "ay", "alen", "awid",
             "revcmpl", "xover", "gx")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _vec_cs_inputs(seed, B, G, R):
    """Colour windows with their row-0 colours, colour reads (half copied
    from their window, some with dot colours), lengths."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, (B, G)).astype(np.uint8)
    g0 = rng.integers(0, 4, (B, G)).astype(np.uint8)
    r = rng.integers(0, 4, (B, R)).astype(np.uint8)
    for k in range(1, B, 2):
        o = int(rng.integers(0, max(1, G - R)))
        n = min(R, G - o)
        r[k, :n] = g[k, o:o + n]
        r[k, 0] = g0[k, o]
        r[k, rng.integers(0, R, 2)] = rng.integers(0, 4, 2)
    r[rng.random((B, R)) < 0.01] = C.BASE_N
    g[rng.random((B, G)) < 0.005] = C.BASE_N
    glen = rng.integers(1, G + 1, B).astype(np.int32)
    rlen = rng.integers(1, R + 1, B).astype(np.int32)
    return g, glen, r, rlen, g0


def _dp_inputs(seed, B, G, R, edge=False):
    """4-layer DP inputs drawn as tests/test_cs_pallas.py draws them,
    with layers translated from colour reads that follow their window,
    per-row crossovers from qualities, BASE_N cells and both strands.
    `edge` gives the first quarter of the pairs the band geometries of
    dataset.edge_bands (bands clipped to one column at either edge, pad
    rows, awid = 1, a band that jumps at the anchor's end); crossovers
    vary by row, so local mode's out-of-band values do too."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, (B, G)).astype(np.uint8)
    colours = rng.integers(0, 4, (B, R)).astype(np.uint8)
    initbp = rng.integers(0, 4, B)
    for k in range(0, B, 2):
        o = int(rng.integers(0, G - R))
        lets = np.concatenate([[initbp[k]], g[k, o:o + R]])
        colours[k] = C.COLOUR_MAT[lets[:-1], lets[1:]]
        colours[k, rng.integers(0, R, 2)] = rng.integers(0, 4, 2)
    colours[rng.random((B, R)) < 0.01] = C.BASE_N
    g[rng.random((B, G)) < 0.01] = C.BASE_N
    qr = cs_layers_batch(colours, initbp)
    a = dict(
        genome=g, glen=rng.integers(40, G + 1, B).astype(np.int32), qr=qr,
        rlen=rng.integers(R - 12, R + 1, B).astype(np.int32),
        ax=rng.integers(-4, 6, B).astype(np.int32),
        ay=rng.integers(5, 15, B).astype(np.int32),
        alen=rng.integers(10, 20, B).astype(np.int32),
        awid=rng.integers(6, 14, B).astype(np.int32),
        revcmpl=(rng.random(B) < 0.5).astype(np.int32),
        xover=rng.integers(2 * XOVER, 0, (B, R)).astype(np.int32),
        gx=np.full(B, XOVER, np.int32),
        thresh=rng.integers(0, 200, B).astype(np.int32))
    if edge:
        a.update((k, np.concatenate([v, a[k][B // 4:]]))
                 for k, v in edge_bands(rng, B // 4, G, R).items())
    return a


@pytest.mark.parametrize("G,R", [(32, 24), (64, 36), (128, 36)])
def test_sw_vector_cs_ref_matches_pallas_and_xla(G, R):
    g, glen, r, rlen, g0 = _vec_cs_inputs(G * 100 + R, 1024, G, R)
    kw = dict(KW, mismatch=KW["match"] + XOVER)
    pallas = np.asarray(sw_vector_batch_pallas(
        g, glen, r, rlen, g0, cs_mode=True, interpret=True, **kw))
    xla = np.asarray(sw_jax.sw_vector_batch(g, glen, r, rlen, g0,
                                            cs_mode=True, **kw))
    got = sw_vector.sw_vector_batch(*_t(g, glen, r, rlen, g0),
                                    cs_mode=True, **kw).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, pallas)
    assert np.array_equal(got, xla)
    assert got.max() >= 100
    # row 0 really reads g_row0: scoring it against the colour window
    # instead changes some scores
    ls = sw_vector.sw_vector_batch(*_t(g, glen, r, rlen), **kw).numpy()
    assert not np.array_equal(got, ls)
    with pytest.raises(ValueError, match="g_row0"):
        sw_vector.sw_vector_batch(*_t(g, glen, r, rlen), cs_mode=True, **kw)


@pytest.mark.parametrize("local,taboo,edge", [
    pytest.param(local, taboo, edge,
                 id=("edge-" if edge else "") + f"{local}-{taboo}")
    for edge in (False, True) for local in (False, True) for taboo in (0, 4)])
def test_sw_full_cs_dp_ref_matches_pallas(local, taboo, edge):
    a = _dp_inputs(10 + 2 * local + taboo + 100 * edge, 1024, 64, 36, edge)
    args = [a[k] for k in _DP_ORDER]
    kw = dict(KW, local_alignment=local, indel_taboo_len=taboo)
    want = [np.asarray(x) for x in sw_full_cs_dp_pallas(
        *args[:8], args[8] != 0, *args[9:], interpret=True, **kw)]
    got = [x.numpy() for x in sw_cs_full.sw_full_cs_dp_ref(*_t(*args), **kw)]
    assert got[5].shape == (1024, 36, 4, 64)
    for name, w, x in zip(("best", "bi", "bj", "bk", "bfrm", "bp"), want,
                          got):
        assert x.dtype == np.int32, name
        assert np.array_equal(x, w), name
    assert (got[0] > 100).sum() > 150
    # the wrapper hands the backpointers on as int16 in the reference's
    # [B, R, 4, G] layout
    *stats, bp = sw_cs_full.sw_full_cs_dp(*_t(*args), **kw)
    assert bp.dtype == torch.int16 and bp.shape == (1024, 36, 4, 64)
    assert np.array_equal(bp.numpy(), want[5])


@pytest.mark.parametrize("local,taboo,G,B,pallas,aligned", [
    pytest.param(False, 4, 64, 1024, True, 200, id="False-4"),
    pytest.param(True, 0, 64, 1024, True, 200, id="True-0"),
    # the Pallas kernel's batch tile at G = 128 is more than 512 rows
    pytest.param(False, 0, 128, 512, False, 50, id="g128-False-0")])
def test_sw_full_cs_matches_jax(local, taboo, G, B, pallas, aligned):
    """DP + traceback against the scan formulation and (`pallas`) the
    Pallas kernel with the shared traceback: packed rows and step
    strings; more than `aligned` rows align."""
    R = 36
    a = _dp_inputs(20 + local + (G != 64), B, G, R)
    args = [a[k] for k in _DP_ORDER] + [a["thresh"]]
    kw = dict(KW, local_alignment=local, indel_taboo_len=taboo)
    jargs = args[:8] + [args[8] != 0] + args[9:]
    wants = [[np.asarray(x) for x in sw_full_cs_tpu(*jargs, **kw)]]
    if pallas:
        wants.append([np.asarray(x) for x in sw_full_cs_tpu_pallas(
            *jargs, interpret=True, **kw)])
    packed, steps = (x.numpy() for x in sw_cs.sw_full_cs(*_t(*args), **kw))
    assert packed.dtype == np.int16 and steps.dtype == np.int8
    assert steps.shape == (B, R + G)
    for w in wants:
        assert np.array_equal(packed, w[0])
        assert np.array_equal(steps, w[1])
    assert (packed[:, 0] > 0).sum() > aligned
    assert (packed[:, 11] > 0).any()       # crossovers walked


def _cs_planes(seed, n_true):
    """Padded letter planes of a random genome and their colour planes,
    as the CS index and Mapper lay them out (254 pad bytes)."""
    rng = np.random.default_rng(seed)
    fw = rng.integers(0, 4, n_true).astype(np.uint8)
    rc = (3 - fw[::-1]).astype(np.uint8)
    cfw = np.concatenate([[0], C.COLOUR_MAT[fw[:-1], fw[1:]]]).astype(
        np.uint8)
    crc = np.concatenate([[0], C.COLOUR_MAT[rc[:-1], rc[1:]]]).astype(
        np.uint8)
    return tuple(Mapper._pad_plane(p) for p in (cfw, crc, fw, rc))


def _cs_fused_case(seed, planes, G, R, B, k):
    cs, cs_rc, ls, ls_rc = planes
    n_gen = len(ls)
    rng = np.random.default_rng(seed)
    n_reads = 64
    a = np.zeros((B, 12), np.int32)
    starts = rng.integers(-5, n_gen + 5, k)
    starts[:32] = rng.integers(-5, 40, 32)                  # plane starts
    starts[32:64] = rng.integers(n_gen - 70, n_gen + 5, 32)  # plane ends
    rcf = rng.integers(0, 2, k)
    rcf[:64:2] = 1
    a[:k, 0] = starts
    a[:k, 1] = rng.integers(1, G + 1, k)
    a[:k, 2] = rng.integers(0, n_reads, k)
    a[:k, 3] = rcf
    a[:k, 4] = R
    a[:k, 5] = rng.integers(-8, G // 2, k)
    a[:k, 6] = rng.integers(-8, R, k)
    a[:k, 7] = rng.integers(0, 24, k)
    a[:k, 8] = rng.integers(0, 30, k)
    a[:k, 9] = rcf & rng.integers(0, 2, k)
    a[:k, 10] = rng.integers(0, 150, k)
    initbp = rng.integers(0, 4, n_reads)
    colours = rng.integers(0, 4, (n_reads, R)).astype(np.uint8)
    # 64 windows whose read follows the band's diagonal
    for q in range(64, 128):
        ri = q - 64
        st = int(rng.integers(0, 20_000))
        a[q, [0, 1, 2, 5, 6, 7, 8]] = (st, G, ri, 0, 0, R, 8)
        plane = ls_rc if a[q, 3] else ls
        lets = np.concatenate([[initbp[ri]], plane[st:st + R]])
        colours[ri] = C.COLOUR_MAT[lets[:-1], lets[1:]]
        colours[ri, rng.integers(0, R)] = C.BASE_N
    a[:k, 11] = initbp[a[:k, 2]]
    a[k:, [1, 4, 7, 8, 10]] = 1                              # pad rows
    rtab = np.full((n_reads + 64, R), C.BASE_N, np.uint8)
    rtab[:n_reads] = colours
    qr = np.full((n_reads + 64, 4, R), C.BASE_N, np.uint8)
    qr[:n_reads] = cs_layers_batch(colours, initbp)
    xov = np.full((n_reads + 64, R), XOVER, np.int32)
    xov[:n_reads] = rng.integers(2 * XOVER, 0, (n_reads, R))
    return a, rtab, qr, xov


@pytest.mark.parametrize("local", [False, True])
def test_vec_cs_full_from_index_matches_jax(local):
    planes = _cs_planes(7, 30_000)
    cats = (cat_word_plane(*planes[:2]), cat_word_plane(*planes[2:]))
    G, R, B = 64, 36, 2048
    args, rtab, qr, xov = _cs_fused_case(11, planes, G, R, B, 1800)
    kw = dict(KW, G=G, xover=XOVER, local_alignment=local,
              indel_taboo_len=4)
    want = [np.asarray(x) for x in ref_vec_cs_full(
        *planes, args, rtab, qr, xov, *cats, **kw)]
    got = [x.numpy() for x in sw_cs.sw_vec_cs_full_from_index(
        *_t(*planes, args, rtab, qr, xov, *cats), **kw)]
    for name, w, x in zip(("vec", "packed", "steps_rev"), want, got):
        assert x.dtype == w.dtype and np.array_equal(x, w), name
    assert (got[0] > 100).sum() >= 64
    assert (got[1][:, 0] > 0).sum() >= 64
    # without the word planes both windows are gathered byte by byte, as
    # the reference does where its word gather gives up (planes over
    # ~1 Gbp): forced here by that gather answering None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sw_jax, "fast_window_gather", lambda *a, **k: None)
        want = [np.asarray(x) for x in jax.jit(
            ref_vec_cs_full.__wrapped__, static_argnames=tuple(kw))(
                *planes, args, rtab, qr, xov, **kw)]
    got = [x.numpy() for x in sw_cs.sw_vec_cs_full_from_index(
        *_t(*planes, args, rtab, qr, xov), **kw)]
    for name, w, x in zip(("vec", "packed", "steps_rev"), want, got):
        assert x.dtype == w.dtype and np.array_equal(x, w), name


def test_cs_wrappers_raise_off_cpu_without_kernel():
    a = _dp_inputs(1, 8, 64, 36)
    t = [x.to("meta") for x in _t(*[a[k] for k in _DP_ORDER])]
    with pytest.raises(ValueError, match="no kernel"):
        sw_cs_full.sw_full_cs_dp(*t, **KW)
    s = [x.to("meta") for x in _t(a["genome"], a["qr"],
                                  *[np.zeros(8, np.int32)] * 5)]
    bp = torch.zeros((8, 36, 4, 64), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        sw_cs_full.cs_traceback(*s, bp, s[2])
    v = [x.to("meta") for x in _t(*_vec_cs_inputs(1, 8, 32, 16))]
    with pytest.raises(ValueError, match="no kernel"):
        sw_vector.sw_vector_batch(*v, cs_mode=True, **KW)


@pytest.mark.cuda
@pytest.mark.parametrize("local,taboo,B,R,G", [
    pytest.param(False, 0, 2048, 36, 64, id="False-0"),
    pytest.param(True, 4, 2048, 36, 64, id="True-4"),
    pytest.param(False, 0, 2048, 36, 256, id="g256-False-0"),
    pytest.param(True, 0, 2048, 72, 128, id="r72-True-0")])
def test_cuda_cs_kernels_match_plain(local, taboo, B, R, G):
    """The CS kernels on the card against their plain versions (tolerance
    0): the DP and the traceback on its backpointers, a quarter of the
    pairs at the edge bands; the vector SW with the length edges of
    dataset.length_edges; the traceback also on dataset.cs_walk_pairs
    (walks that reach row 0 and column 0, leave the kernel's band, start
    outside layer 0, or do not start)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    a = _dp_inputs(3, B, G, R, edge=True)
    args = [torch.from_numpy(a[k]).to(dev) for k in _DP_ORDER]
    thresh = torch.from_numpy(a["thresh"]).to(dev)
    kw = dict(KW, local_alignment=local, indel_taboo_len=taboo)
    n0 = sw_cs_full.DP_LAUNCHES.n
    got = sw_cs_full.sw_full_cs_dp(*args, **kw)
    want = sw_cs_full.sw_full_cs_dp_ref(*args, **kw)
    assert sw_cs_full.DP_LAUNCHES.n == n0 + 1
    for x, w in zip(got[:5], want[:5]):
        assert torch.equal(x, w)
    assert torch.equal(got[5].to(torch.int32), want[5])
    tb = (args[0], args[2], *got, thresh)
    for x, w in zip(sw_cs_full.cs_traceback(*tb),
                    sw_cs_full.cs_traceback_ref(*tb)):
        assert torch.equal(x, w)
    rng = np.random.default_rng(G + R)
    w = cs_walk_pairs(rng, 512, R, G)
    tb = [torch.from_numpy(w[k]).to(dev) for k in (
        "genome", "qr", "best", "bi", "bj", "bk", "bfrm", "bp", "thresh")]
    for x, y in zip(sw_cs_full.cs_traceback(*tb),
                    sw_cs_full.cs_traceback_ref(*tb)):
        assert torch.equal(x, y)
    g, glen, r, rlen, g0 = _vec_cs_inputs(4, B, G, R)
    length_edges(rng, glen, rlen, G, R)
    v = [torch.from_numpy(x).to(dev) for x in (g, glen, r, rlen, g0)]
    assert torch.equal(
        sw_vector.sw_vector_batch(*v, cs_mode=True, **KW),
        sw_vector.sw_vector_batch_ref(*v, cs_mode=True, **KW))


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,G,walks", [
    pytest.param(1024, 256, 352, (256, 256, 352), id="g352"),
    pytest.param(64, 1000, 1408, (16, 1000, 1408), id="g1408"),
    pytest.param(8, 64, 110_592, (4, 16, 115_200),
                 id="g110592-device-memory"),
    pytest.param(1, 1000, 1408, (1, 1000, 1408), id="g1408-1-pair"),
    pytest.param(47, 1000, 1408, (4, 1000, 1408), id="g1408-47-pairs")])
def test_cuda_cs_kernels_match_plain_past_256(B, R, G, walks):
    """The 4-layer DP and the traceback on the card against their plain
    versions (tolerance 0) on windows past the strip kernel's 256
    columns: the launches of 250- and 1000-colour reads (one pair and 47,
    the generic mapper's launch, as well: the wide DP's column groups),
    and a width past both kernels' shared-memory fit (the DP's row
    buffers in device memory, the traceback's window, layers and steps
    read and written in place); global and local, taboo 0 and 4, a
    quarter of the pairs at the edge bands; the traceback also on
    dataset.cs_walk_pairs at `walks`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from shrimp_tpu_torch import _build
    dev = torch.device("cuda", 0)
    past = G > 100_000
    with torch.cuda.device(dev):
        assert (_build.scratch("sw_cs_full", B, G, R, dev) is not None
                ) == past
    a = _dp_inputs(G + R, B, G, R, edge=True)
    args = [torch.from_numpy(a[k]).to(dev) for k in _DP_ORDER]
    thresh = torch.from_numpy(a["thresh"]).to(dev)
    for local, taboo in ((False, 0), (False, 4), (True, 0), (True, 4)):
        kw = dict(KW, local_alignment=local, indel_taboo_len=taboo)
        got = sw_cs_full.sw_full_cs_dp(*args, **kw)
        want = sw_cs_full.sw_full_cs_dp_ref(*args, **kw)
        for x, w in zip(got[:5], want[:5]):
            assert torch.equal(x, w)
        assert torch.equal(got[5].to(torch.int32), want[5])
        tb = (args[0], args[2], *got, thresh)
        for x, w in zip(sw_cs_full.cs_traceback(*tb),
                        sw_cs_full.cs_traceback_ref(*tb)):
            assert torch.equal(x, w)
    Bw, Rw, Gw = walks
    w = cs_walk_pairs(np.random.default_rng(Gw), Bw, Rw, Gw)
    tb = [torch.from_numpy(w[k]).to(dev) for k in (
        "genome", "qr", "best", "bi", "bj", "bk", "bfrm", "bp", "thresh")]
    for x, y in zip(sw_cs_full.cs_traceback(*tb),
                    sw_cs_full.cs_traceback_ref(*tb)):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_cuda_cs_traceback_refuses_unaligned():
    """The traceback kernel copies in 16- and 4-byte pieces: G not a
    multiple of 8, backpointers off a 16-byte boundary and windows off a
    4-byte one raise rather than launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    B, R = 64, 36
    for G, off, goff in ((60, 0, 0), (64, 1, 0), (64, 0, 1)):
        bp = torch.zeros(B * R * 4 * G + 8, dtype=torch.int16, device=dev)[
            off:off + B * R * 4 * G].view(B, R, 4, G)
        g = torch.zeros(B * G + 4, dtype=torch.uint8, device=dev)[
            goff:goff + B * G].view(B, G)
        z = torch.zeros(B, dtype=torch.int32, device=dev)
        qr = torch.zeros((B, 4, R), dtype=torch.uint8, device=dev)
        n0 = sw_cs_full.TB_LAUNCHES.n
        with pytest.raises(NotImplementedError, match="16-byte"):
            sw_cs_full.cs_traceback(g, qr, z, z, z, z, z, bp, z)
        assert sw_cs_full.TB_LAUNCHES.n == n0
