"""The flows the packed path leaves to others, on the CPU, against the JAX
package: the byte gather for genome planes whose concatenated word plane
would overflow int32 offsets (planes over ~1 Gbp), and the unpacked-IO
steps for batches of more than 2^16 read rows.

- `core.sw.window_gather_bytes` against the bytes of the reference's
  `sw_jax._vec_full_gather` (each position clipped to the plane) at both
  plane ends and on both strands, in one block and in many, and against
  the port's word gather where the two agree by construction;
- `sw_vec_full_stats_from_index` and `sw_vec_full_tb_from_index` against
  the reference's functions of the same names, every phase, and the
  packed steps without a word plane against the reference's packed steps
  with its word gather forced to give up;
- the LS, LS-paired and CS streams with the mapper's word planes
  withheld, and the LS stream forced onto the unpacked flow, each SAM
  byte-identical to the reference's normal run.

Tolerance 0 throughout (uint8 windows, int32 and int16 rows, SAM bytes),
except where the reference's XLA full SW with backpointers is the
oracle: its rows are compared where the score is positive, as in
tests/test_torch_two_phase.py. The `cuda` cases hold the CUDA steps
against the CPU steps and skip without a card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shrimp_tpu import fastpath as ref_fastpath
from shrimp_tpu import fastpath_cs as ref_fastpath_cs
from shrimp_tpu.config import MapperConfig
from shrimp_tpu.core import sw_jax
from shrimp_tpu.mapper import Mapper as RefMapper
from shrimp_tpu.paired import PairedMapper as RefPairedMapper
from shrimp_tpu_torch import fastpath, fastpath_cs
from shrimp_tpu_torch.config import MapperConfig as PortConfig
from shrimp_tpu_torch.core import sw as port_sw
from shrimp_tpu_torch.core import sw_cs
from shrimp_tpu_torch.core.sw import PAD, cat_word_plane
from shrimp_tpu_torch.mapper import Mapper
from shrimp_tpu_torch.paired import PairedMapper

from .test_fastpath_paired import make_pairs
from .test_torch_fastpath import _build as _build_ls
from .test_torch_fastpath_cs import _build as _build_cs
from .test_torch_fastpath_long import _build as _build_long
from .test_torch_fastpath_paired import _indexes as _paired_indexes
from .test_torch_sw import KW

CS = "cs"
G, L = 64, 36


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _planes(seed=5, n_true=30_000):
    """Padded forward and reverse-complement planes of a random genome,
    as the Mapper lays them out (254 pad bytes)."""
    fw = np.random.default_rng(seed).integers(0, 4, n_true).astype(np.uint8)
    return Mapper._pad_plane(fw), Mapper._pad_plane((3 - fw[::-1]).astype(
        np.uint8))


def _windows(seed, fp, rp, k, Gw, Lw=L):
    """The window geometry of k windows (`fastpath._launch_args`'s `win`
    fields) and a 64-row read table: windows at both plane ends of both
    strands, including starts before 0 and tails past the end, and 64
    windows whose read aligns along the band's diagonal."""
    n_gen = len(fp)
    rng = np.random.default_rng(seed)
    starts = rng.integers(-5, n_gen + 5, k)
    starts[:32] = rng.integers(-70, 40, 32)               # plane starts
    starts[32:64] = rng.integers(n_gen - 70, n_gen + 5, 32)  # plane ends
    rc = rng.integers(0, 2, k)
    rc[:64:2] = 1
    win = dict(starts=starts, glen=rng.integers(1, Gw + 1, k),
               ri=rng.integers(0, 64, k), rcmask=rc,
               rx=rng.integers(-8, Gw // 2, k), ry=rng.integers(-8, Lw, k),
               rl_=rng.integers(1, 24, k), rw_=rng.integers(1, 30, k))
    win["rev"] = rc & rng.integers(0, 2, k)
    R = -(-Lw // 8) * 8
    rtab = np.full((64, R), 254, np.uint8)
    rtab[:, :Lw] = rng.integers(0, 4, (64, Lw))
    for q in range(64, 128):
        st = int(rng.integers(0, 20_000))
        for f, v in (("ri", q - 64), ("glen", Gw), ("rx", 0), ("ry", 0),
                     ("rl_", Lw), ("rw_", 8), ("starts", st)):
            win[f][q] = v
        plane = rp if rc[q] else fp
        rtab[q - 64, :Lw] = plane[st:st + Lw]
        rtab[q - 64, rng.integers(0, Lw)] = rng.integers(0, 4)
    return win, rtab


def _args(win, k, B, packed_io):
    return fastpath._launch_args(win, slice(0, k), k, B, L, packed_io)


# ------------------------------------------------------------- the gather

@pytest.mark.parametrize("Gw,block_cells", [(64, None), (64, 1000),
                                            (352, 5000)])
def test_byte_gather_matches_reference_clip(monkeypatch, Gw, block_cells):
    """The windows of `_vec_full_gather` (each position gstart + j clipped
    to [0, n_gen - 1]), in one block of rows and in many."""
    fp, rp = _planes()
    win, rtab = _windows(3, fp, rp, 500, Gw)
    args = _args(win, 500, 512, False)
    if block_cells:
        monkeypatch.setattr(port_sw, "GATHER_BLOCK_CELLS", block_cells)
    want = np.asarray(sw_jax._vec_full_gather(
        jnp.asarray(fp), jnp.asarray(rp), jnp.asarray(args),
        jnp.asarray(rtab), Gw)[0])
    got = port_sw.window_gather_bytes(
        *_t(fp, rp, args[:, 0], args[:, 3]), Gw)
    assert got.dtype == torch.uint8 and got.shape == (512, Gw)
    assert np.array_equal(got.numpy(), want)
    # the edges are there: starts before 0, tails past the end, and
    # both strands
    n = len(fp)
    assert (args[:32, 0] < 0).any() and (args[32:64, 0] + Gw > n).any()
    assert args[:64, 3].any() and not args[:64, 3].all()


def test_byte_gather_matches_word_gather_in_range():
    """Where a window starts in the plane and overruns its end by at most
    the word plane's pad, the byte gather and the word gather read the
    same bytes; both ends of both strands."""
    fp, rp = _planes()
    n = len(fp)
    rng = np.random.default_rng(4)
    B = 4096
    starts = rng.integers(0, n - G, B)
    starts[:64] = rng.integers(0, 40, 64)
    starts[64:128] = rng.integers(n - G - PAD // 2, n, 64)
    starts[128:132] = (0, n - 1, n - G, n - G - PAD)
    rc = rng.integers(0, 2, B)
    rc[:132:2] = 1
    assert ((starts + G - 1) - (n - 1) <= PAD).all()
    gs, rct = _t(starts.astype(np.int32), rc.astype(np.int32))
    by = port_sw.window_gather_bytes(*_t(fp, rp), gs, rct, G)
    wd = port_sw.fast_window_gather(_t(cat_word_plane(fp, rp))[0], n, gs,
                                    rct, G)
    assert torch.equal(by, wd)


def test_byte_gather_refuses_unequal_planes():
    fp, rp = _planes()
    with pytest.raises(ValueError, match="differ in length"):
        port_sw.window_gather_bytes(*_t(fp, rp[:-8], np.zeros(4, np.int32),
                                        np.zeros(4, np.int32)), G)


# ------------------------------------------------------------- the steps

@pytest.fixture(scope="module")
def steps_case():
    fp, rp = _planes()
    win, rtab = _windows(11, fp, rp, 1800, G)
    return fp, rp, win, rtab


def _ref_stats_from_index(fp, rp, args, rtab, phase):
    return [np.asarray(x) for x in sw_jax.sw_vec_full_stats_from_index(
        fp, rp, args, rtab, G=G, use_pallas=False, interpret=True,
        phase=phase, **KW)]


@pytest.mark.parametrize("phase", ["fused", "vec", "full"])
def test_stats_from_index_matches_jax(steps_case, phase):
    """The unpacked stats step: (vec, stats) int16, (vec,) or (stats,)."""
    fp, rp, win, rtab = steps_case
    args = _args(win, 1800, 2048, False)
    want = _ref_stats_from_index(fp, rp, args, rtab, phase)
    got = [x.numpy() for x in port_sw.sw_vec_full_stats_from_index(
        *_t(fp, rp, args, rtab), G=G, phase=phase, **KW)]
    assert len(got) == len(want) == (2 if phase == "fused" else 1)
    for w, x in zip(want, got):
        assert x.dtype == w.dtype == np.int16 and np.array_equal(x, w)
    assert (want[-1][:, 0] > 0).sum() >= 64 if phase != "vec" else \
        (want[0] > 100).sum() >= 64


@pytest.mark.parametrize("phase", ["fused", "vec", "full"])
def test_tb_from_index_matches_jax(steps_case, phase):
    """The unpacked traceback step: (vec, packed, ops), (vec,) or
    (packed, ops); rows and ops where the score is positive."""
    fp, rp, win, rtab = steps_case
    args = _args(win, 1800, 2048, False)
    want = [np.asarray(x) for x in sw_jax.sw_vec_full_tb_from_index(
        fp, rp, args, rtab, G=G, use_pallas=False, phase=phase, **KW)]
    got = [x.numpy() for x in port_sw.sw_vec_full_tb_from_index(
        *_t(fp, rp, args, rtab), G=G, phase=phase, **KW)]
    assert len(got) == len(want) == {"fused": 3, "vec": 1, "full": 2}[phase]
    if phase != "full":
        assert got[0].dtype == np.int16 and np.array_equal(got[0], want[0])
    if phase == "vec":
        return
    (pk, ops), (wpk, wops) = got[-2:], want[-2:]
    pos = wpk[:, 0] > 0
    assert pos.sum() >= 64
    assert np.array_equal(pk[:, 0], wpk[:, 0])
    assert np.array_equal(pk[pos], wpk[pos])
    assert np.array_equal(ops[pos], wops[pos])


def test_unpacked_steps_match_packed_steps(steps_case):
    """The same windows through the unpacked and the packed steps (no
    word plane: both gather by byte) give the same rows."""
    fp, rp, win, rtab = steps_case
    un = _args(win, 1800, 2048, False)
    pk4 = _args(win, 1800, 2048, True)
    rtab_pk = fastpath._pack_rtab(rtab)
    vec, st = port_sw.sw_vec_full_stats_from_index(*_t(fp, rp, un, rtab),
                                                   G=G, **KW)
    rows = port_sw.sw_vec_full_stats_packed(*_t(fp, rp, pk4, rtab_pk), None,
                                            G=G, L=L, **KW).numpy()
    # the first 1800 rows are windows; the pad rows differ (the packed
    # flow's pad rows keep the batch read length)
    v2, st2 = fastpath._unpack_stats3(rows[:1800])
    v1, st1 = fastpath._stats_rows((vec, st), 1800, False)
    pos = st1[:, 0] > 0
    assert pos.sum() >= 64
    assert np.array_equal(v1, v2) and np.array_equal(st1[:, 0], st2[:, 0])
    assert np.array_equal(st1[pos], st2[pos])
    tb = port_sw.sw_vec_full_tb_from_index(*_t(fp, rp, un, rtab), G=G, **KW)
    tb2 = port_sw.sw_vec_full_tb_packed(*_t(fp, rp, pk4, rtab_pk), None,
                                        G=G, L=L, **KW)
    for a, b in zip(tb, tb2):
        assert torch.equal(a[:1800], b[:1800])


def _ref_without_word_gather(fn, *arrays, **kw):
    """A reference step with its word gather giving up, as it does for
    planes over ~1 Gbp (fast_window_gather answers None), so that it
    gathers byte by byte; traced afresh, outside the jit cache."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sw_jax, "fast_window_gather", lambda *a, **k: None)
        return [np.asarray(x) for x in jax.jit(
            fn.__wrapped__, static_argnames=tuple(kw))(*arrays, **kw)]


def test_packed_steps_by_byte_match_jax(steps_case):
    """The packed stats and traceback steps with no word plane against
    the reference's packed steps gathering by byte."""
    fp, rp, win, rtab = steps_case
    args = _args(win, 1800, 2048, True)
    rtab_pk = fastpath._pack_rtab(rtab)
    (want,) = _ref_without_word_gather(
        sw_jax.sw_vec_full_stats_packed, fp, rp, args, rtab_pk, G=G, L=L,
        use_pallas=False, interpret=True, **KW)
    got = port_sw.sw_vec_full_stats_packed(*_t(fp, rp, args, rtab_pk), None,
                                           G=G, L=L, **KW)
    assert np.array_equal(got.numpy(), want)
    assert ((want[:, 0] >> 16) > 0).sum() >= 64
    want = _ref_without_word_gather(
        sw_jax.sw_vec_full_tb_packed, fp, rp, args, rtab_pk, G=G, L=L,
        use_pallas=False, **KW)
    got = [x.numpy() for x in port_sw.sw_vec_full_tb_packed(
        *_t(fp, rp, args, rtab_pk), None, G=G, L=L, **KW)]
    assert np.array_equal(got[0], want[0])
    pos = want[1][:, 0] > 0
    assert np.array_equal(got[1][pos], want[1][pos])
    assert np.array_equal(got[2][pos], want[2][pos])


# ------------------------------------------------------------ the streams

def _withhold_word_planes(m):
    m._cat_words_dev = None
    m._cs_cat_words_dev = None
    return m


class _GatherSpy:
    """Counts the byte gather's calls while active."""

    def __init__(self, mp):
        self.n = 0
        orig = port_sw.window_gather_bytes

        def spy(*a, **k):
            self.n += 1
            return orig(*a, **k)
        for mod in (port_sw, sw_cs):
            mp.setattr(mod, "window_gather_bytes", spy)


@pytest.mark.parametrize("wpr", [None, 0], ids=["fused", "two-phase"])
def test_ls_stream_by_byte_matches_reference(tmp_path, monkeypatch, wpr):
    idx, pidx, recs = _build_ls(tmp_path, n_reads=120)
    want = b"".join(ref_fastpath.map_unpaired_sam_stream(
        RefMapper(idx, MapperConfig()), recs, batch_size=64))
    if wpr is not None:
        monkeypatch.setattr(fastpath, "LS_TWO_PHASE_WPR", wpr)
    spy = _GatherSpy(monkeypatch)
    m = _withhold_word_planes(Mapper(pidx, None, "cpu"))
    got = b"".join(fastpath.map_unpaired_sam_stream(m, recs, batch_size=64))
    assert spy.n > 0 and got == want
    assert ("device full (2ph)" in m.stats.stage_secs) == (wpr == 0)


def test_ls_paired_stream_by_byte_matches_reference(monkeypatch):
    g, recs = make_pairs(5, 60, "opp-in")
    idx, pidx = _paired_indexes(g)
    want = b"".join(ref_fastpath.map_paired_sam_stream(
        RefPairedMapper(idx, MapperConfig(pair_mode="opp-in")), recs,
        batch_size=64, lanes=1))
    spy = _GatherSpy(monkeypatch)
    m = _withhold_word_planes(
        PairedMapper(pidx, PortConfig(pair_mode="opp-in"), "cpu"))
    got = b"".join(fastpath.map_paired_sam_stream(m, recs, batch_size=64,
                                                  lanes=1))
    assert spy.n > 0 and got == want


def test_cs_stream_by_byte_matches_reference(tmp_path, monkeypatch):
    idx, pidx, recs = _build_cs(tmp_path, n_reads=80)
    want = b"".join(ref_fastpath_cs.map_unpaired_cs_sam_stream(
        RefMapper(idx, MapperConfig(mode=CS)), recs, batch_size=40))
    spy = _GatherSpy(monkeypatch)
    m = _withhold_word_planes(Mapper(pidx, PortConfig(mode=CS), "cpu"))
    got = b"".join(fastpath_cs.map_unpaired_cs_sam_stream(m, recs,
                                                          batch_size=40))
    assert spy.n > 0 and got == want


@pytest.mark.parametrize("read_len,n_reads,wpr", [
    (36, 120, None), (36, 120, 0), (250, 24, None)],
    ids=["stats", "stats-two-phase", "traceback"])
def test_ls_stream_unpacked_matches_reference(tmp_path, monkeypatch,
                                              read_len, n_reads, wpr):
    """The LS stream forced onto the unpacked flow (the `_packed_io`
    gate answering False, as for more than 2^16 read rows): [B, 10]
    args, the byte read table, the byte gather."""
    idx, pidx, recs = (_build_long if read_len > 36 else _build_ls)(
        tmp_path, n_reads=n_reads, read_len=read_len)
    want = b"".join(ref_fastpath.map_unpaired_sam_stream(
        RefMapper(idx, MapperConfig()), recs, batch_size=n_reads))
    monkeypatch.setattr(fastpath, "_packed_io", lambda *a: False)
    if wpr is not None:
        monkeypatch.setattr(fastpath, "LS_TWO_PHASE_WPR", wpr)
    seen = []
    orig = fastpath._launch_args

    def spy(win, rows, k, bucket, L_, packed_io):
        seen.append(packed_io)
        return orig(win, rows, k, bucket, L_, packed_io)
    monkeypatch.setattr(fastpath, "_launch_args", spy)
    m = Mapper(pidx, None, "cpu")
    got = b"".join(fastpath.map_unpaired_sam_stream(m, recs,
                                                    batch_size=n_reads))
    assert seen and not any(seen)
    assert got == want
    assert ("device full (2ph)" in m.stats.stage_secs) == (wpr == 0)


# ------------------------------------------------------------ on the card

@pytest.mark.cuda
def test_cuda_byte_steps_match_cpu(steps_case):
    """The byte gather, the unpacked steps and the packed steps without
    a word plane on CUDA tensors equal the same calls on CPU tensors."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    dev = torch.device("cuda", 0)
    fp, rp, win, rtab = steps_case
    un = _args(win, 1800, 2048, False)
    pk4 = _args(win, 1800, 2048, True)
    rtab_pk = fastpath._pack_rtab(rtab)
    calls = (
        (port_sw.sw_vec_full_stats_from_index, (fp, rp, un, rtab), {}),
        (port_sw.sw_vec_full_tb_from_index, (fp, rp, un, rtab), {}),
        (port_sw.sw_vec_full_stats_packed, (fp, rp, pk4, rtab_pk),
         dict(cat_words=None, L=L)),
        (port_sw.sw_vec_full_tb_packed, (fp, rp, pk4, rtab_pk),
         dict(cat_words=None, L=L)))
    for fn, arrays, kw in calls:
        cpu = fn(*_t(*arrays), G=G, **kw, **KW)
        gpu = fn(*(x.to(dev) for x in _t(*arrays)), G=G, **kw, **KW)
        for a, b in zip(cpu if isinstance(cpu, tuple) else (cpu,),
                        gpu if isinstance(gpu, tuple) else (gpu,)):
            assert torch.equal(a, b.cpu()), fn.__name__
