"""The port's two-phase dispatch (vector SW on every window, then the full
SW on the pass-1 survivors only) against the JAX package, on the CPU:
the `phase="vec"` and `phase="full"` outputs of the device steps against
the JAX functions with the same phase, and the SAM bytes of the LS and
CS streams with the gate forced, or firing by itself on a repeat-dense
genome, against `shrimp_tpu`'s streams and the port's fused runs.
Tolerance 0 throughout (int32 scores and SAM bytes). The `cuda` cases
hold the kernels at the two-phase shapes on the card and skip without
one."""
import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from shrimp_tpu import constants as RC
from shrimp_tpu import fastpath as ref_fastpath
from shrimp_tpu import fastpath_cs as ref_fastpath_cs
from shrimp_tpu.config import MapperConfig
from shrimp_tpu.core import sw_jax
from shrimp_tpu.core.sw_cs_jax import \
    sw_vec_cs_full_from_index as ref_vec_cs_full
from shrimp_tpu.index.build import build_index
from shrimp_tpu.index.seeds import default_seeds
from shrimp_tpu.io.fasta import SeqRecord
from shrimp_tpu.mapper import Mapper as RefMapper
from shrimp_tpu_torch import fastpath, fastpath_cs
from shrimp_tpu_torch.config import MapperConfig as PortConfig
from shrimp_tpu_torch.core import sw as port_sw
from shrimp_tpu_torch.core import sw_cs, sw_vector
from shrimp_tpu_torch.core.sw import cat_word_plane
from shrimp_tpu_torch.core.encode import decode_ls
from shrimp_tpu_torch.index import build as port_index
from shrimp_tpu_torch.index import seeds as port_seeds
from shrimp_tpu_torch.mapper import Mapper

from .test_torch_fastpath import _build as _build_ls
from .test_torch_fastpath_cs import _build as _build_cs
from .test_torch_sw import KW, _packed_case, _small_index
from .test_torch_sw_cs import KW as CS_KW
from .test_torch_sw_cs import XOVER, _cs_fused_case, _cs_planes

CS = RC.MODE_COLOUR_SPACE
NEVER = 1 << 30      # a threshold no batch reaches: the fused dispatch


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ------------------------------------------------------- the device steps

@pytest.fixture(scope="module")
def ls_case():
    idx = _small_index()
    codes = RefMapper._pad_plane(idx.codes)
    codes_rc = RefMapper._pad_plane(idx.codes_rc)
    cat = np.asarray(RefMapper(idx)._dev_cat_words())
    args, rtab_pk = _packed_case(11, codes, codes_rc, 64, 36, 2048, 1800)
    return codes, codes_rc, args, rtab_pk, cat


@pytest.mark.parametrize("phase", ["vec", "full"])
def test_stats_step_phases_match_jax(ls_case, phase):
    """sw_vec_full_stats_packed: "vec" gives the int16 vector scores
    alone, "full" the [B, 3] stats rows with the vec field zero."""
    kw = dict(G=64, L=36, **KW)
    (want,) = sw_jax.sw_vec_full_stats_packed(
        *ls_case, use_pallas=False, interpret=True, phase=phase, **kw)
    want = np.asarray(want)
    got = port_sw.sw_vec_full_stats_packed(*_t(*ls_case), phase=phase,
                                           **kw)
    if phase == "vec":
        (got,) = got
        assert got.dtype == torch.int16 and (want > 100).sum() >= 64
    else:
        assert (want[:, 0] & 0xFFFF == 0).all()
        assert ((want[:, 0] >> 16) > 0).sum() >= 64
    assert np.array_equal(got.numpy(), want)
    fused = port_sw.sw_vec_full_stats_packed(*_t(*ls_case), **kw).numpy()
    if phase == "vec":
        assert np.array_equal(fused[:, 0] & 0xFFFF, want)
    else:
        assert np.array_equal(fused[:, 1:], want[:, 1:])


@pytest.mark.parametrize("phase", ["vec", "full"])
def test_tb_step_phases_match_jax(ls_case, phase):
    """sw_vec_full_tb_packed: "vec" gives (vec,), "full" (packed, ops);
    rows and ops compared where the score is positive (the XLA DP's
    backpointers may differ below -2^26, tests/test_full_pallas.py)."""
    kw = dict(G=64, L=36, **KW)
    want = [np.asarray(x) for x in sw_jax.sw_vec_full_tb_packed(
        *ls_case, use_pallas=False, phase=phase, **kw)]
    got = [x.numpy() for x in port_sw.sw_vec_full_tb_packed(
        *_t(*ls_case), phase=phase, **kw)]
    assert len(got) == len(want) == (1 if phase == "vec" else 2)
    if phase == "vec":
        assert got[0].dtype == np.int16
        assert np.array_equal(got[0], want[0])
        return
    pos = want[0][:, 0] > 0
    assert pos.sum() >= 64
    assert np.array_equal(got[0][:, 0], want[0][:, 0])
    assert np.array_equal(got[0][pos], want[0][pos])
    assert np.array_equal(got[1][pos], want[1][pos])


@pytest.mark.parametrize("phase", ["vec", "full"])
def test_cs_step_phases_match_jax(phase):
    """sw_vec_cs_full_from_index: "vec" gives (vec,), "full" (packed,
    steps_rev), each equal to the JAX function's and to the fused
    call's."""
    planes = _cs_planes(7, 30_000)
    cats = (cat_word_plane(*planes[:2]), cat_word_plane(*planes[2:]))
    args, rtab, qr, xov = _cs_fused_case(11, planes, 64, 36, 2048, 1800)
    kw = dict(CS_KW, G=64, xover=XOVER, indel_taboo_len=4)
    want = [np.asarray(x) for x in ref_vec_cs_full(
        *planes, args, rtab, qr, xov, *cats, phase=phase, **kw)]
    got = [x.numpy() for x in sw_cs.sw_vec_cs_full_from_index(
        *_t(*planes, args, rtab, qr, xov, *cats), phase=phase, **kw)]
    assert len(got) == len(want) == (1 if phase == "vec" else 2)
    for w, x in zip(want, got):
        assert x.dtype == w.dtype and np.array_equal(x, w)
    fused = [x.numpy() for x in sw_cs.sw_vec_cs_full_from_index(
        *_t(*planes, args, rtab, qr, xov, *cats), **kw)]
    for w, x in zip(fused[:1] if phase == "vec" else fused[1:], got):
        assert np.array_equal(x, w)
    with pytest.raises(ValueError, match="phase"):
        sw_cs.sw_vec_cs_full_from_index(
            *_t(*planes, args, rtab, qr, xov, *cats), phase="both", **kw)


# ------------------------------------------------------------- LS streams

def _port_ls(pidx, recs, batch_size, wpr, monkeypatch, cfg=None):
    """(SAM bytes, mapper) of the port's LS stream at two-phase
    threshold `wpr` windows per read."""
    monkeypatch.setattr(fastpath, "LS_TWO_PHASE_WPR", wpr)
    m = Mapper(pidx, cfg, "cpu")
    gen = fastpath.map_unpaired_sam_stream(m, recs, batch_size=batch_size)
    return b"".join(gen), m


def _ref_ls(idx, recs, batch_size, tp_env, monkeypatch):
    """SAM bytes of shrimp_tpu's LS stream under its own two-phase knob
    (set for the JAX side only)."""
    monkeypatch.setenv("SHRIMP_TPU_LS_TWO_PHASE", tp_env)
    try:
        return b"".join(ref_fastpath.map_unpaired_sam_stream(
            RefMapper(idx, MapperConfig()), recs, batch_size=batch_size))
    finally:
        monkeypatch.delenv("SHRIMP_TPU_LS_TWO_PHASE")


@pytest.mark.parametrize("dskw,batch_size,stats_flow", [
    (dict(n_reads=150, seed=3), 64, True),
    (dict(n_reads=16, read_len=250, genome_len=20_000), 16, False),
    (dict(n_reads=24, read_len=600, genome_len=20_000), 12, False),
], ids=["36bp-stats-flow", "250bp-traceback-flow", "600bp-traceback-flow"])
def test_ls_two_phase_forced_matches_reference(tmp_path, monkeypatch, dskw,
                                               batch_size, stats_flow):
    """The gate forced open (threshold 0): the port's SAM equals
    shrimp_tpu's two-phase SAM and the port's fused run; phase B ran and
    counted its full-SW rows, no more than the windows."""
    idx, pidx, recs = _build_ls(tmp_path, **dskw)
    fused, m0 = _port_ls(pidx, recs, batch_size, NEVER, monkeypatch)
    got, m = _port_ls(pidx, recs, batch_size, 0, monkeypatch)
    assert "device full (2ph)" in m.stats.stage_secs
    assert "device full (2ph)" not in m0.stats.stage_secs
    assert got == fused
    assert got == _ref_ls(idx, recs, batch_size, "1", monkeypatch)
    assert m.stats.vec_invocs == m0.stats.vec_invocs
    assert 0 < m.stats.full_invocs <= m0.stats.full_invocs
    # windows are 140 % of the read, padded to 32 columns
    G = -(-int(len(recs[0].seq) * 1.4) // 32) * 32
    assert fastpath._stats_flow_enabled(G) is stats_flow


def _dense_codes(slen=1_000_000, seed=777):
    """A genome with SINE-like 300 bp copies (5-25 % divergence) on a
    quarter of it, as in tests/test_fastpath_paired.py: tens of
    candidate windows per 36 bp read."""
    rng = np.random.default_rng(seed)
    sine = np.random.default_rng(3).integers(0, 4, 300).astype(np.uint8)
    codes = rng.integers(0, 4, slen, dtype=np.int64).astype(np.uint8)
    n_sine = int(0.25 * slen) // 300
    starts = rng.integers(0, slen - 300, n_sine)
    cp = np.tile(sine, (n_sine, 1))
    div = rng.uniform(0.05, 0.25, n_sine)
    msk = rng.random((n_sine, 300)) < div[:, None]
    cp[msk] = rng.integers(0, 4, int(msk.sum()),
                           dtype=np.int64).astype(np.uint8)
    codes[(starts[:, None] + np.arange(300)[None, :]).ravel()] = cp.ravel()
    return codes, rng


@pytest.fixture(scope="module")
def dense_ls():
    """(reference index, port index, reads) on the dense genome: 160
    reads of 36 bp, 0-2 substitutions, odd reads reverse-complemented."""
    codes, rng = _dense_codes()
    comp = np.array([3, 2, 1, 0], np.uint8)
    recs = []
    for k in range(160):
        p = int(rng.integers(0, len(codes) - 36))
        r = codes[p:p + 36].copy()
        for _ in range(int(rng.integers(0, 3))):
            r[int(rng.integers(36))] = rng.integers(4)
        if k % 2:
            r = comp[r[::-1]]
        recs.append(SeqRecord(f"d{k}", decode_ls(r)))
    idx = build_index([("dense", codes)], default_seeds())
    pidx = port_index.build_index([("dense", codes)],
                                  port_seeds.default_seeds())
    return idx, pidx, recs


def test_ls_gate_fires_on_dense_genome(dense_ls, monkeypatch):
    """At the default threshold the dense genome's batches take the
    two-phase dispatch by themselves; the SAM equals shrimp_tpu's (its
    gate also on "auto") and the port's fused run."""
    idx, pidx, recs = dense_ls
    got, m = _port_ls(pidx, recs, 80, fastpath.LS_TWO_PHASE_WPR,
                      monkeypatch)
    assert m.stats.vec_invocs / m.stats.reads >= fastpath.LS_TWO_PHASE_WPR
    assert "device full (2ph)" in m.stats.stage_secs
    fused, _ = _port_ls(pidx, recs, 80, NEVER, monkeypatch)
    assert got == fused
    assert got == _ref_ls(idx, recs, 80, "auto", monkeypatch)
    assert got.count(b"\n") >= len(recs) // 2


def test_vec_launch_row_ladder():
    """Above FULL_BUCKETS[-1] the vec-only launch pads to 5/8, 3/4 or all
    of the next power of two, as the reference's dispatch does
    (shrimp_tpu/fastpath.py:332-338)."""
    for k, want in ((32_769, 40_960), (40_961, 49_152), (49_153, 65_536),
                    (2_400_000, 2_621_440), (3_000_000, 3_145_728),
                    (3_200_000, 4_194_304), (1 << 22, 1 << 22)):
        assert fastpath._chunk_bucket(k, fastpath.LS_VEC_BATCH) == want, k
    assert fastpath._chunk_bucket(32_768, fastpath.LS_VEC_BATCH) == 32_768
    assert fastpath.LS_VEC_BATCH == 1 << 22
    assert fastpath.LS_TWO_PHASE_WPR == ref_fastpath.LS_TWO_PHASE_WPR


# ------------------------------------------------------------- CS streams

def _port_cs(pidx, recs, batch_size, wpr, monkeypatch):
    monkeypatch.setattr(fastpath_cs, "CS_TWO_PHASE_WPR", wpr)
    m = Mapper(pidx, PortConfig(mode=CS), "cpu")
    gen = fastpath_cs.map_unpaired_cs_sam_stream(m, recs,
                                                 batch_size=batch_size)
    return b"".join(gen), m


def _ref_cs(idx, recs, batch_size, tp_env, monkeypatch):
    monkeypatch.setenv("SHRIMP_TPU_CS_TWO_PHASE", tp_env)
    try:
        return b"".join(ref_fastpath_cs.map_unpaired_cs_sam_stream(
            RefMapper(idx, MapperConfig(mode=CS)), recs,
            batch_size=batch_size))
    finally:
        monkeypatch.delenv("SHRIMP_TPU_CS_TWO_PHASE")


def test_cs_two_phase_forced_matches_reference(tmp_path, monkeypatch):
    idx, pidx, recs = _build_cs(tmp_path, n_reads=60)
    fused, m0 = _port_cs(pidx, recs, 30, NEVER, monkeypatch)
    got, m = _port_cs(pidx, recs, 30, 0, monkeypatch)
    assert "device full (2ph)" in m.stats.stage_secs
    assert got == fused
    assert got == _ref_cs(idx, recs, 30, "1", monkeypatch)
    assert m.stats.vec_invocs == m0.stats.vec_invocs
    assert 0 < m.stats.full_invocs <= m0.stats.full_invocs


def test_cs_gate_fires_on_dense_genome(monkeypatch):
    codes, rng = _dense_codes()
    cm = RC.COLOUR_MAT
    recs = []
    for k in range(60):
        p = int(rng.integers(0, len(codes) - 38))
        lets = codes[p:p + 37].copy()
        for _ in range(int(rng.integers(0, 3))):
            lets[int(rng.integers(37))] = rng.integers(4)
        cols = [int(cm[3, lets[0]])] + [int(cm[lets[i], lets[i + 1]])
                                        for i in range(35)]
        recs.append(SeqRecord(f"c{k}", "T" + "".join(
            str(c) if c <= 3 else "." for c in cols)))
    idx = build_index([("dense", codes)], default_seeds(mode=CS), mode=CS)
    pidx = port_index.build_index([("dense", codes)],
                                  port_seeds.default_seeds(mode=CS), mode=CS)
    got, m = _port_cs(pidx, recs, 60, fastpath_cs.CS_TWO_PHASE_WPR,
                      monkeypatch)
    assert m.stats.vec_invocs / m.stats.reads >= fastpath_cs.CS_TWO_PHASE_WPR
    assert "device full (2ph)" in m.stats.stage_secs
    assert got == _ref_cs(idx, recs, 60, "auto", monkeypatch)
    assert got.count(b"\n") >= len(recs) // 2


# ------------------------------------------------------------ on the card

@pytest.mark.cuda
def test_cuda_vec_launch_at_four_million_rows():
    """The vector SW at the vec-only launch's largest shapes: 2^22 rows
    at G = 64, and 2^21 at G = 256 (b * G past 2^29, thread ids past
    2^26), bit-equal to the plain version on a 65,536-row slice at each
    end of the launch."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(4)
    for B, G, R in (((1 << 22), 64, 40), ((1 << 21), 256, 40)):
        g = torch.from_numpy(rng.integers(0, 4, (B, G), dtype=np.uint8))
        r = g[:, 3:3 + R].clone()
        r[:, ::7] = 2
        glen = torch.from_numpy(rng.integers(1, G + 1, B).astype(np.int32))
        rlen = torch.full((B,), R, dtype=torch.int32)
        got = sw_vector.sw_vector_batch(*(x.to(dev) for x in (g, glen, r,
                                                              rlen)), **KW)
        for sl in (slice(0, 1 << 16), slice(B - (1 << 16), B)):
            want = sw_vector.sw_vector_batch_ref(g[sl], glen[sl], r[sl],
                                                 rlen[sl], **KW)
            assert torch.equal(got[sl].cpu(), want)


@pytest.mark.cuda
def test_cuda_cs_phase_b_at_131072_rows():
    """CS phase B at 131,072 rows (int16 backpointers [B, 36, 4, 64],
    2.4 GB): the full phase on the card equals the CPU run on the same
    rows."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    dev = torch.device("cuda", 0)
    planes = _cs_planes(7, 30_000)
    cats = (cat_word_plane(*planes[:2]), cat_word_plane(*planes[2:]))
    B = 131_072
    args, rtab, qr, xov = _cs_fused_case(11, planes, 64, 36, B, B - 1000)
    kw = dict(CS_KW, G=64, xover=XOVER, phase="full")
    inputs = _t(*planes, args, rtab, qr, xov, *cats)
    got = sw_cs.sw_vec_cs_full_from_index(*(x.to(dev) for x in inputs),
                                          **kw)
    want = sw_cs.sw_vec_cs_full_from_index(
        *(x[:4096] if i == 4 else x for i, x in enumerate(inputs)), **kw)
    for x, w in zip(got, want):
        assert torch.equal(x[:4096].cpu(), w)
