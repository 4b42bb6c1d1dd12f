"""The port's generic mapper (shrimp_tpu_torch.mapper.Mapper.map_unpaired,
on the CPU) must render the same SAM (and SHRiMP-format) bytes as
shrimp_tpu.mapper.Mapper.map_unpaired on the same seeded inputs, for the
configs outside the fast streams' gates; and each device twin the
generic mapper calls must equal the reference function it replaces, at
small shapes. Every output is an integer array or a string: tolerance
0 throughout."""
import numpy as np
import pytest
import torch

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)

from shrimp_tpu import constants as RC
from shrimp_tpu.config import MapperConfig
from shrimp_tpu.core import encode
from shrimp_tpu.core import sw_cs_jax, sw_jax, sw_pallas
from shrimp_tpu.core.sw_np import _join2_rect
from shrimp_tpu.index.build import build_index
from shrimp_tpu.index.seeds import default_seeds, mirna_seeds
from shrimp_tpu.io import sam as ref_sam
from shrimp_tpu.io import shrimp_format as ref_shrimp
from shrimp_tpu.io.fasta import SeqRecord
from shrimp_tpu.mapper import Mapper as RefMapper
from shrimp_tpu_torch.config import MapperConfig as PortConfig
from shrimp_tpu_torch.core import sw_cs, sw_full, sw_vector
from shrimp_tpu_torch.index import build as port_index
from shrimp_tpu_torch.index import seeds as port_seeds
from shrimp_tpu_torch.io import sam as port_sam
from shrimp_tpu_torch.io import shrimp_format as port_shrimp
from shrimp_tpu_torch.mapper import Mapper

from .test_e2e_cs import make_cs_dataset
from .test_e2e_unpaired import make_dataset

CS = RC.MODE_COLOUR_SPACE
# a strict first round that stops only on a >= 92 % hit, then a
# sensitive second round (tests/test_option_sets.py)
DSL_STRICT = "0;1/1,1,1/1,0,2,60.0/1,55.0,90.0,2,0,30/55.0,0,0,10/1,92.0"
DSL_LOOSE = "0;1/1,1,1/1,0,1,40.0/1,35.0,90.0,1,0,40/35.0,0,0,20/0"
# the miRNA preset of the CLI (set_mode_from_string, gmapper.c:1498-1521)
MIRNA = dict(gapless=True, global_alignment=False, anchor_width=0,
             window_len=100.0, match_mode=1,
             compute_mapping_qualities=False)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _quals(recs, seed, offset, cs=False):
    rng = np.random.default_rng(seed)
    return [SeqRecord(r.name, r.seq, "".join(
        chr(offset + int(q)) for q in
        rng.integers(3, 40, len(r.seq) - (1 if cs else 0))))
        for r in recs]


def _mixed(recs, seed):
    """Trim one read in three by 1-6 bases (adapter-trimmed FASTQ)."""
    rng = np.random.default_rng(seed)
    out = []
    for k, r in enumerate(recs):
        cut = int(rng.integers(1, 7)) if k % 3 == 0 else 0
        out.append(SeqRecord(r.name, r.seq[:len(r.seq) - cut],
                             None if r.qual is None
                             else r.qual[:len(r.qual) - cut]))
    return out


def _ls_data(tmp_path, mirna=False, n_reads=90, seed=42):
    _, _, g, reads = make_dataset(str(tmp_path), n_reads=n_reads, seed=seed)
    codes = encode.encode_ls(g)
    seeds = mirna_seeds() if mirna else default_seeds()
    pseeds = port_seeds.mirna_seeds() if mirna else port_seeds.default_seeds()
    idx = build_index([("chr_test", codes)], seeds, hashed=mirna)
    pidx = port_index.build_index([("chr_test", codes)], pseeds,
                                  hashed=mirna)
    return idx, pidx, [SeqRecord(n, s) for n, s in reads]


def _cs_data(tmp_path, n_reads=70):
    _, _, g, reads = make_cs_dataset(str(tmp_path), n_reads=n_reads,
                                     genome_len=20_000)
    codes = encode.encode_ls(g)
    idx = build_index([("chrC", codes)], default_seeds(mode=CS), mode=CS)
    pidx = port_index.build_index([("chrC", codes)],
                                  port_seeds.default_seeds(mode=CS), mode=CS)
    return idx, pidx, [SeqRecord(n, s) for n, s in reads]


def _render(sam_mod, shrimp_mod, results, idx, cfg, fastq, shrimp):
    out = []
    for re_, hits in results:
        for h in hits:
            out.append(shrimp_mod.output_normal(re_, h, idx) if shrimp
                       else sam_mod.render_unpaired(re_, h, idx, cfg,
                                                    fastq=fastq))
        if not hits and cfg.sam_unaligned:
            out.append(sam_mod.render_unpaired(re_, None, idx, cfg,
                                               fastq=fastq))
    return "\n".join(out)


def _both(idx, pidx, recs, cfgkw, shrimp=False):
    """(port text, reference text, port mapper) of map_unpaired."""
    fq = any(r.qual is not None for r in recs)
    ref = RefMapper(idx, MapperConfig(**cfgkw))
    want = _render(ref_sam, ref_shrimp, ref.map_unpaired(recs), idx,
                   ref.config, fq, shrimp)
    m = Mapper(pidx, PortConfig(**cfgkw), "cpu")
    got = _render(port_sam, port_shrimp, m.map_unpaired(recs), pidx,
                  m.config, fq, shrimp)
    return got, want, m


LS_CASES = {
    "default": (dict(), None),
    "mixed-lengths": (dict(), "mixed"),
    "fastq-qv-trims": (dict(trim_front=2, trim_end=1, min_avg_qv=20,
                            sam_unaligned=True), "fastq"),
    "local": (dict(global_alignment=False), "mixed"),
    "two-option-sets": (dict(custom_unpaired_options=(DSL_STRICT,
                                                      DSL_LOOSE)), None),
    "shrimp-format": (dict(shrimp_format=True), "mixed"),
    "gapless-mirna": (MIRNA, None),
}


@pytest.mark.parametrize("case", list(LS_CASES))
def test_ls_generic_sam_matches_reference(tmp_path, case):
    cfgkw, reads = LS_CASES[case]
    idx, pidx, recs = _ls_data(tmp_path, mirna=case == "gapless-mirna")
    if reads == "mixed":
        recs = _mixed(recs, 3)
    elif reads == "fastq":
        recs = _mixed(_quals(recs, 5, 64), 4)
        # a read under the average-quality floor is dropped
        recs[7] = SeqRecord(recs[7].name, recs[7].seq,
                            "B" * len(recs[7].seq))
    got, want, m = _both(idx, pidx, recs, cfgkw,
                         shrimp=cfgkw.get("shrimp_format", False))
    assert got == want
    assert got.count("\n") >= len(recs) // 3
    assert m.stats.reads > 0 and m.stats.vec_invocs > 0
    if case == "two-option-sets":
        assert m.multi_round


CS_CASES = {
    "default": (dict(mode=CS), None),
    "local": (dict(mode=CS, global_alignment=False), "mixed"),
    "gapless": (dict(mode=CS, gapless=True, global_alignment=False), None),
    "fastq": (dict(mode=CS), "fastq"),
}


@pytest.mark.parametrize("case", list(CS_CASES))
def test_cs_generic_sam_matches_reference(tmp_path, case):
    cfgkw, reads = CS_CASES[case]
    idx, pidx, recs = _cs_data(tmp_path)
    if reads == "mixed":
        recs = _mixed(recs, 6)
    elif reads == "fastq":
        # per-read crossover penalties from the qualities
        recs = _quals(recs, 8, 33, cs=True)
    got, want, m = _both(idx, pidx, recs, cfgkw)
    assert got == want
    assert got.count("\n") >= len(recs) // 2
    assert m.stats.full_invocs > 0


def test_stream_api_matches_reference(tmp_path):
    """map_unpaired_stream over several batches equals the reference's
    (whose scores for a few reads depend on the batch, as the port's
    do)."""
    idx, pidx, recs = _ls_data(tmp_path)
    recs = _mixed(recs, 9)

    def hits(results):
        return [(e.name, [(h.cn, h.genome_start, h.score_full) for h in hs])
                for e, hs in results]
    got = hits(Mapper(pidx, PortConfig(), "cpu").map_unpaired_stream(
        recs, batch_size=25))
    want = hits(RefMapper(idx, MapperConfig()).map_unpaired_stream(
        recs, batch_size=25))
    assert got == want and sum(len(h) for _, h in got) > 50


# ------------------------------------------------------------ device twins

def _pairs(rng, B, G, R):
    g = rng.integers(0, 4, (B, G)).astype(np.uint8)
    r = rng.integers(0, 4, (B, R)).astype(np.uint8)
    for k in range(0, B, 2):
        o = int(rng.integers(0, G - R))
        r[k] = g[k, o:o + R]
        r[k, rng.integers(0, R, 2)] = rng.integers(0, 4, 2)
    return g, r


@pytest.mark.parametrize("local", [False, True])
def test_sw_full_and_traceback_matches_reference(local):
    """Anchor bands of the pass-2 hits, and (local) the retry's wide
    threshold band (_join2_rect, mapper.py:1151-1153)."""
    rng = np.random.default_rng(5 + local)
    B, G, R = 24, 64, 40
    g, r = _pairs(rng, B, G, R)
    glen = rng.integers(R, G + 1, B).astype(np.int32)
    rlen = rng.integers(R - 6, R + 1, B).astype(np.int32)
    rect = np.stack([rng.integers(-4, G // 2, B), rng.integers(0, R, B),
                     rng.integers(1, 20, B), rng.integers(3, 20, B)],
                    1).astype(np.int32)
    for b in range(0, B, 3):      # the local retry's band
        y0 = int(rlen[b]) // 3
        rect[b] = _join2_rect((0, y0, 1, 1),
                              (int(glen[b]) - 1, int(rlen[b]) - 1 - y0,
                               1, 1))
    rev = (np.arange(B) % 2).astype(bool)
    kw = dict(match=10, mismatch=-15, a_gap_open=-40, a_gap_ext=-7,
              b_gap_open=-40, b_gap_ext=-7, local_alignment=local)
    want_pk, want_ops = (np.asarray(x) for x in sw_jax.sw_full_and_traceback(
        g, glen, r, rlen, rect[:, 0], rect[:, 1], rect[:, 2], rect[:, 3],
        rev, use_pallas=False, **kw))
    t = torch.from_numpy
    pk, ops = sw_full.sw_full_and_traceback(
        t(g), t(glen), t(r), t(rlen), *(t(rect[:, c].copy())
                                        for c in range(4)),
        t(rev.astype(np.int32)), **kw)
    pk, ops = pk.numpy(), ops.numpy()
    live = want_pk[:, 0] > 0
    assert live.sum() >= B // 3
    # rows of a positive score walk identical paths; a zero-score row's
    # walk starts from a cell whose backpointers the XLA formulation
    # keeps only to within the NEG floor
    assert (pk[live] == want_pk[live]).all()
    assert (ops[live] == want_ops[live]).all()
    assert (pk[:, 0] == want_pk[:, 0]).all()


def test_sw_vector_from_index_matches_reference():
    rng = np.random.default_rng(7)
    n, B, G, R = 5000, 40, 64, 40
    kw = dict(match=10, mismatch=-15, a_gap_open=-40, a_gap_ext=-7,
              b_gap_open=-40, b_gap_ext=-7)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    gstart = rng.integers(-10, n - 100, B).astype(np.int64)
    gstart[:3] = (n - 5, n - 30, 0)       # tails past the plane clip
    glen = rng.integers(20, G + 1, B).astype(np.int32)
    owner = rng.integers(0, 9, B).astype(np.int32)
    # rows 10-18 hold reads copied from their windows
    rtab = rng.integers(0, 4, (9, R)).astype(np.uint8)
    for j in range(9):
        rtab[j] = codes[gstart[10 + j] + 4:gstart[10 + j] + 4 + R]
        owner[10 + j] = j
    rtab[3, 30:] = 254
    rlen = rng.integers(20, R + 1, B).astype(np.int32)
    want = np.asarray(sw_pallas.sw_vector_ls_from_index(
        codes, gstart, glen, rtab, owner, rlen, G=G, use_pallas=False,
        **kw))
    t = torch.from_numpy
    got = sw_vector.sw_vector_ls_from_index(
        t(codes), t(gstart), t(glen), t(rtab), t(owner), t(rlen), G=G, **kw)
    assert (got.numpy() == want).all() and want.max() > 100

    # colour space: four planes, strand flags, initbp
    planes = [rng.integers(0, 4, n).astype(np.uint8) for _ in range(4)]
    eff_rc = rng.integers(0, 2, B).astype(np.int32)
    initbp = rng.integers(0, 4, B).astype(np.int32)
    ckw = dict(kw, mismatch=kw["match"] - 20)
    want = np.asarray(sw_pallas.sw_vector_cs_from_index(
        *planes, gstart, glen, eff_rc, rtab, owner, rlen, initbp, G=G,
        use_pallas=False, **ckw))
    got = sw_vector.sw_vector_cs_from_index(
        *(t(p) for p in planes), t(gstart), t(glen), t(eff_rc), t(rtab),
        t(owner), t(rlen), t(initbp), G=G, **ckw)
    assert (got.numpy() == want).all()


@pytest.mark.parametrize("local,taboo", [(False, 0), (True, 4)])
def test_sw_full_cs_dispatch_matches_reference(local, taboo):
    """The CS chunk launch and fetch, with per-read crossover rows whose
    last column is the row -1 crossover (gx_col)."""
    rng = np.random.default_rng(11 + local)
    B, G, R = 20, 64, 40
    g = rng.integers(0, 4, (B, G)).astype(np.uint8)
    colours = rng.integers(0, 4, (B, R)).astype(np.uint8)
    for k in range(0, B, 2):
        o = int(rng.integers(0, G - R - 1))
        colours[k] = encode.ls_to_cs(g[k, o:o + R + 1])[1:]
        colours[k, rng.integers(0, R)] = RC.BASE_N
    glen = rng.integers(R + 4, G + 1, B)
    rlen = rng.integers(R - 4, R + 1, B)
    initbp = rng.integers(0, 4, B)
    rect = np.stack([rng.integers(0, G // 2, B), rng.integers(0, R, B),
                     rng.integers(1, 16, B), rng.integers(3, 16, B)], 1)
    rev = (np.arange(B) % 2).astype(bool)
    xo = rng.integers(-40, -1, (B, R + 1))
    thresh = rng.integers(0, 200, B)
    kw = dict(match=10, mismatch=-24, a_gap_open=-33, a_gap_ext=-7,
              b_gap_open=-33, b_gap_ext=-7, local_alignment=local,
              indel_taboo_len=taboo)
    args = (g, glen, colours, rlen, initbp, rect[:, 0], rect[:, 1],
            rect[:, 2], rect[:, 3], rev, xo, thresh)
    want = sw_cs_jax.sw_full_cs_finish(sw_cs_jax.sw_full_cs_dispatch(
        *args, **kw))
    got = sw_cs.sw_full_cs_finish(sw_cs.sw_full_cs_dispatch(
        *args, device=torch.device("cpu"), **kw))
    assert (want.score > 0).sum() >= B // 4
    for f in ("score", "steps", "n_steps", "read_start", "genome_start",
              "rmapped", "gmapped", "matches", "mismatches", "insertions",
              "deletions", "crossovers", "qr"):
        assert (np.asarray(getattr(got, f))
                == np.asarray(getattr(want, f))).all(), f
