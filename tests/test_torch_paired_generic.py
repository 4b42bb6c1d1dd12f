"""The port's generic paired mapper (shrimp_tpu_torch.paired.PairedMapper:
map_paired, the paired MQVs, select_output, on the CPU) must render the
same SAM bytes as shrimp_tpu.paired.PairedMapper on the same seeded
pairs, LS and CS, with mixed read lengths and the output-selection
options; and the insert-size histogram of the port's CLI must count the
same pairs. Tolerance 0 throughout."""
import numpy as np
import pytest
import torch

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)

from shrimp_tpu import cli as ref_cli
from shrimp_tpu import constants as RC
from shrimp_tpu.config import MapperConfig
from shrimp_tpu.core import encode
from shrimp_tpu.index.build import build_index
from shrimp_tpu.index.seeds import default_seeds
from shrimp_tpu.io import sam as ref_sam
from shrimp_tpu.io.fasta import SeqRecord
from shrimp_tpu.paired import PairedMapper as RefPairedMapper
from shrimp_tpu_torch import cli as port_cli
from shrimp_tpu_torch.config import MapperConfig as PortConfig
from shrimp_tpu_torch.index import build as port_index
from shrimp_tpu_torch.index import seeds as port_seeds
from shrimp_tpu_torch.io import sam as port_sam
from shrimp_tpu_torch.paired import PairedMapper

from .test_e2e_paired import make_paired_dataset
from .test_torch_fastpath_cs_paired import cs_pairs

CS = RC.MODE_COLOUR_SPACE


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _indexes(codes, mode="ls"):
    return (build_index([("chrP", codes)], default_seeds(mode=mode),
                        mode=mode),
            port_index.build_index([("chrP", codes)],
                                   port_seeds.default_seeds(mode=mode),
                                   mode=mode))


def _mixed(recs, seed):
    """Trim mate 2 of one pair in four by 1-5 bases."""
    rng = np.random.default_rng(seed)
    out = list(recs)
    for k in range(1, len(out), 8):
        r = out[k]
        cut = int(rng.integers(1, 6))
        out[k] = SeqRecord(r.name, r.seq[:len(r.seq) - cut],
                           None if r.qual is None
                           else r.qual[:len(r.qual) - cut])
    return out


def _render(sam_mod, mapper, pairs, idx, fastq):
    out = []
    for pe in pairs:
        p_out, u_out = mapper.select_output(pe)
        out.extend(sam_mod.render_pair_entry(pe, idx, mapper.config, p_out,
                                             u_out, fastq=fastq))
    return "\n".join(out)


def _both(idx, pidx, recs, **cfgkw):
    """(port text, reference text, port pairs, reference pairs)."""
    fq = any(r.qual is not None for r in recs)
    ref = RefPairedMapper(idx, MapperConfig(**cfgkw))
    rpairs = ref.map_paired(recs)
    want = _render(ref_sam, ref, rpairs, idx, fq)
    m = PairedMapper(pidx, PortConfig(**cfgkw), "cpu")
    pairs = m.map_paired(recs)
    got = _render(port_sam, m, pairs, pidx, fq)
    return got, want, pairs, rpairs


LS_CASES = {
    "opp-in-mixed": (dict(pair_mode="opp-in"), True),
    "col-fw": (dict(pair_mode="col-fw"), False),
    "single-best-all-contigs": (dict(pair_mode="opp-in",
                                     single_best_mapping=True,
                                     all_contigs=True), True),
    "sam-unaligned-trims": (dict(pair_mode="opp-in", sam_unaligned=True,
                                 trim_end=2, trim_first=True,
                                 trim_second=True), False),
}


@pytest.mark.parametrize("case", list(LS_CASES))
def test_ls_pairs_match_reference(tmp_path, case):
    cfgkw, mixed = LS_CASES[case]
    _, _, g, reads = make_paired_dataset(str(tmp_path), n_pairs=40,
                                         mode=cfgkw["pair_mode"])
    idx, pidx = _indexes(encode.encode_ls(g))
    recs = [SeqRecord(n, s) for n, s in reads]
    if mixed:
        recs = _mixed(recs, 4)
    got, want, pairs, _ = _both(idx, pidx, recs, **cfgkw)
    assert got == want
    # (col-fw: half the pairs of this dataset have their mates swapped)
    assert sum(pe.mapped for pe in pairs) >= len(pairs) // 3


@pytest.mark.parametrize("fastq", [False, True])
def test_cs_pairs_match_reference(fastq):
    g, recs = cs_pairs(12, 30, "opp-in")
    idx, pidx = _indexes(g, CS)
    if fastq:
        rng = np.random.default_rng(2)
        recs = [SeqRecord(r.name, r.seq, "".join(
            chr(33 + int(q)) for q in rng.integers(3, 41, len(r.seq) - 1)))
            for r in recs]
    recs = _mixed(recs, 5)
    got, want, pairs, _ = _both(idx, pidx, recs, mode=CS,
                                pair_mode="opp-in")
    assert got == want
    assert sum(pe.mapped for pe in pairs) >= len(pairs) // 2


def test_insert_histogram_matches_reference(tmp_path):
    """-X: the port's InsertHistogram over the port's pairs counts what
    the reference's counts over its own, and prints the same text."""
    import io
    _, _, g, reads = make_paired_dataset(str(tmp_path), n_pairs=40)
    idx, pidx = _indexes(encode.encode_ls(g))
    recs = [SeqRecord(n, s) for n, s in reads]
    _, _, pairs, rpairs = _both(idx, pidx, recs, pair_mode="opp-in")
    cfg = PortConfig(pair_mode="opp-in")
    hp = port_cli.InsertHistogram(cfg.min_insert_size, cfg.max_insert_size)
    hr = ref_cli.InsertHistogram(cfg.min_insert_size, cfg.max_insert_size)
    for pe in pairs:
        hp.add_pair_entry(pe)
    for pe in rpairs:
        hr.add_pair_entry(pe)
    assert hp.total == hr.total > 0 and hp.hist == hr.hist
    op, orf = io.StringIO(), io.StringIO()
    hp.print(op)
    hr.print(orf)
    assert op.getvalue() == orf.getvalue()
