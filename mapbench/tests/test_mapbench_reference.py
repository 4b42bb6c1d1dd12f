"""The NumPy reference against the port's plain CPU path on small
genomes (letter space, long reads, colour space and colour-space pairs
at hg-like repeats), and
its control: the same reference with 8-bit saturating vector scores has
to come out different."""
import numpy as np
import pytest

from mapbench.gen import hg_bin, iid_genome, reads as greads
from mapbench.reference import expected_records


@pytest.fixture(autouse=True)
def _no_hugepages(monkeypatch):
    from shrimp_tpu_torch.utils import hostmem
    monkeypatch.setattr(hostmem, "to_hugepages", lambda a: a)


def _port_sam(genome, pool, mode, insert=None):
    from shrimp_tpu_torch import fastpath, fastpath_cs
    from shrimp_tpu_torch.config import MapperConfig
    from shrimp_tpu_torch.index.build import build_index
    from shrimp_tpu_torch.index.seeds import default_seeds
    from shrimp_tpu_torch.io.fasta import SeqRecord
    from shrimp_tpu_torch.mapper import Mapper
    from shrimp_tpu_torch.paired import PairedMapper
    idx = build_index([("c", genome)], default_seeds(mode=mode), mode=mode)
    if insert is not None:
        m = PairedMapper(idx, MapperConfig(
            mode=mode, pair_mode="opp-in", min_insert_size=insert[0],
            max_insert_size=insert[1]), "cpu")
        recs = [SeqRecord(f"{i}/{k + 1}", p[k].decode())
                for i, p in enumerate(pool) for k in (0, 1)]
        stream = fastpath_cs.map_paired_cs_sam_stream
    else:
        m = Mapper(idx, MapperConfig(mode=mode), "cpu")
        recs = [SeqRecord(str(i), s.decode()) for i, s in enumerate(pool)]
        stream = (fastpath.map_unpaired_sam_stream if mode == "ls"
                  else fastpath_cs.map_unpaired_cs_sam_stream)
    got = [[] for _ in pool]
    for chunk in stream(m, recs, batch_size=4096):
        for line in chunk.decode().splitlines():
            q, rest = line.split("\t", 1)
            got[int(q)].append(rest)
    return got


CASES = {
    "ls36": ("ls", "iid", 200_000, dict(read_len=36, max_errors=2), 60),
    "ls250": ("ls", "iid", 200_000, dict(read_len=250, max_errors=4,
                                         indel_every=10), 20),
    "cs36_hg": ("cs", "hg", 1_000_000, dict(read_len=36, max_errors=2), 40),
    "cs36_hg_pairs": ("cs", "hg", 1_000_000, dict(
        read_len=36, max_errors=2, insert=[100, 300],
        insert_range=[0, 1000]), 24),
}


def _case(name, seed=5):
    mode, kind, L, tr, n = CASES[name]
    rng = np.random.default_rng(seed)
    if kind == "hg":
        g = hg_bin.make({"length": L, "sine_share": .25, "line_share": .15,
                         "sat_share": .05, "n_share": .015}, rng)
    else:
        g = iid_genome.make({"length": L}, rng)
    tr = dict(tr, pool_reads=n)
    pool = greads.make(tr, mode, g, np.random.default_rng(seed + 1))
    return mode, g, tr, pool


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_equals_port_cpu(name):
    mode, g, tr, pool = _case(name)
    want = expected_records({"mode": mode, "contig": "c"}, tr, g, pool)
    assert sum(len(w) for w in want) >= len(pool) * 0.9
    assert _port_sam(g, pool, mode, tr.get("insert_range")) == want


@pytest.mark.parametrize("name", sorted(CASES))
def test_control_fails(name):
    mode, g, tr, pool = _case(name)
    cfg = {"mode": mode, "contig": "c"}
    want = expected_records(cfg, tr, g, pool)
    ctl = expected_records(cfg, tr, g, pool, control=True)
    differ = sum(a != b for a, b in zip(want, ctl))
    assert differ >= len(pool) // 2
