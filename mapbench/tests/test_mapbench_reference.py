"""The NumPy reference against the port's plain CPU path on small
genomes (letter space, long reads, colour space and colour-space pairs
at hg-like repeats), and
its control: the same reference with 8-bit saturating vector scores has
to come out different."""
import sys

import numpy as np
import pytest

from mapbench.gen import hg_bin, iid_genome, reads as greads
from mapbench.reference import common as K, expected_records, pairs


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


# The ten survivors' posteriors, in survivor order, of one `hg-cs.se36`
# read (seed 2147483812, pool entry 32,075), whose top hit gmapper-cs
# writes with MAPQ 149.
POSTERIORS = [0.3199838903658211, 1.9557332412263268e-16,
              5.859604009481391e-17, 5.858076871674328e-17,
              4.939159397600908e-17, 1.2393302757683203e-17,
              1.2393302757683203e-17, 1.2393302757683115e-17,
              1.239330275768338e-17, 1.2393302757683115e-17]


# gmapper's z1 for them: a C double added left to right.
Z1 = 0.3199838903658215


def _hits():
    out = []
    for i, p in enumerate(POSTERIORS):
        h = K.Hit(st=0, gen_st=0, cn=0, g_off=1000 * i, w_len=50,
                  score_window_gen=0, kmer_matches=0, score_vector=200,
                  score_max=360)
        h.score_full, h.pct_score_full = 200, 100 - i
        h.genome_start, h.posterior = 1000 * i, p
        out.append(h)
    return out


def test_mapq_normaliser_is_gmappers_plain_sum():
    """z1 is a double added left to right, as gmapper's C adds it, and not
    Python's `sum()`, which compensates since 3.12: on these posteriors the
    two differ in the last bit and the top hit's MAPQ with them (149, as
    gmapper, the port's CS stream and the port's plain CPU path write; 148
    with `sum()`). With this sum the reference still equals the port's
    CPU path in `test_reference_equals_port_cpu[cs36_hg]` and
    `[cs36_hg_pairs]`, and its control still differs in
    `test_control_fails` on all four cases."""
    want = Z1
    assert K.plain_sum(POSTERIORS) == want
    if sys.version_info >= (3, 12):
        assert want != sum(POSTERIORS)
    survivors = K.finalize(_hits())
    assert [h.posterior for h in survivors] == POSTERIORS
    assert all(h.z1 == want for h in survivors)
    assert survivors[0].mqv == 149
    mates = [K.Read("r/1", "T" + "0" * 35, 35, (), 49),
             K.Read("r/2", "T" + "0" * 35, 35, (), 49)]
    mates[0].final_unpaired_hits = _hits()
    pairs.paired_mqv(mates, [], 100_000_000)
    top = mates[0].final_unpaired_hits
    assert all(h.z1 == want for h in top)
    assert top[0].mqv == 149
