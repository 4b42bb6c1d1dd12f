"""Genome seed index: build.

Copied from `shrimp_tpu/index/build.py`: `SeedIndex`, `GenomeIndex` and
`build_index` with their helpers, with the same vectorized sort-based
CSR build (gmapper/genome.c:1012-1182): for every seed the mapidx of
every valid window start in one pass, then a stable counting sort gives
the inverted index (`offsets`, `positions`), each per-key list
ascending in genome order. Positions are absolute (cumulative across
contigs).

Left out of the copy: saving and loading index files, `trim`, and the
host-memory cap accounting (`utils/memmodel.py`: a pre-build footprint
check and per-array counters that change no array). The CSR sort and
the key projection run through the port's native library, which raises
if it does not build.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from .. import constants as C
from ..core import encode
from ..native import get_lib
from ..utils.hostmem import to_hugepages
from .seeds import Seed, sliding_mapidx, sliding_mapidx_hash


@dataclass
class SeedIndex:
    """CSR inverted index for one spaced seed."""
    seed: Seed
    offsets: np.ndarray    # int64 [4^weight + 1]
    positions: np.ndarray  # uint32 [total], absolute kmer-start coords

    def list_lengths(self) -> np.ndarray:
        return np.diff(self.offsets)


@dataclass
class GenomeIndex:
    mode: str
    contig_names: List[str]
    contig_offsets: np.ndarray   # uint32 [n_contigs], absolute start
    contig_lengths: np.ndarray   # uint32 [n_contigs]
    codes: np.ndarray            # uint8 [total_len], forward strand
    codes_rc: np.ndarray         # uint8 [total_len], per-contig revcomp
    seeds: List[SeedIndex]
    is_rna: bool = False
    # colour-space projection of the concatenated genome (built lazily for CS)
    cs_codes: Optional[np.ndarray] = None
    cs_codes_rc: Optional[np.ndarray] = None
    hashed: bool = False  # -H: 24-bit hashed mapidx (gmapper.h:323-338)

    @property
    def max_seed_span(self) -> int:
        return max(si.seed.span for si in self.seeds)

    @property
    def total_len(self) -> int:
        return int(self.codes.shape[0])

    @property
    def n_contigs(self) -> int:
        return len(self.contig_names)

    def contig_of(self, pos: np.ndarray) -> np.ndarray:
        """Contig number for absolute positions (replaces gen_st_search,
        common/gen-st.c, with a vectorized searchsorted)."""
        return np.searchsorted(self.contig_offsets, pos, side="right") - 1

    def auto_list_cutoff(self) -> int:
        """cutoff = max(1000, 100 * L / 4^max_weight) (gmapper.c:2830-2834);
        hashed mode uses the hash table power (gmapper.c:2820-2828)."""
        max_w = (C.HASH_TABLE_POWER if self.hashed
                 else max(si.seed.weight for si in self.seeds))
        return max(1000, int((100 * self.total_len) // (4 ** max_w)))

    def build_cs_projection(self) -> None:
        """Per-contig colour-space projection (genome.c:1116-1126)."""
        self.cs_codes = _per_contig_cs(self.codes, self.contig_offsets,
                                       self.contig_lengths)
        self.cs_codes_rc = _per_contig_cs(self.codes_rc, self.contig_offsets,
                                          self.contig_lengths)


def _compact_offsets(offsets: np.ndarray) -> np.ndarray:
    """CSR offsets as uint32 when they fit (they always do: positions
    are uint32 genome coordinates, so the total count < 2^32). Halves
    the random-lookup footprint of the per-kmer tables."""
    if offsets.dtype == np.uint32:
        return offsets
    if len(offsets) == 0 or int(offsets[-1]) < (1 << 32):
        return offsets.astype(np.uint32)
    return offsets


def _per_contig_revcomp(codes: np.ndarray, offsets: np.ndarray,
                        lengths: np.ndarray) -> np.ndarray:
    out = np.empty_like(codes)
    for o, l in zip(offsets, lengths):
        out[o:o + l] = encode.revcomp_ls(codes[o:o + l])
    return out


def _per_contig_cs(codes: np.ndarray, offsets: np.ndarray,
                   lengths: np.ndarray) -> np.ndarray:
    out = np.empty_like(codes)
    for o, l in zip(offsets, lengths):
        out[o:o + l] = encode.ls_to_cs(codes[o:o + l])
    return out


def build_index(contigs: Sequence[tuple], seeds: Sequence[Seed],
                mode: str = C.MODE_LETTER_SPACE, is_rna: bool = False,
                hashed: bool = False) -> GenomeIndex:
    """Build a GenomeIndex from [(name, codes_uint8), ...].

    Matches load_genome (genome.c:1012-1182): windows containing N/X are
    skipped; for colour space the index is built over the CS projection of
    the forward genome.
    """
    names = [n for n, _ in contigs]
    lengths = np.array([len(c) for _, c in contigs], dtype=np.uint32)
    offsets = np.zeros(len(contigs), dtype=np.uint32)
    if len(contigs) > 1:
        offsets[1:] = np.cumsum(lengths[:-1],
                                dtype=np.uint64).astype(np.uint32)
    codes = (np.concatenate([c for _, c in contigs])
             if contigs else np.zeros(0, np.uint8))
    codes_rc = _per_contig_revcomp(codes, offsets, lengths)

    gi = GenomeIndex(mode=mode, contig_names=names, contig_offsets=offsets,
                     contig_lengths=lengths, codes=codes, codes_rc=codes_rc,
                     seeds=[], is_rna=is_rna, hashed=hashed)
    if mode == C.MODE_COLOUR_SPACE:
        gi.build_cs_projection()
        indexed = gi.cs_codes
    else:
        indexed = codes

    max_span = max(s.span for s in seeds)
    for seed in seeds:
        seed.validate(hashed=hashed)
        all_keys = []
        all_pos = []
        for o, l in zip(offsets, lengths):
            cseq = indexed[o:o + l]
            n = int(l) - seed.span + 1
            if n <= 0:
                continue
            keys = (sliding_mapidx_hash(cseq, seed, max_span) if hashed
                    else _sliding_keys(cseq, seed))
            # exclude windows containing N/X (genome.c:1145-1147);
            # N-free contigs (the common case) skip the window scan
            if not (cseq == C.BASE_N).any():
                all_keys.append(keys)
                all_pos.append((np.arange(n, dtype=np.uint32)
                                + np.uint32(o)))
                continue
            isn = (cseq == C.BASE_N).astype(np.int32)
            cum = np.concatenate([[0], np.cumsum(isn)])
            bad = (cum[seed.span:] - cum[:-seed.span]) > 0
            starts = np.nonzero(~bad)[0]
            all_keys.append(keys[starts])
            all_pos.append((starts + int(o)).astype(np.uint32))
        if all_keys:
            keys = np.concatenate(all_keys)
            pos = np.concatenate(all_pos)
        else:
            keys = np.zeros(0, np.uint32)
            pos = np.zeros(0, np.uint32)
        n_mapidx = (4 ** C.HASH_TABLE_POWER if hashed else seed.n_mapidx)
        csr_offsets, sorted_pos = _csr_sort(keys, pos, n_mapidx)
        csr_offsets = to_hugepages(_compact_offsets(csr_offsets))
        sorted_pos = to_hugepages(sorted_pos)
        gi.seeds.append(SeedIndex(seed=seed, offsets=csr_offsets,
                                  positions=sorted_pos))
    return gi


def _sliding_keys(cseq: np.ndarray, seed: Seed) -> np.ndarray:
    """sliding_mapidx, through the threaded native kernel for contigs of
    2^16 windows and more (the reference's size switch)."""
    n = len(cseq) - seed.span + 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint32)
    if n < (1 << 16):
        return sliding_mapidx(cseq, seed)
    cc = np.ascontiguousarray(cseq, np.uint8)
    offs = np.ascontiguousarray(seed.offsets, np.int32)
    out = np.empty(n, np.uint32)
    get_lib().spaced_keys(ctypes.c_void_p(cc.ctypes.data), ctypes.c_int64(n),
                          ctypes.c_void_p(offs.ctypes.data),
                          ctypes.c_int32(len(offs)),
                          ctypes.c_void_p(out.ctypes.data), ctypes.c_int32(0))
    return out


def _csr_sort(keys: np.ndarray, pos: np.ndarray, n_mapidx: int):
    """(keys, positions) -> CSR (offsets, sorted positions), per-key
    lists ascending in genome order: the native parallel counting sort
    (native/csrsort.cpp), O(n + K)."""
    if not len(keys):
        return np.zeros(n_mapidx + 1, np.int64), np.zeros(0, np.uint32)
    k32 = np.ascontiguousarray(keys, np.uint32)
    p32 = np.ascontiguousarray(pos, np.uint32)
    offsets = np.zeros(n_mapidx + 1, np.int64)
    out_pos = np.empty(len(keys), np.uint32)
    rv = get_lib().csr_counting_sort(
        ctypes.c_void_p(k32.ctypes.data), ctypes.c_void_p(p32.ctypes.data),
        ctypes.c_int64(len(keys)), ctypes.c_int64(n_mapidx),
        ctypes.c_void_p(offsets.ctypes.data),
        ctypes.c_void_p(out_pos.ctypes.data), ctypes.c_int32(0))
    if rv != 0:
        raise RuntimeError(f"csr_counting_sort failed ({rv})")
    return offsets, out_pos
