"""Genome seed index: build, save, load.

Copied from `shrimp_tpu/index/build.py`: `SeedIndex`, `GenomeIndex` and
`build_index` with their helpers, with the same vectorized sort-based
CSR build (gmapper/genome.c:1012-1182): for every seed the mapidx of
every valid window start in one pass, then a stable counting sort gives
the inverted index (`offsets`, `positions`), each per-key list
ascending in genome order. Positions are absolute (cumulative across
contigs).

The index files are the reference's (`save`/`load` one .npz,
`save_split`/`load_split` the gmapper -S layout of one genome file and
one file per seed, `save_mmap`/`load_mmap` a directory of raw .npy
arrays), so an index saved by either package loads in the other.
`trim` drops the lists longer than a cutoff before a re-save and unmaps
the hugepage buffers it replaces; `release` unmaps an index's buffers
(`utils/hostmem.py`), which otherwise live for the process.

The host-memory cap (`utils/memmodel.py`) is the reference's:
`build_index` checks the predicted footprint against the cap before it
allocates, and every build or load registers the index's arrays
(`_register_memory`), which `release` and `trim` un-account. The CSR
sort and the key projection run through the port's native library,
which raises if it does not build.
"""
from __future__ import annotations

import ctypes
import glob
import json
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import constants as C
from ..core import encode
from ..native import get_lib
from ..utils import memmodel
from ..utils.hostmem import release as hp_release
from ..utils.hostmem import to_hugepages
from .seeds import Seed, sliding_mapidx, sliding_mapidx_hash


def _force_npz(path: str) -> str:
    """np.savez appends .npz unless present; keep names deterministic."""
    return path if path.endswith(".npz") else path + ".npz"


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

    def _register_memory(self) -> None:
        """Account the index's arrays against the process memory cap
        (my-alloc genomemap counters); release() un-accounts them."""
        tr = memmodel.tracker()
        tracked = []
        for nm in ("codes", "codes_rc", "cs_codes", "cs_codes_rc"):
            a = getattr(self, nm, None)
            if a is not None:
                tr.track(a, "genomemap", nm)
                tracked.append(a)
        for i, si in enumerate(self.seeds):
            tr.track(si.offsets, "genomemap", f"seed{i}_offsets")
            tr.track(si.positions, "genomemap", f"seed{i}_positions")
            tracked += [si.offsets, si.positions]
        self._mem_tracked = tracked

    def release(self) -> None:
        """Drop this index's memory accounting and unmap its hugepage
        buffers (the my_free analogue), so that a chunked build
        (project-db) does not trip the cap on later chunks; the index
        must not be used afterwards. Its planes become None and its seeds
        an empty list, so a later use fails loudly instead of reading
        unmapped pages."""
        tr = memmodel.tracker()
        for a in getattr(self, "_mem_tracked", []):
            tr.untrack(a, "genomemap")
        self._mem_tracked = []
        for si in self.seeds:
            hp_release(si.offsets)
            hp_release(si.positions)
        for nm in ("codes", "codes_rc", "cs_codes", "cs_codes_rc"):
            a = getattr(self, nm, None)
            if a is not None:
                hp_release(a)
            setattr(self, nm, None)
        self.seeds = []

    def _meta(self, **extra) -> dict:
        return dict({"mode": self.mode, "contig_names": self.contig_names,
                     "is_rna": self.is_rna}, **extra, hashed=self.hashed)

    @staticmethod
    def _from_arrays(meta: dict, codes, contig_offsets, contig_lengths,
                     seeds: List[SeedIndex]) -> "GenomeIndex":
        codes = to_hugepages(codes)
        codes_rc = to_hugepages(
            _per_contig_revcomp(codes, contig_offsets, contig_lengths))
        gi = GenomeIndex(
            mode=meta["mode"], contig_names=list(meta["contig_names"]),
            contig_offsets=contig_offsets, contig_lengths=contig_lengths,
            codes=codes, codes_rc=codes_rc, seeds=seeds,
            is_rna=bool(meta["is_rna"]),
            hashed=bool(meta.get("hashed", False)))
        if gi.mode == C.MODE_COLOUR_SPACE:
            gi.build_cs_projection()
        gi._register_memory()
        return gi

    def save(self, path: str) -> None:
        """One .npz: the genome, the contig table, every seed's CSR
        lists and a JSON `meta` record (the analogue of the `.genome` +
        `.seed.N` checkpoint files, genome.c:15-270)."""
        meta = self._meta(seeds=[si.seed.mask_string for si in self.seeds])
        arrays: Dict[str, np.ndarray] = {
            "contig_offsets": self.contig_offsets,
            "contig_lengths": self.contig_lengths,
            "codes": self.codes,
        }
        for i, si in enumerate(self.seeds):
            arrays[f"seed{i}_offsets"] = si.offsets
            arrays[f"seed{i}_positions"] = si.positions
        arrays["meta"] = np.frombuffer(
            json.dumps(meta).encode("utf-8"), dtype=np.uint8)
        np.savez(path, **arrays)

    @staticmethod
    def load(path: str) -> "GenomeIndex":
        with np.load(path) as data:
            meta = json.loads(bytes(data["meta"]).decode("utf-8"))
            codes = data["codes"]
            contig_offsets = data["contig_offsets"]
            contig_lengths = data["contig_lengths"]
            seeds = [SeedIndex(
                seed=Seed(s),
                offsets=to_hugepages(_compact_offsets(
                    data[f"seed{i}_offsets"])),
                positions=to_hugepages(data[f"seed{i}_positions"]))
                for i, s in enumerate(meta["seeds"])]
        return GenomeIndex._from_arrays(meta, codes, contig_offsets,
                                        contig_lengths, seeds)

    def save_split(self, prefix: str) -> None:
        """gmapper -S layout: <prefix>.genome.npz plus one
        <prefix>.seed.N.npz per spaced seed (save_genome_map /
        save_genome_map_seed, genome.c:179-270 / 15-68), which the
        long-form -L seed-subset load reads (README:680-719)."""
        meta = self._meta(n_seeds=len(self.seeds))
        np.savez(_force_npz(prefix + ".genome"),
                 contig_offsets=self.contig_offsets,
                 contig_lengths=self.contig_lengths,
                 codes=self.codes,
                 meta=np.frombuffer(json.dumps(meta).encode(), np.uint8))
        for i, si in enumerate(self.seeds):
            np.savez(_force_npz(f"{prefix}.seed.{i}"),
                     offsets=si.offsets, positions=si.positions,
                     meta=np.frombuffer(json.dumps(
                         {"seed": si.seed.mask_string}).encode(),
                         np.uint8))

    @staticmethod
    def load_split(genome_path: str,
                   seed_paths: Optional[List[str]] = None) -> "GenomeIndex":
        """Load a save_split() index. `seed_paths=None` loads every
        <prefix>.seed.*.npz next to the genome file (short-form -L) and
        raises when fewer are there than were saved; an explicit list
        loads only those projections (long-form `-L
        genome,seed_a,seed_b`, genome.c:670-831)."""
        gp = genome_path
        if not os.path.exists(gp) and os.path.exists(gp + ".npz"):
            gp = gp + ".npz"
        with np.load(gp) as data:
            meta = json.loads(bytes(data["meta"]).decode("utf-8"))
            codes = data["codes"]
            contig_offsets = data["contig_offsets"]
            contig_lengths = data["contig_lengths"]
        if seed_paths is None:
            prefix = re.sub(r"\.genome(\.npz)?$", "", gp)

            def seed_no(p):
                m = re.search(r"\.seed\.(\d+)\.npz$", p)
                return int(m.group(1)) if m else 1 << 30
            seed_paths = sorted(glob.glob(prefix + ".seed.*.npz"),
                                key=seed_no)
            if not seed_paths:
                raise FileNotFoundError(
                    f"no {prefix}.seed.*.npz files next to {gp}")
            want = int(meta.get("n_seeds", len(seed_paths)))
            if len(seed_paths) != want:
                raise FileNotFoundError(
                    f"index {gp} was saved with {want} seeds but only "
                    f"{len(seed_paths)} {prefix}.seed.*.npz files are "
                    "present (partial copy?)")
        seeds = []
        for sp in seed_paths:
            if not os.path.exists(sp) and os.path.exists(sp + ".npz"):
                sp = sp + ".npz"
            with np.load(sp) as sd:
                smeta = json.loads(bytes(sd["meta"]).decode("utf-8"))
                seeds.append(SeedIndex(
                    seed=Seed(smeta["seed"]),
                    offsets=to_hugepages(_compact_offsets(sd["offsets"])),
                    positions=to_hugepages(sd["positions"])))
        return GenomeIndex._from_arrays(meta, codes, contig_offsets,
                                        contig_lengths, seeds)

    def trim(self, cutoff: int) -> int:
        """Drop the inverted lists longer than `cutoff` (trim_genome,
        genome.c:1188-1208): the same as the mapper's list-cutoff skip
        at query time, but it shrinks a re-saved index (-L x -S y -z c,
        gmapper.c:2846-2857). Returns the number of lists dropped."""
        dropped = 0
        tr = memmodel.tracker()
        tracked = getattr(self, "_mem_tracked", [])
        for k, si in enumerate(self.seeds):
            lens = si.list_lengths().astype(np.int64)
            over = lens > cutoff
            n_over = int(over.sum())
            if n_over == 0:
                continue
            dropped += n_over
            new_off = np.zeros(len(si.offsets), dtype=np.int64)
            np.cumsum(np.where(over, 0, lens), out=new_off[1:])
            new_pos = si.positions[np.repeat(~over, lens)]
            # the untrimmed lists' buffers and their accounting go now,
            # not with the process
            for old in (si.offsets, si.positions):
                if any(old is t for t in tracked):
                    tr.untrack(old, "genomemap")
                    tracked = [t for t in tracked if t is not old]
                hp_release(old)
            new_si = SeedIndex(
                seed=si.seed,
                offsets=to_hugepages(_compact_offsets(new_off)),
                positions=to_hugepages(new_pos))
            tr.track(new_si.offsets, "genomemap", f"seed{k}_offsets")
            tr.track(new_si.positions, "genomemap", f"seed{k}_positions")
            tracked += [new_si.offsets, new_si.positions]
            self._mem_tracked = tracked
            self.seeds[k] = new_si
        return dropped

    def save_mmap(self, dirpath: str) -> None:
        """Warm-index image: one raw .npy per array, derived arrays
        (revcomp, CS projection) included, so load_mmap maps pages
        instead of re-reading and re-deriving them (--save-mmap,
        genome.c:290-667)."""
        os.makedirs(dirpath, exist_ok=True)
        meta = self._meta(seeds=[si.seed.mask_string for si in self.seeds])
        with open(os.path.join(dirpath, "meta.json"), "w") as f:
            json.dump(meta, f)
        if self.mode == C.MODE_COLOUR_SPACE and self.cs_codes is None:
            self.build_cs_projection()
        arrays = {
            "contig_offsets": self.contig_offsets,
            "contig_lengths": self.contig_lengths,
            "codes": self.codes,
            "codes_rc": self.codes_rc,
        }
        if self.cs_codes is not None:
            arrays["cs_codes"] = self.cs_codes
            arrays["cs_codes_rc"] = self.cs_codes_rc
        for i, si in enumerate(self.seeds):
            arrays[f"seed{i}_offsets"] = si.offsets
            arrays[f"seed{i}_positions"] = si.positions
        for name, arr in arrays.items():
            np.save(os.path.join(dirpath, name + ".npy"), arr)

    @staticmethod
    def load_mmap(dirpath: str) -> "GenomeIndex":
        """Map a save_mmap image; the OS pages the arrays in lazily
        (genome_load_mmap, genome.c:606-667)."""
        def m(name):
            return np.load(os.path.join(dirpath, name + ".npy"),
                           mmap_mode="r")

        with open(os.path.join(dirpath, "meta.json")) as f:
            meta = json.load(f)
        seeds = [SeedIndex(seed=Seed(s), offsets=m(f"seed{i}_offsets"),
                           positions=m(f"seed{i}_positions"))
                 for i, s in enumerate(meta["seeds"])]
        gi = GenomeIndex(
            mode=meta["mode"], contig_names=list(meta["contig_names"]),
            contig_offsets=np.asarray(m("contig_offsets")),
            contig_lengths=np.asarray(m("contig_lengths")),
            codes=m("codes"), codes_rc=m("codes_rc"), seeds=seeds,
            is_rna=bool(meta["is_rna"]),
            hashed=bool(meta.get("hashed", False)))
        if os.path.exists(os.path.join(dirpath, "cs_codes.npy")):
            gi.cs_codes = m("cs_codes")
            gi.cs_codes_rc = m("cs_codes_rc")
        gi._register_memory()   # memmaps count as 0 (paged by the OS)
        return gi

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
    # the memory cap's pre-check: the predicted footprint from the shared
    # RAM model warns or fails before anything is allocated
    memmodel.tracker().precheck_index(
        int(lengths.sum()), len(seeds),
        max((s.weight for s in seeds), default=0),
        colour_space=(mode == C.MODE_COLOUR_SPACE))
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
    gi._register_memory()
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
