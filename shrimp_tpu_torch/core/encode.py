"""Sequence encoding: char <-> 4-bit code arrays, revcomp, colour space.

Unlike SHRiMP2's 2-bases-per-byte bitfields (common/util.h:41), we keep one
4-bit code per byte (uint8 numpy array): gathers on TPU/host are cheaper than
bit twiddling and memory is not the bottleneck at these genome sizes.

Behavioral reference:
- fasta_sequence_to_bitfield  common/fasta.c:610-668
- reverse_complement_read_ls  common/util.c:541-...
- reverse_complement_read_cs  common/util.c:580-616
- bitfield_to_colourspace     common/fasta.c:587-606

Copied from `shrimp_tpu/core/encode.py` unchanged: the port keeps its
own copy of the JAX package's host modules and imports none of them.
"""
from __future__ import annotations

import numpy as np

from .. import constants as C


def encode_ls(seq: str) -> np.ndarray:
    """Letter-space string -> uint8 code array. Raises on invalid chars."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    codes = C.CHAR_TO_INT[raw]
    if (codes < 0).any():
        bad = chr(raw[int(np.argmax(codes < 0))])
        raise ValueError(f"invalid character {bad!r} in sequence")
    return codes.astype(np.uint8)


def encode_cs(seq: str) -> tuple[int, np.ndarray]:
    """Colour-space read string -> (initial base code, colour code array).

    The first char must be a concrete initial base A/C/G/T
    (fasta.c:625-637); remaining chars are colours 0-3 / N / X / '.'.
    """
    init = C.CHAR_TO_INT[ord(seq[0])]
    if not (0 <= init <= 3):
        raise ValueError(f"invalid colour-space initial base {seq[0]!r}")
    raw = np.frombuffer(seq[1:].encode("ascii"), dtype=np.uint8)
    codes = C.CHAR_TO_INT[raw]
    if (codes < 0).any():
        raise ValueError("invalid character in colour-space sequence")
    return int(init), codes.astype(np.uint8)


def decode_ls(codes: np.ndarray) -> str:
    return C.LS_INT_TO_CHAR[codes].tobytes().decode("ascii")


def revcomp_ls(codes: np.ndarray) -> np.ndarray:
    """Reverse complement (wobble codes included; util.c:541)."""
    return C.COMPLEMENT[codes[::-1]]


def ls_to_cs(codes: np.ndarray, first: int = C.BASE_T) -> np.ndarray:
    """Letter-space codes -> colour codes, colour[i] = mat[prev, cur].

    The genome projection starts from an implicit BASE_T
    (bitfield_to_colourspace, fasta.c:591 `lastbp = BASE_T`).
    """
    prev = np.empty_like(codes)
    prev[0] = first
    prev[1:] = codes[:-1]
    return C.COLOUR_MAT[prev, codes]


def revcomp_cs(colours: np.ndarray, initbp: int, initbp_rc: int,
               ) -> np.ndarray:
    """Reverse complement of a colour-space read (util.c:580-616).

    Colours are strand-invariant, so the body is just reversed; the first
    colour is recomputed from the original initial base via the sequence end.
    Following reverse_complement_read_cs: result[0] =
    lstocs(base_at_end, complement(initbp_rc)) where base_at_end is the last
    letter of the decoded read; result[1:] = reversed colours[1:].
    """
    n = len(colours)
    out = np.empty_like(colours)
    # decode final letter of read
    cur = initbp
    for c in colours:
        cur = _cstols(cur, int(c))
    out[1:] = colours[:0:-1]
    out[0] = C.COLOUR_MAT[cur, C.COMPLEMENT[initbp_rc]] \
        if cur <= 3 else C.BASE_N
    return out


def _cstols(first_letter: int, colour: int) -> int:
    """util.h:157-180."""
    if first_letter == C.BASE_N or not (0 <= colour <= 3):
        return C.BASE_N
    if first_letter % 2 == 0:
        return (4 + first_letter + colour) % 4
    return (4 + first_letter - colour) % 4
