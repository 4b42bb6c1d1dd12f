"""Reads drawn from the genome (the read generators of
`shrimp_tpu_torch/dataset.py`, made from the run's seed).

A pool of `pool_reads` reads (pairs, where `insert` is given) at
uniform positions outside N gaps, every odd one from the reverse
strand. Letter space: `read_len` bases with 0..`max_errors`
substitutions; every `indel_every`-th read (if set) also carries an
insertion or a deletion of 1-3 bp. Colour space: a `T` primer and
`read_len` colours of the letters, with 0..`max_errors` colour errors.
Pairs (`insert: [lo, hi]`): opp-in mates of one fragment of lo..hi-1
bp, errors drawn for each mate.
"""
from __future__ import annotations

import numpy as np

BASE_N = 15
_LETTERS = np.frombuffer(b"ACGTN", np.uint8)
_COLOURS = np.frombuffer(b"0123", np.uint8)


def _clear_of_n(rng, genome, span, n, lo_pad=0):
    """n starts p with genome[p - lo_pad, p + span) free of N."""
    npos = np.flatnonzero(genome == BASE_N)
    hi = len(genome) - span
    p = rng.integers(lo_pad, hi, n)
    while len(npos):
        k = np.searchsorted(npos, p - lo_pad)
        bad = (k < len(npos)) & (npos[np.minimum(k, len(npos) - 1)]
                                 < p + span)
        if not bad.any():
            break
        p[bad] = rng.integers(lo_pad, hi, int(bad.sum()))
    return p


def _errors(rng, mat, max_errors, alphabet=4):
    """0..max_errors random replacements a row, in place."""
    n, L = mat.shape
    nerr = rng.integers(0, max_errors + 1, n)
    for j in range(max_errors):
        rows = np.flatnonzero(nerr > j)
        mat[rows, rng.integers(0, L, len(rows))] = rng.integers(
            0, alphabet, len(rows), dtype=np.uint8)


def _letters(rng, genome, starts, read_len, indel_every):
    """[n, read_len] letters from `starts`, with the indel reads."""
    span = read_len + 3
    src = genome[starts[:, None] + np.arange(span)]
    mat = src[:, :read_len].copy()
    if indel_every:
        for k in range(indel_every - 1, len(starts), indel_every):
            d = int(rng.integers(1, 4))
            cut = int(rng.integers(20, read_len - 20))
            if rng.integers(0, 2):      # deletion: skip d genome bases
                mat[k, cut:] = src[k, cut + d:read_len + d]
            else:                       # insertion of d random bases
                mat[k, cut + d:] = src[k, cut:read_len - d]
                mat[k, cut:cut + d] = rng.integers(0, 4, d)
    return mat


def _render(rng, lets, mode, max_errors):
    """Rows of letters -> read strings (bytes), errors applied."""
    if mode == "ls":
        _errors(rng, lets, max_errors)
        return [r.tobytes() for r in _LETTERS[lets]]
    cols = np.empty_like(lets)
    cols[:, 0] = 3 ^ lets[:, 0]
    cols[:, 1:] = lets[:, :-1] ^ lets[:, 1:]
    _errors(rng, cols, max_errors)
    return [b"T" + r.tobytes() for r in _COLOURS[cols]]


def make(params: dict, mode: str, genome: np.ndarray,
         rng: np.random.Generator):
    """The pool: a list of read strings, or of (mate 1, mate 2) pairs."""
    n = int(params["pool_reads"])
    L = int(params["read_len"])
    maxe = int(params["max_errors"])
    if "insert" not in params:
        starts = _clear_of_n(rng, genome, L + 3, n)
        lets = _letters(rng, genome, starts, L,
                        int(params.get("indel_every", 0)))
        odd = np.arange(n) % 2 == 1
        lets[odd] = 3 - lets[odd, ::-1]
        return _render(rng, lets, mode, maxe)
    lo, hi = params["insert"]
    isz = rng.integers(lo, hi, n)
    starts = _clear_of_n(rng, genome, int(hi), n)
    m1 = genome[starts[:, None] + np.arange(L)]
    m2 = genome[(starts + isz - L)[:, None] + np.arange(L)]
    m2 = 3 - m2[:, ::-1]
    r1 = _render(rng, m1, mode, maxe)
    r2 = _render(rng, m2, mode, maxe)
    return list(zip(r1, r2))
