"""Batched host-side traceback over packed backpointer tensors.

Equivalent of do_backtrace (common/sw-full-ls.c:413-516) run as a
vectorized-over-batch numpy walk: every step advances all alignments one
cell, so the python loop length is bounded by R+G, not by batch size.

Copied from `shrimp_tpu/core/traceback.py` unchanged: the port keeps its own
copy of the JAX package's host modules and imports none of them.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .sw_np import (BACK_DELETION, BACK_INSERTION, BACK_MATCH_MISMATCH,
                    FROM_NORTH_NORTH, FROM_NORTH_NORTHWEST,
                    FROM_NORTHWEST_NORTH, FROM_NORTHWEST_NORTHWEST,
                    FROM_NORTHWEST_WEST, FROM_WEST_NORTHWEST, FROM_WEST_WEST)

# nibble -> FROM code tables per plane (must match sw_jax packing)
_NW_DECODE = np.array([0, FROM_NORTHWEST_NORTHWEST, FROM_NORTHWEST_NORTH,
                       FROM_NORTHWEST_WEST], np.int8)
_N_DECODE = np.array([0, FROM_NORTH_NORTH, FROM_NORTH_NORTHWEST, 0], np.int8)
_W_DECODE = np.array([0, FROM_WEST_WEST, FROM_WEST_NORTHWEST, 0], np.int8)

# FROM code -> plane to follow next (0=nw, 1=w, 2=n); sw-full-ls.c:475-507
_NEXT_PLANE = np.zeros(8, np.int8)
_NEXT_PLANE[FROM_NORTH_NORTH] = 2
_NEXT_PLANE[FROM_NORTH_NORTHWEST] = 0
_NEXT_PLANE[FROM_WEST_WEST] = 1
_NEXT_PLANE[FROM_WEST_NORTHWEST] = 0
_NEXT_PLANE[FROM_NORTHWEST_NORTH] = 2
_NEXT_PLANE[FROM_NORTHWEST_NORTHWEST] = 0
_NEXT_PLANE[FROM_NORTHWEST_WEST] = 1


def unpack_ops(packed: np.ndarray) -> np.ndarray:
    """Expand the device's 4-per-byte 2-bit op packing (sw_jax
    _sw_full_tb_jit); trailing pad ops decode as 0 and are masked by
    n_ops in from_device."""
    B, n4 = packed.shape
    out = np.empty((B, n4 * 4), np.int8)
    out[:, 0::4] = packed & 3
    out[:, 1::4] = (packed >> 2) & 3
    out[:, 2::4] = (packed >> 4) & 3
    out[:, 3::4] = (packed >> 6) & 3
    return out


def from_device(ops_rev: np.ndarray, n_ops: np.ndarray, read_start,
                genome_start, rmapped_end_i, rmapped_end_j, matches,
                mismatches, insertions, deletions) -> "TracebackResult":
    """Assemble a TracebackResult from on-device traceback outputs
    (sw_jax.sw_full_and_traceback); only the op order reversal happens
    here."""
    B, maxsteps = ops_rev.shape
    n_ops = n_ops.astype(np.int64)
    k = n_ops[:, None]
    idx = np.arange(maxsteps)[None, :]
    src = np.clip(k - 1 - idx, 0, maxsteps - 1)
    ops = np.where(idx < k, ops_rev[np.arange(B)[:, None], src], 0
                   ).astype(np.int8)
    read_start = read_start.astype(np.int64)
    genome_start = genome_start.astype(np.int64)
    rmapped = rmapped_end_i.astype(np.int64) - read_start + 1
    gmapped = rmapped_end_j.astype(np.int64) - genome_start + 1
    return TracebackResult(ops, n_ops, read_start, genome_start, rmapped,
                           gmapped, matches.astype(np.int64),
                           mismatches.astype(np.int64),
                           insertions.astype(np.int64),
                           deletions.astype(np.int64))


@dataclass
class TracebackResult:
    ops: np.ndarray          # [B, R+G] int8 BACK_* codes in alignment order
    n_ops: np.ndarray        # [B]
    read_start: np.ndarray   # [B]
    genome_start: np.ndarray  # [B]
    rmapped: np.ndarray
    gmapped: np.ndarray
    matches: np.ndarray
    mismatches: np.ndarray
    insertions: np.ndarray   # genome-only steps (CIGAR D)
    deletions: np.ndarray    # read-only steps (CIGAR I)


def _decode(bp_val: np.ndarray, plane: np.ndarray) -> np.ndarray:
    """Unpack the `plane` nibble of a packed backpointer byte -> FROM code."""
    nw = _NW_DECODE[bp_val & 3]
    w = _W_DECODE[(bp_val >> 4) & 3]
    n = _N_DECODE[(bp_val >> 2) & 3]
    return np.where(plane == 0, nw, np.where(plane == 1, w, n)).astype(np.int8)


def traceback_batch(bp: np.ndarray, max_i: np.ndarray, max_j: np.ndarray,
                    start_plane: np.ndarray, genome: np.ndarray,
                    read: np.ndarray) -> TracebackResult:
    B, R, G = bp.shape
    maxsteps = R + G
    bidx = np.arange(B)

    i = max_i.astype(np.int64).copy()
    j = max_j.astype(np.int64).copy()
    frm = _decode(bp[bidx, i, j], start_plane.astype(np.int8))

    ops_rev = np.zeros((B, maxsteps), np.int8)
    read_start = np.zeros(B, np.int64)
    genome_start = np.zeros(B, np.int64)
    matches = np.zeros(B, np.int64)
    mismatches = np.zeros(B, np.int64)
    insertions = np.zeros(B, np.int64)
    deletions = np.zeros(B, np.int64)
    n_ops = np.zeros(B, np.int64)

    active = (frm != 0) & (i >= 0) & (j >= 0)
    for step in range(maxsteps):
        if not active.any():
            break
        is_n = active & ((frm == FROM_NORTH_NORTH)
                         | (frm == FROM_NORTH_NORTHWEST))
        is_w = active & ((frm == FROM_WEST_WEST)
                         | (frm == FROM_WEST_NORTHWEST))
        is_nw = active & (frm >= FROM_NORTHWEST_NORTH)

        ops_rev[:, step] = np.where(
            is_n, BACK_DELETION,
            np.where(is_w, BACK_INSERTION,
                     np.where(is_nw, BACK_MATCH_MISMATCH, 0)))
        deletions += is_n
        insertions += is_w
        eq = genome[bidx, np.clip(j, 0, G - 1)] == read[bidx,
                                                        np.clip(i, 0, R - 1)]
        matches += is_nw & eq
        mismatches += is_nw & ~eq
        read_start = np.where(is_n | is_nw, i, read_start)
        genome_start = np.where(is_w | is_nw, j, genome_start)
        n_ops += active

        i = i - (is_n | is_nw)
        j = j - (is_w | is_nw)

        nxt = _NEXT_PLANE[np.clip(frm, 0, 7)]
        inb = active & (i >= 0) & (j >= 0)
        bp_val = bp[bidx, np.clip(i, 0, R - 1), np.clip(j, 0, G - 1)]
        frm_new = np.where(inb, _decode(bp_val, nxt), 0).astype(np.int8)
        active = inb & (frm_new != 0)
        frm = frm_new

    # reverse per-row into alignment order (vectorized)
    k = n_ops[:, None]
    idx = np.arange(maxsteps)[None, :]
    src = np.clip(k - 1 - idx, 0, maxsteps - 1)
    ops = np.where(idx < k, ops_rev[bidx[:, None], src], 0).astype(np.int8)

    rmapped = max_i.astype(np.int64) - read_start + 1
    gmapped = max_j.astype(np.int64) - genome_start + 1
    return TracebackResult(ops, n_ops, read_start, genome_start, rmapped,
                           gmapped, matches, mismatches, insertions,
                           deletions)
