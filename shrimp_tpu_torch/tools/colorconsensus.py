"""Colour-space consensus caller (common/colorconsensus.c — standalone
legacy tool, not in the reference Makefile).

Input (stdin): blocks of ``Contig <name> <len>`` followed by read lines
``<pos> <cs_read> [<qual>]`` where ``cs_read`` is an initial letter plus
colour digits and ``pos`` is 1-based (negative = reverse strand, giving
the position of the read's last covered base negated).  Per contig
position the tool runs a 16-state HMM (states = adjacent letter pairs,
colour = XOR of the letters, colorconsensus.c:61-64), forward-backward
over the observed first-letters and colours, and calls the
maximum-posterior letter when its posterior clears ``conf_level``
(otherwise ``N``), followed by a line of confidence digits
``min(int(-ln(1-p)), 9)``.

The reference iterates states in scalar loops with -log scaling
(do_forwards colorconsensus.c:271-305); here the whole contig is four
numpy [len, 16] passes with per-position normalization — identical
posteriors, since the per-position normalizer cancels every scale
factor.  Letter encoding follows bbmap: T=0, G=1, C=2, A=3
(colorconsensus.c:465-473).

Copied from `shrimp_tpu/tools/colorconsensus.py` unchanged: the port keeps its own
copy of the JAX package's host modules and imports none of them.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import List, Optional, TextIO, Tuple

import numpy as np

DEFAULT_ERROR_RATE = 0.04
DEFAULT_CONF_LEVEL = 0.9

_LETMAP = "TGCA"                       # index -> letter (letmap)
_BB = {c: i for i, c in enumerate(_LETMAP)}
_BB.update({str(i): i for i in range(4)})

_LEFT = np.arange(16) >> 2             # state -> left letter
_RIGHT = np.arange(16) & 3             # state -> right letter
_COLOR = _LEFT ^ _RIGHT                # state -> emitted colour
# trans[k, j] = 1 iff state k can precede state j (right(k) == left(j))
_TRANS = (_RIGHT[:, None] == _LEFT[None, :]).astype(np.float64)


@dataclass
class _Obs:
    """Per-contig emission accumulators (struct column lets/cols)."""
    # -log P(observations | left letter) per (pos, letter)
    let_nll: np.ndarray
    # -log P(observations | colour) per (pos, colour)
    col_nll: np.ndarray

    @classmethod
    def empty(cls, n: int) -> "_Obs":
        return cls(np.zeros((n, 4)), np.zeros((n, 4)))

    def add_letter(self, pos: int, let: int, err: float) -> None:
        hit, miss = -np.log1p(-err), -np.log(err / 3.0)
        self.let_nll[pos] += miss
        self.let_nll[pos, let] += hit - miss

    def add_color(self, pos: int, col: int, err: float) -> None:
        hit, miss = -np.log1p(-err), -np.log(err / 3.0)
        self.col_nll[pos] += miss
        self.col_nll[pos, col] += hit - miss


def _update(obs: _Obs, pos: int, read: str, qual: Optional[str],
            err_rate: float, base_offset: int = 1) -> None:
    """updateStates (colorconsensus.c:319-388): place one CS read's
    first-letter and colour observations on contig coordinates.

    With a quality string the reference indexes it by CONTIG position
    (``qual[base]``, :357,383 — an out-of-range read for any contig
    longer than the string); we index by read position, which is the
    evident intent.
    """
    readlen = len(read) - 1
    first = _BB[read[0]] ^ _BB[read[1]]

    def err(rdpos: int) -> float:
        if qual is None:
            return err_rate
        return 10.0 ** (-(ord(qual[min(rdpos, len(qual) - 1)]) - ord("!"))
                        / 10.0)

    if pos < 0:
        first ^= 3                      # revcomp the derived letter
        base = -pos + readlen - base_offset - 1
    else:
        base = pos - base_offset
    obs.add_letter(base, first, err(1))

    for i in range(2, readlen + 1):
        if pos < 0:
            base = -pos + i - base_offset - 2
            rdpos = readlen - i + 2
        else:
            base = pos + i - 2 - base_offset
            rdpos = i
        obs.add_color(base, _BB[read[rdpos]], err(rdpos))


def _posteriors(obs: _Obs) -> np.ndarray:
    """Forward-backward over the 16-state chain; returns [len, 4]
    per-position letter posteriors (sum over states by left letter)."""
    n = obs.let_nll.shape[0]
    # P_emit[i, j] up to a per-position constant (normalized for range)
    nll = obs.let_nll[:, _LEFT] + obs.col_nll[:, _COLOR]
    emit = np.exp(-(nll - nll.min(axis=1, keepdims=True)))
    fwd = np.empty((n, 16))
    f = emit[0].copy()
    fwd[0] = f / f.sum()
    for i in range(1, n):
        f = emit[i] * (fwd[i - 1] @ _TRANS)
        fwd[i] = f / f.sum()
    bwd = np.empty((n, 16))
    bwd[n - 1] = 1.0 / 16.0
    for i in range(n - 2, -1, -1):
        b = _TRANS @ (emit[i + 1] * bwd[i + 1])
        bwd[i] = b / b.sum()
    post = fwd * bwd
    post /= post.sum(axis=1, keepdims=True)
    out = np.zeros((n, 4))
    for let in range(4):
        out[:, let] = post[:, _LEFT == let].sum(axis=1)
    return out


def call_consensus(n: int, reads: List[Tuple[int, str, Optional[str]]],
                   err_rate: float = DEFAULT_ERROR_RATE,
                   conf_level: float = DEFAULT_CONF_LEVEL
                   ) -> Tuple[str, str]:
    """Consensus + confidence-digit strings for one contig
    (parseContig + post_traceback, colorconsensus.c:136-166,390-458)."""
    obs = _Obs.empty(n)
    for pos, read, qual in reads:
        _update(obs, pos, read, qual, err_rate)
    post = _posteriors(obs)
    best = post.argmax(axis=1)          # ties -> lowest index (T,G,C,A)
    pbest = post[np.arange(n), best]
    letters = np.array(list(_LETMAP))[best]
    letters[pbest <= conf_level] = "N"
    miss = 1.0 - pbest
    digits = np.where(miss > 1e-10,
                      np.minimum(-np.log(np.maximum(miss, 1e-300)),
                                 9).astype(int),
                      9)
    digits = np.clip(digits, 0, 9)
    return "".join(letters), "".join(chr(ord("0") + d) for d in digits)


def main_stream(inp: TextIO, out: TextIO,
                err_rate: float = DEFAULT_ERROR_RATE,
                conf_level: float = DEFAULT_CONF_LEVEL) -> None:
    """Streamed driver over ``Contig`` blocks (main/parseContig)."""
    line = inp.readline()
    while line:
        if "Contig" not in line:
            raise ValueError(f"Parse error {line!r}")
        toks = line.split()
        name, n = toks[1], int(toks[2])
        reads: List[Tuple[int, str, Optional[str]]] = []
        while True:
            line = inp.readline()
            if not line or "Contig" in line:
                break
            toks = line.split()
            if len(toks) < 2:
                raise ValueError(f"Parse error {line!r}")
            reads.append((int(toks[0]), toks[1],
                          toks[2] if len(toks) > 2 else None))
        cons, conf = call_consensus(n, reads, err_rate, conf_level)
        out.write(f"{name} {n}\n{cons}\n{conf}\n")


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="colorconsensus")
    ap.add_argument("-e", "--error-rate", type=float,
                    default=DEFAULT_ERROR_RATE)
    ap.add_argument("-c", "--conf-level", type=float,
                    default=DEFAULT_CONF_LEVEL)
    args = ap.parse_args(argv)
    main_stream(sys.stdin, sys.stdout, args.error_rate, args.conf_level)
    return 0


if __name__ == "__main__":
    sys.exit(main())
