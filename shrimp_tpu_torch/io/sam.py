"""SAM text helpers the port's streams need outside the native
renderers.

Copied from `shrimp_tpu/io/sam.py` (`_pair_qname` only): the port keeps
its own copy of the JAX package's host modules and imports none of
them.
"""
from __future__ import annotations


def _pair_qname(name: str, mate_name: str) -> str:
    """Longest common prefix, trailing ':' or '/' stripped
    (output.c:372-385)."""
    i = 0
    n = min(len(name), len(mate_name))
    while i < n and name[i] == mate_name[i]:
        i += 1
    if i > 0 and name[i - 1] in ":/":
        i -= 1
    return name[:i]
