"""Baselines the paper compares against (counterpart of
`repro.core.baselines`).

  * ALTO [Helal et al., ICS'21] — linearized coordinate order: every nonzero
    keyed by a bit-interleaved (Morton-like) linearization of its coords and
    processed in that order.  `alto_order` is a numpy copy that returns the
    reference's permutation for every shape, including those past 64 key
    bits, where the int64 key's top bits land on the sign or vanish as they
    do in the reference.
  * Plain COO ("BLCO-like" GPU style) — unsorted atomic scatter-add.

Both compute `mttkrp_coo`'s result up to summation order; they differ in
memory access structure.
"""
from __future__ import annotations

import numpy as np

from .mttkrp import mttkrp_coo

__all__ = ["alto_order", "mttkrp_alto", "mttkrp_plain_coo"]


def alto_order(coords: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """ALTO linearization: interleave the bits of each mode's coordinate,
    mode-major round-robin over the bits each mode actually needs (adaptive —
    modes with fewer bits drop out early, as in the ALTO paper)."""
    n = len(shape)
    bits = [max(1, int(np.ceil(np.log2(max(s, 2))))) for s in shape]
    maxbits = max(bits)
    key = np.zeros(coords.shape[0], dtype=np.int64)
    pos = 0
    for b in range(maxbits):
        for m in range(n):
            if b < bits[m]:
                key |= ((coords[:, m].astype(np.int64) >> b) & 1) << pos
                pos += 1
    return np.argsort(key, kind="stable")


# In torch the reference's sorted `segment_sum` and its unsorted scatter-add
# are the same `index_add_` (rows outside [0, out_dim) dropped), so both
# baselines are `mttkrp_coo`; they differ only in the order of the nonzeros
# they are given (`alto_order` for ALTO).
mttkrp_alto = mttkrp_coo
mttkrp_plain_coo = mttkrp_coo
