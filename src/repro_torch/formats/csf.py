"""CSF (Compressed Sparse Fiber) mode trees, a numpy copy of
`repro.formats.csf` that builds byte-identical trees.

SPLATT-style CSF compresses a sparse tensor into one tree per MTTKRP output
mode: the output mode is the root level, the remaining modes are interior
levels, and the innermost level holds the leaf coordinates.  Every group of
nonzeros sharing a root+interior prefix is a *fiber* — the unit of factor-row
reuse: during MTTKRP the interior factor rows are fetched once per fiber
instead of once per nonzero.

This module builds the host-side (numpy) tree; the torch op consuming it is
`repro_torch.core.mttkrp.mttkrp_csf` (two reductions over sorted indices:
nonzeros → fibers → output rows).  Trees are built once per (tensor, mode)
and cached by `repro_torch.formats.convert.FormatCache`.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..core.sptensor import SparseTensor

__all__ = [
    "CSFModeTree",
    "build_csf_tree",
    "csf_index_bytes",
    "csf_mode_order",
    "csf_to_coo",
    "fiber_count",
]


def csf_index_bytes(nnz: int, ndim: int, n_fibers: int) -> int:
    """Bytes a mode tree's index structure occupies — leaf coordinates +
    fiber membership (nnz·2·4) plus fiber prefix coordinates
    (n_fibers·(ndim-1)·4).  Single source for both the real layout
    (`CSFModeTree.index_bytes`) and `FormatStats`."""
    return 4 * (nnz * 2 + n_fibers * (ndim - 1))


def csf_mode_order(shape: tuple[int, ...], mode: int) -> tuple[int, tuple[int, ...], int]:
    """Tree level order for the mode-`mode` CSF tree: ``(root, mids, inner)``.

    The root is the output mode (its coordinate addresses the output row);
    the innermost level is the largest remaining mode — pushing the longest
    axis to the leaves minimizes the fiber count, i.e. maximizes how many
    nonzeros share each interior factor-row fetch.  Deterministic ties by
    mode index."""
    others = [m for m in range(len(shape)) if m != mode]
    if not others:
        raise ValueError("CSF needs at least 2 modes")
    inner = max(others, key=lambda m: (shape[m], m))
    mids = tuple(m for m in others if m != inner)
    return mode, mids, inner


@dataclasses.dataclass(frozen=True)
class CSFModeTree:
    """One mode's fiber tree, flattened to rectangular arrays.

    Nonzeros are sorted lexicographically by (root, mids..., inner)
    coordinate, so both `fiber_ids` and the fibers' root coordinates are
    non-decreasing.

    perm         — (nnz,) position of each tree-ordered nonzero in the
                   source COO arrays (coords/values round-trip through it).
    inner_coord  — (nnz,) int32 leaf-level coordinate.
    values       — (nnz,) f32, tree order.
    fiber_ids    — (nnz,) int32 fiber of each nonzero, sorted.
    fiber_coords — (n_fibers, N) int32 prefix coordinates of each fiber
                   (the inner column is 0 — a fiber has no leaf coordinate).
    """

    mode: int
    inner_mode: int
    mid_modes: tuple[int, ...]
    perm: np.ndarray
    inner_coord: np.ndarray
    values: np.ndarray
    fiber_ids: np.ndarray
    fiber_coords: np.ndarray
    shape: tuple[int, ...]

    @property
    def nnz(self) -> int:
        return self.values.shape[0]

    @property
    def n_fibers(self) -> int:
        return self.fiber_coords.shape[0]

    @property
    def index_bytes(self) -> int:
        """What the cost model charges as `indexed` traffic."""
        return csf_index_bytes(self.nnz, len(self.shape), self.n_fibers)


def build_csf_tree(st: SparseTensor, mode: int) -> CSFModeTree:
    """Sort the nonzeros into mode-`mode` tree order and delimit fibers."""
    root, mids, inner = csf_mode_order(st.shape, mode)
    prefix = (root, *mids)
    # np.lexsort: last key is most significant → (root, mids..., inner).
    keys = [st.coords[:, inner], *(st.coords[:, m] for m in reversed(prefix))]
    perm = np.lexsort(tuple(keys)).astype(np.int64)
    coords_s = st.coords[perm]

    if st.nnz == 0:
        new_fiber = np.zeros(0, dtype=bool)
    else:
        prev = coords_s[:-1][:, list(prefix)]
        cur = coords_s[1:][:, list(prefix)]
        new_fiber = np.concatenate([[True], (prev != cur).any(axis=1)])
    fiber_ids = (np.cumsum(new_fiber) - 1).astype(np.int32)
    fiber_coords = np.zeros((int(new_fiber.sum()), st.ndim), dtype=np.int32)
    if fiber_coords.shape[0]:
        starts = np.flatnonzero(new_fiber)
        fiber_coords[:, list(prefix)] = coords_s[starts][:, list(prefix)]

    return CSFModeTree(
        mode=mode, inner_mode=inner, mid_modes=mids,
        perm=perm,
        inner_coord=coords_s[:, inner].astype(np.int32),
        values=st.values[perm].astype(np.float32),
        fiber_ids=fiber_ids,
        fiber_coords=fiber_coords,
        shape=st.shape,
    )


def csf_to_coo(tree: CSFModeTree) -> SparseTensor:
    """Invert the tree back to COO (nonzeros come back in tree order; the
    coordinate/value multiset — and therefore `to_dense()` — is preserved
    exactly)."""
    coords = tree.fiber_coords[tree.fiber_ids].copy()
    coords[:, tree.inner_mode] = tree.inner_coord
    return SparseTensor(coords.astype(np.int32), tree.values.copy(), tree.shape)


def fiber_count(st: SparseTensor, mode: int) -> int:
    """Number of fibers the mode-`mode` tree has, without building it:
    distinct (root, mids...) coordinate prefixes."""
    root, mids, _inner = csf_mode_order(st.shape, mode)
    prefix = [root, *mids]
    if st.nnz == 0:
        return 0
    if math.prod(st.shape[m] for m in prefix) < (1 << 62):
        lin = np.zeros(st.nnz, dtype=np.int64)
        for m in prefix:
            lin = lin * st.shape[m] + st.coords[:, m]
        return int(np.unique(lin).size)
    return int(np.unique(st.coords[:, prefix], axis=0).shape[0])
