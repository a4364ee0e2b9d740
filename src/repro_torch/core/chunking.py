"""The PRISM chunked tensor format (paper §IV-A) and task packing, a numpy
copy of `repro.core.chunking` that builds byte-identical arrays.

The tensor is cut into equal-size chunks; each nonzero's coordinates become
relative to its chunk, so a chunk pins down exactly which factor rows it
touches.  A *task* is one chunk or, when a chunk holds more nonzeros than
the capacity, one capacity-sized slice of it (nonzero partitioning).  Tasks
are padded to a uniform capacity so the layout is rectangular.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from .sptensor import SparseTensor

__all__ = ["ChunkedTensor", "chunk_tensor", "clamp_capacity", "replication_stats"]


def clamp_capacity(nnz: int, capacity: int) -> int:
    """Clamp a task capacity to [1, nnz]: capacity above the nonzero count
    is pure padding.  Shared by chunk_tensor and the plan cache so cache
    keys agree with chunking behaviour."""
    return max(min(int(capacity), max(int(nnz), 1)), 1)


@dataclasses.dataclass(frozen=True)
class ChunkedTensor:
    """Rectangular packed chunk/task layout.

    task_chunk : (T, N) int32 — chunk-grid coordinate of each task.
    coords_rel : (T, P, N) int32 — chunk-relative nonzero coords, padded.
    values     : (T, P) float32 — nonzero values, padded with 0.
    nnz_per_task : (T,) int32 — live entries per task (≤ P).
    chunk_shape  : per-mode chunk size S_m.
    tensor_shape : original tensor dims I_m.
    """

    task_chunk: np.ndarray
    coords_rel: np.ndarray
    values: np.ndarray
    nnz_per_task: np.ndarray
    chunk_shape: tuple[int, ...]
    tensor_shape: tuple[int, ...]

    @property
    def num_tasks(self) -> int:
        return self.task_chunk.shape[0]

    @property
    def capacity(self) -> int:
        return self.coords_rel.shape[1]

    @property
    def ndim(self) -> int:
        return len(self.tensor_shape)

    @property
    def grid(self) -> tuple[int, ...]:
        return tuple(
            -(-i // s) for i, s in zip(self.tensor_shape, self.chunk_shape, strict=True)
        )

    @property
    def nnz(self) -> int:
        return int(self.nnz_per_task.sum())

    def row_offsets(self) -> np.ndarray:
        """(T, N) global row offset of each task's chunk in every mode."""
        return self.task_chunk * np.asarray(self.chunk_shape, dtype=np.int32)

    def coords_global(self) -> np.ndarray:
        """(T, P, N) absolute coordinates (padding rows map inside chunk 0)."""
        return self.coords_rel + self.row_offsets()[:, None, :]

    def pad_tasks(self, multiple: int) -> ChunkedTensor:
        """Pad the task axis to a multiple.  Padding tasks point at chunk 0
        with zero live nonzeros and zero values."""
        t = self.num_tasks
        tt = -(-t // multiple) * multiple
        if tt == t:
            return self
        pad = tt - t
        return ChunkedTensor(
            np.concatenate([self.task_chunk, np.zeros((pad, self.ndim), np.int32)]),
            np.concatenate([self.coords_rel, np.zeros((pad, self.capacity, self.ndim), np.int32)]),
            np.concatenate([self.values, np.zeros((pad, self.capacity), np.float32)]),
            np.concatenate([self.nnz_per_task, np.zeros((pad,), np.int32)]),
            self.chunk_shape,
            self.tensor_shape,
        )


def chunk_tensor(
    st: SparseTensor,
    chunk_shape: tuple[int, ...],
    capacity: int | None = None,
) -> ChunkedTensor:
    """Build the chunked format (Fig. 3b) with nonzero partitioning applied.

    `capacity` is the max nonzeros a task may hold; None → the largest chunk
    population (no nonzero partitioning).
    """
    n = st.ndim
    cs = np.asarray(chunk_shape, dtype=np.int64)
    if cs.shape != (n,) or not np.all(cs >= 1):
        raise ValueError(f"chunk_shape must be {n} positive sizes; got {chunk_shape}")
    grid = tuple(int(-(-i // s)) for i, s in zip(st.shape, cs, strict=True))

    # Device-side coordinates and every row index derived from them
    # (task_chunk * chunk_shape + local) are int32.
    for m, (g, s) in enumerate(zip(grid, cs, strict=True)):
        if g * int(s) - 1 > np.iinfo(np.int32).max:
            raise ValueError(
                f"mode {m}: padded extent {g * int(s)} (grid {g} x chunk "
                f"{int(s)}) exceeds int32 — device coordinates are int32; "
                "use a smaller chunk_shape or split the mode")
    if math.prod(grid) >= 1 << 62:
        raise ValueError(
            f"chunk grid {grid} linearizes past int64; coarsen chunk_shape")
    cs32 = cs.astype(np.int32)

    chunk_coord = st.coords // cs32  # (nnz, N)
    # Linearize chunk coordinates to group nonzeros by chunk.
    lin = np.zeros(st.nnz, dtype=np.int64)
    for m in range(n):
        lin = lin * grid[m] + chunk_coord[:, m]
    order = np.argsort(lin, kind="stable")
    lin_s = lin[order]
    coords_s = st.coords[order]
    values_s = st.values[order]

    uniq, start = np.unique(lin_s, return_index=True)
    counts = np.diff(np.append(start, st.nnz))
    if capacity is None:
        capacity = int(counts.max()) if counts.size else 1
    capacity = clamp_capacity(st.nnz, capacity)

    # Split over-full chunks into multiple tasks (nonzero partitioning).
    task_chunk, task_start, task_count = [], [], []
    for u, s0, c in zip(uniq, start, counts, strict=True):
        cc = np.zeros(n, dtype=np.int32)
        rem = u
        for m in reversed(range(n)):
            cc[m] = rem % grid[m]
            rem //= grid[m]
        off = 0
        while off < c:
            take = min(capacity, c - off)
            task_chunk.append(cc)
            task_start.append(s0 + off)
            task_count.append(take)
            off += take

    t = len(task_chunk)
    task_chunk = np.asarray(task_chunk, dtype=np.int32).reshape(t, n)
    coords_rel = np.zeros((t, capacity, n), dtype=np.int32)
    values = np.zeros((t, capacity), dtype=np.float32)
    nnz_per_task = np.asarray(task_count, dtype=np.int32)
    for i, (s0, c) in enumerate(zip(task_start, task_count, strict=True)):
        abs_coords = coords_s[s0 : s0 + c]
        coords_rel[i, :c] = abs_coords - task_chunk[i] * cs32
        values[i, :c] = values_s[s0 : s0 + c]

    return ChunkedTensor(
        task_chunk, coords_rel, values, nnz_per_task,
        tuple(int(s) for s in cs), st.shape,
    )


def replication_stats(ct: ChunkedTensor, rank: int, mode: int) -> dict:
    """Data-replication / reduction accounting (paper §IV-B trade-off):
    factor elements transferred per mode-`mode` MTTKRP, the replication
    factor vs. unpartitioned factors, and the partial-output rows that need
    sum reduction."""
    n = ct.ndim
    transferred = 0
    ideal = 0
    for m in range(n):
        if m == mode:
            continue
        transferred += ct.num_tasks * ct.chunk_shape[m] * rank
        ideal += ct.tensor_shape[m] * rank
    out_chunks = np.unique(ct.task_chunk[:, mode])
    partial_rows = ct.num_tasks * ct.chunk_shape[mode]
    final_rows = ct.tensor_shape[mode]
    return dict(
        factor_elements_transferred=int(transferred),
        factor_elements_ideal=int(ideal),
        replication_factor=float(transferred / max(ideal, 1)),
        partial_output_rows=int(partial_rows),
        final_output_rows=int(final_rows),
        reduction_factor=float(partial_rows / max(final_rows, 1)),
        nonempty_output_chunks=int(out_chunks.size),
    )
