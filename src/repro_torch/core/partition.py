"""Hierarchical partition decider (paper §IV-B, Fig. 5), a numpy copy of
`repro.core.partition` that returns the same plan for the same tensor.

Partitioning preference order (replication-minimizing):
  1. rank partitioning      — no factor replication;
  2. dimension-size part.   — bounds factor bytes per device, replicates
                              factor rows at chunk boundaries;
  3. nonzero partitioning   — bounds tensor bytes per device, maximal
                              replication + output sum reduction.

The decider halves the largest chunk dimension until the device density
(nonzeros a device can hold beside its factor slice, per chunk cell) reaches
the tensor density.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from .sptensor import SparseTensor

__all__ = ["PartitionPlan", "decide_partition", "DPU_MRAM_BYTES"]

DPU_MRAM_BYTES = 64 * 1024 * 1024  # UPMEM per-DPU MRAM; the per-PE budget knob.


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    chunk_shape: tuple[int, ...]
    capacity: int                  # max nonzeros per task
    rank_block: int                # ranks per device (rank partitioning)
    n_rank_partitions: int
    est_chunks: int                # grid size (upper bound on nonempty chunks)
    factor_bytes_per_device: int
    tensor_bytes_per_device: int
    device_density: float
    tensor_density: float
    kernel_iterations: int         # >1 when partitions exceed device count

    @property
    def mem_bytes_per_device(self) -> int:
        return self.factor_bytes_per_device + self.tensor_bytes_per_device


def decide_partition(
    st: SparseTensor,
    rank: int,
    *,
    mem_bytes: int = DPU_MRAM_BYTES,
    factor_elt_bytes: int = 2,     # Q9.7 int16 (paper's preferred mode-3 format)
    value_bytes: int = 2,          # 16-bit tensor values (paper §IV-C)
    coord_bytes: int = 4,
    n_devices: int = 2560,
    rank_axis: int | None = None,  # fixed rank partitions
) -> PartitionPlan:
    """Run the Fig. 5 decider.  The chunking itself is
    `chunking.chunk_tensor(st, plan.chunk_shape, plan.capacity)`."""
    n = st.ndim
    nnz_bytes = value_bytes + coord_bytes * n
    tensor_density = st.density

    n_rank = (rank_axis if rank_axis is not None
              else max(1, min(rank, n_devices)))
    rank_block = -(-rank // n_rank)

    chunk_shape = [int(d) for d in st.shape]

    def factor_bytes(cs):
        # One factor slice per mode, rank_block columns each.
        return sum(s * rank_block * factor_elt_bytes for s in cs)

    def capacity_for(cs):
        avail = mem_bytes - factor_bytes(cs)
        return avail // nnz_bytes

    while True:
        cap = capacity_for(chunk_shape)
        if cap >= 1:
            device_density = cap / math.prod(chunk_shape)
            if device_density >= tensor_density:
                break
        # Halve the largest chunk dimension (paper: iterative dim-size step).
        m = int(np.argmax(chunk_shape))
        if chunk_shape[m] == 1:
            # Cannot shrink further; rely on nonzero partitioning.
            cap = max(int(cap), 1)
            device_density = cap / math.prod(chunk_shape)
            break
        chunk_shape[m] = -(-chunk_shape[m] // 2)

    cap = max(int(capacity_for(chunk_shape)), 1)
    grid = [int(-(-i // s)) for i, s in zip(st.shape, chunk_shape, strict=True)]
    est_chunks = math.prod(grid)
    est_tasks = min(est_chunks, st.nnz)
    total_partitions = est_tasks * n_rank
    kernel_iterations = max(1, -(-total_partitions // n_devices))

    return PartitionPlan(
        chunk_shape=tuple(chunk_shape),
        capacity=cap,
        rank_block=rank_block,
        n_rank_partitions=n_rank,
        est_chunks=est_chunks,
        factor_bytes_per_device=factor_bytes(chunk_shape),
        tensor_bytes_per_device=cap * nnz_bytes,
        device_density=float(cap / math.prod(chunk_shape)),
        tensor_density=float(tensor_density),
        kernel_iterations=int(kernel_iterations),
    )
