"""Heterogeneous execution (paper §IV-D), counterpart of `repro.core.hetero`.

The paper splits spMTTKRP between UPMEM PIM (chunks dense enough to fill a
DPU) and the CPU (the rest, via ALTO).  The port keeps the reference's
*scheduler* and its two executors:

  * dense path  — chunks above a density threshold are densified into small
    dense blocks and contracted with the gathered factor blocks by one
    float32 `torch.einsum`, as the reference computes it outside any kernel;
  * sparse path — the remaining tasks run the hand-written float CUDA kernel
    (`kernels.ops.mttkrp_kernel_op`; its plain version on a CPU tensor).

The split is decided statically from per-task density with a FLOP/byte cost
model (`split_tasks`, a numpy copy, so both packages give the same split).
"""
from __future__ import annotations

import dataclasses
import math
import string

import numpy as np
import torch

from .chunking import ChunkedTensor
from .mttkrp import chunk_offsets, gather_factor_blocks, index_add_drop

__all__ = [
    "MAX_DENSE_VOLUME",
    "HeteroSplit",
    "dense_path_cost",
    "densify_tasks",
    "hetero_device_arrays",
    "mttkrp_hetero",
    "sparse_path_cost",
    "split_tasks",
]


def dense_path_cost(chunk_shape, rank: int) -> float:
    """MACs for one densified chunk (all modes share one block)."""
    return math.prod(chunk_shape) * rank * (len(chunk_shape) - 1)


def sparse_path_cost(capacity: int, chunk_shape, rank: int) -> float:
    """MACs + gather overhead for one task on the sparse path."""
    n = len(chunk_shape)
    mults = capacity * rank * n
    gather_overhead = capacity * rank * 2  # index arithmetic / one-hot waste
    return mults + gather_overhead


@dataclasses.dataclass(frozen=True)
class HeteroSplit:
    dense_idx: np.ndarray   # task indices on the dense path
    sparse_idx: np.ndarray  # task indices on the sparse path
    threshold: float

    @property
    def dense_fraction(self) -> float:
        total = self.dense_idx.size + self.sparse_idx.size
        return self.dense_idx.size / max(total, 1)


MAX_DENSE_VOLUME = 1 << 22  # dense blocks must fit the executor (the DPU-
                            # capacity analogue of the dense path)


def split_tasks(
    ct: ChunkedTensor,
    rank: int,
    *,
    dense_fraction: float | None = None,
    max_dense_volume: int = MAX_DENSE_VOLUME,
) -> HeteroSplit:
    """Static split.  Default threshold from the cost model: a task goes dense
    when densifying is cheaper than gathering.  `dense_fraction` overrides the
    threshold with a paper-style static workload fraction (densest-first).
    Chunks whose dense form exceeds `max_dense_volume` elements never go
    dense — mirroring the paper's only-what-fits-a-DPU rule."""
    density = ct.nnz_per_task / max(math.prod(ct.chunk_shape), 1)
    if math.prod(ct.chunk_shape) > max_dense_volume:
        return HeteroSplit(np.zeros((0,), np.int32),
                           np.arange(ct.num_tasks, dtype=np.int32),
                           float("inf"))
    if dense_fraction is not None:
        k = int(round(dense_fraction * ct.num_tasks))
        order = np.argsort(-density, kind="stable")
        dense = order[:k]
        sparse = order[k:]
        thr = float(density[dense[-1]]) if k else float("inf")
    else:
        cost_d = dense_path_cost(ct.chunk_shape, rank)
        # Per-task sparse cost scales with its live nonzeros.
        cost_s = np.array(
            [sparse_path_cost(int(c), ct.chunk_shape, rank) for c in ct.nnz_per_task]
        )
        dense_mask = cost_d < cost_s
        dense = np.nonzero(dense_mask)[0]
        sparse = np.nonzero(~dense_mask)[0]
        thr = cost_d / max(
            sparse_path_cost(1, ct.chunk_shape, rank) * math.prod(ct.chunk_shape), 1
        )
    return HeteroSplit(dense.astype(np.int32), sparse.astype(np.int32), thr)


def densify_tasks(ct: ChunkedTensor, idx: np.ndarray) -> np.ndarray:
    """(Td, S_0, ..., S_{N-1}) dense blocks for the selected tasks."""
    out = np.zeros((idx.size, *ct.chunk_shape), dtype=np.float32)
    for o, i in enumerate(idx):
        c = int(ct.nnz_per_task[i])
        if c:
            np.add.at(out[o], tuple(ct.coords_rel[i, :c].T), ct.values[i, :c])
    return out


def hetero_device_arrays(ct: ChunkedTensor, split: HeteroSplit, dev: dict) -> dict:
    """Both paths' operands, made once per split on the device of `dev`, the
    chunked tensor's resident arrays (`chunked_device_arrays`).

    The sparse path takes its tasks' rows of them, or `dev` itself when every
    task is sparse; the dense path its densified blocks and their task
    chunks.  A path with no task is None."""
    device = dev["values"].device
    sparse = None
    if split.sparse_idx.size == ct.num_tasks:
        sparse = dev
    elif split.sparse_idx.size:
        idx = torch.from_numpy(split.sparse_idx.astype(np.int64)).to(device)
        sparse = {k: v.index_select(0, idx) for k, v in dev.items()}
    dense = None
    if split.dense_idx.size:
        dense = dict(blocks=torch.from_numpy(densify_tasks(ct, split.dense_idx)).to(device),
                     task_chunk=torch.from_numpy(ct.task_chunk[split.dense_idx]).to(device))
    return dict(dense=dense, sparse=sparse)


def _dense_path(factors, blocks, task_chunk, *, mode: int, chunk_shape, out_dim: int):
    """einsum over densified chunks: e.g. mode-2 3D → 'tabc,tar,tbr->tcr'.
    Float32 throughout: torch contracts it with TF32 only where the caller
    has allowed TF32 matrix products (`torch.backends.cuda.matmul`)."""
    n = len(factors)
    rank = factors[0].shape[1]
    offsets = chunk_offsets(task_chunk, chunk_shape)
    letters = string.ascii_lowercase
    operands, subs = [blocks], ["t" + letters[:n]]
    for m in range(n):
        if m != mode:
            operands.append(gather_factor_blocks(factors[m], offsets[:, m], chunk_shape[m]))
            subs.append(f"t{letters[m]}r")
    local = torch.einsum(",".join(subs) + f"->t{letters[mode]}r", *operands)  # (Td, S, R)
    rows = offsets[:, mode:mode + 1] + torch.arange(
        chunk_shape[mode], dtype=torch.int32, device=offsets.device)
    return index_add_drop(out_dim, rows.reshape(-1), local.reshape(-1, rank))


def mttkrp_hetero(factors, arrays: dict, *, mode: int, chunk_shape: tuple[int, ...],
                  out_dim: int) -> torch.Tensor:
    """Run both paths on `hetero_device_arrays`' operands and sum (the
    paper's final CPU+PIM combine).  The sparse path launches the float
    kernel once on a CUDA device; a failing build or launch raises."""
    from ..kernels import ops as kops  # the kernels package imports core

    out = torch.zeros((out_dim, factors[0].shape[1]), dtype=torch.float32,
                      device=factors[0].device)
    if arrays["dense"] is not None:
        d = arrays["dense"]
        out = out + _dense_path(factors, d["blocks"], d["task_chunk"], mode=mode,
                                chunk_shape=chunk_shape, out_dim=out_dim)
    if arrays["sparse"] is not None:
        s = arrays["sparse"]
        out = out + kops.mttkrp_kernel_op(
            factors, s["task_chunk"], s["coords_rel"], s["values"], mode=mode,
            chunk_shape=chunk_shape, out_dim=out_dim, nnz_per_task=s["nnz_per_task"])
    return out
