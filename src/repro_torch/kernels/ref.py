"""Plain PyTorch versions of the kernel's contract (counterpart of
`repro.kernels.ref`): per-task (T, S_mode, R) partial blocks before the
global sum, and that global sum.  The CPU path runs them; on the card they
are what the CUDA kernel is held against.
"""
from __future__ import annotations

import torch

from ..core.mttkrp import chunk_offsets, index_add_drop, scatter_local

__all__ = ["mttkrp_local_ref", "reduce_local"]


def mttkrp_local_ref(factors, task_chunk, coords_rel, values, *,
                     mode: int, chunk_shape: tuple[int, ...]) -> torch.Tensor:
    """(T, S_mode, R) f32 per-task partials, gather/scatter formulation.
    Factor rows are read at task_chunk·S + coords_rel, clamped to the last
    row; local rows outside [0, S_mode) are dropped."""
    t, p, _ = coords_rel.shape
    rank = factors[0].shape[1]
    offsets = chunk_offsets(task_chunk, chunk_shape)
    part = values[..., None].to(torch.float32)  # (T, P, 1)
    for m, f in enumerate(factors):
        if m == mode:
            continue
        idx = (offsets[:, m, None] + coords_rel[:, :, m]).clamp_max(f.shape[0] - 1)
        part = part * f.index_select(0, idx.reshape(-1)).reshape(t, p, rank)
    return scatter_local(part, coords_rel[:, :, mode], chunk_shape[mode])


def reduce_local(local, task_chunk, *, mode: int,
                 chunk_shape: tuple[int, ...], out_dim: int) -> torch.Tensor:
    """Global sum of per-task partial blocks (the paper's host step):
    block t lands on rows task_chunk[t, mode]·S + [0, S) of the output."""
    rank = local.shape[-1]
    s_out = chunk_shape[mode]
    rows = task_chunk[:, mode, None] * s_out + torch.arange(
        s_out, dtype=torch.int32, device=local.device)
    return index_add_drop(out_dim, rows.reshape(-1), local.reshape(-1, rank))
