"""Plain PyTorch versions of the kernels' contracts (counterpart of
`repro.kernels.ref`): per-task (T, S_mode, R) partial blocks before the
global sum, float and fixed point, and that global sum.  The CPU path runs
them; on the card they are what the CUDA kernels are held against.
"""
from __future__ import annotations

import torch

from ..core.mttkrp import _fixed_partials, chunk_offsets, index_add_drop, scatter_local

__all__ = ["mttkrp_fixed_local_ref", "mttkrp_local_ref", "reduce_local"]


def mttkrp_local_ref(factors, task_chunk, coords_rel, values, *, mode: int,
                     chunk_shape: tuple[int, ...], nnz_per_task=None) -> torch.Tensor:
    """(T, S_mode, R) f32 per-task partials, gather/scatter formulation.
    Factor rows are read at task_chunk·S + coords_rel, clamped to the last
    row; local rows outside [0, S_mode) are dropped.  `nnz_per_task` is
    ignored: the slots past it hold 0 and add nothing."""
    offsets = chunk_offsets(task_chunk, chunk_shape)
    part = values[..., None].to(torch.float32)  # (T, P, 1)
    for m, f in enumerate(factors):
        if m != mode:
            part = part * _rows(f, offsets, coords_rel, m)
    return scatter_local(part, coords_rel[:, :, mode], chunk_shape[mode])


def _rows(factor, offsets, coords_rel, m: int) -> torch.Tensor:
    """(T, P, R) rows of mode `m`'s factor at task_chunk·S + coords_rel,
    clamped to the last row."""
    idx = (offsets[:, m, None] + coords_rel[:, :, m]).clamp_max(factor.shape[0] - 1)
    return factor.index_select(0, idx.reshape(-1)).reshape(*idx.shape, factor.shape[1])


def mttkrp_fixed_local_ref(qfactors, task_chunk, coords_rel, qvalues, *,
                           mode: int, chunk_shape: tuple[int, ...], matrix_frac: int,
                           value_frac: int, prec_shift: int = 0,
                           nnz_per_task=None) -> torch.Tensor:
    """(T, S_mode, R) int32 per-task partials, bit-exact Algorithm 2, in
    Q(·, matrix_frac - prec_shift).  Rows are gathered as in
    `mttkrp_local_ref` (clamped), multiplied in mode order; `nnz_per_task`
    is ignored as there."""
    offsets = chunk_offsets(task_chunk, chunk_shape)
    rows = [None if m == mode else _rows(f, offsets, coords_rel, m)
            for m, f in enumerate(qfactors)]
    part = _fixed_partials(rows, qvalues, mode, matrix_frac, value_frac, prec_shift)
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
