"""Plain PyTorch versions of the kernels' contracts (counterpart of
`repro.kernels.ref`): per-task (T, S_mode, R) partial blocks before the
global sum, float and fixed point, that global sum (which the kernels' direct
output takes in place of the blocks), the pseudo-inverse
of CP-ALS's Gram Hadamard products, and the sum of squares of the fit's
||X||².  The CPU path runs them; on the card they are what the CUDA kernels
are held against.
"""
from __future__ import annotations

import torch

from ..core.mttkrp import _fixed_partials, chunk_offsets, index_add_drop, scatter_local

__all__ = ["gram_pinv_ref", "mttkrp_fixed_local_ref", "mttkrp_local_ref", "reduce_local",
           "sum_squares_ref"]

#: Values `sum_squares_ref` widens to float64 at a time (32 MiB).
SUM_SQUARES_SLICE = 1 << 22


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


def gram_pinv_rtol(rank: int) -> float:
    """`jnp.linalg.pinv`'s cutoff for (rank, rank) float32 matrices,
    10·max(m, n)·eps relative to the largest singular value (torch's default
    is 10× lower).  m and n are the last two dimensions, so a batched
    (B, R, R) stack takes R's cutoff, not B's."""
    return 10 * rank * torch.finfo(torch.float32).eps


def _nonfinite_members(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Which (R, R) matrices of `v` `jnp.linalg.pinv` answers without an SVD
    of finite numbers: (all NaN, all zeros) boolean masks over the leading
    dimensions.  A NaN anywhere, or a ±Inf off the diagonal, makes the whole
    pseudo-inverse NaN; ±Inf only on the diagonal makes it zeros (the
    cutoff, rtol·Inf, keeps no direction)."""
    rank = v.shape[-1]
    off = ~torch.eye(rank, dtype=torch.bool, device=v.device)
    finite = torch.isfinite(v)
    nan = (torch.isnan(v) | (~finite & off)).flatten(-2).any(-1)
    return nan, (~finite).flatten(-2).any(-1) & ~nan


def gram_pinv_ref(v: torch.Tensor) -> torch.Tensor:
    """Pseudo-inverse of each (R, R) matrix of `v` by torch's SVD, with
    `jnp.linalg.pinv`'s cutoff; a member holding a non-finite entry gets
    jnp's answer (`_nonfinite_members`) and never reaches the SVD, which
    would raise for the whole stack."""
    rtol = gram_pinv_rtol(v.shape[-1])
    nan, zero = _nonfinite_members(v)
    bad = (nan | zero)[..., None, None]
    # repro-lint: disable=host-sync -- plain version: CPU and tests only; the card's main path runs gram_pinv.cu
    out = torch.linalg.pinv(torch.where(bad, 0.0, v), rtol=rtol)
    return out.masked_fill(nan[..., None, None], float("nan"))


def sum_squares_ref(values: torch.Tensor) -> torch.Tensor:
    """Σ v² of float32 `values` as a 0-d float64 tensor on their device.  A
    float32 squares exactly in float64, so only the summation order differs
    from `SparseTensor.norm() ** 2`.  torch widens a whole tensor before a
    float64 reduction of it, so each slice of `SUM_SQUARES_SLICE` values is
    widened and reduced apart."""
    parts = [torch.dot(s, s) for s in (c.to(torch.float64)
                                       for c in values.split(SUM_SQUARES_SLICE))]
    return torch.stack(parts).sum()
