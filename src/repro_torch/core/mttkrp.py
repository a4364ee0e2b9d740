"""spMTTKRP in plain PyTorch: the COO reference and the chunked (PRISM)
formulation, float path.  Counterpart of the float half of
`repro.core.mttkrp`, with the same index semantics:

  * gathers of factor blocks clamp to the last row (`gather_factor_blocks`);
  * scatters drop out-of-range rows, as `.at[].add(mode="drop")` does,
    where `index_add_` alone would raise (`index_add_drop`).

Coordinates stay int32 on the device; they are widened to int64 only for
`torch.gather`, which takes nothing else.
"""
from __future__ import annotations

import torch

from .chunking import ChunkedTensor

__all__ = [
    "chunk_offsets",
    "chunked_device_arrays",
    "gather_factor_blocks",
    "index_add_drop",
    "mttkrp_chunked",
    "mttkrp_coo",
    "scatter_local",
]


def index_add_drop(n_rows: int, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """(n_rows, R) sums of `src` rows at `idx`; rows outside [0, n_rows) are
    dropped.  They land in one spare row past the end, which is cut off, so
    `src` is never copied."""
    idx = torch.where((idx >= 0) & (idx < n_rows), idx, n_rows)
    out = torch.zeros((n_rows + 1, src.shape[-1]), dtype=src.dtype, device=src.device)
    out.index_add_(0, idx, src)
    return out[:n_rows]


def mttkrp_coo(factors, coords, values, *, mode: int, out_dim: int) -> torch.Tensor:
    """Reference spMTTKRP (paper Fig. 1).  factors: sequence of (I_m, R) f32;
    coords (nnz, N) int32; values (nnz,) f32.  Returns (out_dim, R) f32."""
    part = values[:, None].to(torch.float32)
    for m, f in enumerate(factors):
        if m == mode:
            continue
        part = part * f.index_select(0, coords[:, m])
    return index_add_drop(out_dim, coords[:, mode], part)


def chunked_device_arrays(ct: ChunkedTensor, device: torch.device) -> dict:
    """The static per-run arrays, moved to `device` once (the tensor stays
    resident across CP-ALS iterations; only factors change)."""
    return dict(
        task_chunk=torch.from_numpy(ct.task_chunk).to(device),
        coords_rel=torch.from_numpy(ct.coords_rel).to(device),
        values=torch.from_numpy(ct.values).to(device),
    )


def gather_factor_blocks(factor: torch.Tensor, offsets: torch.Tensor, size: int) -> torch.Tensor:
    """factor (I, R), offsets (T,) → (T, size, R) chunk-local blocks.
    Boundary chunks clamp; clamped rows are never addressed by live nonzeros."""
    idx = offsets[:, None] + torch.arange(size, dtype=offsets.dtype, device=offsets.device)
    idx = idx.clamp_max(factor.shape[0] - 1)
    return factor.index_select(0, idx.reshape(-1)).reshape(*idx.shape, factor.shape[1])


def chunk_offsets(task_chunk: torch.Tensor, chunk_shape: tuple[int, ...]) -> torch.Tensor:
    """(T, N) int32 global row offset of each task's chunk."""
    return task_chunk * torch.tensor(chunk_shape, dtype=torch.int32, device=task_chunk.device)


def scatter_local(part: torch.Tensor, c_out: torch.Tensor, s_out: int) -> torch.Tensor:
    """(T, P, R) partials scatter-added into (T, s_out, R) task-local blocks
    at rows `c_out` (T, P); rows outside [0, s_out) are dropped."""
    t, p, rank = part.shape
    base = torch.arange(t, dtype=torch.int64, device=part.device)[:, None] * s_out
    flat = torch.where((c_out >= 0) & (c_out < s_out), base + c_out, -1)
    return index_add_drop(t * s_out, flat.reshape(-1), part.reshape(t * p, rank)).reshape(
        t, s_out, rank)


def mttkrp_chunked(
    factors,
    task_chunk,
    coords_rel,
    values,
    *,
    mode: int,
    chunk_shape: tuple[int, ...],
    out_dim: int,
) -> torch.Tensor:
    """PRISM chunked spMTTKRP (float path): per task, gather the chunk's
    factor blocks, form the partials, reduce them into a chunk-local block,
    and sum the blocks into the global output.

    factors : sequence of (I_m, R) f32
    task_chunk : (T, N) int32; coords_rel : (T, P, N) int32; values : (T, P) f32
    """
    rank = factors[0].shape[1]
    offsets = chunk_offsets(task_chunk, chunk_shape)

    # Per-task partials (T, P, R).  Padded entries have value 0 → no-op.
    part = values[..., None].to(torch.float32)
    for m, f in enumerate(factors):
        if m == mode:
            continue
        blocks = gather_factor_blocks(f, offsets[:, m], chunk_shape[m])
        idx = coords_rel[:, :, m, None].long().expand(-1, -1, rank)
        part = part * torch.gather(blocks, 1, idx)

    s_out = chunk_shape[mode]
    local = scatter_local(part, coords_rel[:, :, mode], s_out)

    # Sum reduction of the chunk-local partials into the global output.
    rows = offsets[:, mode : mode + 1] + torch.arange(
        s_out, dtype=torch.int32, device=offsets.device)
    return index_add_drop(out_dim, rows.reshape(-1), local.reshape(-1, rank))
