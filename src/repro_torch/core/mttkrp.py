"""spMTTKRP in plain PyTorch: the COO reference, the chunked (PRISM)
formulation, float and fixed point (paper Alg. 2), and the ops over the
CSF and ALTO layouts (`repro_torch.formats`).  Counterpart of
`repro.core.mttkrp`, with the same index semantics:

  * gathers of factor blocks clamp to the last row (`gather_factor_blocks`);
  * scatters drop out-of-range rows, as `.at[].add(mode="drop")` does,
    where `index_add_` alone would raise (`index_add_drop`).

Coordinates stay int32 on the device; they are widened to int64 only for
`torch.gather`, which takes nothing else.

Fixed-point products are int32 and wrap on overflow, as XLA's do, and `>>`
on a signed tensor is the arithmetic shift of `jnp.right_shift`, so the
fixed ops give the reference's integers bit for bit.
"""
from __future__ import annotations

import torch

from .chunking import ChunkedTensor

__all__ = [
    "chunk_offsets",
    "chunked_device_arrays",
    "dequantize_output",
    "gather_factor_blocks",
    "index_add_drop",
    "mttkrp_alto",
    "mttkrp_chunked",
    "mttkrp_chunked_fixed",
    "mttkrp_coo",
    "mttkrp_coo_fixed",
    "mttkrp_csf",
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
    resident across CP-ALS iterations; only factors change).  The kernels
    read `nnz_per_task` to stop at each task's live slots."""
    return dict(
        task_chunk=torch.from_numpy(ct.task_chunk).to(device),
        coords_rel=torch.from_numpy(ct.coords_rel).to(device),
        values=torch.from_numpy(ct.values).to(device),
        nnz_per_task=torch.from_numpy(ct.nnz_per_task).to(device),
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
    offsets = chunk_offsets(task_chunk, chunk_shape)

    # Per-task partials (T, P, R).  Padded entries have value 0 → no-op.
    part = values[..., None].to(torch.float32)
    for m, f in enumerate(factors):
        if m != mode:
            part = part * _chunk_rows(f, offsets, coords_rel, m, chunk_shape)
    return _sum_partials(part, offsets, coords_rel, mode, chunk_shape, out_dim)


def _chunk_rows(factor, offsets, coords_rel, m: int, chunk_shape) -> torch.Tensor:
    """(T, P, R) rows of mode `m`'s factor for every slot, through the
    task's (clamped) factor block."""
    blocks = gather_factor_blocks(factor, offsets[:, m], chunk_shape[m])
    idx = coords_rel[:, :, m, None].long().expand(-1, -1, factor.shape[1])
    return torch.gather(blocks, 1, idx)


def _sum_partials(part, offsets, coords_rel, mode: int, chunk_shape, out_dim: int):
    """Scatter (T, P, R) partials into chunk-local blocks, then sum the
    blocks into the global (out_dim, R) output."""
    s_out = chunk_shape[mode]
    local = scatter_local(part, coords_rel[:, :, mode], s_out)
    rows = offsets[:, mode : mode + 1] + torch.arange(
        s_out, dtype=torch.int32, device=offsets.device)
    return index_add_drop(out_dim, rows.reshape(-1), local.reshape(-1, part.shape[-1]))


# ---------------------------------------------------------------------------
# Format-subsystem ops (repro_torch.formats): CSF fiber trees and the ALTO
# linearized index.  Both are exact float paths — they change the memory
# access structure, not the arithmetic.  The reference's `segment_sum`
# becomes `index_add_` into a zero (num_segments, R) tensor.
# ---------------------------------------------------------------------------

def mttkrp_csf(factors, inner_coord, values, fiber_ids, fiber_coords, *, mode: int,
               inner_mode: int, mid_modes: tuple[int, ...], out_dim: int,
               n_fibers: int) -> torch.Tensor:
    """spMTTKRP over a CSF mode tree (see `repro_torch.formats.csf`): two
    reductions over sorted indices, nonzeros → fibers → output rows.

    The interior (mid) factor rows are gathered once per *fiber* instead of
    once per nonzero — the fiber-reuse win CSF exists for; only the innermost
    factor is gathered per nonzero.

    inner_coord (nnz,), values (nnz,), fiber_ids (nnz, sorted),
    fiber_coords (n_fibers, N; inner column unused).  Returns (out_dim, R).
    """
    part = values[:, None].to(torch.float32) * factors[inner_mode].index_select(0, inner_coord)
    fib = torch.zeros((n_fibers, part.shape[1]), dtype=torch.float32, device=part.device)
    fib.index_add_(0, fiber_ids, part)  # fiber ids are the tree's own, all in range
    del part
    for m in mid_modes:
        fib = fib * factors[m].index_select(0, fiber_coords[:, m])
    return index_add_drop(out_dim, fiber_coords[:, mode], fib)


def _alto_decode(words, positions: tuple[int, ...]) -> torch.Tensor:
    """Gather one mode's coordinate bits back out of the packed key:
    `positions[b]` is the key bit holding coordinate bit `b`, in word
    `words[p // 32]` (int32 views of the uint32 words: bit `b` is moved
    into place by one shift and masked, so the sign fill of an arithmetic
    shift never reaches it)."""
    c = torch.zeros(words[0].shape[0], dtype=torch.int32, device=words[0].device)
    for b, p in enumerate(positions):
        s = p % 32 - b
        w = words[p // 32]
        c |= (w >> s if s >= 0 else w << -s) & (1 << b)
    return c


def mttkrp_alto(factors, key_words, values, *, mode: int,
                positions: tuple[tuple[int, ...], ...], out_dim: int) -> torch.Tensor:
    """spMTTKRP over the ALTO linearized index (see `repro_torch.formats.alto`):
    every mode's coordinates are de-interleaved from ONE key stream
    (`key_words`, (nnz, W) int32 — the layout's uint32 words reinterpreted,
    sorted by key), so a single tensor copy serves all modes."""
    # Each word column is made contiguous once, not read strided per bit.
    words = [key_words[:, w].contiguous() for w in range(key_words.shape[1])]
    part = values[:, None].to(torch.float32)
    for m, f in enumerate(factors):
        if m != mode:
            part = part * f.index_select(0, _alto_decode(words, positions[m]))
    return index_add_drop(out_dim, _alto_decode(words, positions[mode]), part)


# ---------------------------------------------------------------------------
# Fixed point (paper Algorithm 2) — bit-exact Q arithmetic.
# ---------------------------------------------------------------------------

def _fixed_partials(qfactor_rows, qvalues, mode, matrix_frac, value_frac, prec_shift):
    """Shared Alg.-2 inner loop.  qfactor_rows: list over modes of (..., R)
    gathered factor rows (entry at `mode` ignored); qvalues (...,).
    Returns int32 partial results in Q(.., matrix_frac - prec_shift)."""
    inputs = [m for m in range(len(qfactor_rows)) if m != mode]
    part = qfactor_rows[inputs[0]].to(torch.int32)
    for m in inputs[1:]:
        part = (part * qfactor_rows[m].to(torch.int32)) >> matrix_frac  # Alg. 2 l.11-12
    part = part * qvalues[..., None].to(torch.int32)
    return part >> (value_frac + prec_shift)  # Alg. 2 l.14-15


def mttkrp_coo_fixed(qfactors, coords, qvalues, *, mode: int, out_dim: int,
                     matrix_frac: int, value_frac: int, prec_shift: int = 0) -> torch.Tensor:
    """Fixed-point COO reference.  qfactors: sequence of (I_m, R) int8/16/32;
    coords (nnz, N) int32; qvalues (nnz,) int16/int32.  Returns (out_dim, R)
    int32 in Q(·, matrix_frac - prec_shift)."""
    rows = [None if m == mode else f.index_select(0, coords[:, m])
            for m, f in enumerate(qfactors)]
    part = _fixed_partials(rows, qvalues, mode, matrix_frac, value_frac, prec_shift)
    return index_add_drop(out_dim, coords[:, mode], part)


def mttkrp_chunked_fixed(
    qfactors,
    task_chunk,
    coords_rel,
    qvalues,
    *,
    mode: int,
    chunk_shape: tuple[int, ...],
    out_dim: int,
    matrix_frac: int,
    value_frac: int,
    prec_shift: int = 0,
) -> torch.Tensor:
    """Chunked fixed-point spMTTKRP (paper Alg. 2 on the chunked format).

    qfactors : sequence of (I_m, R) int8/int16/int32 (by preset);
    qvalues : (T, P) int16/int32.  Output (out_dim, R) int32 in
    Q(·, matrix_frac - prec_shift).
    """
    offsets = chunk_offsets(task_chunk, chunk_shape)
    rows = [None if m == mode else _chunk_rows(f, offsets, coords_rel, m, chunk_shape)
            for m, f in enumerate(qfactors)]
    part = _fixed_partials(rows, qvalues, mode, matrix_frac, value_frac, prec_shift)
    return _sum_partials(part, offsets, coords_rel, mode, chunk_shape, out_dim)


def dequantize_output(qout: torch.Tensor, matrix_frac: int, prec_shift: int) -> torch.Tensor:
    """Output of the fixed kernels is Q(·, matrix_frac - prec_shift)."""
    return qout.to(torch.float32) / (1 << (matrix_frac - prec_shift))
