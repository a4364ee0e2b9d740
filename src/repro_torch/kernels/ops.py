"""Public wrappers around the MTTKRP kernels (counterparts of
`repro.kernels.ops.mttkrp_pallas` and `mttkrp_fixed_pallas`): pad factor
rows to whole chunks, run the per-task kernel, sum the task blocks into the
chunk-padded output and cut the padding off.  The TPU's rank padding to 128
lanes has no counterpart here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import ref
from .mttkrp_fixed_kernel import mttkrp_fixed_local
from .mttkrp_kernel import mttkrp_local

__all__ = ["mttkrp_fixed_kernel_op", "mttkrp_kernel_op", "pad_factor"]


def pad_factor(f: torch.Tensor, chunk: int) -> torch.Tensor:
    """Pad rows with zeros to a whole number of chunks."""
    rpad = (-f.shape[0]) % chunk
    return F.pad(f, (0, 0, 0, rpad)) if rpad else f


def mttkrp_kernel_op(factors, task_chunk, coords_rel, values, *, mode: int,
                     chunk_shape: tuple[int, ...], out_dim: int,
                     nnz_per_task: torch.Tensor | None = None) -> torch.Tensor:
    """Chunked spMTTKRP through the kernel.  Returns (out_dim, R) f32.
    `nnz_per_task` (T,) int32, when given, lets the kernel stop at each
    task's live slots."""
    padded = tuple(pad_factor(f, chunk_shape[m]) for m, f in enumerate(factors))
    local = mttkrp_local(padded, task_chunk, coords_rel, values, mode=mode,
                         chunk_shape=chunk_shape, nnz_per_task=nnz_per_task)
    return _reduce(local, task_chunk, mode, chunk_shape, out_dim)


def mttkrp_fixed_kernel_op(qfactors, task_chunk, coords_rel, qvalues, *, mode: int,
                           chunk_shape: tuple[int, ...], out_dim: int, matrix_frac: int,
                           value_frac: int, prec_shift: int = 0,
                           nnz_per_task: torch.Tensor | None = None) -> torch.Tensor:
    """Fixed-point chunked spMTTKRP through the kernel.  Returns (out_dim, R)
    int32 in Q(·, matrix_frac - prec_shift); the global sum is int32 too.
    `nnz_per_task` as in `mttkrp_kernel_op`."""
    padded = tuple(pad_factor(f, chunk_shape[m]) for m, f in enumerate(qfactors))
    local = mttkrp_fixed_local(padded, task_chunk, coords_rel, qvalues, mode=mode,
                               chunk_shape=chunk_shape, matrix_frac=matrix_frac,
                               value_frac=value_frac, prec_shift=prec_shift,
                               nnz_per_task=nnz_per_task)
    return _reduce(local, task_chunk, mode, chunk_shape, out_dim)


def _reduce(local, task_chunk, mode, chunk_shape, out_dim):
    out_pad = -(-out_dim // chunk_shape[mode]) * chunk_shape[mode]
    out = ref.reduce_local(local, task_chunk, mode=mode,
                           chunk_shape=chunk_shape, out_dim=out_pad)
    return out[:out_dim]
