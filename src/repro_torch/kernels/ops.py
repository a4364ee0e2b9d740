"""Public wrappers around the MTTKRP kernels (counterparts of
`repro.kernels.ops.mttkrp_pallas` and `mttkrp_fixed_pallas`): pad factor
rows to whole chunks, allocate one zero-filled chunk-padded (I_pad, R)
output, let the kernel add every task's sums straight into it, and cut the
padding off.  The TPU's per-task (T, S_mode, R) partials and their global
sum have no counterpart on the card: at FROSTT Delicious's size they would
be hundreds of GB a mode.  The TPU's rank padding to 128 lanes has none
either.

While tracing is on (`obs.tracing`), the counters `mttkrp.out_bytes` and
`mttkrp.calls` of `obs.metrics.default_registry` add each call's output
bytes and the call.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..obs import metrics as _metrics
from ..obs.tracing import tracing_enabled
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
    s = chunk_shape[mode]
    out = torch.zeros((-(-out_dim // s) * s, factors[0].shape[1]), dtype=torch.float32,
                      device=coords_rel.device)
    _count(out)
    mttkrp_local(padded, task_chunk, coords_rel, values, mode=mode, chunk_shape=chunk_shape,
                 nnz_per_task=nnz_per_task, out=out)
    return out[:out_dim]


def mttkrp_fixed_kernel_op(qfactors, task_chunk, coords_rel, qvalues, *, mode: int,
                           chunk_shape: tuple[int, ...], out_dim: int, matrix_frac: int,
                           value_frac: int, prec_shift: int = 0,
                           nnz_per_task: torch.Tensor | None = None) -> torch.Tensor:
    """Fixed-point chunked spMTTKRP through the kernel.  Returns (out_dim, R)
    int32 in Q(·, matrix_frac - prec_shift); the sum is int32 throughout.
    `nnz_per_task` as in `mttkrp_kernel_op`."""
    padded = tuple(pad_factor(f, chunk_shape[m]) for m, f in enumerate(qfactors))
    s = chunk_shape[mode]
    out = torch.zeros((-(-out_dim // s) * s, qfactors[0].shape[1]), dtype=torch.int32,
                      device=coords_rel.device)
    _count(out)
    mttkrp_fixed_local(padded, task_chunk, coords_rel, qvalues, mode=mode,
                       chunk_shape=chunk_shape, matrix_frac=matrix_frac,
                       value_frac=value_frac, prec_shift=prec_shift,
                       nnz_per_task=nnz_per_task, out=out)
    return out[:out_dim]


def _count(out: torch.Tensor) -> None:
    """A traced call's zero-filled (I_pad, R) output, I_pad = out_dim rounded
    up to whole chunks, in `obs.metrics.default_registry`."""
    if tracing_enabled():
        _metrics.default_registry.counter("mttkrp.out_bytes").inc(out.nbytes)
        _metrics.default_registry.counter("mttkrp.calls").inc()
