"""Chunked spMTTKRP through the hand-written CUDA kernel `csrc/mttkrp.cu`,
the port of the TPU kernel `repro.kernels.mttkrp_kernel.mttkrp_pallas_local`.

`mttkrp_local` adds the MTTKRP into an (I_pad, R) output (what `ops.py`
runs).  For CUDA tensors it launches the kernel in the tier that
`tiles.plan_launch` picks from the shapes and the card's shared memory,
and raises if it cannot (a refused launch never falls back to another tier
or to the plain version); for CPU tensors it adds the summed partials of
the plain version, `ref.mttkrp_local_ref`.  `launches` counts kernel
launches (plain-version calls are not counted).
"""
from __future__ import annotations

import torch

from . import ref, tiles

__all__ = ["launches", "mttkrp_local"]

#: Number of times `mttkrp_local` has launched the CUDA kernel.
launches = 0


def mttkrp_local(factors, task_chunk, coords_rel, values, *, mode: int,
                 chunk_shape: tuple[int, ...], out: torch.Tensor,
                 nnz_per_task: torch.Tensor | None = None,
                 plan: tiles.LaunchPlan | None = None) -> torch.Tensor:
    """Adds task t's (S_mode, R) f32 MTTKRP block into out's rows
    task_chunk[t, mode]·S_mode + [0, S_mode), every t, and returns `out`.

    factors     : sequence of (rows_m, R) f32 (ops.py pads rows to whole chunks)
    task_chunk  : (T, N) int32; coords_rel: (T, P, N) int32; values: (T, P) f32.
    out         : (I_pad, R) f32, I_pad a multiple of S_mode past every
                  task's chunk; the sums are added to what it holds.
    nnz_per_task: optional (T,) int32 live slots per task; the kernel reads no
                  slot at or past it (the caller guarantees those hold 0).
                  The plain version ignores it.
    plan        : a `tiles.plan_launch` result to launch instead of the one
                  chosen from the shapes and the card's shared memory.
    """
    global launches
    if coords_rel.device.type == "cpu":
        local = ref.mttkrp_local_ref(factors, task_chunk, coords_rel, values, mode=mode,
                                     chunk_shape=chunk_shape, nnz_per_task=nnz_per_task)
        out.add_(ref.reduce_local(local, task_chunk, mode=mode, chunk_shape=chunk_shape,
                                  out_dim=out.shape[0]))
        return out
    tiles.check_inputs(factors, task_chunk, coords_rel, values, mode, chunk_shape,
                       factor_dtype=torch.float32, value_dtype=torch.float32)
    if tiles.launch("mttkrp", "prism_mttkrp_local_f32", factors, task_chunk, coords_rel, values,
                    mode=mode, chunk_shape=chunk_shape, nnz_per_task=nnz_per_task, plan=plan,
                    out=out):
        launches += 1
    return out
