"""Fixed-point chunked spMTTKRP (paper Alg. 2) through the hand-written CUDA
kernel `csrc/mttkrp_fixed.cu`, the port of the TPU kernel
`repro.kernels.mttkrp_fixed_kernel.mttkrp_fixed_pallas_local`.

`mttkrp_fixed_local` adds the MTTKRP into an (I_pad, R) int32 output (what
`ops.py` runs).  For CUDA tensors it launches the kernel in the tier that
`tiles.plan_launch` picks, and raises if it cannot; for CPU tensors it adds
the summed partials of the plain version, `ref.mttkrp_fixed_local_ref`.
`launches` counts kernel launches (plain-version calls are not counted).
"""
from __future__ import annotations

import torch

from . import ref, tiles

__all__ = ["launches", "mttkrp_fixed_local"]

#: Number of times `mttkrp_fixed_local` has launched the CUDA kernel.
launches = 0

_FACTOR_DTYPES = (torch.int8, torch.int16, torch.int32)
_VALUE_DTYPES = (torch.int16, torch.int32)


def mttkrp_fixed_local(qfactors, task_chunk, coords_rel, qvalues, *, mode: int,
                       chunk_shape: tuple[int, ...], matrix_frac: int, value_frac: int,
                       out: torch.Tensor, prec_shift: int = 0,
                       nnz_per_task: torch.Tensor | None = None,
                       plan: tiles.LaunchPlan | None = None) -> torch.Tensor:
    """Adds task t's (S_mode, R) int32 MTTKRP block, in Q(·, matrix_frac -
    prec_shift), into out's rows task_chunk[t, mode]·S_mode + [0, S_mode)
    (int32, wrapping), every t, and returns `out`.

    qfactors    : sequence of (rows_m, R), all int8, int16 or int32 (by preset;
                  ops.py pads rows to whole chunks)
    task_chunk  : (T, N) int32; coords_rel: (T, P, N) int32;
    qvalues     : (T, P) int16 or int32.
    out         : (I_pad, R) int32, I_pad a multiple of S_mode past every
                  task's chunk; the sums are added to what it holds.
    nnz_per_task: optional (T,) int32 live slots per task; the kernel reads no
                  slot at or past it (the caller guarantees those hold 0).
                  The plain version ignores it.
    plan        : a `tiles.plan_launch` result to launch instead of the one
                  chosen from the shapes and the card's shared memory.
    """
    global launches
    if coords_rel.device.type == "cpu":
        local = ref.mttkrp_fixed_local_ref(
            qfactors, task_chunk, coords_rel, qvalues, mode=mode, chunk_shape=chunk_shape,
            matrix_frac=matrix_frac, value_frac=value_frac, prec_shift=prec_shift,
            nnz_per_task=nnz_per_task)
        out.add_(ref.reduce_local(local, task_chunk, mode=mode, chunk_shape=chunk_shape,
                                  out_dim=out.shape[0]))
        return out
    tiles.check_inputs(qfactors, task_chunk, coords_rel, qvalues, mode, chunk_shape,
                       names=("qfactors", "qvalues"))
    fdtype = qfactors[0].dtype
    if fdtype not in _FACTOR_DTYPES:
        raise TypeError(f"qfactors must be one of {_FACTOR_DTYPES}; got {fdtype}")
    if qvalues.dtype not in _VALUE_DTYPES:
        raise TypeError(f"qvalues must be one of {_VALUE_DTYPES}; got {qvalues.dtype}")
    # A Qm.n factor keeps its sign bit beside its n fractional bits.
    if not 0 <= matrix_frac < torch.iinfo(fdtype).bits:
        raise TypeError(f"{fdtype} factors cannot hold {matrix_frac} fractional bits")
    if min(value_frac, prec_shift) < 0 or value_frac + prec_shift >= 32:
        raise ValueError(f"value_frac {value_frac} + prec_shift {prec_shift} must be in [0, 32)")
    factor_bytes, value_bytes = qfactors[0].element_size(), qvalues.element_size()
    if tiles.launch("mttkrp_fixed", "prism_mttkrp_fixed_local", qfactors, task_chunk,
                    coords_rel, qvalues, mode=mode, chunk_shape=chunk_shape,
                    nnz_per_task=nnz_per_task, plan=plan, out=out,
                    trailing=(matrix_frac, value_frac + prec_shift, factor_bytes, value_bytes)):
        launches += 1
    return out
