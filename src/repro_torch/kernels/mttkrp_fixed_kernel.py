"""Fixed-point chunked spMTTKRP per-task partials (paper Alg. 2) through the
hand-written CUDA kernel `csrc/mttkrp_fixed.cu`, the port of the TPU kernel
`repro.kernels.mttkrp_fixed_kernel.mttkrp_fixed_pallas_local`.

`mttkrp_fixed_local` launches the kernel for CUDA tensors, in the tier that
`tiles.plan_launch` picks, and raises if it cannot; for CPU tensors it runs
the plain version, `ref.mttkrp_fixed_local_ref`.  `launches` counts kernel
launches (plain-version calls are not counted).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref, tiles

__all__ = ["launches", "mttkrp_fixed_local"]

#: Number of times `mttkrp_fixed_local` has launched the CUDA kernel.
launches = 0

_SOURCE = "mttkrp_fixed"
_FACTOR_DTYPES = (torch.int8, torch.int16, torch.int32)
_VALUE_DTYPES = (torch.int16, torch.int32)


def _entry():
    lib = _build.load(_SOURCE)
    fn = lib.prism_mttkrp_fixed_local
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = tiles.entry_argtypes(4)
        lib.prism_cuda_error_string.restype = ctypes.c_char_p
        lib.prism_cuda_error_string.argtypes = [ctypes.c_int]
    return lib, fn


def _check(qfactors, task_chunk, coords_rel, qvalues, mode, chunk_shape,
           matrix_frac, value_frac, prec_shift):
    n = len(qfactors)
    if n < 2:
        raise ValueError(f"spMTTKRP needs at least 2 modes; got {n}")
    if not 0 <= mode < n or len(chunk_shape) != n:
        raise ValueError(f"mode {mode} / chunk_shape {chunk_shape} do not fit {n} modes")
    if coords_rel.dim() != 3 or coords_rel.shape[2] != n:
        raise ValueError(f"coords_rel must be (T, P, {n}); got {tuple(coords_rel.shape)}")
    t, p, _ = coords_rel.shape
    if tuple(task_chunk.shape) != (t, n) or tuple(qvalues.shape) != (t, p):
        raise ValueError(
            f"task_chunk {tuple(task_chunk.shape)} / qvalues {tuple(qvalues.shape)} "
            f"do not match coords_rel {tuple(coords_rel.shape)}")
    fdtype = qfactors[0].dtype
    if fdtype not in _FACTOR_DTYPES:
        raise TypeError(f"qfactors must be one of {_FACTOR_DTYPES}; got {fdtype}")
    if qvalues.dtype not in _VALUE_DTYPES:
        raise TypeError(f"qvalues must be one of {_VALUE_DTYPES}; got {qvalues.dtype}")
    # A Qm.n factor keeps its sign bit beside its n fractional bits.
    bits = torch.iinfo(fdtype).bits
    if not 0 <= matrix_frac < bits:
        raise TypeError(f"{fdtype} factors cannot hold {matrix_frac} fractional bits")
    if min(value_frac, prec_shift) < 0 or value_frac + prec_shift >= 32:
        raise ValueError(f"value_frac {value_frac} + prec_shift {prec_shift} must be in [0, 32)")
    rank = qfactors[0].shape[1]
    for name, x, dtype in [("task_chunk", task_chunk, torch.int32),
                           ("coords_rel", coords_rel, torch.int32),
                           ("qvalues", qvalues, qvalues.dtype),
                           *[(f"qfactors[{m}]", f, fdtype) for m, f in enumerate(qfactors)]]:
        if x.device != coords_rel.device:
            raise ValueError(f"{name} is on {x.device}, coords_rel on {coords_rel.device}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}; got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for m, f in enumerate(qfactors):
        if f.dim() != 2 or f.shape[1] != rank or (m != mode and f.shape[0] < 1):
            raise ValueError(f"qfactors[{m}] must be (rows >= 1, {rank}); got {tuple(f.shape)}")


def mttkrp_fixed_local(qfactors, task_chunk, coords_rel, qvalues, *, mode: int,
                       chunk_shape: tuple[int, ...], matrix_frac: int, value_frac: int,
                       prec_shift: int = 0, nnz_per_task: torch.Tensor | None = None,
                       plan: tiles.LaunchPlan | None = None) -> torch.Tensor:
    """Fixed-point per-task partials: returns (T, S_mode, R) int32 chunk-local
    blocks in Q(·, matrix_frac - prec_shift).

    qfactors    : sequence of (rows_m, R), all int8, int16 or int32 (by preset;
                  ops.py pads rows to whole chunks)
    task_chunk  : (T, N) int32; coords_rel: (T, P, N) int32;
    qvalues     : (T, P) int16 or int32.
    nnz_per_task: optional (T,) int32 live slots per task; the kernel reads no
                  slot at or past it (the caller guarantees those hold 0).
                  The plain version ignores it.
    plan        : a `tiles.plan_launch` result to launch instead of the one
                  chosen from the shapes and the card's shared memory.
    """
    global launches
    if coords_rel.device.type == "cpu":
        return ref.mttkrp_fixed_local_ref(
            qfactors, task_chunk, coords_rel, qvalues, mode=mode, chunk_shape=chunk_shape,
            matrix_frac=matrix_frac, value_frac=value_frac, prec_shift=prec_shift,
            nnz_per_task=nnz_per_task)
    if coords_rel.device.type != "cuda":
        raise ValueError(f"no kernel for device {coords_rel.device}")
    _check(qfactors, task_chunk, coords_rel, qvalues, mode, chunk_shape,
           matrix_frac, value_frac, prec_shift)
    tiles.check_nnz_per_task(nnz_per_task, coords_rel)
    t, p, n = coords_rel.shape
    rank = qfactors[0].shape[1]
    device = coords_rel.device
    shape = (t, chunk_shape[mode], rank)
    if t == 0 or p == 0 or rank == 0:
        return torch.zeros(shape, dtype=torch.int32, device=device)
    factor_bytes, value_bytes = qfactors[0].element_size(), qvalues.element_size()
    if plan is None:
        plan = tiles.plan_launch(t, p, chunk_shape, mode, rank, factor_bytes=factor_bytes,
                                 value_bytes=value_bytes, smem_budget=tiles.device_budget(device))
    lib, fn = _entry()
    local = tiles.new_output(plan, shape, torch.int32, device)
    meta, *launch = tiles.launch_args(qfactors, mode, chunk_shape, plan, device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(task_chunk.data_ptr(), coords_rel.data_ptr(), qvalues.data_ptr(),
                meta.data_ptr(), 0 if nnz_per_task is None else nnz_per_task.data_ptr(),
                local.data_ptr(), t, p, n, rank, mode, *launch, matrix_frac,
                value_frac + prec_shift, factor_bytes, value_bytes, stream)
    tiles.raise_on(rc, lib, "mttkrp_fixed", plan)
    launches += 1
    return local
