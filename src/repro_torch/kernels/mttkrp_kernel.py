"""Chunked spMTTKRP per-task partials through the hand-written CUDA kernel
`csrc/mttkrp.cu`, the port of the TPU kernel
`repro.kernels.mttkrp_kernel.mttkrp_pallas_local`.

`mttkrp_local` launches the kernel for CUDA tensors, in the tier that
`tiles.plan_launch` picks from the shapes and the card's shared memory,
and raises if it cannot (a refused launch never falls back to another tier
or to the plain version); for CPU tensors it runs the plain version,
`ref.mttkrp_local_ref`.  `launches` counts kernel launches (plain-version
calls are not counted).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref, tiles

__all__ = ["launches", "mttkrp_local"]

#: Number of times `mttkrp_local` has launched the CUDA kernel.
launches = 0

_SOURCE = "mttkrp"


def _entry():
    lib = _build.load(_SOURCE)
    fn = lib.prism_mttkrp_local_f32
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = tiles.entry_argtypes(0)
        lib.prism_cuda_error_string.restype = ctypes.c_char_p
        lib.prism_cuda_error_string.argtypes = [ctypes.c_int]
    return lib, fn


def _check(factors, task_chunk, coords_rel, values, mode, chunk_shape):
    n = len(factors)
    if n < 2:
        raise ValueError(f"spMTTKRP needs at least 2 modes; got {n}")
    if not 0 <= mode < n or len(chunk_shape) != n:
        raise ValueError(f"mode {mode} / chunk_shape {chunk_shape} do not fit {n} modes")
    if coords_rel.dim() != 3 or coords_rel.shape[2] != n:
        raise ValueError(f"coords_rel must be (T, P, {n}); got {tuple(coords_rel.shape)}")
    t, p, _ = coords_rel.shape
    if tuple(task_chunk.shape) != (t, n) or tuple(values.shape) != (t, p):
        raise ValueError(
            f"task_chunk {tuple(task_chunk.shape)} / values {tuple(values.shape)} "
            f"do not match coords_rel {tuple(coords_rel.shape)}")
    rank = factors[0].shape[1]
    for name, x, dtype in [("task_chunk", task_chunk, torch.int32),
                           ("coords_rel", coords_rel, torch.int32),
                           ("values", values, torch.float32),
                           *[(f"factors[{m}]", f, torch.float32) for m, f in enumerate(factors)]]:
        if x.device != coords_rel.device:
            raise ValueError(f"{name} is on {x.device}, coords_rel on {coords_rel.device}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}; got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for m, f in enumerate(factors):
        if f.dim() != 2 or f.shape[1] != rank or (m != mode and f.shape[0] < 1):
            raise ValueError(f"factors[{m}] must be (rows >= 1, {rank}); got {tuple(f.shape)}")


def mttkrp_local(factors, task_chunk, coords_rel, values, *, mode: int,
                 chunk_shape: tuple[int, ...], nnz_per_task: torch.Tensor | None = None,
                 plan: tiles.LaunchPlan | None = None) -> torch.Tensor:
    """Per-task partial MTTKRP: returns (T, S_mode, R) f32 chunk-local blocks.

    factors     : sequence of (rows_m, R) f32 (ops.py pads rows to whole chunks)
    task_chunk  : (T, N) int32; coords_rel: (T, P, N) int32; values: (T, P) f32.
    nnz_per_task: optional (T,) int32 live slots per task; the kernel reads no
                  slot at or past it (the caller guarantees those hold 0).
                  The plain version ignores it.
    plan        : a `tiles.plan_launch` result to launch instead of the one
                  chosen from the shapes and the card's shared memory.
    """
    global launches
    if coords_rel.device.type == "cpu":
        return ref.mttkrp_local_ref(factors, task_chunk, coords_rel, values, mode=mode,
                                    chunk_shape=chunk_shape, nnz_per_task=nnz_per_task)
    if coords_rel.device.type != "cuda":
        raise ValueError(f"no kernel for device {coords_rel.device}")
    _check(factors, task_chunk, coords_rel, values, mode, chunk_shape)
    tiles.check_nnz_per_task(nnz_per_task, coords_rel)
    t, p, n = coords_rel.shape
    rank = factors[0].shape[1]
    device = coords_rel.device
    shape = (t, chunk_shape[mode], rank)
    if t == 0 or p == 0 or rank == 0:
        return torch.zeros(shape, dtype=torch.float32, device=device)
    if plan is None:
        plan = tiles.plan_launch(t, p, chunk_shape, mode, rank,
                                 smem_budget=tiles.device_budget(device))
    lib, fn = _entry()
    local = tiles.new_output(plan, shape, torch.float32, device)
    meta, *launch = tiles.launch_args(factors, mode, chunk_shape, plan, device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(task_chunk.data_ptr(), coords_rel.data_ptr(), values.data_ptr(),
                meta.data_ptr(), 0 if nnz_per_task is None else nnz_per_task.data_ptr(),
                local.data_ptr(), t, p, n, rank, mode, *launch, stream)
    tiles.raise_on(rc, lib, "mttkrp", plan)
    launches += 1
    return local
