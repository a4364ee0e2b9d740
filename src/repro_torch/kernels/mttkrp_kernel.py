"""Chunked spMTTKRP per-task partials through the hand-written CUDA kernel
`csrc/mttkrp.cu`, the port of the TPU kernel
`repro.kernels.mttkrp_kernel.mttkrp_pallas_local`.

`mttkrp_local` launches the kernel for CUDA tensors and raises if it cannot;
for CPU tensors it runs the plain version, `ref.mttkrp_local_ref`.
`launches` counts kernel launches (plain-version calls are not counted).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

__all__ = ["launches", "mttkrp_local"]

#: Number of times `mttkrp_local` has launched the CUDA kernel.
launches = 0

_SOURCE = "mttkrp"


def _entry():
    lib = _build.load(_SOURCE)
    fn = lib.prism_mttkrp_local_f32
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
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


def mttkrp_local(factors, task_chunk, coords_rel, values, *,
                 mode: int, chunk_shape: tuple[int, ...]) -> torch.Tensor:
    """Per-task partial MTTKRP: returns (T, S_mode, R) f32 chunk-local blocks.

    factors   : sequence of (rows_m, R) f32 (ops.py pads rows to whole chunks)
    task_chunk: (T, N) int32; coords_rel: (T, P, N) int32; values: (T, P) f32.
    """
    global launches
    if coords_rel.device.type == "cpu":
        return ref.mttkrp_local_ref(factors, task_chunk, coords_rel, values,
                                    mode=mode, chunk_shape=chunk_shape)
    if coords_rel.device.type != "cuda":
        raise ValueError(f"no kernel for device {coords_rel.device}")
    _check(factors, task_chunk, coords_rel, values, mode, chunk_shape)
    t, p, n = coords_rel.shape
    rank = factors[0].shape[1]
    device = coords_rel.device
    local = torch.zeros((t, chunk_shape[mode], rank), dtype=torch.float32, device=device)
    if t == 0 or p == 0 or rank == 0:
        return local
    lib, fn = _entry()
    # (3, N): factor address, factor rows, chunk size per mode.  Pinned and
    # copied without blocking, so the launch adds no host synchronisation.
    meta = torch.tensor(
        [[0 if m == mode else f.data_ptr() for m, f in enumerate(factors)],
         [f.shape[0] for f in factors],
         list(chunk_shape)], dtype=torch.int64).pin_memory()
    meta = meta.to(device, non_blocking=True)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(task_chunk.data_ptr(), coords_rel.data_ptr(), values.data_ptr(),
                meta.data_ptr(), local.data_ptr(), t, p, n, rank, mode, stream)
    if rc != 0:
        raise RuntimeError(
            f"mttkrp kernel launch failed: {lib.prism_cuda_error_string(rc).decode()} ({rc})")
    launches += 1
    return local
