"""Pseudo-inverse of CP-ALS's Gram Hadamard products through the
hand-written CUDA kernel `csrc/gram_pinv.cu`, with no host synchronisation.

It ports `jnp.linalg.pinv` as the reference's `cp_als` calls it: V, the
Hadamard product of the other modes' Gram matrices, is symmetric positive
semi-definite, so its pseudo-inverse comes from an eigendecomposition, with
jnp's cutoff (`gram_pinv_rtol`).  There is no Pallas counterpart.

`gram_pinv` launches the kernel for CUDA tensors and raises if it cannot (a
failed build or launch never falls back to the plain version); for CPU
tensors it runs the plain version, `ref.gram_pinv_ref`.  `launches` counts
kernel launches (plain-version calls are not counted).
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import _build, ref, tiles

__all__ = ["gram_pinv", "launches"]

#: Number of times `gram_pinv` has launched the CUDA kernel.
launches = 0

_SOURCE = "gram_pinv"
_LAM_MAX_BYTES = 16  # the kernel's static shared memory beside its work area


@dataclasses.dataclass(frozen=True)
class PinvLaunch:
    """Where one launch keeps each matrix's work area: `smem_bytes` of
    dynamic shared memory, or (0 and) `scratch_bytes` of device memory per
    matrix when the area does not fit the card's shared memory."""

    smem_bytes: int
    scratch_bytes: int = 0


def work_bytes(rank: int) -> int:
    """Bytes of one matrix's float64 work area (A, V, one value per index);
    mirrors `prism_gram_pinv_work_bytes` in the CUDA source."""
    return 8 * (2 * rank * rank + rank + (rank & 1))


def plan_pinv(rank: int, smem_budget: int) -> PinvLaunch:
    """Shared memory when the work area fits `smem_budget`, else a global
    scratch buffer."""
    need = work_bytes(rank)
    return PinvLaunch(need) if need + _LAM_MAX_BYTES <= smem_budget else PinvLaunch(0, need)


def _entry():
    lib = _build.load(_SOURCE)
    fn = lib.prism_gram_pinv_f32
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_double, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
        lib.prism_cuda_error_string.restype = ctypes.c_char_p
        lib.prism_cuda_error_string.argtypes = [ctypes.c_int]
    return lib, fn


def gram_pinv(v: torch.Tensor, *, launch: PinvLaunch | None = None) -> torch.Tensor:
    """Pseudo-inverse of each symmetric positive semi-definite (R, R) matrix
    of `v` ((R, R) or (..., R, R) float32), keeping the directions whose
    |eigenvalue| exceeds `ref.gram_pinv_rtol(R)` times the largest, as
    `jnp.linalg.pinv` does.  Only the upper triangle is read.  `launch`
    forces a work-area placement (`plan_pinv`'s choice otherwise)."""
    global launches
    if v.device.type == "cpu":
        return ref.gram_pinv_ref(v)
    if v.device.type != "cuda":
        raise ValueError(f"no kernel for device {v.device}")
    if v.dim() < 2 or v.shape[-1] != v.shape[-2]:
        raise ValueError(f"v must be (..., R, R); got {tuple(v.shape)}")
    if v.dtype != torch.float32:
        raise TypeError(f"v must be torch.float32; got {v.dtype}")
    if not v.is_contiguous():
        raise ValueError("v must be contiguous")
    rank = v.shape[-1]
    out = torch.empty_like(v)
    n = v.numel() // (rank * rank) if rank else 0
    if n == 0:
        return out
    if launch is None:
        launch = plan_pinv(rank, tiles.device_budget(v.device))
    scratch = (torch.empty(n * launch.scratch_bytes // 8, dtype=torch.float64, device=v.device)
               if launch.scratch_bytes else None)
    lib, fn = _entry()
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        rc = fn(v.data_ptr(), out.data_ptr(), n, rank, ref.gram_pinv_rtol(rank),
                0 if scratch is None else scratch.data_ptr(), launch.smem_bytes, stream)
    tiles.raise_on(rc, lib, "gram_pinv", launch)
    launches += 1
    return out
