"""||X||² of CP-ALS's fit through the hand-written CUDA kernel of
`csrc/sum_squares.cu`, with no host synchronisation.

It has no Pallas counterpart: the reference takes ||X|| on the host every
iteration, and the port reduces ||X||² once a `cp_als` call from the values
already on the card.  torch's float64 reductions of a float32 tensor widen
a whole copy first (615 MB at NELL-2); the kernel widens in registers and
reads each value once, which is its bound.  `sum_squares` launches it for
CUDA tensors and raises if it cannot (a failed build or launch never falls
back to the plain version); for CPU tensors it runs the plain version,
`ref.sum_squares_ref`.  `launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

__all__ = ["sum_squares", "launches"]

#: Number of times `sum_squares` has launched the CUDA kernel.
launches = 0

_SOURCE = "sum_squares"
THREADS = 256  # kThreads
MAX_BLOCKS = 1024  # kMaxBlocks: the partials the wrapper sums
_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int]


def sum_squares(values: torch.Tensor) -> torch.Tensor:
    """Σ v² of the float32 vector `values`, squared and summed in float64,
    as a 0-d float64 tensor on its device.  The summation order depends on
    the length alone, so equal inputs give equal bits."""
    global launches
    if values.device.type == "cpu":
        return ref.sum_squares_ref(values)
    if values.device.type != "cuda":
        raise ValueError(f"no kernel for device {values.device}")
    if values.dim() != 1:
        raise ValueError(f"values must be a vector; got {tuple(values.shape)}")
    if values.dtype != torch.float32:
        raise TypeError(f"values must be torch.float32; got {values.dtype}")
    if not values.is_contiguous():
        raise ValueError("values must be contiguous")
    n = values.numel()
    if n == 0:
        return torch.zeros((), dtype=torch.float64, device=values.device)
    blocks = min(MAX_BLOCKS, -(-n // THREADS))
    partials = torch.empty(blocks, dtype=torch.float64, device=values.device)
    _build.call(_SOURCE, "prism_sum_squares_f32", _ARGTYPES, values.data_ptr(), n,
                partials.data_ptr(), blocks, device=values.device,
                context=f"n = {n}, blocks = {blocks}")
    launches += 1
    return partials.sum()
