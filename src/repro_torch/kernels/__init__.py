"""Hand-written CUDA kernels for the PRISM spMTTKRP hot spot.

`csrc/` holds the CUDA sources (two kernels on one tiling,
`csrc/mttkrp_tiles.cuh`) and `_build` compiles them at first use (raising
`KernelError` when a kernel cannot be built, loaded or launched); `tiles`
plans each launch (tier, blocks per task, shared memory); `mttkrp_kernel`
wraps the float kernel, `mttkrp_fixed_kernel` the fixed-point one (paper
Alg. 2), `ops` the padded full ops, `ref` the plain PyTorch versions.
Importing this package builds nothing.
"""
from ._build import KernelError
from .mttkrp_fixed_kernel import mttkrp_fixed_local
from .mttkrp_kernel import mttkrp_local
from .ops import mttkrp_fixed_kernel_op, mttkrp_kernel_op, pad_factor

__all__ = ["KernelError", "mttkrp_fixed_kernel_op", "mttkrp_fixed_local", "mttkrp_kernel_op", "mttkrp_local",
           "pad_factor"]
