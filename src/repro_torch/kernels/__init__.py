"""Hand-written CUDA kernels for the PRISM spMTTKRP hot spot.

`csrc/` holds the CUDA sources and `_build` compiles them at first use;
`mttkrp_kernel` wraps the float kernel, `ops` the padded full op, `ref` the
plain PyTorch versions.  Importing this package builds nothing.
"""
from .mttkrp_kernel import mttkrp_local
from .ops import mttkrp_kernel_op, pad_factor

__all__ = ["mttkrp_kernel_op", "mttkrp_local", "pad_factor"]
