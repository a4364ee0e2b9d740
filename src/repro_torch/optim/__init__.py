"""The optimizer (counterpart of `repro.optim`): AdamW with float32 or
8-bit moments, and CP-rank gradient compression with error feedback."""
from .adamw import AdamWConfig, adamw_init, adamw_update
from .cp_compress import compress_grad, cp_compress_state, cp_compressed_mean

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "compress_grad", "cp_compress_state",
           "cp_compressed_mean"]
