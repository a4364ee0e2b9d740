"""The built-in execution strategies, as registry backends:

  ref      plain COO scatter (paper Fig. 1)
  chunked  PRISM chunked format, plain PyTorch (the "PIM" role)
  kernel   PRISM chunked format through the hand-written CUDA kernel
           (counterpart of the reference's `pallas`); on a CPU device the
           kernel wrapper takes its plain version

Chunk-based builders pull their ChunkedTensor and device tensors from the
context's PlanCache, so several backends built against one tensor chunk it
once and move it to the card once.
"""
from __future__ import annotations

import torch

from ..core import mttkrp
from ..kernels import ops as kops
from .registry import EngineContext, register_backend

__all__ = []  # backends are reached through the registry, not by import


@register_backend("ref", description="plain COO scatter-add reference (paper Fig. 1)")
def _build_ref(ctx: EngineContext):
    coords = torch.from_numpy(ctx.st.coords).to(ctx.device)
    values = torch.from_numpy(ctx.st.values).to(ctx.device)
    shape = ctx.st.shape

    def engine(factors, mode):
        return mttkrp.mttkrp_coo(factors, coords, values, mode=mode, out_dim=shape[mode])
    return engine


@register_backend("chunked", needs_chunking=True,
                  description="PRISM chunked format, float, plain PyTorch (PIM role)")
def _build_chunked(ctx: EngineContext):
    dev = ctx.device_arrays()
    cs, shape = ctx.chunk_shape, ctx.st.shape

    def engine(factors, mode):
        return mttkrp.mttkrp_chunked(
            factors, dev["task_chunk"], dev["coords_rel"], dev["values"],
            mode=mode, chunk_shape=cs, out_dim=shape[mode])
    return engine


@register_backend("kernel", needs_chunking=True,
                  description="PRISM chunked format through the hand-written CUDA kernel")
def _build_kernel(ctx: EngineContext):
    dev = ctx.device_arrays()
    cs, shape = ctx.chunk_shape, ctx.st.shape

    def engine(factors, mode):
        return kops.mttkrp_kernel_op(
            factors, dev["task_chunk"], dev["coords_rel"], dev["values"],
            mode=mode, chunk_shape=cs, out_dim=shape[mode])
    return engine
