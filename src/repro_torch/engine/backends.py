"""The built-in execution strategies, as registry backends:

  ref      plain COO scatter (paper Fig. 1)
  alto     ALTO linearized format: one bit-interleaved index serving every
           mode, de-interleaved at call time (the "CPU" role); past 64 key
           bits the ALTO-ordered COO baseline
  csf      CSF fiber trees (`repro_torch.formats.csf`): per-mode trees with
           fiber-level factor reuse
  chunked  PRISM chunked format, plain PyTorch (the "PIM" role)
  kernel   PRISM chunked format through the hand-written CUDA kernel
           (counterpart of the reference's `pallas`); on a CPU device the
           kernel wrapper takes its plain version
  fixed    PRISM chunked format + paper Alg. 2 fixed point (presets int3,
           int7, int15-12) through the hand-written fixed-point CUDA
           kernel; on a CPU device the kernel wrapper takes its plain version
  hetero   dense/sparse split of the chunk tasks (paper §IV-D): dense tasks
           by one float32 einsum, sparse ones through the float CUDA kernel
  distributed
           PRISM chunked format over a (data, model) mesh of
           `torch.distributed` ranks (paper §IV-B): factor columns split on
           `model`, tasks on `data`, each rank's shard through the float
           CUDA kernel (its plain version on the CPU); needs 2 ranks to be
           eligible for the autotuner

`lockfree_mode` (the paper's lock-free lost updates, emulated by
`core.lockfree.wave_collision_mask`) is read by `chunked` and `fixed`, as
in the reference; `ref` and `kernel` ignore it, as the reference's `ref`
and `pallas` do.

Chunk-based builders pull their ChunkedTensor and device tensors from the
context's PlanCache, so several backends built against one tensor chunk it
once and move it to the card once; the format-based builders (`csf`,
`alto`) likewise pull their layouts from the context's FormatCache.
"""
from __future__ import annotations

import torch

from ..core import baselines, hetero, lockfree, mttkrp
from ..core.distributed import DistributedMTTKRP
from ..core.qformat import FIXED_PRESETS, value_qformat
from ..formats.alto import MAX_KEY_BITS, alto_key_bits
from ..kernels import ops as kops
from ..launch.mesh import join_launched_group, make_local_mesh, mesh_axes, world_size
from .registry import EngineContext, register_backend

__all__ = []  # backends are reached through the registry, not by import


def _lockfree_nnz(ctx: EngineContext, dev: dict):
    """The resident per-task nonzero counts when lock-free mode is on."""
    return dev["nnz_per_task"] if ctx.lockfree_mode else None


@register_backend("ref", description="plain COO scatter-add reference (paper Fig. 1)")
def _build_ref(ctx: EngineContext):
    # repro-lint: disable=host-sync -- engine build: the tensor's arrays are uploaded once and stay resident across iterations
    coords = torch.from_numpy(ctx.st.coords).to(ctx.device)
    # repro-lint: disable=host-sync -- engine build: the tensor's arrays are uploaded once and stay resident across iterations
    values = torch.from_numpy(ctx.st.values).to(ctx.device)
    shape = ctx.st.shape

    def engine(factors, mode):
        return mttkrp.mttkrp_coo(factors, coords, values, mode=mode, out_dim=shape[mode])
    return engine


@register_backend(
    "alto",
    description="ALTO linearized index: one bit-interleaved copy serves all modes (CPU role)")
def _build_alto(ctx: EngineContext):
    shape = ctx.st.shape
    if alto_key_bits(shape) > MAX_KEY_BITS:
        # The packed linearization caps at 64 key bits (BLCO block splitting
        # is the ROADMAP lift); beyond it, take the ALTO-*ordered* COO
        # baseline — same traversal order, explicit coordinates.
        order = baselines.alto_order(ctx.st.coords, shape)
        # repro-lint: disable=host-sync -- engine build: the tensor's arrays are uploaded once and stay resident across iterations
        a_coords = torch.from_numpy(ctx.st.coords[order]).to(ctx.device)
        # repro-lint: disable=host-sync -- engine build: the tensor's arrays are uploaded once and stay resident across iterations
        a_values = torch.from_numpy(ctx.st.values[order]).to(ctx.device)

        def engine(factors, mode):
            return baselines.mttkrp_alto(factors, a_coords, a_values, mode=mode,
                                         out_dim=shape[mode])
        return engine

    positions = ctx.formats.alto(ctx.st).positions
    dev = ctx.formats.device_alto(ctx.st, ctx.device)

    def engine(factors, mode):
        return mttkrp.mttkrp_alto(factors, dev["key_words"], dev["values"], mode=mode,
                                  positions=positions, out_dim=shape[mode])
    return engine


@register_backend(
    "csf",
    description="CSF fiber trees: interior factor rows fetched once per fiber")
def _build_csf(ctx: EngineContext):
    st, formats, device = ctx.st, ctx.formats, ctx.device

    def engine(factors, mode):
        # Trees build lazily per mode and come from the FormatCache, so
        # CP-ALS and repeated builds construct each tree exactly once.
        tree = formats.csf(st, mode)
        dev = formats.device_csf(st, mode, device)
        return mttkrp.mttkrp_csf(
            factors, dev["inner_coord"], dev["values"], dev["fiber_ids"], dev["fiber_coords"],
            mode=mode, inner_mode=tree.inner_mode, mid_modes=tree.mid_modes,
            out_dim=st.shape[mode], n_fibers=tree.n_fibers)
    return engine


@register_backend("chunked", needs_chunking=True,
                  description="PRISM chunked format, float, plain PyTorch (PIM role)")
def _build_chunked(ctx: EngineContext):
    dev = ctx.device_arrays()
    cs, shape = ctx.chunk_shape, ctx.st.shape
    nnz_pt = _lockfree_nnz(ctx, dev)

    def engine(factors, mode):
        vals = dev["values"]
        if nnz_pt is not None:
            vals = vals * lockfree.wave_collision_mask(dev["coords_rel"][:, :, mode], nnz_pt)
        return mttkrp.mttkrp_chunked(
            factors, dev["task_chunk"], dev["coords_rel"], vals,
            mode=mode, chunk_shape=cs, out_dim=shape[mode])
    return engine


@register_backend("kernel", needs_chunking=True, launches_kernel=True,
                  description="PRISM chunked format through the hand-written CUDA kernel")
def _build_kernel(ctx: EngineContext):
    dev = ctx.device_arrays()
    cs, shape = ctx.chunk_shape, ctx.st.shape

    def engine(factors, mode):
        return kops.mttkrp_kernel_op(
            factors, dev["task_chunk"], dev["coords_rel"], dev["values"],
            mode=mode, chunk_shape=cs, out_dim=shape[mode], nnz_per_task=dev["nnz_per_task"])
    return engine


@register_backend("fixed", needs_chunking=True, supports_fixed_point=True, lossless=False,
                  presets=tuple(FIXED_PRESETS), launches_kernel=True,
                  description="PRISM chunked + paper Alg. 2 fixed point through the "
                              "hand-written CUDA kernel")
def _build_fixed(ctx: EngineContext):
    qf, prec_shift = FIXED_PRESETS[ctx.fixed_preset]
    ct = ctx.chunked()
    dev = ctx.device_arrays()
    cs, shape = ct.chunk_shape, ctx.st.shape
    # The values are quantized once, on the host, to the runtime 16-bit format.
    vq = value_qformat(ctx.st.values, storage_bits=16)
    # repro-lint: disable=host-sync -- engine build: the tensor's arrays are uploaded once and stay resident across iterations
    qvalues = torch.from_numpy(vq.quantize_np(ct.values)).to(ctx.device)
    nnz_pt = _lockfree_nnz(ctx, dev)

    def engine(factors, mode):
        qfactors = [qf.quantize(f) for f in factors]
        qvals = qvalues
        if nnz_pt is not None:
            mask = lockfree.wave_collision_mask(dev["coords_rel"][:, :, mode], nnz_pt)
            qvals = qvals * mask.to(qvals.dtype)
        qout = kops.mttkrp_fixed_kernel_op(
            qfactors, dev["task_chunk"], dev["coords_rel"], qvals,
            mode=mode, chunk_shape=cs, out_dim=shape[mode],
            matrix_frac=qf.frac_bits, value_frac=vq.frac_bits, prec_shift=prec_shift,
            nnz_per_task=dev["nnz_per_task"])
        return mttkrp.dequantize_output(qout, qf.frac_bits, prec_shift)
    return engine


@register_backend("hetero", needs_chunking=True, launches_kernel=True,
                  description="dense (einsum)/sparse (CUDA kernel) split of the chunk tasks, "
                              "cost-model scheduled (paper §IV-D)")
def _build_hetero(ctx: EngineContext):
    ct = ctx.chunked()
    split = hetero.split_tasks(ct, ctx.rank, dense_fraction=ctx.dense_fraction)
    arrays = hetero.hetero_device_arrays(ct, split, ctx.device_arrays())
    cs, shape = ct.chunk_shape, ctx.st.shape

    def engine(factors, mode):
        return hetero.mttkrp_hetero(factors, arrays, mode=mode, chunk_shape=cs,
                                    out_dim=shape[mode])
    return engine


@register_backend("distributed", needs_chunking=True, min_devices=2, launches_kernel=True,
                  description="torch.distributed mesh: rank partitioning on `model`, tasks "
                              "on `data`, each shard through the CUDA kernel")
def _build_distributed(ctx: EngineContext):
    # Default to a real model axis when there are ranks for it, so rank
    # partitioning (the paper's favored, replication-free partitioning) is
    # exercised, not just the data/task axis.
    mesh = ctx.mesh
    if mesh is None:
        join_launched_group(ctx.device)  # under a launcher, the mesh spans its ranks
        mesh = make_local_mesh(n_model=2 if world_size() >= 2 else 1, device=ctx.device)
    if mesh.device_type != ctx.device.type:
        raise ValueError(f"the mesh is over {mesh.device_type} ranks; the engine's device "
                         f"is {ctx.device}")
    # At one data rank the task block is the whole tensor: take the plan
    # cache's resident arrays rather than move a second copy to the card.
    arrays = ctx.device_arrays() if mesh_axes(mesh)["data"] == 1 else None
    return DistributedMTTKRP(mesh, ctx.chunked(), ctx.rank, reduce=ctx.reduce, arrays=arrays)
