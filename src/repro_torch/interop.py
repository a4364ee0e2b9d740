"""Turn the JAX package's state, as numpy arrays, into the port's.

Each function takes the reference's object (or anything with the same
attributes) and copies nothing it does not have to: host arrays stay numpy,
factors become float32 tensors on `device`, quantized factors keep their
integer type.  Nothing here imports the JAX
package.
"""
from __future__ import annotations

import numpy as np
import torch

from .batch.bucketing import PaddedBatch
from .core.chunking import ChunkedTensor
from .core.sptensor import SparseTensor
from .device import resolve_device
from .models.model import ENC_SPEC
from .models.nn import tree_map
from .models.transformer import segment_layout

__all__ = ["chunked_from_reference", "cp_state_from_reference", "factors_from_reference",
           "lm_params_from_reference", "opt_state_from_reference", "padded_batch_from_reference",
           "qfactors_from_reference", "tensor_from_reference"]


def tensor_from_reference(st) -> SparseTensor:
    """A `repro.core.SparseTensor` as the port's SparseTensor."""
    return SparseTensor(np.asarray(st.coords, dtype=np.int32),
                        np.asarray(st.values, dtype=np.float32),
                        tuple(int(d) for d in st.shape))


def chunked_from_reference(ct) -> ChunkedTensor:
    """A `repro.core.ChunkedTensor` as the port's ChunkedTensor."""
    return ChunkedTensor(
        np.asarray(ct.task_chunk, dtype=np.int32),
        np.asarray(ct.coords_rel, dtype=np.int32),
        np.asarray(ct.values, dtype=np.float32),
        np.asarray(ct.nnz_per_task, dtype=np.int32),
        tuple(int(s) for s in ct.chunk_shape),
        tuple(int(d) for d in ct.tensor_shape),
    )


def padded_batch_from_reference(pb) -> PaddedBatch:
    """A `repro.batch.PaddedBatch` as the port's PaddedBatch."""
    return PaddedBatch(
        dims=tuple(int(d) for d in pb.dims), band=int(pb.band),
        coords=np.asarray(pb.coords, dtype=np.int32),
        values=np.asarray(pb.values, dtype=np.float32),
        mask=np.asarray(pb.mask, dtype=np.float32),
        shapes=tuple(tuple(int(d) for d in s) for s in pb.shapes),
        nnz=tuple(int(k) for k in pb.nnz))


def factors_from_reference(factors, lam, device: str | torch.device | None = None):
    """CP factors and weights (numpy or JAX arrays) as float32 tensors on
    `device` (None → the CUDA card)."""
    device = resolve_device(device)

    def to_tensor(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
    return [to_tensor(f) for f in factors], to_tensor(lam)


def qfactors_from_reference(qfactors, device: str | torch.device | None = None):
    """Quantized factors (numpy or JAX integer arrays, as `QFormat.quantize`
    gives them) as tensors of the same integer type on `device` (None → the
    CUDA card)."""
    device = resolve_device(device)
    out = []
    for q in qfactors:
        a = np.array(q)
        if a.dtype.kind != "i":
            raise TypeError(f"quantized factors must be signed integers; got {a.dtype}")
        out.append(torch.from_numpy(a).to(device))
    return out


def _on_mesh(tree, cfg, mesh, opt_cfg=None):
    """tree (whole params, or an AdamW state with `opt_cfg`) cut to this
    rank's blocks on `mesh` (`launch.shardings`)."""
    from .launch import shardings as sh
    from .models.model import LM
    structs, specs = sh.init_shapes(LM(cfg))
    p_sh = sh.param_shardings(mesh, structs, specs)
    if opt_cfg is None:
        return sh.shard_tree(tree, p_sh, mesh)
    from .launch.steps import init_opt_shapes
    return sh.shard_tree(tree, sh.opt_shardings(mesh, init_opt_shapes(structs, opt_cfg), p_sh),
                         mesh)


def lm_params_from_reference(params, cfg, device: str | torch.device | None = None, *,
                             mesh=None) -> dict:
    """The reference's `LM.init` params (numpy or JAX arrays) as the port's,
    on `device` (None → the CUDA card), same dtypes.  The reference stacks
    each segment's pattern slot over its repeats (`{"b0": stacked, ...}`);
    repeat r of slot j becomes the port's layer r·len(pattern) + j of that
    segment, for the decoder's `layers` and an enc-dec model's `enc_layers`
    (one bidirectional block repeated `n_enc_layers` times).  The other
    leaves (`enc_norm` and `img_proj` among them) pass through.  With a
    `mesh`, each leaf is this rank's block of it (`shard_tree` by the
    resolved specs)."""
    device = resolve_device(device)

    def to_tensor(a):
        return torch.from_numpy(np.array(a)).to(device)

    def unstack(stacked, layout):
        return [[tree_map(lambda a, r=r: to_tensor(np.asarray(a)[r]), seg_p[f"b{j}"])
                 for r in range(reps) for j in range(len(pat))]
                for seg_p, (pat, reps) in zip(stacked, layout, strict=True)]
    layouts = {"layers": segment_layout(cfg.n_layers, cfg.pattern)}
    if cfg.encoder_decoder:
        layouts["enc_layers"] = segment_layout(cfg.n_enc_layers, (ENC_SPEC,))
    out = {k: unstack(v, layouts[k]) if k in layouts else tree_map(to_tensor, v)
           for k, v in params.items()}
    return out if mesh is None else _on_mesh(out, cfg, mesh)


def opt_state_from_reference(opt_state, cfg, device: str | torch.device | None = None, *,
                             mesh=None, opt_cfg=None) -> dict:
    """The reference's AdamW state for an LM's params (`adamw_init` or
    `adamw_update`'s) as the port's, on `device` (None → the CUDA card):
    `m` and `v` unstacked layer by layer as `lm_params_from_reference`
    unstacks the params (an 8-bit moment's `{"q", "s"}` too: its blocks lie
    along the last axis, so a row of the stack is that layer's state), and
    `step` a 0-d int32 tensor.  With a `mesh` (and the state's `opt_cfg`),
    this rank's blocks as `opt_shardings` places them."""
    device = resolve_device(device)
    out = {"m": lm_params_from_reference(opt_state["m"], cfg, device),
           "v": lm_params_from_reference(opt_state["v"], cfg, device),
           "step": torch.from_numpy(np.array(opt_state["step"], dtype=np.int32)).to(device)}
    return out if mesh is None else _on_mesh(out, cfg, mesh, opt_cfg)


def cp_state_from_reference(state, device: str | torch.device | None = None):
    """The reference's `cp_compress_state` tree (its `{"err", "q"}` pairs,
    None where a tensor is not compressed) as float32 tensors on `device`
    (None → the CUDA card), in the same structure."""
    device = resolve_device(device)
    return tree_map(lambda a: None if a is None else torch.from_numpy(
        np.array(a, dtype=np.float32)).to(device), state)
