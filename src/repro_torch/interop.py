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

__all__ = ["chunked_from_reference", "factors_from_reference", "padded_batch_from_reference",
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
