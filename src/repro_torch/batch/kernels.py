"""Batched MTTKRP: one bucket's members in one set of tensor ops.

Counterpart of `repro.batch.kernels`, which `jax.vmap`s the plain
`mttkrp_coo` and `mttkrp_alto` over the bucket's batch axis.  Neither runs
a Pallas kernel there, so neither is a hand-written kernel here: both are
plain PyTorch tensor ops, as the port's single-tensor `ref` and `alto` ops
are (`core/mttkrp.py`).

In place of a vmap the batch is flattened.  Row i of member b of a
(B, I, R) factor is row ``b·I + i`` of its (B·I, R) view, so each other
mode's rows come from one `index_select` over all B·P slots, and the output
from one `index_add_drop` into (B·I_mode, R), reshaped to (B, I_mode, R).
Per member the indices keep the reference's semantics: a gather clamps
into the member's own rows (as `jnp` indexing clamps), and a scatter row
outside them is dropped (as ``.at[].add(mode="drop")`` drops it), never
added to a neighbour's.

Candidates:

  ref   — the batched COO op.  Padded slots carry value 0.0, so their
          scatter-add contribution is exactly zero.  The flat rows are
          computed once, when the engine is built.
  alto  — the batched ALTO op.  Each member is linearized against the
          PADDED dims with `build_alto`; the bit-interleave positions depend
          only on the shape, and every member shares the padded shape class,
          so one `positions` tuple decodes all B·P keys at call time.  (CSF
          is not a candidate: its fiber count differs per member.)

A factory takes the bucket's `PaddedBatch` and a device, moves the batch
arrays to the device once, and returns ``engine(factors, mode) -> (B,
dims[mode], R)`` with ``factors`` a list of ``(B, dims[m], R)`` batched
factor matrices on that device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.mttkrp import _alto_decode, index_add_drop
from ..core.sptensor import SparseTensor
from ..device import resolve_device
from ..formats.alto import build_alto
from .bucketing import PaddedBatch

__all__ = ["batched_kernel_names", "build_batched_kernel"]


def _flat_rows(coords: torch.Tensor, dim: int, *, gather: bool) -> torch.Tensor:
    """(B, P) member-local rows → (B·P,) rows of the (B·dim, R) view.  A
    gather clamps into [0, dim); a scatter sends an out-of-range row to
    B·dim, which `index_add_drop` drops."""
    c = coords.to(torch.int64)
    base = torch.arange(c.shape[0], dtype=torch.int64, device=c.device)[:, None] * dim
    if gather:
        return (base + c.clamp(0, dim - 1)).reshape(-1)
    return torch.where((c >= 0) & (c < dim), base + c, c.shape[0] * dim).reshape(-1)


def _batched_mttkrp(factors, gather_rows, scatter_rows, values, *, mode: int,
                    out_dim: int) -> torch.Tensor:
    """factors: sequence of (B, I_m, R); gather_rows[m] and scatter_rows
    (B·P,) flat rows; values (B·P,) f32.  Returns (B, out_dim, R) f32."""
    part = values[:, None]
    for m, f in enumerate(factors):
        if m != mode:
            part = part * f.reshape(-1, f.shape[-1]).index_select(0, gather_rows[m])
    b = factors[0].shape[0]
    return index_add_drop(b * out_dim, scatter_rows, part).reshape(b, out_dim, -1)


def _build_ref(pb: PaddedBatch, device: torch.device):
    coords = torch.from_numpy(pb.coords).to(device)
    values = torch.from_numpy(pb.values).to(device).reshape(-1)
    dims = pb.dims
    gather = [_flat_rows(coords[:, :, m], d, gather=True) for m, d in enumerate(dims)]
    scatter = [_flat_rows(coords[:, :, m], d, gather=False) for m, d in enumerate(dims)]
    del coords

    def engine(factors, mode: int):
        return _batched_mttkrp(factors, gather, scatter[mode], values, mode=int(mode),
                               out_dim=dims[mode])
    return engine


def _build_alto(pb: PaddedBatch, device: torch.device):
    # Linearize each member against the PADDED dims: the interleave
    # positions are a function of the shape alone, so the whole bucket
    # shares one decode — padded slots (coords 0, value 0) sort to the
    # front as key 0 and contribute zero to the sum.
    alto = [build_alto(SparseTensor(pb.coords[i], pb.values[i], pb.dims))
            for i in range(pb.size)]
    key_words = np.stack([a.key_words for a in alto]).view(np.int32)  # (B, P, W)
    b, p = key_words.shape[:2]
    # One contiguous (B·P,) column per key word, as `mttkrp_alto` reads
    # them; int32 views of the uint32 words (torch has no uint32 shift).
    words = [torch.from_numpy(np.ascontiguousarray(key_words[:, :, w])).to(device).reshape(-1)
             for w in range(key_words.shape[2])]
    values = torch.from_numpy(np.stack([a.values for a in alto])).to(device).reshape(-1)
    positions = alto[0].positions
    dims = pb.dims

    def engine(factors, mode: int):
        mode = int(mode)
        coords = [_alto_decode(words, positions[m]).reshape(b, p) for m in range(len(dims))]
        gather = [None if m == mode else _flat_rows(c, dims[m], gather=True)
                  for m, c in enumerate(coords)]
        scatter = _flat_rows(coords[mode], dims[mode], gather=False)
        return _batched_mttkrp(factors, gather, scatter, values, mode=mode,
                               out_dim=dims[mode])
    return engine


#: name -> factory(PaddedBatch, device) -> engine.  Enumerations go through
#: `batched_kernel_names()` (sorted) so registration order never leaks into
#: probe order or tie-breaks.
_BATCHED_FACTORIES = {
    "alto": _build_alto,
    "ref": _build_ref,
}


def batched_kernel_names() -> list[str]:
    """The registered batched kernels, sorted by name."""
    return sorted(_BATCHED_FACTORIES)


def build_batched_kernel(name: str, pb: PaddedBatch,
                         device: str | torch.device | None = None):
    """Build the named batched kernel against one bucket's padded arrays on
    `device` (None: the CUDA card, raising where there is none)."""
    try:
        factory = _BATCHED_FACTORIES[name]
    except KeyError:
        raise ValueError(
            f"unknown batched kernel {name!r}; registered: "
            f"{batched_kernel_names()}") from None
    return factory(pb, resolve_device(device))
