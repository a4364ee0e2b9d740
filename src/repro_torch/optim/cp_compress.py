"""CP-rank-R gradient compression with error feedback (counterpart of
`repro.optim.cp_compress`).

For a 2-D gradient G, one CP-ALS sweep is one alternating-least-squares
low-rank step (P ← G Q, orthonormalised; Q ← Gᵀ P): the PowerSGD
iteration.  Across a group of ranks the *factors* are averaged instead of
the full gradient, which is the compressed collective: R·(rows + cols)
numbers per tensor where G has rows·cols.  Error feedback keeps the
residual on the rank and adds it back at the next step.

Two deviations from the reference, both deliberate:
- The reference seeds each tensor's initial Q from Python's `hash` of its
  path, which changes from process to process (string hashing is
  randomised); here the seed is `zlib.crc32` of the path, the same in every
  process and on every rank.
- A group of ranks is a `torch.distributed` group in the place of a JAX
  axis name; the mean is an `all_reduce` SUM divided by the group's size
  (gloo has no AVG).
"""
from __future__ import annotations

import math
import zlib

import torch
import torch.distributed as dist

__all__ = ["MIN_SIZE", "compress_grad", "cp_compress_state", "cp_compressed_mean"]

MIN_SIZE = 1 << 16  # don't compress tiny tensors


def _rows_cols(shape) -> tuple[int, int] | None:
    """The 2-D view a gradient of `shape` is compressed as (leading axis
    by the rest), or None for a vector."""
    if len(shape) == 1:
        return None
    return shape[0], math.prod(shape[1:])


def _mean(t: torch.Tensor, group) -> torch.Tensor:
    t = t.clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t.div_(dist.get_world_size(group))


def cp_compress_state(params, rank: int = 16, seed: int = 0):
    """Per tensor of at least MIN_SIZE entries and two or more axes, an
    error-feedback buffer and a random right factor Q (cols, rank), drawn
    on the param's device from a generator seeded by `seed` and the
    tensor's path; None for the others."""
    def init(path: str, p: torch.Tensor):
        rc = _rows_cols(tuple(p.shape))
        if rc is None or p.numel() < MIN_SIZE:
            return None
        gen = torch.Generator(p.device).manual_seed((seed << 32) | zlib.crc32(path.encode()))
        q = torch.randn((rc[1], rank), generator=gen, device=p.device, dtype=torch.float32)
        return {"err": torch.zeros(p.shape, dtype=torch.float32, device=p.device), "q": q}

    def walk(path: str, t):
        if isinstance(t, dict):
            return {k: walk(f"{path}[{k!r}]", v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(f"{path}[{i}]", v) for i, v in enumerate(t))
        return init(path, t)
    return walk("", params)


def compress_grad(g: torch.Tensor, st: dict | None, group=None):
    """One ALS sweep (CP-ALS on a matrix) with error feedback.  Returns
    (the compressed gradient in g's dtype, the new state).  With a
    `torch.distributed` group the factors are averaged over it (an
    uncompressed tensor, `st` None, is averaged whole)."""
    if st is None:
        if group is not None:
            g = _mean(g, group)
        return g, st
    shape = g.shape
    gf = g.float() + st["err"]
    g2 = gf.reshape(_rows_cols(tuple(shape)))
    # ALS half-step 1: P = G Q, orthonormalised (stabilises like pinv(QᵀQ))
    p = g2 @ st["q"]
    if group is not None:
        p = _mean(p, group)
    p, _ = torch.linalg.qr(p)
    # ALS half-step 2: Q = Gᵀ P
    q_new = g2.T @ p
    if group is not None:
        q_new = _mean(q_new, group)
    approx = (p @ q_new.T).reshape(shape)
    err = gf - approx
    return approx.to(g.dtype), {"err": err, "q": q_new}


def cp_compressed_mean(grads, state, group=None):
    """`compress_grad` over a gradient tree and its state tree (the same
    structure, None where a tensor is not compressed).  Returns (grads,
    new_state)."""
    if isinstance(grads, dict):
        out = {k: cp_compressed_mean(grads[k], state[k], group) for k in grads}
        return {k: v[0] for k, v in out.items()}, {k: v[1] for k, v in out.items()}
    if isinstance(grads, (list, tuple)):
        out = [cp_compressed_mean(g, s, group) for g, s in zip(grads, state, strict=True)]
        return type(grads)(o[0] for o in out), type(grads)(o[1] for o in out)
    return compress_grad(grads, state, group)
