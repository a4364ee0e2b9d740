"""Minimal functional NN substrate (counterpart of `repro.models.nn`):
params are nested dicts of tensors, every layer is a pair of plain
functions, init and apply.

Each init returns (params, specs): the specs tree names the logical axes
of each array, as the reference's does.  An init draws from the
`torch.Generator` it is given, on that generator's device; the arrays it
makes land there (`SHAPES` in a generator's place: meta tensors, the
counterpart of `jax.eval_shape` over an init).  The draws are torch's, not
`jax.random`'s: weights are carried across from the reference by
`repro_torch.interop.lm_params_from_reference`.
"""
from __future__ import annotations

import functools
import math

import torch

__all__ = [
    "Params", "dense_init", "embed_init", "rmsnorm_init",
    "linear", "rmsnorm", "layernorm", "apply_rope", "softcap",
    "param_count", "tree_cast", "tree_leaves", "tree_map", "tree_unflatten", "weak",
    "SHAPES",
]

Params = dict  # nested dict of tensors


def tree_map(fn, tree):
    """`fn` applied to every tensor leaf of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves in JAX's order: dict keys sorted, lists in order, None
    dropped (an empty subtree in JAX)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_unflatten(like, leaves):
    """`leaves`, in `tree_leaves` order, in the structure of `like`."""
    it = iter(leaves)

    def rebuild(t):
        if isinstance(t, dict):
            out = {k: rebuild(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(rebuild(v) for v in t)
        return None if t is None else next(it)
    tree = rebuild(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has places")
    return tree


class _Shapes:
    """Stands in for a `torch.Generator` in an init: every array lands on
    the meta device, so the init gives the tree's shapes and dtypes and
    allocates nothing."""
    device = torch.device("meta")


SHAPES = _Shapes()


@functools.lru_cache(maxsize=None)
def weak(value: float, dtype: torch.dtype) -> float:
    """A Python float as jnp applies it to an array of `dtype`: rounded to
    that dtype first (JAX's weak typing; torch would keep the full value).
    Cached: the decode loop asks for the same few constants every layer."""
    # repro-lint: disable=host-sync -- a CPU tensor made from a Python constant; no device value
    return torch.tensor(value, dtype=dtype).item()


def _normal(generator: torch.Generator, shape, dtype=None) -> torch.Tensor:
    if generator is SHAPES:
        return torch.empty(shape, dtype=dtype, device=generator.device)
    return torch.randn(shape, generator=generator, device=generator.device, dtype=dtype)


def dense_init(generator: torch.Generator, d_in: int, d_out: int, *, bias: bool = False,
               scale: float | None = None, axes=("in", "out"), dtype=torch.float32):
    """Returns (params, specs). Logical axes name the sharding intent."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = _normal(generator, (d_in, d_out), dtype).mul_(scale)
    p, s = {"w": w}, {"w": axes}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=generator.device)
        s["b"] = (axes[1],)
    return p, s


def embed_init(generator: torch.Generator, vocab: int, d: int, *, dtype=torch.float32):
    w = _normal(generator, (vocab, d), dtype).mul_(0.02)
    return {"w": w}, {"w": ("vocab", "embed")}


def rmsnorm_init(d: int, device: torch.device, dtype=torch.float32):
    return {"g": torch.ones((d,), dtype=dtype, device=device)}, {"g": (None,)}


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x @ w, the weight cast to the activation's type on every call."""
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Scales by 1 + g, in float32, and casts back."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + p["g"].float())).to(dtype)


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * p["g"].float()).to(dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D) rotary over last dim; positions (..., S).  The
    half-split rotation (first half against second), float32 angles."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].float() * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap)


def param_count(params: Params) -> int:
    return sum(a.numel() for a in tree_leaves(params))


def tree_cast(params: Params, dtype) -> Params:
    return tree_map(lambda a: a.to(dtype) if a.is_floating_point() else a, params)
