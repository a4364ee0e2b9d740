"""Minimal functional NN substrate (counterpart of `repro.models.nn`):
params are nested dicts of tensors, every layer is a pair of plain
functions, init and apply.

Each init returns (params, specs): the specs tree names the logical axes
of each array, as the reference's does.  An init draws from the
`torch.Generator` it is given, on that generator's device; the arrays it
makes land there (`SHAPES` in a generator's place: meta tensors, the
counterpart of `jax.eval_shape` over an init).  The draws are torch's, not
`jax.random`'s: weights are carried across from the reference by
`repro_torch.interop.lm_params_from_reference`.  An init's `dtype` is the
params' type: each leaf is drawn in float32, scaled, and cast to it before
the next is drawn (the reference draws the whole tree in float32 and casts
it after), so a bfloat16 model never has a float32 copy.
"""
from __future__ import annotations

import functools
import math

import torch

__all__ = [
    "Params", "dense_init", "embed_init", "rmsnorm_init",
    "linear", "rmsnorm", "layernorm", "apply_rope", "softcap",
    "param_count", "tree_cast", "tree_leaves", "tree_map", "tree_unflatten", "weak",
    "SHAPES", "normal", "uniform", "silu", "gelu", "softplus", "log_sigmoid",
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


def normal(generator: torch.Generator, shape, scale: float = 1.0,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A standard normal draw in float32 times `scale`, cast to `dtype`."""
    if generator is SHAPES:
        return torch.empty(shape, dtype=dtype, device=generator.device)
    w = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32).mul_(scale)
    return w.to(dtype)


def uniform(generator: torch.Generator, shape) -> torch.Tensor:
    """A float32 draw from [0, 1) (meta under `SHAPES`)."""
    if generator is SHAPES:
        return torch.empty(shape, dtype=torch.float32, device=generator.device)
    return torch.rand(shape, generator=generator, device=generator.device, dtype=torch.float32)


def dense_init(generator: torch.Generator, d_in: int, d_out: int, *, bias: bool = False,
               scale: float | None = None, axes=("in", "out"), dtype=torch.float32):
    """Returns (params, specs). Logical axes name the sharding intent."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = normal(generator, (d_in, d_out), scale, dtype)
    p, s = {"w": w}, {"w": axes}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=generator.device)
        s["b"] = (axes[1],)
    return p, s


def embed_init(generator: torch.Generator, vocab: int, d: int, *, dtype=torch.float32):
    w = normal(generator, (vocab, d), 0.02, dtype)
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


# jax.nn.gelu (its default, the tanh approximation), silu, softplus
# (jnp.logaddexp(x, 0)) and log_sigmoid (-softplus(-x)) op by op: a bfloat16
# activation is the reference's bit for bit (F.gelu(approximate="tanh") and
# F.silu round once, and differ from it in the last bit of about a third
# of the bfloat16 entries).

def gelu(v):
    c0 = weak(0.044715, v.dtype)
    c1 = weak(math.sqrt(2 / math.pi), v.dtype)
    return v * (0.5 * (1.0 + torch.tanh(c1 * (v + c0 * (v * v * v)))))


def silu(v):
    return v * (1.0 / (1.0 + torch.exp(-v)))


def softplus(v):
    # torch.maximum splits the gradient at a tie: softplus'(0) = 1/2, as JAX's
    return torch.maximum(v, v.new_zeros(())) + torch.log1p(torch.exp(-v.abs()))


def log_sigmoid(v):
    return -softplus(-v)


def param_count(params: Params) -> int:
    return sum(a.numel() for a in tree_leaves(params))


def tree_cast(params: Params, dtype) -> Params:
    return tree_map(lambda a: a.to(dtype) if a.is_floating_point() else a, params)
