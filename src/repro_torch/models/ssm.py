"""Mamba (selective SSM) block for the Jamba hybrid (counterpart of
`repro.models.ssm`).

Prefill and training use the reference's chunked selective scan: each
chunk of `scan_chunk` steps is discretised on its own, so the (B, chunk,
d_inner, d_state) float32 dA and dBu exist for one chunk at a time, and
the state h is carried across chunks.  Within a chunk the recurrence
h_t = dA_t·h_{t-1} + dBu_t runs as `associative_scan`, a port of
`jax.lax.associative_scan`'s odd/even recursion, so the products pair up
as the reference's do (log-depth, no loop over time).  With `remat` and
autograd on, each chunk runs under `torch.utils.checkpoint`, as the
reference wraps its chunk step in `jax.checkpoint`.  Decode is one O(1)
state update.

On a model axis of tp ranks that d_inner divides, Mamba is channel-parallel
(`mamba_local`): rank r runs channels [r·d_inner/tp, (r+1)·d_inner/tp) of u
and of z (cut from the gathered `in_proj`, whose resolved block is a slice
of the concatenated [u | z] columns, not the rank's channels), its blocks
of the per-channel leaves (`conv_w`, `conv_b`, `dt_proj`, `dt_bias`,
`a_log`, `d_skip`) and of `out_proj`'s rows; `x_proj` contracts over the
split channels, so dt, B and C are summed over the axis (`psum`), and the
output is a partial product the block reduces.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import comm, nn

__all__ = ["MambaConfig", "mamba_init", "mamba_apply", "mamba_decode", "init_mamba_cache",
           "associative_scan", "mamba_local"]


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_model: int
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int | None = None
    scan_chunk: int = 512

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank or max(1, self.d_model // 16)


def mamba_init(generator: torch.Generator, cfg: MambaConfig, dtype=torch.float32):
    d, di, n, r = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.dt_rank_
    lo, hi = math.log(1e-3), math.log(0.1)
    # init dt in [1e-3, 1e-1] (Mamba paper), stored through softplus's inverse
    dt = torch.exp(nn.uniform(generator, (di,)) * (hi - lo) + lo)
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=generator.device))
    p = {
        "in_proj": nn.normal(generator, (d, 2 * di), d ** -0.5, dtype),
        "conv_w": nn.normal(generator, (cfg.d_conv, di), 0.1, dtype),
        "conv_b": torch.full((di,), 0.0, dtype=dtype, device=generator.device),
        "x_proj": nn.normal(generator, (di, r + 2 * n), di ** -0.5, dtype),
        "dt_proj": nn.normal(generator, (r, di), r ** -0.5, dtype),
        "dt_bias": torch.log(torch.expm1(dt)).to(dtype),
        "a_log": a_log.expand(di, n).contiguous().to(dtype),
        "d_skip": torch.full((di,), 1.0, dtype=dtype, device=generator.device),
        "out_proj": nn.normal(generator, (di, d), di ** -0.5, dtype),
    }
    s = {
        "in_proj": ("embed", "inner"), "conv_w": (None, "inner"),
        "conv_b": ("inner",), "x_proj": ("inner", None),
        "dt_proj": (None, "inner"), "dt_bias": ("inner",),
        "a_log": ("inner", None), "d_skip": ("inner",),
        "out_proj": ("inner", "embed"),
    }
    return p, s


def _interleave(a, b, dim: int):
    """a's entries at the even places of `dim`, b's at the odd ones
    (a has as many as b, or one more)."""
    n = b.shape[dim]
    pairs = torch.stack([a.narrow(dim, 0, n), b], dim=dim + 1).flatten(dim, dim + 1)
    return pairs if a.shape[dim] == n else torch.cat([pairs, a.narrow(dim, n, 1)], dim=dim)


def associative_scan(combine, elems: list, dim: int) -> list:
    """`jax.lax.associative_scan(combine, elems, axis=dim)` for a list of
    tensors: the same odd/even recursion, so the same pairs combine."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def sl(e, start, stop=None, step=1):
        return e[(slice(None),) * dim + (slice(start, stop, step),)]
    reduced = combine([sl(e, 0, -1, 2) for e in elems], [sl(e, 1, None, 2) for e in elems])
    odd = associative_scan(combine, reduced, dim)
    if n % 2 == 0:
        even = combine([sl(e, 0, -1) for e in odd], [sl(e, 2, None, 2) for e in elems])
    else:
        even = combine(odd, [sl(e, 2, None, 2) for e in elems])
    even = [torch.cat([sl(e, 0, 1), r], dim=dim) for e, r in zip(elems, even, strict=True)]
    return [_interleave(e, o, dim) for e, o in zip(even, odd, strict=True)]


def _combine(left, right):
    return [left[0] * right[0], left[1] * right[0] + right[1]]


def _ssm_inputs(p, cfg: MambaConfig, u, psum=None):
    """u (B,S,di) post-conv. Returns dA (B,S,di,N), dBu (B,S,di,N), C (B,S,N).
    With `psum` (channel-parallel) the x_proj product is this rank's
    float32 share, summed over the axis and cast to u's dtype."""
    r, n = cfg.dt_rank_, cfg.d_state
    proj = (u @ p["x_proj"].to(u.dtype) if psum is None
            else psum(u.float() @ p["x_proj"].float()).to(u.dtype))
    dt, b_ssm, c = torch.split(proj, [r, n, n], dim=-1)
    dt = nn.softplus(dt @ p["dt_proj"].to(u.dtype) + p["dt_bias"].to(u.dtype))
    a = -torch.exp(p["a_log"].float())  # (di, N)
    dt32 = dt.float()
    da = torch.exp(dt32[..., None] * a)  # (B,S,di,N)
    dbu = (dt32 * u.float())[..., None] * b_ssm.float()[..., None, :]
    return da, dbu, c


def _conv(p, cfg: MambaConfig, x, conv_state=None):
    """Causal depthwise conv over time, its taps summed in x's dtype.
    x (B,S,di).  Returns (out, the last d_conv - 1 inputs)."""
    k = cfg.d_conv
    xp = (F.pad(x, (0, 0, k - 1, 0)) if conv_state is None
          else torch.cat([conv_state.to(x.dtype), x], dim=1))
    w = p["conv_w"].to(x.dtype)  # (K, di)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    return out + p["conv_b"].to(x.dtype), xp[:, -(k - 1):]


def _chunk_step(p, cfg: MambaConfig, h, u_k, psum=None):
    """One chunk: discretise it, scan it from h.  Returns (the chunk's last
    state, y (B,cc,di) float32)."""
    da, dbu, c = _ssm_inputs(p, cfg, u_k, psum)
    a_acc, b_acc = associative_scan(_combine, [da, dbu], dim=1)
    hs = a_acc * h[:, None] + b_acc
    y = torch.einsum("bsdn,bsn->bsd", hs, c.float())
    return hs[:, -1], y


def mamba_apply(p, cfg: MambaConfig, x, *, h0=None, conv_state=None, return_state=False,
                remat: bool = False, psum=None):
    """x (B,S,D) → (B,S,D).  Chunked selective scan; with `remat` and
    autograd on, each chunk is recomputed in the backward pass.  `p` may
    be a rank's channels (`mamba_local`, which gives `psum`)."""
    b, s, _ = x.shape
    xz = x @ p["in_proj"].to(x.dtype)
    u, z = torch.chunk(xz, 2, dim=-1)
    u, conv_out = _conv(p, cfg, u, conv_state)
    u = nn.silu(u)

    cc = min(cfg.scan_chunk, s)
    pad = (-s) % cc
    u_p = F.pad(u, (0, 0, 0, pad)) if pad else u
    h = (torch.zeros((b, u.shape[-1], cfg.d_state), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    remat = remat and torch.is_grad_enabled()
    ys = []
    for start in range(0, s + pad, cc):
        args = (p, cfg, h, u_p[:, start:start + cc], psum)
        h, y_k = (checkpoint(_chunk_step, *args, use_reentrant=False, preserve_rng_state=False)
                  if remat else _chunk_step(*args))
        ys.append(y_k)
    y = torch.cat(ys, dim=1)[:, :s]

    y = y + u.float() * p["d_skip"].float()
    y = y.to(x.dtype) * nn.silu(z)
    out = y @ p["out_proj"].to(x.dtype)
    if return_state:
        return out, (h, conv_out)
    return out


def init_mamba_cache(cfg: MambaConfig, batch: int, dtype=torch.bfloat16, *,
                     device: torch.device, width: int | None = None):
    """The state of `width` channels (None: all d_inner)."""
    di = width or cfg.d_inner
    return {
        "h": torch.zeros((batch, di, cfg.d_state), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.d_conv - 1, di), dtype=dtype, device=device),
    }


def mamba_decode(p, cfg: MambaConfig, x, cache, psum=None):
    """Single-token step. x (B,1,D) → (B,1,D), new cache."""
    xz = x @ p["in_proj"].to(x.dtype)
    u, z = torch.chunk(xz, 2, dim=-1)
    u, conv_state = _conv(p, cfg, u, cache["conv"])
    u = nn.silu(u)
    da, dbu, c = _ssm_inputs(p, cfg, u, psum)  # S=1
    h = cache["h"] * da[:, 0] + dbu[:, 0]
    y = torch.einsum("bdn,bn->bd", h, c[:, 0].float())[:, None]
    y = y + u.float() * p["d_skip"].float()
    y = y.to(x.dtype) * nn.silu(z)
    out = y @ p["out_proj"].to(x.dtype)
    return out, {"h": h, "conv": conv_state.to(cache["conv"].dtype)}


def mamba_local(p, cfg: MambaConfig, ctx):
    """(weights, psum, partial) of this rank of the model axis: its channels
    (partial True, `psum` the sum over the axis) when d_inner divides over
    it, else the whole weights (psum None, partial False)."""
    specs = ctx.specs(mamba_init, cfg)
    tp = ctx.size(ctx.tp)
    di = cfg.d_inner
    if tp == 1 or di % tp:
        return ctx.weights(p, specs), None, False
    n = di // tp
    c0 = ctx.coord(ctx.tp) * n
    w = ctx.weights({k: v for k, v in p.items() if k != "in_proj"}, specs, keep=(ctx.tp,))
    in_proj = ctx.weight(p["in_proj"], specs["in_proj"])
    w["in_proj"] = torch.cat([in_proj[:, c0:c0 + n], in_proj[:, di + c0:di + c0 + n]], dim=1)
    group = ctx.group(ctx.tp)
    return w, (lambda t: comm.all_reduce(t, group)), True
