"""Mixture-of-Experts layer (counterpart of `repro.models.moe`): dropless
token-choice top-k with SwiGLU experts and optional shared experts.

The reference runs its body inside a fully manual `shard_map`, experts
sharded over the `model` axis.  On one rank of that axis, which is all this
slice serves (one card, or data-parallel ranks each routing its own rows
against whole expert weights), its arithmetic is:

  1. route the tokens' float32 logits with top-k (ties to the lower expert
     id, as `lax.top_k`), softmax the k gate values, cast them to the
     compute dtype;
  2. sort the T·k assignments by expert, stably; the capacity `cap` is
     T·k on one rank, so nothing drops;
  3. per expert group, act(x·wg) * (x·wu), then ·wd, then scale by the gate
     (the reference's `lax.ragged_dot`, here one product per group with
     assignments, the expert's weights cast to the compute dtype one expert
     at a time);
  4. add the outputs back into token order in the compute dtype, each
     token's k contributions in the order of the sorted assignments
     (ascending expert id) and rounded after each add, as a sequential
     scatter-add does; no atomics, so two runs give the same bits;
  5. add the shared experts on the whole x.

The group sizes are data: the loop over groups reads them on the host, one
wait per call.  A model axis of more than one rank raises.
"""
from __future__ import annotations

import dataclasses

import torch

from ..launch.mesh import mesh_axes
from . import nn

__all__ = ["MoEConfig", "moe_init", "moe_apply"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int               # per-expert hidden dim
    n_experts: int
    top_k: int
    n_shared_experts: int = 0
    act: str = "silu"       # swiglu-style gating inside each expert


def moe_init(generator: torch.Generator, cfg: MoEConfig, dtype=torch.float32):
    """The reference's tree, names, shapes and scales.  Its quirk is kept:
    the reference draws `shared_wg`, `shared_wu` and `shared_wd` from one
    key, so `shared_wg` and `shared_wu` start equal; here `shared_wu` is a
    copy of `shared_wg`, and `shared_wd` its own draw."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    scale = d ** -0.5
    p = {
        "router": nn.normal(generator, (d, e), scale, dtype),
        "wg": nn.normal(generator, (e, d, f), scale, dtype),
        "wu": nn.normal(generator, (e, d, f), scale, dtype),
        "wd": nn.normal(generator, (e, f, d), f ** -0.5, dtype),
    }
    s = {
        "router": (None, None),
        "wg": ("expert", None, "expert_ffn"),
        "wu": ("expert", None, "expert_ffn"),
        "wd": ("expert", "expert_ffn", None),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared_wg"] = nn.normal(generator, (d, fs), scale, dtype)
        p["shared_wu"] = p["shared_wg"].clone()
        p["shared_wd"] = nn.normal(generator, (fs, d), fs ** -0.5, dtype)
        s["shared_wg"] = ("embed", "ffn")
        s["shared_wu"] = ("embed", "ffn")
        s["shared_wd"] = ("ffn", "embed")
    return p, s


def _act(name):
    return {"silu": nn.silu, "gelu": nn.gelu}[name]


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _route(cfg: MoEConfig, xt, router):
    """(gates (T, k) in xt's dtype, expert ids (T, k)): the top-k of the
    float32 logits, ties to the lower id, and the softmax of their values.
    The logits are taken in the promoted type of x and the router, as jnp
    promotes `xt @ router` (a bfloat16 x against a float32 router is a
    float32 product)."""
    dt = torch.promote_types(xt.dtype, router.dtype)
    logits = (xt.to(dt) @ router.to(dt)).float()
    vals, eids = torch.sort(logits, dim=-1, descending=True, stable=True)
    vals, eids = vals[:, :cfg.top_k], eids[:, :cfg.top_k]
    return torch.softmax(vals, dim=-1).to(xt.dtype), eids


def _experts(cfg: MoEConfig, xs, group_sizes, wg, wu, wd):
    """The reference's three `ragged_dot`s: rows of group e through expert
    e's SwiGLU, one product per group that has rows."""
    act = _act(cfg.act)
    wg, wu, wd = wg.unbind(0), wu.unbind(0), wd.unbind(0)  # one backward for all groups
    outs, start = [], 0
    for e, n in enumerate(group_sizes):
        if n:
            x_e = xs[start:start + n]
            h = act(x_e @ wg[e].to(xs.dtype)) * (x_e @ wu[e].to(xs.dtype))
            outs.append(h @ wd[e].to(xs.dtype))
            start += n
    return torch.cat(outs) if outs else xs.new_zeros((0, wd[0].shape[1]))


def moe_apply(p, cfg: MoEConfig, x, *, mesh=None, dp_axes=("data",), model_axis="model",
              seq_sharded=True):
    """x: (B, S, D) → (B, S, D), in x's dtype.  `mesh`, `dp_axes` and
    `seq_sharded` are the reference's; on one model rank the layout is the
    caller's, and each rank computes its own rows."""
    n_model = 1 if mesh is None else mesh_axes(mesh).get(model_axis, 1)
    if n_model > 1:
        from .transformer import later
        raise later("multi-card")
    e_loc = cfg.n_experts // n_model
    b, s, d = x.shape
    t = b * s
    k = cfg.top_k
    xt = x.reshape(t, d)
    gates, eids = _route(cfg, xt, p["router"])

    flat_e = eids.reshape(-1)
    flat_tok = torch.arange(t * k, device=x.device) // k
    a = t * k
    cap = min(a, max(_round_up(int(a * e_loc / cfg.n_experts * 2.0), 128), 128))
    order = torch.argsort(flat_e, stable=True)[:cap]
    xs = xt[flat_tok[order]]                               # (cap, D)
    gs = gates.reshape(-1)[order]
    counts = torch.zeros(e_loc, dtype=flat_e.dtype, device=x.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    # repro-lint: disable=host-sync -- the group sizes steer the per-expert loop: one wait per call
    sizes = counts.tolist()
    ys = _experts(cfg, xs, sizes, p["wg"], p["wu"], p["wd"]) * gs[:, None]

    # Back to token order.  inv[i] is where slot i of (T, k) went in the
    # sorted order; the sort is stable by expert and a token's k experts
    # are distinct, so a token's positions in ascending order are its
    # experts in ascending order: add them in turn.
    inv = torch.argsort(order)
    pos, _ = torch.sort(inv.reshape(t, k), dim=-1)
    out = ys[pos]                                          # (T, k, D)
    acc = out[:, 0]
    for j in range(1, k):
        acc = acc + out[:, j]
    out = acc.reshape(b, s, d)

    if cfg.n_shared_experts:
        act = _act(cfg.act)
        h = act(x @ p["shared_wg"].to(x.dtype)) * (x @ p["shared_wu"].to(x.dtype))
        out = out + h @ p["shared_wd"].to(x.dtype)
    return out
