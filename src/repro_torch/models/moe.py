"""Mixture-of-Experts layer (counterpart of `repro.models.moe`): token-choice
top-k with SwiGLU experts and optional shared experts, experts parallel
over the mesh's `model` axis as the reference's `_moe_body` runs them.

Each rank of the model axis:

  1. all-gathers the tokens over `model` when the residual is
     sequence-split, and gathers its experts' hidden dim over `data`
     (FSDP) just before use;
  2. routes the tokens' float32 logits with top-k (ties to the lower
     expert id, as `lax.top_k`), softmaxes the k gate values and casts
     them to the compute dtype;
  3. keeps the assignments of its experts e0 … e0 + e_loc - 1; the others
     fall into a dummy group e_loc;
  4. sorts the T·k assignments by local expert, stably, and keeps the first
     `cap` = min(T·k, max(round_up(2·T·k·e_loc/E, 128), 128)): on a model
     axis of more ranks the tail of the last local groups drops (GShard
     capacity dropping, counted in `drops`); on one rank cap is T·k and
     nothing drops;
  5. per expert group, act(x·wg) * (x·wu), then ·wd, then scales by the
     gate (the reference's `lax.ragged_dot`, here one product per group
     with assignments);
  6. adds the outputs back into token order in the compute dtype, each
     token's contributions in ascending expert id and rounded after each
     add, as a sequential scatter-add does; no atomics, so two runs give
     the same bits;
  7. adds the shared experts (column- then row-parallel over `model` where
     their hidden dim divides), and reduce-scatters the partial output over
     the rows (all-reduces it when the rows are not split).

The group sizes are data: the loop over groups reads them on the host, one
wait per call.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

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
    if not outs:
        # no rows: an empty product keeps the weights in the graph, so that
        # every rank runs the same collectives in the backward pass (their
        # FSDP gathers' reduce-scatters)
        x_e = xs[:0]
        outs.append((act(x_e @ wg[0].to(xs.dtype)) * (x_e @ wu[0].to(xs.dtype)))
                    @ wd[0].to(xs.dtype))
    return torch.cat(outs)


#: Assignments dropped by the capacity rule on this process since the
#: count was last set to 0 (a rank counts its own experts').
drops = 0


def _capacity(a: int, e_loc: int, n_experts: int) -> int:
    return min(a, max(_round_up(int(a * e_loc / n_experts * 2.0), 128), 128))


def moe_apply(p, cfg: MoEConfig, x, *, mesh=None, dp_axes=("data",), model_axis="model",
              seq_sharded=True):
    """x: (B, S, D) in the residual's layout — this rank's rows of the
    sequence when `seq_sharded` on a model axis of more ranks, the whole
    otherwise — → the same layout, in x's dtype."""
    global drops
    from .transformer import MeshCtx
    ctx = MeshCtx(mesh, tuple(dp_axes), model_axis, seq_sharded and mesh is not None)
    tp = ctx.size(model_axis)
    if cfg.n_experts % tp:
        raise ValueError(f"n_experts {cfg.n_experts} must divide over the model axis ({tp})")
    e_loc = cfg.n_experts // tp
    e0 = ctx.coord(model_axis) * e_loc
    specs = ctx.specs(moe_init, cfg)
    keep = (model_axis,)
    xf = ctx.full(x)
    b, s, d = xf.shape
    t = b * s
    k = cfg.top_k
    xt = xf.reshape(t, d)
    gates, eids = _route(cfg, xt, ctx.weight(p["router"], specs["router"]))

    flat_e = eids.reshape(-1)
    flat_tok = torch.arange(t * k, device=x.device) // k
    local = (flat_e >= e0) & (flat_e < e0 + e_loc)
    le = torch.where(local, flat_e - e0, e_loc)  # dummy group = e_loc
    cap = _capacity(t * k, e_loc, cfg.n_experts)
    order = torch.argsort(le, stable=True)[:cap]
    counts = torch.zeros(e_loc + 1, dtype=le.dtype, device=x.device).scatter_add_(
        0, le, torch.ones_like(le))
    # a dry run (meta tensors, `launch.dryrun`) routes no rows
    # repro-lint: disable=host-sync -- the group sizes steer the per-expert loop: one wait per call
    counts = [0] * e_loc if counts.is_meta else counts.tolist()[:e_loc]
    sizes, kept = [], 0
    for n in counts:
        sizes.append(min(kept + n, cap) - kept)
        kept += sizes[-1]
    drops += sum(counts) - kept
    order = order[:kept]
    # a token's k rows through `F.embedding`: its CUDA backward adds them
    # in a fixed order (indexing's would add them with atomics)
    xs = F.embedding(flat_tok[order], xt)                  # (kept, D)
    gs = gates.reshape(-1)[order]
    w = {name: ctx.weight(p[name], specs[name], keep) for name in ("wg", "wu", "wd")}
    ys = _experts(cfg, xs, sizes, w["wg"], w["wu"], w["wd"]) * gs[:, None]

    # Back to token order: slot (token, j) of the (T, k) assignments holds
    # its output (zero where dropped or another rank's), and a token's k
    # slots are added in ascending expert id, one rounding per add.
    slots = ys.new_zeros((t * k, d)).index_put((order,), ys).reshape(t, k, d)
    slots = torch.gather(slots, 1, torch.argsort(eids, dim=-1)[..., None].expand(t, k, d))
    acc = slots[:, 0]
    for j in range(1, k):
        acc = acc + slots[:, j]
    out = acc.reshape(b, s, d)

    shared = None
    if cfg.n_shared_experts:
        split = tp > 1 and (cfg.d_ff * cfg.n_shared_experts) % tp == 0
        sw = {name: ctx.weight(p[name], specs[name], keep if split else ())
              for name in ("shared_wg", "shared_wu", "shared_wd")}
        act = _act(cfg.act)
        src_x = xf if tp > 1 else x
        h = act(src_x @ sw["shared_wg"].to(x.dtype)) * (src_x @ sw["shared_wu"].to(x.dtype))
        shared = h @ sw["shared_wd"].to(x.dtype)
        if split:
            out, shared = out + shared, None
    if tp > 1:
        out = ctx.land(out, True)
        if shared is not None:
            shared = ctx.resid(shared)
    return out if shared is None else out + shared
