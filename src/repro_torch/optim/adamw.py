"""AdamW with float32 or 8-bit moments (counterpart of `repro.optim.adamw`).

The 8-bit layout is the reference's: int8 blockwise absmax along the last
axis only, 256-element blocks, one float32 scale per block, so the int8
buffer keeps the parameter's shape (padded only in the last dimension).  A
row of the reference's stacked `(reps, ...)` state is therefore the port's
per-layer state as it is (`repro_torch.interop.opt_state_from_reference`).

The update copies the reference's arithmetic op for op (a Python constant
is applied as jnp applies it, rounded to float32 by the op), and works in
place: the step counter is a 0-d int32 tensor on the params' device, the
bias corrections are computed there from it, and nothing is read back to
the host.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..models.nn import tree_leaves, tree_map

__all__ = ["AdamWConfig", "adamw_init", "adamw_update"]

_BLOCK = 256


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    use_8bit: bool = False


def _q8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 blockwise absmax quantization along the last axis.  Returns
    (q (*lead, padded_last) int8, scales (*lead, n_blocks) float32)."""
    if x.dim() == 0:
        x = x[None]
    *lead, last = x.shape
    pad = (-last) % _BLOCK
    blocks = F.pad(x, (0, pad)).reshape(*lead, -1, _BLOCK)
    scale = torch.clamp_min(blocks.abs().amax(dim=-1) / 127.0, 1e-12).float()
    q = torch.clamp(torch.round(blocks / scale[..., None]), -127, 127)
    return q.to(torch.int8).reshape(*lead, last + pad), scale


def _dq8(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    if len(shape) == 0:
        shape = (1,)
    *lead, last = shape
    blocks = q.reshape(*lead, -1, _BLOCK).float() * scale[..., None]
    return blocks.reshape(*lead, -1)[..., :last].reshape(shape)


def _zeros8(p: torch.Tensor) -> dict:
    """`_q8` of zeros, made directly: q all 0, every scale the 1e-12 floor."""
    *lead, last = p.shape if p.dim() else (1,)
    n_blocks = -(-last // _BLOCK)
    return {"q": torch.zeros((*lead, n_blocks * _BLOCK), dtype=torch.int8, device=p.device),
            "s": torch.full((*lead, n_blocks), 1e-12, dtype=torch.float32, device=p.device)}


def adamw_init(params, cfg: AdamWConfig) -> dict:
    """Zero moments (float32, or 8-bit `{"q", "s"}` pairs) and a 0-d int32
    step counter, on the params' device (meta params give meta state:
    the counterpart of `jax.eval_shape` over this)."""
    if cfg.use_8bit:
        def zero(p):
            return _zeros8(p)
    else:
        def zero(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zero, params), "v": tree_map(zero, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _zip(p, *trees):
    """(param, the other trees' entries at its place) for every param, in
    the params' order; an 8-bit moment's `{"q", "s"}` stands at a leaf."""
    if isinstance(p, dict):
        for k in p:
            yield from _zip(p[k], *(t[k] for t in trees))
    elif isinstance(p, (list, tuple)):
        for i, v in enumerate(p):
            yield from _zip(v, *(t[i] for t in trees))
    else:
        yield (p, *trees)


def _global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads)))


@torch.no_grad()
def adamw_update(grads, state: dict, params, cfg: AdamWConfig):
    """One AdamW step.  Updates `params` and `state` in place and returns
    them, `(params, state)`: the same tensors (at full width a second copy
    of the params would not fit beside the moments).  Pass copies to keep
    the old values."""
    step = state["step"].add_(1)
    gnorm = _global_norm(grads)
    clip = torch.full((), cfg.grad_clip, dtype=torch.float32, device=gnorm.device)
    scale = torch.clamp_max(clip / torch.clamp_min(gnorm, 1e-12), 1.0)
    t = step.float()
    bc1 = 1.0 - torch.pow(cfg.b1, t)
    bc2 = 1.0 - torch.pow(cfg.b2, t)

    for p, g, m_st, v_st in _zip(params, grads, state["m"], state["v"]):
        g = g.float() * scale
        if cfg.use_8bit:
            m = _dq8(m_st["q"], m_st["s"], p.shape).reshape(p.shape)
            v = _dq8(v_st["q"], v_st["s"], p.shape).reshape(p.shape)
        else:
            m, v = m_st, v_st
        m.mul_(cfg.b1).add_(g.mul(1 - cfg.b1))
        v.mul_(cfg.b2).add_(g.mul(1 - cfg.b2).mul_(g))
        del g
        u = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        if cfg.use_8bit:
            # int8 v underestimates small entries (block absmax quant), which
            # explodes m/√v: bound the step as the reference does.
            u.clamp_(-4.0, 4.0)
            u.div_(torch.clamp_min(torch.sqrt(torch.mean(u * u)), 1.0))
            for st, new in ((m_st, m), (v_st, v)):
                q, s = _q8(new)
                st["q"].copy_(q)
                st["s"].copy_(s)
        pf = p.float()
        u.add_(pf * cfg.weight_decay).mul_(cfg.lr)
        if p.dtype == torch.float32:
            p.sub_(u)
        else:
            p.copy_(pf - u)
    return params, state
