"""xLSTM blocks (counterpart of `repro.models.xlstm`): mLSTM (matrix memory,
exponential gating) and sLSTM (scalar memory with recurrent gate
preactivations), arXiv:2405.04517, with the paper's stabilised
exponential gating.

The mLSTM runs chunkwise-parallel: O(L²) within a chunk of L steps, the
(C, n, m) state carried across chunks; `_mlstm_step` is its one-step
recurrence, kept to hold the chunkwise form against.  The sLSTM's
recurrent gates make it a loop over time.  Decode is `*_apply` at S = 1
from a cache.  The states are float32 whatever the compute dtype.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from . import nn
from .ssm import associative_scan

__all__ = [
    "MLSTMConfig", "mlstm_init", "mlstm_apply", "mlstm_decode", "init_mlstm_cache",
    "SLSTMConfig", "slstm_init", "slstm_apply", "slstm_decode", "init_slstm_cache",
]

#: The stabiliser's start and the padded steps' input gate.
NEG_BIG = -1e30


def _gate_norm(gn, ys):
    """The reference's group-norm stand-in: rmsnorm with g = gn - 1 (so
    that its 1 + g is gn), the default eps."""
    return nn.rmsnorm({"g": gn - 1.0}, ys)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MLSTMConfig:
    d_model: int
    n_heads: int
    proj_factor: float = 2.0
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return int(self.d_model * self.proj_factor)

    @property
    def d_head(self) -> int:
        return self.d_inner // self.n_heads


def mlstm_init(generator: torch.Generator, cfg: MLSTMConfig, dtype=torch.float32):
    d, di, h = cfg.d_model, cfg.d_inner, cfg.n_heads
    p = {
        "up": nn.normal(generator, (d, 2 * di), d ** -0.5, dtype),
        "wq": nn.normal(generator, (di, di), di ** -0.5, dtype),
        "wk": nn.normal(generator, (di, di), di ** -0.5, dtype),
        "wv": nn.normal(generator, (di, di), di ** -0.5, dtype),
        "wi": nn.normal(generator, (di, h), di ** -0.5, dtype),
        "wf": nn.normal(generator, (di, h), di ** -0.5, dtype),
        "fb": torch.full((h,), 3.0, dtype=dtype, device=generator.device),  # open forget gates
        "gn": torch.full((di,), 1.0, dtype=dtype, device=generator.device),
        "down": nn.normal(generator, (di, d), di ** -0.5, dtype),
    }
    s = {
        "up": ("embed", "inner"), "wq": ("inner", "inner"),
        "wk": ("inner", "inner"), "wv": ("inner", "inner"),
        "wi": ("inner", None), "wf": ("inner", None), "fb": (None,),
        "gn": ("inner",), "down": ("inner", "embed"),
    }
    return p, s


def _mlstm_qkvif(p, cfg: MLSTMConfig, x):
    b, s, _ = x.shape
    h, dh = cfg.n_heads, cfg.d_head
    up = x @ p["up"].to(x.dtype)
    u, z = torch.chunk(up, 2, dim=-1)
    scale = nn.weak(dh ** -0.5, x.dtype)
    q = (u @ p["wq"].to(x.dtype)).reshape(b, s, h, dh) * scale
    k = (u @ p["wk"].to(x.dtype)).reshape(b, s, h, dh) * scale
    v = (u @ p["wv"].to(x.dtype)).reshape(b, s, h, dh)
    log_i = (u @ p["wi"].to(x.dtype)).float()  # (B,S,H)
    log_f = nn.log_sigmoid((u @ p["wf"].to(x.dtype)).float() + p["fb"].float())
    return q, k, v, log_i, log_f, z


def _cummax(a, dim: int):
    """`jax.lax.cummax(a, axis=dim)` as the reference differentiates it:
    `associative_scan` of `torch.maximum`, whose backward splits a tie in
    half at each pair, as `lax.max`'s does (`torch.cummax` would give one
    index all of it, through a `scatter_add` whose atomics make the CUDA
    backward vary from run to run)."""
    return associative_scan(lambda x, y: [torch.maximum(x[0], y[0])], [a], dim)[0]


def _mlstm_step(carry, xs):
    """One step of the recurrence (the reference's `_mlstm_step`)."""
    c, n, m = carry  # (B,H,dk,dv), (B,H,dk), (B,H)
    q, k, v, log_i, log_f = xs  # (B,H,dh) ×3, (B,H) ×2
    m_new = torch.maximum(log_f + m, log_i)
    i_s = torch.exp(log_i - m_new)[..., None]
    f_s = torch.exp(log_f + m - m_new)[..., None]
    kf = k.float()
    c = f_s[..., None] * c + i_s[..., None] * (kf[..., :, None] * v.float()[..., None, :])
    n = f_s * n + i_s * kf
    qf = q.float()
    num = torch.einsum("bhk,bhkv->bhv", qf, c)
    den = torch.clamp_min(torch.einsum("bhk,bhk->bh", qf, n).abs(), 1.0)
    return (c, n, m_new), num / den[..., None]


def _mlstm_chunk(carry, xs):
    """Chunkwise-parallel mLSTM (stabilised): O(L²) within the chunk, the
    (C, n, m̂) state carried."""
    c_st, n_st, m_st = carry          # (B,H,dk,dv), (B,H,dk), (B,H)
    q, k, v, log_i, log_f = xs        # (B,L,H,dh) ×3, (B,L,H) ×2
    l = q.shape[1]
    qf = q.float().transpose(1, 2)    # (B,H,L,dh)
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    li = log_i.transpose(1, 2)                         # (B,H,L)
    g = torch.cumsum(log_f.transpose(1, 2), dim=-1)    # (B,H,L) cumulative
    g_total = g[..., -1:]

    # Stabilisers: intra max over s≤t of (g_t - g_s + i_s); inter g_t + m̂.
    a = li - g
    m_intra = g + _cummax(a, 2)
    m_t = torch.maximum(m_intra, g + m_st[..., None])  # (B,H,L)

    # Intra-chunk decay matrix D[t,s] = exp(g_t - g_s + i_s - m_t), s ≤ t;
    # masked to -inf before the exp, so the masked entries and their
    # gradients are 0.
    dmat = g[..., :, None] - g[..., None, :] + li[..., None, :] - m_t[..., :, None]
    mask = torch.ones((l, l), dtype=torch.bool, device=q.device).tril()
    dexp = torch.exp(dmat.masked_fill(~mask, float("-inf")))   # (B,H,L,L)
    scores = torch.einsum("bhtd,bhsd->bhts", qf, kf) * dexp
    h_intra = torch.einsum("bhts,bhsv->bhtv", scores, vf)
    n_intra = torch.einsum("bhts,bhsd->bhtd", dexp, kf)

    # Inter-chunk (carried state) contribution.
    w = torch.exp(g + m_st[..., None] - m_t)           # (B,H,L)
    h_inter = torch.einsum("bhtd,bhdv->bhtv", qf, c_st) * w[..., None]
    n_inter = n_st[:, :, None, :] * w[..., None]

    num = h_intra + h_inter
    n_t = n_intra + n_inter
    den = torch.clamp_min(torch.einsum("bhtd,bhtd->bht", qf, n_t).abs(), 1.0)
    y = (num / den[..., None]).transpose(1, 2)          # (B,L,H,dv)

    # Carry update to the chunk end (stabilised by the new running max).
    m_new = torch.maximum(g_total[..., 0] + m_st, torch.amax(g_total - g + li, dim=-1))
    scat = torch.exp(g_total - g + li - m_new[..., None])   # (B,H,L)
    decay = torch.exp(g_total[..., 0] + m_st - m_new)
    c_new = decay[..., None, None] * c_st + torch.einsum("bhs,bhsd,bhsv->bhdv", scat, kf, vf)
    n_new = decay[..., None] * n_st + torch.einsum("bhs,bhsd->bhd", scat, kf)
    return (c_new, n_new, m_new), y


def mlstm_apply(p, cfg: MLSTMConfig, x, *, cache=None, return_state=False):
    """x (B,S,D) → (B,S,D).  Chunks of cfg.chunk steps (the last padded:
    zero q, k, v and forget gates, input gates at -1e30, so the padding
    leaves the state alone)."""
    b, s, _ = x.shape
    q, k, v, log_i, log_f, z = _mlstm_qkvif(p, cfg, x)
    if cache is None:
        cache = init_mlstm_cache(cfg, b, device=x.device)
    carry = (cache["c"], cache["n"], cache["m"])
    l = min(cfg.chunk, s)
    pad = (-s) % l
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        log_i = F.pad(log_i, (0, 0, 0, pad), value=NEG_BIG)
        log_f = F.pad(log_f, (0, 0, 0, pad))
    ys = []
    for start in range(0, s + pad, l):
        carry, y = _mlstm_chunk(carry, tuple(a[:, start:start + l]
                                             for a in (q, k, v, log_i, log_f)))
        ys.append(y)
    c, n, m = carry
    ys = torch.cat(ys, dim=1)[:, :s].reshape(b, s, cfg.d_inner).to(x.dtype)
    ys = _gate_norm(p["gn"], ys)
    out = (ys * nn.silu(z)) @ p["down"].to(x.dtype)
    if return_state:
        return out, {"c": c, "n": n, "m": m}
    return out


def init_mlstm_cache(cfg: MLSTMConfig, batch: int, dtype=torch.float32, *,
                     device: torch.device):
    h, dh = cfg.n_heads, cfg.d_head
    return {
        "c": torch.zeros((batch, h, dh, dh), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, h, dh), dtype=torch.float32, device=device),
        "m": torch.full((batch, h), NEG_BIG, dtype=torch.float32, device=device),
    }


def mlstm_decode(p, cfg: MLSTMConfig, x, cache):
    return mlstm_apply(p, cfg, x, cache=cache, return_state=True)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SLSTMConfig:
    d_model: int
    n_heads: int

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads


def slstm_init(generator: torch.Generator, cfg: SLSTMConfig, dtype=torch.float32):
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.d_head
    b = torch.full((4 * d,), 0.0, dtype=dtype, device=generator.device)
    b[2 * d:3 * d] = 3.0  # z | i | f | o: open forget gates
    p = {
        "wx": nn.normal(generator, (d, 4 * d), d ** -0.5, dtype),
        # block-diagonal (per-head) recurrent weights
        "r": nn.normal(generator, (4, h, dh, dh), dh ** -0.5, dtype),
        "b": b,
        "gn": torch.full((d,), 1.0, dtype=dtype, device=generator.device),
        "out": nn.normal(generator, (d, d), d ** -0.5, dtype),
    }
    s = {"wx": ("embed", None), "r": (None, None, None, None), "b": (None,),
         "gn": (None,), "out": ("embed", "embed")}
    return p, s


def _slstm_step(r, cfg: SLSTMConfig, carry, x_pre):
    """x_pre (B, 4D) float32, the input's share of the gate preactivations;
    r the float32 recurrent weights."""
    c, n, m, h = carry  # (B,H,dh) ×3, h (B,H·dh)
    b = x_pre.shape[0]
    hh = h.reshape(b, cfg.n_heads, cfg.d_head)
    rec = torch.einsum("ghij,bhi->gbhj", r, hh)  # (4,B,H,dh)
    pre = x_pre.reshape(b, 4, cfg.n_heads, cfg.d_head).transpose(0, 1) + rec
    z_p, i_p, f_p, o_p = pre.unbind(0)
    z = torch.tanh(z_p)
    o = torch.sigmoid(o_p)
    log_i = i_p
    log_f = nn.log_sigmoid(f_p)
    m_new = torch.maximum(log_f + m, log_i)
    i_s = torch.exp(log_i - m_new)
    f_s = torch.exp(log_f + m - m_new)
    c = f_s * c + i_s * z
    n = f_s * n + i_s
    h_new = (o * c / torch.clamp_min(n, 1.0)).reshape(b, -1)
    return (c, n, m_new, h_new), h_new


def slstm_apply(p, cfg: SLSTMConfig, x, *, cache=None, return_state=False):
    b, s, d = x.shape
    x_pre = (x @ p["wx"].to(x.dtype)).float() + p["b"].float()
    x_pre = x_pre.transpose(0, 1)  # (S, B, 4D), gate-major z|i|f|o
    if cache is None:
        cache = init_slstm_cache(cfg, b, device=x.device)
    carry = (cache["c"], cache["n"], cache["m"], cache["h"])
    r = p["r"].float()
    hs = []
    for t in range(s):
        carry, h = _slstm_step(r, cfg, carry, x_pre[t])
        hs.append(h)
    c, n, m, h = carry
    hs = torch.stack(hs, dim=1).to(x.dtype)  # (B,S,D)
    hs = _gate_norm(p["gn"], hs)
    out = hs @ p["out"].to(x.dtype)
    if return_state:
        return out, {"c": c, "n": n, "m": m, "h": h}
    return out


def init_slstm_cache(cfg: SLSTMConfig, batch: int, dtype=torch.float32, *,
                     device: torch.device):
    h, dh = cfg.n_heads, cfg.d_head
    return {
        "c": torch.zeros((batch, h, dh), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, h, dh), dtype=torch.float32, device=device),
        "m": torch.full((batch, h, dh), NEG_BIG, dtype=torch.float32, device=device),
        "h": torch.zeros((batch, h * dh), dtype=torch.float32, device=device),
    }


def slstm_decode(p, cfg: SLSTMConfig, x, cache):
    return slstm_apply(p, cfg, x, cache=cache, return_state=True)
