"""GQA attention (counterpart of `repro.models.attention`): the blocked
(flash-style) prefill path, cache-based decode, sliding-window and
chunked-local variants, optional qk-norm, RoPE and logit softcap.

Plain torch products, as the reference's are plain jnp: logits and their
softcap in float32, masked with NEG_INF = -1e30 (not -inf, so a row with no
valid key stays finite).  `F.scaled_dot_product_attention` is not used: it
has no softcap and no ring mask.

On a model axis of tp ranks attention is head-parallel (`local_attn`):
rank r runs query heads [r·H/tp, (r+1)·H/tp) against the KV heads their
GQA groups read, with its block of `wq` and of `wo`'s rows, and its output
is a partial product that the block reduces.  The KV heads are rank r's
block of `wk`/`wv` when KH divides over tp; otherwise (8 KV heads on 16
ranks: a rank's block of the flat columns is half a head) `wk`/`wv` are
gathered and the heads the rank's queries read are cut from them.  Where
the query heads do not split into whole GQA groups, or not at all, the
weights are gathered and attention runs replicated.  The decode cache
holds the rank's KV heads (`head_plan`).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from . import nn

__all__ = ["AttnConfig", "attn_init", "attention", "attn_decode", "attn_cross_decode",
           "cache_len", "init_kv_cache", "head_plan", "local_attn"]

NEG_INF = -1e30
_KV_PAD = 2 ** 30  # the position of a padded key: past every query


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    causal: bool = True
    window: int | None = None      # sliding-window (local) attention
    chunk: int | None = None       # llama4-style chunked attention
    qk_norm: bool = False
    rope: bool = True
    rope_theta: float = 10000.0
    softcap: float | None = None
    bias: bool = False
    q_block: int = 512
    kv_block: int = 1024


def attn_init(generator: torch.Generator, cfg: AttnConfig, dtype=torch.float32):
    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    p, s = {}, {}
    p["wq"], s["wq"] = nn.dense_init(generator, cfg.d_model, qd, bias=cfg.bias,
                                     axes=("embed", "heads"), dtype=dtype)
    p["wk"], s["wk"] = nn.dense_init(generator, cfg.d_model, kvd, bias=cfg.bias,
                                     axes=("embed", "heads"), dtype=dtype)
    p["wv"], s["wv"] = nn.dense_init(generator, cfg.d_model, kvd, bias=cfg.bias,
                                     axes=("embed", "heads"), dtype=dtype)
    p["wo"], s["wo"] = nn.dense_init(generator, qd, cfg.d_model, bias=cfg.bias,
                                     axes=("heads", "embed"), dtype=dtype)
    if cfg.qk_norm:
        p["qn"], s["qn"] = nn.rmsnorm_init(cfg.head_dim, generator.device, dtype)
        p["kn"], s["kn"] = nn.rmsnorm_init(cfg.head_dim, generator.device, dtype)
    return p, s


def _project_qkv(p, cfg: AttnConfig, x, kv_x, q_pos, kv_pos):
    b, sq, _ = x.shape
    skv = kv_x.shape[1]
    q = nn.linear(p["wq"], x).reshape(b, sq, cfg.n_heads, cfg.head_dim)
    k = nn.linear(p["wk"], kv_x).reshape(b, skv, cfg.n_kv_heads, cfg.head_dim)
    v = nn.linear(p["wv"], kv_x).reshape(b, skv, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = nn.rmsnorm(p["qn"], q)
        k = nn.rmsnorm(p["kn"], k)
    if cfg.rope:
        q = nn.apply_rope(q, q_pos, theta=cfg.rope_theta)
        k = nn.apply_rope(k, kv_pos, theta=cfg.rope_theta)
    return q, k, v


def _sdpa(cfg: AttnConfig, q, k, v, mask):
    """Dense attention on a (already block-sliced) window.
    q (B,Sq,H,D), k/v (B,Sk,KH,D), mask (Sq,Sk) or None → (B,Sq,H,D)."""
    g = cfg.n_heads // cfg.n_kv_heads
    b, sq, h, d = q.shape
    qg = q.reshape(b, sq, cfg.n_kv_heads, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float()
    logits = logits / math.sqrt(d)
    if cfg.softcap:
        logits = nn.softcap(logits, cfg.softcap)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v)
    return out.reshape(b, sq, h, d)


def _pad_seq(a: torch.Tensor, n: int) -> torch.Tensor:
    """Zero rows appended to dim 1 of a (B, S, H, D) tensor."""
    return F.pad(a, (0, 0, 0, 0, 0, n))


def _flash(cfg: AttnConfig, q, k, v, q_pos, kv_pos):
    """Blocked attention: a loop over q blocks, an online-softmax loop over
    kv blocks.  Peak memory O(B·H·q_block·kv_block).  Padded query rows
    sit at position -1 and padded keys at 2**30, and both are masked."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    kh = cfg.n_kv_heads
    g = cfg.n_heads // kh
    qb = min(cfg.q_block, sq)
    kb = min(cfg.kv_block, skv)
    nq, nk = -(-sq // qb), -(-skv // kb)
    pad_q, pad_k = nq * qb - sq, nk * kb - skv
    q, k, v = _pad_seq(q, pad_q), _pad_seq(k, pad_k), _pad_seq(v, pad_k)
    q_pos = F.pad(q_pos, (0, pad_q), value=-1)
    kv_pos = F.pad(kv_pos, (0, pad_k), value=_KV_PAD)

    qs = q.reshape(b, nq, qb, kh, g, d).permute(1, 0, 3, 4, 2, 5)  # (nq,B,KH,G,qb,D)
    ks = k.reshape(b, nk, kb, kh, d).permute(1, 0, 3, 2, 4)        # (nk,B,KH,kb,D)
    vs = v.reshape(b, nk, kb, kh, d).permute(1, 0, 3, 2, 4)
    qp = q_pos.reshape(nq, qb)
    kp = kv_pos.reshape(nk, kb)
    scale = 1.0 / math.sqrt(d)

    outs = []
    for qblk, qpos in zip(qs, qp, strict=True):
        m = torch.full((b, kh, g, qb), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, kh, g, qb), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, kh, g, qb, d), dtype=torch.float32, device=q.device)
        for kblk, vblk, kpos in zip(ks, vs, kp, strict=True):
            logits = torch.einsum("bhgqd,bhkd->bhgqk", qblk, kblk)
            logits = logits.float() * scale
            if cfg.softcap:
                logits = nn.softcap(logits, cfg.softcap)
            mask = torch.ones((qb, kb), dtype=torch.bool, device=q.device)
            if cfg.causal:
                mask &= qpos[:, None] >= kpos[None, :]
            if cfg.window is not None:
                mask &= qpos[:, None] - kpos[None, :] < cfg.window
            mask &= (qpos >= 0)[:, None] & (kpos < _KV_PAD)[None, :]
            logits = torch.where(mask, logits, NEG_INF)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p.to(qblk.dtype), vblk).float()
            m = m_new
        outs.append(acc / torch.clamp_min(l[..., None], 1e-30))

    out = torch.stack(outs)  # (nq,B,KH,G,qb,D)
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(b, nq * qb, h, d)
    return out[:, :sq].to(q.dtype)


def _chunked_attn(cfg: AttnConfig, q, k, v, q_pos, kv_pos):
    """Chunked-local attention (llama4 iRoPE style): causal within aligned
    chunks of size cfg.chunk; no cross-chunk attention.  The chunks are
    folded into the batch (the reference vmaps over them)."""
    b, s, h, d = q.shape
    c = cfg.chunk
    pad = (-s) % c
    q, k, v = _pad_seq(q, pad), _pad_seq(k, pad), _pad_seq(v, pad)
    n = (s + pad) // c
    qc = q.reshape(b * n, c, h, d)
    kc = k.reshape(b * n, c, cfg.n_kv_heads, d)
    vc = v.reshape(b * n, c, cfg.n_kv_heads, d)
    mask = (torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
            if cfg.causal else None)
    out = _sdpa(cfg, qc, kc, vc, mask)
    return out.reshape(b, n * c, h, d)[:, :s]


def attention(p, cfg: AttnConfig, x, *, positions=None, kv_x=None, kv_positions=None):
    """Training / prefill attention.  x (B,S,D); kv_x for cross-attention.
    Returns (out (B,S,D), (k, v) for cache seeding)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    kv_x = x if kv_x is None else kv_x
    kv_positions = positions if kv_positions is None else kv_positions
    q, k, v = _project_qkv(p, cfg, x, kv_x, positions, kv_positions)
    out = (_chunked_attn(cfg, q, k, v, positions, kv_positions)
           if cfg.chunk is not None
           else _flash(cfg, q, k, v, positions, kv_positions))
    return nn.linear(p["wo"], out.reshape(b, s, -1)), (k, v)


# ---------------------------------------------------------------------------
# Decode path (single new token against a cache)
# ---------------------------------------------------------------------------

def cache_len(cfg: AttnConfig, max_len: int) -> int:
    """Local layers only keep a ring buffer of their receptive field."""
    if cfg.window is not None:
        return min(cfg.window, max_len)
    if cfg.chunk is not None:
        return min(cfg.chunk, max_len)
    return max_len


def init_kv_cache(cfg: AttnConfig, batch: int, max_len: int, dtype=torch.bfloat16, *,
                  device: torch.device):
    s = cache_len(cfg, max_len)
    shape = (batch, s, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        # absolute position per slot, -1 = empty
        "pos": torch.full((batch, s), -1, dtype=torch.int32, device=device),
    }


def attn_decode(p, cfg: AttnConfig, x, cache, pos: int):
    """x (B,1,D), pos the position of the whole batch.  Returns (out
    (B,1,D), cache).  The new key and value go to ring slot pos % cache
    length; the cache is updated in place (the reference returns a new one)
    and returned.  Keys are masked by row 0's slot positions."""
    b = x.shape[0]
    at = torch.full((1,), pos, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, x, at, at)
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    slot = pos % ck.shape[1]
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)
    cpos[:, slot] = pos

    kp = cpos[0]  # (S,) absolute positions in slots
    valid = kp >= 0
    if cfg.causal:
        valid &= kp <= pos
    if cfg.window is not None:
        valid &= pos - kp < cfg.window
    if cfg.chunk is not None:
        valid &= kp // cfg.chunk == pos // cfg.chunk

    g = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(b, 1, cfg.n_kv_heads, g, cfg.head_dim)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, ck.to(q.dtype))
    logits = logits.float() / math.sqrt(cfg.head_dim)
    if cfg.softcap:
        logits = nn.softcap(logits, cfg.softcap)
    logits = torch.where(valid, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, cv.to(q.dtype))
    out = out.reshape(b, 1, cfg.n_heads * cfg.head_dim)
    return nn.linear(p["wo"], out), cache


def attn_cross_decode(p, cfg: AttnConfig, x, enc_k, enc_v):
    """Cross-attention decode: static encoder KV, no cache update."""
    b = x.shape[0]
    q = nn.linear(p["wq"], x).reshape(b, 1, cfg.n_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = nn.rmsnorm(p["qn"], q)
    out = _sdpa(dataclasses.replace(cfg, causal=False, rope=False), q, enc_k, enc_v, None)
    return nn.linear(p["wo"], out.reshape(b, 1, -1))


# ---------------------------------------------------------------------------
# Head parallelism over a mesh's model axis
# ---------------------------------------------------------------------------

def head_plan(cfg: AttnConfig, ctx):
    """(q0, n_q, kv0, n_kv) — the query heads and KV heads this rank of the
    model axis runs; None when attention runs replicated (a model axis of
    one rank, heads that do not divide, or groups split unevenly)."""
    tp = ctx.size(ctx.tp)
    h, kh = cfg.n_heads, cfg.n_kv_heads
    if tp == 1 or h % tp:
        return None
    n_q, g = h // tp, h // kh
    if n_q % g and g % n_q:
        return None
    q0 = ctx.coord(ctx.tp) * n_q
    kv0 = q0 // g
    return q0, n_q, kv0, (q0 + n_q - 1) // g + 1 - kv0


def local_attn(p, cfg: AttnConfig, ctx):
    """(weights, config, partial, out_bias) of this rank: head-parallel
    blocks (partial True: the output of `wo`'s rows is a partial sum, and
    `wo`'s bias, returned apart, is added once after the reduction), or the
    whole weights (partial False)."""
    specs = ctx.specs(attn_init, cfg)
    plan = head_plan(cfg, ctx)
    if plan is None:
        return ctx.weights(p, specs), cfg, False, None
    tp = (ctx.tp,)
    q0, n_q, kv0, n_kv = plan
    hd = cfg.head_dim
    w = {"wq": ctx.weights(p["wq"], specs["wq"], keep=tp),
         "wo": {"w": ctx.weight(p["wo"]["w"], specs["wo"]["w"], keep=tp)}}
    for name in ("wk", "wv"):
        if cfg.n_kv_heads % ctx.size(ctx.tp) == 0:
            w[name] = ctx.weights(p[name], specs[name], keep=tp)
        else:
            cols = slice(kv0 * hd, (kv0 + n_kv) * hd)
            w[name] = {k: v[..., cols] for k, v in ctx.weights(p[name], specs[name]).items()}
    for name in ("qn", "kn"):
        if name in p:
            w[name] = ctx.weights(p[name], specs[name])
    bias = ctx.weight(p["wo"]["b"], specs["wo"]["b"]) if "b" in p["wo"] else None
    return w, dataclasses.replace(cfg, n_heads=n_q, n_kv_heads=n_kv), True, bias
