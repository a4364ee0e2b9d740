"""Block composition and layer stacking (counterpart of
`repro.models.transformer`).

A model is a list of *segments*; each segment is a repeating pattern of
blocks (gemma3-4b: the 6-pattern five times, then a remainder of four
local layers).  The reference stacks each pattern slot's weights over the
repeats and scans them; here a segment is a plain list of its layers in
order, layer r·len(pattern) + j being repeat r of pattern slot j, and the
stack is a Python loop.  With `cfg.remat` and autograd on, each repeat of
the pattern runs under `torch.utils.checkpoint` (the reference wraps the
scan body, one repeat, in `jax.checkpoint`): its activations are
recomputed in the backward pass.  `cfg.unroll_stack` steers the
reference's compiled scan and means nothing here.

Blocks are pre-norm residual: x + Mixer(LN(x)); x + MLP(LN(x)).  The
mixers are attention, Mamba (`ssm`), mLSTM and sLSTM (`xlstm`); the MLP is
dense, MoE (`moe`) or none.  An enc-dec decoder block also cross-attends
(`lnx`, `xattn`) to the encoder's output in prefill and training, and to
its cache's `xk`/`xv` in decode.  The stack serves and trains every family
on one card or on data-parallel ranks; a model axis of more than one rank
(the tensor-parallel slice) raises NotImplementedError naming that slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..launch.mesh import mesh_axes
from . import attention as attn_mod
from . import moe as moe_mod
from . import nn, ssm, xlstm

__all__ = ["LayerSpec", "MeshCtx", "block_init", "block_apply", "block_decode",
           "init_block_cache", "segment_layout", "stack_init", "stack_apply",
           "stack_decode", "init_stack_cache"]

#: The slice of the port that brings each part of the reference's stack.
LATER_SLICES = {
    "multi-card": "the tensor-parallel slice",
}


def later(part: str) -> NotImplementedError:
    return NotImplementedError(f"{part} is not ported yet: it comes with {LATER_SLICES[part]}")


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"          # attn | mamba | mlstm | slstm
    attn_kind: str = "global"    # global | local | chunked
    mlp: str = "dense"           # dense | moe | none
    cross_attn: bool = False     # enc-dec decoder blocks
    causal: bool = True


@dataclasses.dataclass(frozen=True)
class MeshCtx:
    """The reference's sharding context.  With no mesh, or a mesh whose
    model axis is one rank, every constraint is a no-op: data-parallel
    ranks each hold whole activations of their rows.  A model axis of more
    ranks raises (tensor parallelism is a later slice)."""
    mesh: Any
    dp: tuple[str, ...] = ("data",)
    tp: str = "model"
    seq_sharded: bool = True

    def shard(self, x, *spec):
        if self.mesh is None or mesh_axes(self.mesh).get(self.tp, 1) == 1:
            return x
        raise later("multi-card")

    def resid(self, x):
        sp = self.tp if self.seq_sharded else None
        return self.shard(x, self.dp, sp, None)


MIXERS = ("attn", "mamba", "mlstm", "slstm")


def _check_spec(spec: LayerSpec) -> None:
    if spec.mixer not in MIXERS:
        raise ValueError(spec.mixer)


# ---------------------------------------------------------------------------
# Block init
# ---------------------------------------------------------------------------

def _attn_cfg(cfg, spec: LayerSpec) -> attn_mod.AttnConfig:
    return attn_mod.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, causal=spec.causal,
        window=cfg.window if spec.attn_kind == "local" else None,
        chunk=cfg.chunk_attn if spec.attn_kind == "chunked" else None,
        qk_norm=cfg.qk_norm,
        rope=cfg.rope and not (spec.attn_kind == "global" and cfg.nope_global),
        rope_theta=cfg.rope_theta, softcap=cfg.attn_softcap, bias=cfg.bias,
        q_block=cfg.q_block, kv_block=cfg.kv_block,
    )


def _cross_cfg(cfg) -> attn_mod.AttnConfig:
    return dataclasses.replace(
        _attn_cfg(cfg, LayerSpec(causal=False)), causal=False, rope=False)


def _mamba_cfg(cfg) -> ssm.MambaConfig:
    return ssm.MambaConfig(d_model=cfg.d_model, d_state=cfg.d_state,
                           scan_chunk=cfg.mamba_scan_chunk)


def _mlp_init(generator: torch.Generator, cfg):
    d, f = cfg.d_model, cfg.d_ff

    def normal(shape, scale):
        return nn.normal(generator, shape, scale, cfg.pdtype)

    if cfg.mlp_act in ("gelu2", "relu2"):  # plain 2-matrix MLP (whisper/minitron)
        p = {"w1": normal((d, f), d ** -0.5), "w2": normal((f, d), f ** -0.5)}
        s = {"w1": ("embed", "ffn"), "w2": ("ffn", "embed")}
    else:  # gated: swiglu / geglu
        p = {"wg": normal((d, f), d ** -0.5), "wu": normal((d, f), d ** -0.5),
             "wd": normal((f, d), f ** -0.5)}
        s = {"wg": ("embed", "ffn"), "wu": ("embed", "ffn"), "wd": ("ffn", "embed")}
    return p, s


def _acts(cfg):
    acts = {"gelu": nn.gelu, "gelu2": nn.gelu, "geglu": nn.gelu,
            "relu2": lambda v: torch.square(F.relu(v))}
    return acts.get(cfg.mlp_act, nn.silu)


def _mlp_apply(p, cfg, ctx: MeshCtx, x):
    act = _acts(cfg)
    if cfg.mlp_act in ("gelu2", "relu2"):  # non-gated 2-matrix MLP
        h = act(x @ p["w1"].to(x.dtype))
        h = ctx.shard(h, ctx.dp, None, ctx.tp)
        return h @ p["w2"].to(x.dtype)
    h = act(x @ p["wg"].to(x.dtype)) * (x @ p["wu"].to(x.dtype))
    h = ctx.shard(h, ctx.dp, None, ctx.tp)
    return h @ p["wd"].to(x.dtype)


def _mlp_manual_sp(p, cfg, ctx: MeshCtx, h):
    """The reference's explicit Megatron-SP MLP collectives (`cfg.manual_sp`)
    need a mesh of more than one rank.  On one rank the reference's manual
    schedule computes `_mlp_apply`, which `block_apply` calls."""
    raise later("multi-card")


def block_init(generator: torch.Generator, cfg, spec: LayerSpec):
    """One block's params, each leaf in cfg.pdtype as it is drawn."""
    _check_spec(spec)
    dt = cfg.pdtype
    p, s = {}, {}
    p["ln1"], s["ln1"] = nn.rmsnorm_init(cfg.d_model, generator.device, dt)
    if spec.mixer == "attn":
        p["attn"], s["attn"] = attn_mod.attn_init(generator, _attn_cfg(cfg, spec), dt)
    elif spec.mixer == "mamba":
        p["mamba"], s["mamba"] = ssm.mamba_init(generator, _mamba_cfg(cfg), dt)
    elif spec.mixer == "mlstm":
        p["mlstm"], s["mlstm"] = xlstm.mlstm_init(
            generator, xlstm.MLSTMConfig(cfg.d_model, cfg.n_heads), dt)
    else:
        p["slstm"], s["slstm"] = xlstm.slstm_init(
            generator, xlstm.SLSTMConfig(cfg.d_model, cfg.n_heads), dt)
    if spec.cross_attn:
        p["lnx"], s["lnx"] = nn.rmsnorm_init(cfg.d_model, generator.device, dt)
        p["xattn"], s["xattn"] = attn_mod.attn_init(generator, _cross_cfg(cfg), dt)
    if spec.mlp != "none":
        p["ln2"], s["ln2"] = nn.rmsnorm_init(cfg.d_model, generator.device, dt)
        if spec.mlp == "moe":
            p["moe"], s["moe"] = moe_mod.moe_init(generator, cfg.moe_cfg(), dt)
        else:
            p["mlp"], s["mlp"] = _mlp_init(generator, cfg)
    return p, s


# ---------------------------------------------------------------------------
# Block apply (train / prefill)
# ---------------------------------------------------------------------------

def block_apply(p, cfg, spec: LayerSpec, ctx: MeshCtx, x, *, positions, enc_out=None):
    """One block over x (B, S, D); a cross-attending block attends to
    enc_out (B, S_enc, D) at key positions 0..S_enc-1."""
    _check_spec(spec)
    h = nn.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if spec.mixer == "attn":
        h = ctx.shard(h, ctx.dp, None, None)  # gather seq for attention
        out, _ = attn_mod.attention(p["attn"], _attn_cfg(cfg, spec), h, positions=positions)
        out = ctx.resid(out)
    elif spec.mixer == "mamba":
        h = ctx.shard(h, ctx.dp, None, None)
        out = ssm.mamba_apply(p["mamba"], _mamba_cfg(cfg), h, remat=cfg.remat)
    elif spec.mixer == "mlstm":
        out = xlstm.mlstm_apply(
            p["mlstm"], xlstm.MLSTMConfig(cfg.d_model, cfg.n_heads, chunk=cfg.mlstm_chunk), h)
    else:
        out = xlstm.slstm_apply(p["slstm"], xlstm.SLSTMConfig(cfg.d_model, cfg.n_heads), h)
    x = ctx.resid(x + out)
    if spec.cross_attn:
        h = ctx.shard(nn.rmsnorm(p["lnx"], x, cfg.norm_eps), ctx.dp, None, None)
        out, _ = attn_mod.attention(
            p["xattn"], _cross_cfg(cfg), h, kv_x=enc_out, positions=positions,
            kv_positions=torch.arange(enc_out.shape[1], device=enc_out.device))
        x = ctx.resid(x + out)
    if spec.mlp != "none":
        h = nn.rmsnorm(p["ln2"], x, cfg.norm_eps)
        if spec.mlp == "moe":
            out = moe_mod.moe_apply(p["moe"], cfg.moe_cfg(), h, mesh=ctx.mesh, dp_axes=ctx.dp,
                                    model_axis=ctx.tp, seq_sharded=ctx.seq_sharded)
        else:
            out = _mlp_apply(p["mlp"], cfg, ctx, h)
        x = ctx.resid(x + out)
    return x


# ---------------------------------------------------------------------------
# Block decode (single token against cache)
# ---------------------------------------------------------------------------

def init_block_cache(cfg, spec: LayerSpec, batch: int, max_len: int,
                     dtype=torch.bfloat16, *, enc_len: int = 0, device: torch.device):
    """The mixer's cache on `device`: attention's KV ring in `dtype`, the
    recurrent mixers' float32 states (Mamba's conv window in `dtype`).  A
    cross-attending block adds the encoder's keys and values `xk`/`xv`,
    zeros of (batch, enc_len, n_kv_heads, head_dim) in `dtype`, as the
    reference leaves them: nothing writes the encoder's into them."""
    _check_spec(spec)
    if spec.mixer == "attn":
        c = {"kv": attn_mod.init_kv_cache(_attn_cfg(cfg, spec), batch, max_len, dtype,
                                          device=device)}
    elif spec.mixer == "mamba":
        c = {"mamba": ssm.init_mamba_cache(_mamba_cfg(cfg), batch, dtype, device=device)}
    elif spec.mixer == "mlstm":
        c = {"mlstm": xlstm.init_mlstm_cache(xlstm.MLSTMConfig(cfg.d_model, cfg.n_heads),
                                             batch, device=device)}
    else:
        c = {"slstm": xlstm.init_slstm_cache(xlstm.SLSTMConfig(cfg.d_model, cfg.n_heads),
                                             batch, device=device)}
    if spec.cross_attn:
        shape = (batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
        c["xk"] = torch.zeros(shape, dtype=dtype, device=device)
        c["xv"] = torch.zeros(shape, dtype=dtype, device=device)
    return c


def block_decode(p, cfg, spec: LayerSpec, ctx: MeshCtx, x, cache, pos: int):
    """One token through one block; `cache` is updated in place and returned."""
    _check_spec(spec)
    h = nn.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if spec.mixer == "attn":
        out, cache["kv"] = attn_mod.attn_decode(p["attn"], _attn_cfg(cfg, spec), h,
                                                cache["kv"], pos)
    elif spec.mixer == "mamba":
        out, cache["mamba"] = ssm.mamba_decode(p["mamba"], _mamba_cfg(cfg), h, cache["mamba"])
    elif spec.mixer == "mlstm":
        out, cache["mlstm"] = xlstm.mlstm_decode(
            p["mlstm"], xlstm.MLSTMConfig(cfg.d_model, cfg.n_heads), h, cache["mlstm"])
    else:
        out, cache["slstm"] = xlstm.slstm_decode(
            p["slstm"], xlstm.SLSTMConfig(cfg.d_model, cfg.n_heads), h, cache["slstm"])
    x = x + out
    if spec.cross_attn:
        h = nn.rmsnorm(p["lnx"], x, cfg.norm_eps)
        x = x + attn_mod.attn_cross_decode(p["xattn"], _cross_cfg(cfg), h,
                                           cache["xk"].to(x.dtype), cache["xv"].to(x.dtype))
    if spec.mlp != "none":
        h = nn.rmsnorm(p["ln2"], x, cfg.norm_eps)
        out = (moe_mod.moe_apply(p["moe"], cfg.moe_cfg(), h, mesh=ctx.mesh, dp_axes=ctx.dp,
                                 model_axis=ctx.tp, seq_sharded=False)
               if spec.mlp == "moe" else _mlp_apply(p["mlp"], cfg, ctx, h))
        x = x + out
    return x, cache


# ---------------------------------------------------------------------------
# Stacking: segments of repeated patterns, one list of layers per segment
# ---------------------------------------------------------------------------

def segment_layout(n_layers: int, pattern: tuple[LayerSpec, ...]):
    """[(pattern, n_repeats), (remainder_pattern, 1)] covering n_layers."""
    plen = len(pattern)
    reps, rem = divmod(n_layers, plen)
    segs = []
    if reps:
        segs.append((tuple(pattern), reps))
    if rem:
        segs.append((tuple(pattern[:rem]), 1))
    return segs


def _layers(pat, reps):
    """The specs of a segment's layers in order: pattern slot j of repeat r
    at r·len(pat) + j."""
    return pat * reps


def stack_init(generator: torch.Generator, cfg, pattern, n_layers: int):
    """Per segment, the list of its layers' params (and specs)."""
    segs = segment_layout(n_layers, pattern)
    params, specs = [], []
    for pat, reps in segs:
        seg = [block_init(generator, cfg, spec) for spec in _layers(pat, reps)]
        params.append([p for p, _ in seg])
        specs.append([s for _, s in seg])
    return params, specs, segs


def _repeat_apply(layers, cfg, pat, ctx: MeshCtx, x, positions, enc_out):
    """One repeat of a pattern: its len(pat) layers in order."""
    for layer_p, spec in zip(layers, pat, strict=True):
        x = block_apply(layer_p, cfg, spec, ctx, x, positions=positions, enc_out=enc_out)
    return x


def stack_apply(params, cfg, segs, ctx: MeshCtx, x, *, positions, enc_out=None):
    """x through every segment; cross-attending blocks attend to enc_out,
    an argument of each checkpointed repeat, so its gradient reaches the
    encoder."""
    remat = cfg.remat and torch.is_grad_enabled()
    for seg_p, (pat, reps) in zip(params, segs, strict=True):
        n = len(pat)
        for r in range(reps):
            args = (seg_p[r * n:(r + 1) * n], cfg, pat, ctx, x, positions, enc_out)
            x = (checkpoint(_repeat_apply, *args, use_reentrant=False, preserve_rng_state=False)
                 if remat else _repeat_apply(*args))
    return x


def init_stack_cache(cfg, segs, batch: int, max_len: int, dtype=torch.bfloat16, *,
                     enc_len: int = 0, device: torch.device):
    return [[init_block_cache(cfg, spec, batch, max_len, dtype, enc_len=enc_len, device=device)
             for spec in _layers(pat, reps)] for pat, reps in segs]


def stack_decode(params, cfg, segs, ctx: MeshCtx, x, caches, pos: int):
    """One token through the stack; the caches are updated in place."""
    for seg_p, seg_c, (pat, reps) in zip(params, caches, segs, strict=True):
        for layer_p, layer_c, spec in zip(seg_p, seg_c, _layers(pat, reps), strict=True):
            x, _ = block_decode(layer_p, cfg, spec, ctx, x, layer_c, pos)
    return x, caches
