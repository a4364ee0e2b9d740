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
its cache's `xk`/`xv` in decode.

On a mesh (`MeshCtx`) the stack runs the reference's placement: the
residual stream of train and prefill is split over `model` by rows
(Megatron SP), all-gathered before each mixer and MLP, whose partial
outputs are reduce-scattered back; attention is head-parallel, the dense
MLP column- then row-parallel, MoE expert-parallel, Mamba
channel-parallel, and the xLSTM mixers, whose leaves do not come out in a
tensor-parallel pattern, run on their gathered weights.  Leaves sharded
over `data` (FSDP) are gathered just before use.  Decode keeps the one
token's rows whole and all-reduces the partial outputs.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..launch.mesh import mesh_axes
from ..launch.shardings import _resolve, param_shardings
from . import attention as attn_mod
from . import comm
from . import moe as moe_mod
from . import nn, ssm, xlstm

__all__ = ["LayerSpec", "MeshCtx", "block_init", "block_apply", "block_decode",
           "init_block_cache", "segment_layout", "stack_init", "stack_apply",
           "stack_decode", "init_stack_cache"]

@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"          # attn | mamba | mlstm | slstm
    attn_kind: str = "global"    # global | local | chunked
    mlp: str = "dense"           # dense | moe | none
    cross_attn: bool = False     # enc-dec decoder blocks
    causal: bool = True


@dataclasses.dataclass(frozen=True)
class MeshCtx:
    """The reference's sharding context, with the collectives GSPMD would
    insert written out (`comm`).  Activations take one of three layouts
    over the model axis: replicated (every rank the whole), sequence-split
    (the residual stream of train and prefill, rows (B, S/tp, D)), and
    partial (a row-parallel product whose ranks' outputs sum to it).  Each
    rank of the data axis runs its own rows; a param is held as the block
    its resolved spec (`launch.shardings`) gives the rank, and gathered
    over the axes that do not serve the computation just before use.  With
    no mesh every method is the identity."""
    mesh: Any
    dp: tuple[str, ...] = ("data",)
    tp: str = "model"
    seq_sharded: bool = True

    # -- the mesh -------------------------------------------------------------

    def size(self, axis: str) -> int:
        return 1 if self.mesh is None else mesh_axes(self.mesh).get(axis, 1)

    def group(self, axis: str):
        """The axis's process group, None for an axis of one rank."""
        return self.mesh.get_group(axis) if self.size(axis) > 1 else None

    def coord(self, axis: str) -> int:
        return self.mesh.get_local_rank(axis) if self.size(axis) > 1 else 0

    def sizes(self) -> tuple:
        return () if self.mesh is None else tuple(sorted(mesh_axes(self.mesh).items()))

    def for_seq(self, s: int) -> "MeshCtx":
        """This context for a residual of s rows: sequence-split only when
        asked for, over a model axis of more ranks that s divides."""
        tp = self.size(self.tp)
        split = self.seq_sharded and tp > 1 and s % tp == 0
        return self if split == self.seq_sharded else dataclasses.replace(self, seq_sharded=split)

    # -- params ---------------------------------------------------------------

    def resolve(self, shape, axes):
        """The resolved spec of a leaf of `shape` named `axes` (None without a mesh)."""
        return None if self.mesh is None else _resolve(dict(self.sizes()), tuple(shape), axes)

    def specs(self, init, cfg):
        """The resolved specs of the params `init(generator, cfg)` makes."""
        return _module_specs(init, cfg, self.sizes())

    def weight(self, w, spec, keep: tuple[str, ...] = (), dtype=None):
        """w gathered over every axis its spec shards but those in `keep`;
        cast to `dtype` first when given (half the wire bytes in bf16)."""
        if dtype is not None:
            w = w.to(dtype)
        if self.mesh is None:
            return w
        for d, ax in enumerate(spec):
            for name in reversed(ax if isinstance(ax, tuple) else (ax,) if ax else ()):
                if name not in keep:
                    w = comm.all_gather(w, d, self.group(name))
        return w

    def weights(self, p, specs, keep: tuple[str, ...] = ()):
        """`weight` over a (nested) dict of params."""
        if self.mesh is None:
            return p
        return {k: (self.weights(v, specs[k], keep) if isinstance(v, dict)
                    else self.weight(v, specs[k], keep)) for k, v in p.items()}

    # -- activations ----------------------------------------------------------

    def full(self, x):
        """The residual's layout → replicated (all-gather of the rows)."""
        return comm.all_gather(x, 1, self.group(self.tp)) if self.seq_sharded else x

    def resid(self, x):
        """A replicated tensor → the residual's layout (this rank's rows)."""
        n, r = self.size(self.tp), self.coord(self.tp)
        if not self.seq_sharded or n == 1:
            return x
        s = x.shape[1] // n
        return x[:, r * s:(r + 1) * s]

    def land(self, out, partial: bool):
        """A mixer's output → the residual's layout: a partial product is
        reduce-scattered over the rows (all-reduced when they are not
        split), a replicated one cut to this rank's rows."""
        if not partial:
            return self.resid(out)
        g = self.group(self.tp)
        return comm.reduce_scatter(out, 1, g) if self.seq_sharded else comm.all_reduce(out, g)


@functools.lru_cache(maxsize=None)
def _module_specs(init, cfg, sizes: tuple):
    p, s = init(nn.SHAPES, cfg)
    return param_shardings(dict(sizes), p, s) if sizes else nn.tree_map(lambda a: None, p)


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


def _mlp_local(p, cfg, ctx: MeshCtx, dtype=None):
    """(weights, partial): column-parallel `wg`/`wu`/`w1` and row-parallel
    `wd`/`w2` blocks over the model axis when d_ff divides over it (partial
    True), else the whole weights; either way gathered over `data`, after
    the cast to `dtype` when one is given."""
    specs = ctx.specs(_mlp_init, cfg)
    tp = ctx.size(ctx.tp)
    split = tp > 1 and cfg.d_ff % tp == 0
    keep = (ctx.tp,) if split else ()
    return {k: ctx.weight(v, specs[k], keep, dtype) for k, v in p.items()}, split


def _mlp_body(w, cfg, x):
    act = _acts(cfg)
    if cfg.mlp_act in ("gelu2", "relu2"):  # non-gated 2-matrix MLP
        return act(x @ w["w1"].to(x.dtype)) @ w["w2"].to(x.dtype)
    h = act(x @ w["wg"].to(x.dtype)) * (x @ w["wu"].to(x.dtype))
    return h @ w["wd"].to(x.dtype)


def _mlp_apply(p, cfg, ctx: MeshCtx, x):
    """x whole over the model axis → (out, partial)."""
    w, partial = _mlp_local(p, cfg, ctx)
    return _mlp_body(w, cfg, x), partial


def _mlp_manual_sp(p, cfg, ctx: MeshCtx, h):
    """The reference's explicit Megatron-SP schedule (`cfg.manual_sp`):
    h (this rank's rows) all-gathered over `model`, the weights cast to
    h's dtype and then gathered over `data` (half the wire of float32
    masters), column- then row-parallel, the output reduce-scattered back
    to this rank's rows.  Returns the output in h's layout."""
    w, partial = _mlp_local(p, cfg, ctx, dtype=h.dtype)
    return ctx.land(_mlp_body(w, cfg, ctx.full(h)), partial)


def _mlp_manual_ok(cfg, ctx: MeshCtx) -> bool:
    """Manual SP needs split rows and divisible dims."""
    if not (cfg.manual_sp and ctx.seq_sharded and ctx.mesh is not None):
        return False
    tp, d_sz = ctx.size(ctx.tp), ctx.size("data")
    d = cfg.d_model
    return (cfg.d_ff % tp == 0 and d % d_sz == 0 and cfg.d_ff % d_sz == 0 and d % tp == 0)


def _attend(p, acfg, ctx: MeshCtx, h, **kw):
    """Attention on this rank's heads: (out, partial, wo's bias or None)."""
    w, lcfg, partial, bias = attn_mod.local_attn(p, acfg, ctx)
    out, _ = attn_mod.attention(w, lcfg, h, **kw)
    return out, partial, bias


def _landed(ctx: MeshCtx, out, partial, bias=None):
    out = ctx.land(out, partial)
    return out if bias is None else out + bias.to(out.dtype)


def _mixer_weights(p, init, mcfg, ctx: MeshCtx):
    return ctx.weights(p, ctx.specs(init, mcfg))


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
    """One block over x (B, S, D) in the residual's layout (`ctx`); a
    cross-attending block attends to enc_out (B, S_enc, D), whole over the
    model axis, at key positions 0..S_enc-1."""
    _check_spec(spec)
    h = nn.rmsnorm(p["ln1"], x, cfg.norm_eps)
    bias, partial = None, False  # the xLSTM mixers run whole on their gathered weights
    if spec.mixer == "attn":
        out, partial, bias = _attend(p["attn"], _attn_cfg(cfg, spec), ctx, ctx.full(h),
                                     positions=positions)
    elif spec.mixer == "mamba":
        mcfg = _mamba_cfg(cfg)
        w, psum, partial = ssm.mamba_local(p["mamba"], mcfg, ctx)
        out = ssm.mamba_apply(w, mcfg, ctx.full(h), remat=cfg.remat, psum=psum)
    elif spec.mixer == "mlstm":
        w = _mixer_weights(p["mlstm"], xlstm.mlstm_init,
                           xlstm.MLSTMConfig(cfg.d_model, cfg.n_heads), ctx)
        out = xlstm.mlstm_apply(
            w, xlstm.MLSTMConfig(cfg.d_model, cfg.n_heads, chunk=cfg.mlstm_chunk), ctx.full(h))
    else:
        scfg = xlstm.SLSTMConfig(cfg.d_model, cfg.n_heads)
        out = xlstm.slstm_apply(_mixer_weights(p["slstm"], xlstm.slstm_init, scfg, ctx), scfg,
                                ctx.full(h))
    x = x + _landed(ctx, out, partial, bias)
    if spec.cross_attn:
        h = ctx.full(nn.rmsnorm(p["lnx"], x, cfg.norm_eps))
        out, partial, bias = _attend(
            p["xattn"], _cross_cfg(cfg), ctx, h, kv_x=enc_out, positions=positions,
            kv_positions=torch.arange(enc_out.shape[1], device=enc_out.device))
        x = x + _landed(ctx, out, partial, bias)
    if spec.mlp != "none":
        h = nn.rmsnorm(p["ln2"], x, cfg.norm_eps)
        if spec.mlp == "moe":
            out = moe_mod.moe_apply(p["moe"], cfg.moe_cfg(), h, mesh=ctx.mesh, dp_axes=ctx.dp,
                                    model_axis=ctx.tp, seq_sharded=ctx.seq_sharded)
        elif _mlp_manual_ok(cfg, ctx):
            out = _mlp_manual_sp(p["mlp"], cfg, ctx, h)
        else:
            out = _landed(ctx, *_mlp_apply(p["mlp"], cfg, ctx, ctx.full(h)))
        x = x + out
    return x


# ---------------------------------------------------------------------------
# Block decode (single token against cache)
# ---------------------------------------------------------------------------

def init_block_cache(cfg, spec: LayerSpec, batch: int, max_len: int,
                     dtype=torch.bfloat16, *, enc_len: int = 0, device: torch.device,
                     ctx: MeshCtx | None = None):
    """The mixer's cache on `device`: attention's KV ring in `dtype`, the
    recurrent mixers' float32 states (Mamba's conv window in `dtype`).  A
    cross-attending block adds the encoder's keys and values `xk`/`xv`,
    zeros of (batch, enc_len, n_kv_heads, head_dim) in `dtype`, as the
    reference leaves them: nothing writes the encoder's into them.  On a
    model axis (`ctx`) a rank holds the KV heads of its query heads
    (`attention.head_plan`) and Mamba's state of its channels; the xLSTM
    states, computed whole, are whole."""
    _check_spec(spec)
    ctx = ctx or MeshCtx(mesh=None)
    if spec.mixer == "attn":
        acfg = _attn_cfg(cfg, spec)
        plan = attn_mod.head_plan(acfg, ctx)
        if plan is not None:
            acfg = dataclasses.replace(acfg, n_heads=plan[1], n_kv_heads=plan[3])
        c = {"kv": attn_mod.init_kv_cache(acfg, batch, max_len, dtype, device=device)}
    elif spec.mixer == "mamba":
        mcfg = _mamba_cfg(cfg)
        tp = ctx.size(ctx.tp)
        width = mcfg.d_inner // tp if mcfg.d_inner % tp == 0 else None
        c = {"mamba": ssm.init_mamba_cache(mcfg, batch, dtype, device=device, width=width)}
    elif spec.mixer == "mlstm":
        c = {"mlstm": xlstm.init_mlstm_cache(xlstm.MLSTMConfig(cfg.d_model, cfg.n_heads),
                                             batch, device=device)}
    else:
        c = {"slstm": xlstm.init_slstm_cache(xlstm.SLSTMConfig(cfg.d_model, cfg.n_heads),
                                             batch, device=device)}
    if spec.cross_attn:
        plan = attn_mod.head_plan(_cross_cfg(cfg), ctx)
        shape = (batch, enc_len, cfg.n_kv_heads if plan is None else plan[3], cfg.head_dim)
        c["xk"] = torch.zeros(shape, dtype=dtype, device=device)
        c["xv"] = torch.zeros(shape, dtype=dtype, device=device)
    return c


def block_decode(p, cfg, spec: LayerSpec, ctx: MeshCtx, x, cache, pos: int):
    """One token through one block, x whole over the model axis; `cache`
    (this rank's, `init_block_cache`) is updated in place and returned."""
    _check_spec(spec)
    h = nn.rmsnorm(p["ln1"], x, cfg.norm_eps)
    bias, partial = None, False  # the xLSTM mixers run whole on their gathered weights
    if spec.mixer == "attn":
        w, lcfg, partial, bias = attn_mod.local_attn(p["attn"], _attn_cfg(cfg, spec), ctx)
        out, cache["kv"] = attn_mod.attn_decode(w, lcfg, h, cache["kv"], pos)
    elif spec.mixer == "mamba":
        mcfg = _mamba_cfg(cfg)
        w, psum, partial = ssm.mamba_local(p["mamba"], mcfg, ctx)
        out, cache["mamba"] = ssm.mamba_decode(w, mcfg, h, cache["mamba"], psum)
    elif spec.mixer == "mlstm":
        mcfg = xlstm.MLSTMConfig(cfg.d_model, cfg.n_heads)
        out, cache["mlstm"] = xlstm.mlstm_decode(
            _mixer_weights(p["mlstm"], xlstm.mlstm_init, mcfg, ctx), mcfg, h, cache["mlstm"])
    else:
        scfg = xlstm.SLSTMConfig(cfg.d_model, cfg.n_heads)
        out, cache["slstm"] = xlstm.slstm_decode(
            _mixer_weights(p["slstm"], xlstm.slstm_init, scfg, ctx), scfg, h, cache["slstm"])
    x = x + _landed(ctx, out, partial, bias)
    if spec.cross_attn:
        h = nn.rmsnorm(p["lnx"], x, cfg.norm_eps)
        w, lcfg, partial, bias = attn_mod.local_attn(p["xattn"], _cross_cfg(cfg), ctx)
        out = attn_mod.attn_cross_decode(w, lcfg, h, cache["xk"].to(x.dtype),
                                         cache["xv"].to(x.dtype))
        x = x + _landed(ctx, out, partial, bias)
    if spec.mlp != "none":
        h = nn.rmsnorm(p["ln2"], x, cfg.norm_eps)
        if spec.mlp == "moe":
            out = moe_mod.moe_apply(p["moe"], cfg.moe_cfg(), h, mesh=ctx.mesh, dp_axes=ctx.dp,
                                    model_axis=ctx.tp, seq_sharded=False)
        else:
            out = _landed(ctx, *_mlp_apply(p["mlp"], cfg, ctx, h))
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


def stack_init(generator: torch.Generator, cfg, pattern, n_layers: int, place=None):
    """Per segment, the list of its layers' params (and specs); `place(p,
    s)`, when given, turns each layer's params into what is kept as soon
    as the layer is drawn (a rank's blocks)."""
    segs = segment_layout(n_layers, pattern)
    params, specs = [], []
    for pat, reps in segs:
        seg = []
        for spec in _layers(pat, reps):
            p, s = block_init(generator, cfg, spec)
            seg.append((p if place is None else place(p, s), s))
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
                     enc_len: int = 0, device: torch.device, ctx: MeshCtx | None = None):
    return [[init_block_cache(cfg, spec, batch, max_len, dtype, enc_len=enc_len, device=device,
                              ctx=ctx)
             for spec in _layers(pat, reps)] for pat, reps in segs]


def stack_decode(params, cfg, segs, ctx: MeshCtx, x, caches, pos: int):
    """One token through the stack; the caches are updated in place."""
    ctx = ctx.for_seq(1)
    for seg_p, seg_c, (pat, reps) in zip(params, caches, segs, strict=True):
        for layer_p, layer_c, spec in zip(seg_p, seg_c, _layers(pat, reps), strict=True):
            x, _ = block_decode(layer_p, cfg, spec, ctx, x, layer_c, pos)
    return x, caches
