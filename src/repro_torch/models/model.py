"""Model wrapper (counterpart of `repro.models.model`): the config dataclass
and the LM.

`ModelConfig` keeps every field and default of the reference's, so the ten
configs of `repro_torch.configs` are its data unchanged; `cdtype` and
`pdtype` are torch dtypes.  `LM` serves and trains every family: dense,
MoE, SSM (xLSTM), hybrid (Jamba), enc-dec audio (whisper: an encoder stack
over stub frame embeddings, cross-attending decoder blocks) and VLM
(InternVL: `img_proj` of stub patch embeddings before the text) through
`prefill`, `decode_step`, and `loss`, which autograd differentiates for
`repro_torch.launch.steps.make_train_step`.  Parameters are a nested dict
of tensors passed explicitly, as in the reference, so weights carried
across from it (`repro_torch.interop.lm_params_from_reference`) drop in.

As in the reference, decode embeds tokens alone: a VLM's image prefix
never reaches it, and an enc-dec decoder cross-attends to its cache's
`xk`/`xv`, which `init_cache` makes zeros and nothing fills with the
encoder's keys and values.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from . import comm, nn
from .moe import MoEConfig
from .transformer import (LayerSpec, MeshCtx, init_stack_cache, segment_layout, stack_apply,
                          stack_decode, stack_init)
from ..device import resolve_device

__all__ = ["ModelConfig", "LM", "LayerSpec", "ENC_SPEC"]

#: The encoder's block: bidirectional global attention and a dense MLP.
ENC_SPEC = LayerSpec(mixer="attn", attn_kind="global", mlp="dense", causal=False)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | audio | vlm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int
    # attention variants
    window: int | None = None
    chunk_attn: int | None = None
    qk_norm: bool = False
    rope: bool = True
    nope_global: bool = False      # llama4 iRoPE: global layers have no RoPE
    rope_theta: float = 10000.0
    attn_softcap: float | None = None
    final_softcap: float | None = None
    bias: bool = False
    q_block: int = 512
    kv_block: int = 1024
    # layer pattern (repeats to cover n_layers; remainder truncates pattern)
    pattern: tuple[LayerSpec, ...] = (LayerSpec(),)
    # mlp / moe
    mlp_act: str = "silu"
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    # ssm
    d_state: int = 16
    # embeddings
    tie_embeddings: bool = False
    scale_embed: bool = False
    norm_eps: float = 1e-6
    remat: bool = True
    # enc-dec (whisper)
    encoder_decoder: bool = False
    n_enc_layers: int = 0
    dec_ratio: int = 8             # decoder len = seq // dec_ratio
    # vlm
    n_image_tokens: int = 0
    # frontend stubs
    audio_frontend: bool = False
    # dtypes / memory policy
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    opt_8bit: bool = False
    # long-context capability (sub-quadratic path exists)
    supports_long_context: bool = False
    # the reference's inner-loop chunking and compiled-scan controls
    mamba_scan_chunk: int = 512
    mlstm_chunk: int = 256
    unroll_stack: bool = False
    # the reference's sharding experiments (no effect on one rank)
    attn_pin_layout: bool = False
    manual_sp: bool = False

    def moe_cfg(self) -> MoEConfig:
        return MoEConfig(self.d_model, self.d_ff, self.n_experts, self.top_k,
                         self.n_shared_experts)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)


class LM(torch.nn.Module):
    """The LM (decoder-only, enc-dec or VLM); params passed explicitly
    everywhere.  Its `forward` is one decode step (`decode_step`)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.segs = segment_layout(cfg.n_layers, cfg.pattern)
        if cfg.encoder_decoder:
            self.enc_segs = segment_layout(cfg.n_enc_layers, (ENC_SPEC,))
            dec_pattern = tuple(dataclasses.replace(s, cross_attn=True) for s in cfg.pattern)
            self.segs = segment_layout(cfg.n_layers, dec_pattern)

    # -- init ---------------------------------------------------------------

    def init(self, generator: torch.Generator, *, mesh=None):
        """(params, specs), drawn from `generator` on its device (`nn.SHAPES`:
        meta tensors, nothing allocated).  Each leaf is drawn in float32 and
        cast to cfg.pdtype before the next is drawn, so a bfloat16 model
        never has a float32 copy (the reference casts the whole float32
        tree at the end).  With a `mesh`, each part (the embedding, each
        layer, ...) is cut to this rank's blocks (`launch.shardings`) as
        soon as it is drawn: every rank draws the same whole weights, one
        part at a time, and keeps its blocks."""
        cfg = self.cfg
        dt = cfg.pdtype
        def place(p, s):
            if mesh is None:
                return p
            from ..launch.shardings import param_shardings, shard_tree
            return shard_tree(p, param_shardings(mesh, p, s), mesh)
        p, s = {}, {}
        p["embed"], s["embed"] = nn.embed_init(generator, cfg.vocab, cfg.d_model, dtype=dt)
        p["embed"] = place(p["embed"], s["embed"])
        p["final_norm"], s["final_norm"] = nn.rmsnorm_init(cfg.d_model, generator.device, dt)
        pattern = self.segs[0][0]
        p["layers"], s["layers"], _ = stack_init(generator, cfg, pattern, cfg.n_layers, place)
        if not cfg.tie_embeddings:
            p["unembed"], s["unembed"] = nn.dense_init(
                generator, cfg.d_model, cfg.vocab, axes=("embed", "vocab"),
                scale=cfg.d_model ** -0.5, dtype=dt)
            p["unembed"] = place(p["unembed"], s["unembed"])
        if cfg.encoder_decoder:
            p["enc_layers"], s["enc_layers"], _ = stack_init(
                generator, cfg, self.enc_segs[0][0], cfg.n_enc_layers, place)
            p["enc_norm"], s["enc_norm"] = nn.rmsnorm_init(cfg.d_model, generator.device, dt)
        if cfg.n_image_tokens:
            p["img_proj"], s["img_proj"] = nn.dense_init(
                generator, cfg.d_model, cfg.d_model, axes=("embed", None), dtype=dt)
            p["img_proj"] = place(p["img_proj"], s["img_proj"])
        return p, s

    # -- shared pieces --------------------------------------------------------

    def _vocab_spec(self, ctx: MeshCtx, untied: bool):
        """The resolved spec of the (un)embedding and whether its vocabulary
        is split over the model axis."""
        cfg = self.cfg
        shape, axes = (((cfg.d_model, cfg.vocab), ("embed", "vocab")) if untied
                       else ((cfg.vocab, cfg.d_model), ("vocab", "embed")))
        spec = ctx.resolve(shape, axes)
        return spec, spec is not None and spec[axes.index("vocab")] == ctx.tp \
            and ctx.size(ctx.tp) > 1

    def _embed(self, p, ctx: MeshCtx, tokens):
        """Rows of the table in the compute dtype, then the sqrt(d_model)
        scale.  A vocabulary split over the model axis is looked up by each
        rank in its block (other rows zero) and summed over the axis.  The
        lookup is `F.embedding`, whose CUDA backward sums a row's repeats
        in a fixed order (indexing's would add them with atomics)."""
        cfg = self.cfg
        spec, split = self._vocab_spec(ctx, False)
        w = p["embed"]["w"] if spec is None else ctx.weight(p["embed"]["w"], spec, (ctx.tp,))
        if split:
            n = w.shape[0]
            ids = tokens.long() - ctx.coord(ctx.tp) * n
            ok = (ids >= 0) & (ids < n)
            x = torch.where(ok[..., None], F.embedding(ids.clamp(0, n - 1), w).to(cfg.cdtype), 0)
            x = comm.all_reduce(x, ctx.group(ctx.tp))
        else:
            x = F.embedding(tokens, w).to(cfg.cdtype)
        if cfg.scale_embed:
            x = x * nn.weak(math.sqrt(cfg.d_model), x.dtype)
        return x

    def _logits(self, p, x, ctx: MeshCtx | None = None):
        """x @ the (tied) unembedding in x's dtype, the final softcap in
        float32: this rank's block of the vocabulary when it is split over
        the model axis (`_vocab_spec`)."""
        cfg = self.cfg
        untied = not cfg.tie_embeddings
        w = p["unembed"]["w"] if untied else p["embed"]["w"]
        if ctx is not None:
            spec, split = self._vocab_spec(ctx, untied)
            if spec is not None:
                w = ctx.weight(w, spec, (ctx.tp,) if split else ())
        logits = x @ (w if untied else w.T).to(x.dtype)
        if cfg.final_softcap:
            logits = nn.softcap(logits.float(), cfg.final_softcap)
        return logits

    def _whole_logits(self, p, ctx: MeshCtx, x):
        """The logits of the whole vocabulary on every rank."""
        logits = self._logits(p, x, ctx)
        split = self._vocab_spec(ctx, not self.cfg.tie_embeddings)[1]
        return comm.all_gather(logits, -1, ctx.group(ctx.tp)) if split else logits

    def _encode(self, p, ctx: MeshCtx, frames):
        """The encoder stack over stub frame embeddings (B, S_enc, D); its
        output whole over the model axis."""
        cfg = self.cfg
        x = frames.to(cfg.cdtype)
        ctx = ctx.for_seq(x.shape[1])
        pos = torch.arange(x.shape[1], device=x.device)
        x = stack_apply(p["enc_layers"], cfg, self.enc_segs, ctx, ctx.resid(x), positions=pos)
        return ctx.full(nn.rmsnorm(p["enc_norm"], x, cfg.norm_eps))

    def _backbone_inputs(self, p, ctx: MeshCtx, batch):
        """(x, enc_out): the decoder's input (B, S, D) and the encoder's
        output, None but for an enc-dec model.  A VLM's x is `img_proj` of
        batch["image_embeds"] followed by the token embeddings; an
        audio-frontend model without an encoder takes batch["frames"] as x."""
        cfg = self.cfg
        if cfg.encoder_decoder:
            return self._embed(p, ctx, batch["tokens"]), self._encode(p, ctx, batch["frames"])
        if cfg.n_image_tokens:
            spec = ctx.resolve((cfg.d_model, cfg.d_model), ("embed", None))
            w = p["img_proj"] if spec is None else {"w": ctx.weight(p["img_proj"]["w"], spec)}
            img = nn.linear(w, batch["image_embeds"].to(cfg.cdtype))
            return torch.cat([img, self._embed(p, ctx, batch["tokens"])], dim=1), None
        if cfg.audio_frontend:
            return batch["frames"].to(cfg.cdtype), None
        return self._embed(p, ctx, batch["tokens"]), None

    def _backbone(self, p, ctx: MeshCtx, batch):
        """The final norm's output (B, S, D), whole over the model axis."""
        x, enc_out = self._backbone_inputs(p, ctx, batch)
        ctx = ctx.for_seq(x.shape[1])
        positions = torch.arange(x.shape[1], device=x.device)
        x = stack_apply(p["layers"], self.cfg, self.segs, ctx, ctx.resid(x),
                        positions=positions, enc_out=enc_out)
        return ctx.full(nn.rmsnorm(p["final_norm"], x, self.cfg.norm_eps))

    # -- train --------------------------------------------------------------

    def loss(self, p, ctx: MeshCtx, batch):
        """Mean next-token cross-entropy over batch["tokens"] (B, S); a VLM's
        over the text tail only.  On a mesh, `batch` is this rank's rows
        and the loss theirs; a vocabulary split over the model axis takes
        its log-sum-exp and target logits over the ranks' blocks."""
        x = self._backbone(p, ctx, batch)
        if self.cfg.n_image_tokens:
            x = x[:, self.cfg.n_image_tokens:]
        split = self._vocab_spec(ctx, not self.cfg.tie_embeddings)[1]
        logits = self._logits(p, x, ctx)
        targets = batch["tokens"][:, 1:].long()
        logits = logits[:, :-1].float()
        if not split:
            lse = torch.logsumexp(logits, dim=-1)
            true = torch.gather(logits, -1, targets[..., None])[..., 0]
            return torch.mean(lse - true)
        g = ctx.group(ctx.tp)
        n = logits.shape[-1]
        m = comm.all_reduce_max(logits.amax(dim=-1), g)
        lse = m + torch.log(comm.all_reduce(torch.exp(logits - m[..., None]).sum(dim=-1), g))
        ids = targets - ctx.coord(ctx.tp) * n
        ok = (ids >= 0) & (ids < n)
        true = torch.gather(logits, -1, ids.clamp(0, n - 1)[..., None])[..., 0]
        true = comm.all_reduce(torch.where(ok, true, 0.0), g)
        return torch.mean(lse - true)

    # -- serve --------------------------------------------------------------

    def prefill(self, p, ctx: MeshCtx, batch):
        """Returns last-token logits (B, 1, V), the whole vocabulary.
        (Decode seeds its cache through decode_step, whose cache is an
        explicit input.)"""
        return self._whole_logits(p, ctx, self._backbone(p, ctx, batch)[:, -1:])

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16, *, enc_len: int = 0,
                   device: str | torch.device | None = None, ctx: MeshCtx | None = None):
        """Per segment, each layer's cache on `device` (None → the card); a
        cross-attending layer's `xk`/`xv` hold enc_len zero keys and values.
        With `ctx` on a mesh, this rank's part (`init_block_cache`)."""
        return init_stack_cache(self.cfg, self.segs, batch, max_len, dtype, enc_len=enc_len,
                                device=resolve_device(device), ctx=ctx)

    def decode_step(self, p, ctx: MeshCtx, token, cache, pos: int):
        """token (B,1) int; pos the position of the whole batch.  Returns
        (logits (B,V), cache), the cache updated in place."""
        cfg = self.cfg
        x = self._embed(p, ctx, token)
        x, cache = stack_decode(p["layers"], cfg, self.segs, ctx, x, cache, pos)
        x = nn.rmsnorm(p["final_norm"], x, cfg.norm_eps)
        return self._whole_logits(p, ctx, x)[:, 0], cache

    forward = decode_step
