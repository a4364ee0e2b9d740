"""Model wrapper (counterpart of `repro.models.model`): the config dataclass
and the LM.

`ModelConfig` keeps every field and default of the reference's, so the ten
configs of `repro_torch.configs` are its data unchanged; `cdtype` and
`pdtype` are torch dtypes.  `LM` serves and trains the decoder-only
families, dense, MoE, SSM (xLSTM) and hybrid (Jamba) (`prefill`,
`decode_step`, and `loss`, which autograd differentiates for
`repro_torch.launch.steps.make_train_step`).  Parameters are a nested
dict of tensors passed explicitly, as in the reference, so weights carried
across from it (`repro_torch.interop.lm_params_from_reference`) drop in.
The enc-dec, VLM and audio branches raise until their slice.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from . import nn
from .moe import MoEConfig
from .transformer import (LATER_SLICES, LayerSpec, MeshCtx, init_stack_cache, segment_layout,
                          stack_apply, stack_decode, stack_init)
from ..device import resolve_device

__all__ = ["ModelConfig", "LM", "LayerSpec"]

#: The families this slice serves, and the slice that serves each other one.
SERVED = ("dense", "moe", "ssm", "hybrid")
FAMILY_SLICES = {
    "audio": LATER_SLICES["cross_attn"],
    "vlm": LATER_SLICES["cross_attn"],
}


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


def _refusal(cfg: ModelConfig) -> str | None:
    if cfg.family in FAMILY_SLICES:
        return f"the {cfg.family} family comes with {FAMILY_SLICES[cfg.family]}"
    if cfg.family not in SERVED:
        return f"unknown family {cfg.family!r}"
    if cfg.encoder_decoder or cfg.n_image_tokens or cfg.audio_frontend:
        return f"enc-dec, image and audio inputs come with {LATER_SLICES['cross_attn']}"
    return None


class LM(torch.nn.Module):
    """The decoder-only LM; params passed explicitly everywhere.  Its
    `forward` is one decode step (`decode_step`)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        why = _refusal(cfg)
        if why:
            raise NotImplementedError(f"LM({cfg.name}): {why}")
        self.cfg = cfg
        self.segs = segment_layout(cfg.n_layers, cfg.pattern)

    # -- init ---------------------------------------------------------------

    def init(self, generator: torch.Generator):
        """(params, specs), drawn from `generator` on its device (`nn.SHAPES`:
        meta tensors, nothing allocated).  Each leaf is drawn in float32 and
        cast to cfg.pdtype before the next is drawn, so a bfloat16 model
        never has a float32 copy (the reference casts the whole float32
        tree at the end)."""
        cfg = self.cfg
        dt = cfg.pdtype
        p, s = {}, {}
        p["embed"], s["embed"] = nn.embed_init(generator, cfg.vocab, cfg.d_model, dtype=dt)
        p["final_norm"], s["final_norm"] = nn.rmsnorm_init(cfg.d_model, generator.device, dt)
        pattern = self.segs[0][0]
        p["layers"], s["layers"], _ = stack_init(generator, cfg, pattern, cfg.n_layers)
        if not cfg.tie_embeddings:
            p["unembed"], s["unembed"] = nn.dense_init(
                generator, cfg.d_model, cfg.vocab, axes=("embed", "vocab"),
                scale=cfg.d_model ** -0.5, dtype=dt)
        return p, s

    # -- shared pieces --------------------------------------------------------

    def _embed(self, p, tokens):
        """Rows of the table in the compute dtype, then the sqrt(d_model) scale."""
        cfg = self.cfg
        x = p["embed"]["w"][tokens].to(cfg.cdtype)
        if cfg.scale_embed:
            x = x * nn.weak(math.sqrt(cfg.d_model), x.dtype)
        return x

    def _logits(self, p, x):
        """x @ the (tied) unembedding in x's dtype; the final softcap in float32."""
        cfg = self.cfg
        w = (p["embed"]["w"].T if cfg.tie_embeddings else p["unembed"]["w"]).to(x.dtype)
        logits = x @ w
        if cfg.final_softcap:
            logits = nn.softcap(logits.float(), cfg.final_softcap)
        return logits

    def _backbone(self, p, ctx: MeshCtx, tokens):
        x = ctx.resid(self._embed(p, tokens))
        positions = torch.arange(x.shape[1], device=x.device)
        x = stack_apply(p["layers"], self.cfg, self.segs, ctx, x, positions=positions)
        return nn.rmsnorm(p["final_norm"], x, self.cfg.norm_eps)

    # -- train --------------------------------------------------------------

    def loss(self, p, ctx: MeshCtx, batch):
        """Mean next-token cross-entropy over batch["tokens"] (B, S)."""
        x = ctx.shard(self._backbone(p, ctx, batch["tokens"]), ctx.dp, None, None)
        logits = ctx.shard(self._logits(p, x), ctx.dp, None, ctx.tp)
        targets = batch["tokens"][:, 1:].long()
        logits = logits[:, :-1].float()
        lse = torch.logsumexp(logits, dim=-1)
        true = torch.gather(logits, -1, targets[..., None])[..., 0]
        return torch.mean(lse - true)

    # -- serve --------------------------------------------------------------

    def prefill(self, p, ctx: MeshCtx, batch):
        """Returns last-token logits (B, 1, V).  (Decode seeds its cache
        through decode_step, whose cache is an explicit input.)"""
        return self._logits(p, self._backbone(p, ctx, batch["tokens"])[:, -1:])

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16, *,
                   device: str | torch.device | None = None):
        """Per segment, each layer's KV cache on `device` (None → the card)."""
        return init_stack_cache(self.cfg, self.segs, batch, max_len, dtype,
                                device=resolve_device(device))

    def decode_step(self, p, ctx: MeshCtx, token, cache, pos: int):
        """token (B,1) int; pos the position of the whole batch.  Returns
        (logits (B,V), cache), the cache updated in place."""
        cfg = self.cfg
        x = self._embed(p, token)
        x, cache = stack_decode(p["layers"], cfg, self.segs, ctx, x, cache, pos)
        x = nn.rmsnorm(p["final_norm"], x, cfg.norm_eps)
        return self._logits(p, x)[:, 0], cache

    forward = decode_step
