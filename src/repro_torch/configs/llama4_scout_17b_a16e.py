"""llama4-scout-17b-a16e [moe] — 48L d_model=5120 40H (GQA kv=8,
head_dim=128) d_ff=8192/expert vocab=202048; MoE 16 experts top-1 + 1 shared
expert every layer; iRoPE: chunked-local attention (8192) with a NoPE global
layer every 4th.  [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

long_500k: RUN — 3/4 of layers are chunk-8192 local.
"""
from ..models import LayerSpec, ModelConfig

_C = LayerSpec(mixer="attn", attn_kind="chunked", mlp="moe")
_G = LayerSpec(mixer="attn", attn_kind="global", mlp="moe")


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab=202048,
        chunk_attn=8192, nope_global=True, rope_theta=500_000.0,
        pattern=(_C, _C, _C, _G),
        n_experts=16, top_k=1, n_shared_experts=1,
        supports_long_context=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-smoke", family="moe",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab=512,
        chunk_attn=32, nope_global=True,
        pattern=(_C, _G),
        n_experts=4, top_k=1, n_shared_experts=1,
        q_block=16, kv_block=32, supports_long_context=True,
    )
