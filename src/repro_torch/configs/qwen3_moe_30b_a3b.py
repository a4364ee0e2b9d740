"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4, head_dim=128)
d_ff=768/expert vocab=151936; 128 experts top-8, qk_norm.
[hf:Qwen/Qwen3-30B-A3B; hf]

long_500k: SKIP — pure full attention.
"""
from ..models import LayerSpec, ModelConfig

_G = LayerSpec(mixer="attn", attn_kind="global", mlp="moe")


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
        d_ff=768, vocab=151936,
        qk_norm=True, rope_theta=1_000_000.0,
        pattern=(_G,), n_experts=128, top_k=8,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=32, vocab=512,
        qk_norm=True, pattern=(_G,), n_experts=8, top_k=2,
        q_block=16, kv_block=32,
    )
