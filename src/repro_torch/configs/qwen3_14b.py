"""qwen3-14b [dense] — 40L d_model=5120 40H (GQA kv=8, head_dim=128)
d_ff=17408 vocab=151936; qk_norm, SwiGLU, no bias.  [hf:Qwen/Qwen3-14B; hf]

long_500k: SKIP — pure full attention (noted in DESIGN.md §5).
"""
from ..models import LayerSpec, ModelConfig

_G = LayerSpec(mixer="attn", attn_kind="global", mlp="dense")


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b", family="dense",
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
        d_ff=17408, vocab=151936,
        qk_norm=True, rope_theta=1_000_000.0,
        pattern=(_G,), mlp_act="silu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512,
        qk_norm=True, pattern=(_G,), mlp_act="silu",
        q_block=16, kv_block=32,
    )
