"""internvl2-1b [vlm] — 24L d_model=896 14H (GQA kv=2, head_dim=64)
d_ff=4864 vocab=151655; Qwen2-0.5B text backbone + InternViT patch frontend
as a STUB (input_specs provides 256 precomputed patch embeddings projected
into the LM width).  [arXiv:2404.16821; hf]

long_500k: SKIP — pure full attention.
"""
from ..models import LayerSpec, ModelConfig

_G = LayerSpec(mixer="attn", attn_kind="global", mlp="dense")


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b", family="vlm",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
        d_ff=4864, vocab=151655,
        bias=True, rope_theta=1_000_000.0,
        pattern=(_G,), mlp_act="silu",
        n_image_tokens=256, tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512,
        bias=True, pattern=(_G,), mlp_act="silu",
        n_image_tokens=8, tie_embeddings=True, q_block=16, kv_block=32,
    )
