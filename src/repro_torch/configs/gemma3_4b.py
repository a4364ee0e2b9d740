"""gemma3-4b [dense] — 34L d_model=2560 8H (GQA kv=4, head_dim=256)
d_ff=10240 vocab=262144; 5:1 local(1024):global interleave, GeGLU, tied +
scaled embeddings.  [hf:google/gemma-3-*-pt; unverified]

long_500k: RUN — 5/6 of layers are window-1024 local; global layers use the
blocked attention + sequence-sharded KV (DESIGN.md §5).
"""
from ..models import LayerSpec, ModelConfig

_L = LayerSpec(mixer="attn", attn_kind="local", mlp="dense")
_G = LayerSpec(mixer="attn", attn_kind="global", mlp="dense")


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b", family="dense",
        n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, head_dim=256,
        d_ff=10240, vocab=262144,
        window=1024, qk_norm=True, rope_theta=1_000_000.0,
        pattern=(_L, _L, _L, _L, _L, _G),
        mlp_act="geglu", tie_embeddings=True, scale_embed=True,
        final_softcap=30.0, supports_long_context=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b-smoke", family="dense",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512,
        window=16, qk_norm=True,
        pattern=(_L, _G),
        mlp_act="geglu", tie_embeddings=True, scale_embed=True,
        final_softcap=30.0, q_block=16, kv_block=32,
        supports_long_context=True,
    )
