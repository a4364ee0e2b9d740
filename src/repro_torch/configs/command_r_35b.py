"""command-r-35b [dense] — 40L d_model=8192 64H (GQA kv=8, head_dim=128)
d_ff=22528 vocab=256000; no biases.  [hf:CohereForAI/c4ai-command-r-v01;
unverified]  (Cohere uses a parallel attn+FFN block; we keep the sequential
pre-norm form — a noted simplification, parameter shapes identical.)

long_500k: SKIP — pure full attention.
"""
from ..models import LayerSpec, ModelConfig

_G = LayerSpec(mixer="attn", attn_kind="global", mlp="dense")


def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b", family="dense",
        n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=22528, vocab=256000,
        rope_theta=8_000_000.0, pattern=(_G,), mlp_act="silu",
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=160, vocab=512,
        pattern=(_G,), mlp_act="silu", tie_embeddings=True,
        q_block=16, kv_block=32,
    )
