"""minitron-4b [dense] — 32L d_model=3072 24H (GQA kv=8, head_dim=128)
d_ff=9216 vocab=256000; pruned Nemotron: squared-ReLU MLP, no gating.
[arXiv:2407.14679; hf]

long_500k: SKIP — pure full attention.
"""
from ..models import LayerSpec, ModelConfig

_G = LayerSpec(mixer="attn", attn_kind="global", mlp="dense")


def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-4b", family="dense",
        n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
        d_ff=9216, vocab=256000,
        rope_theta=10000.0, pattern=(_G,), mlp_act="relu2",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minitron-4b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512,
        pattern=(_G,), mlp_act="relu2", q_block=16, kv_block=32,
    )
