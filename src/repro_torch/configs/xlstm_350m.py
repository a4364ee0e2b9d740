"""xlstm-350m [ssm] — 24L d_model=1024 4H vocab=50304; xLSTM[7:1] —
7 mLSTM blocks per 1 sLSTM block, no separate FFN (d_ff=0; the blocks carry
their own up/down projections).  [arXiv:2405.04517; unverified]

long_500k: RUN — recurrent O(1) state (this family is why the shape exists).
"""
from ..models import LayerSpec, ModelConfig

_M = LayerSpec(mixer="mlstm", mlp="none")
_S = LayerSpec(mixer="slstm", mlp="none")


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m", family="ssm",
        n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, head_dim=256,
        d_ff=0, vocab=50304, rope=False,
        pattern=(_M, _M, _M, _M, _M, _M, _M, _S),
        tie_embeddings=True, supports_long_context=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m-smoke", family="ssm",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=0, vocab=512, rope=False,
        pattern=(_M, _S),
        tie_embeddings=True, supports_long_context=True,
    )
