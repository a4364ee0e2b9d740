"""whisper-medium [audio] — enc-dec, 24+24L d_model=1024 16H (MHA, head_dim=64)
d_ff=4096 vocab=51865; conv frontend is a STUB (input_specs provides
precomputed frame embeddings), plain GELU MLP.  [arXiv:2212.04356; unverified]

Adaptations (DESIGN.md): RMSNorm instead of LayerNorm, RoPE on decoder
self-attn instead of learned positional embeddings (parameter-free; the stub
frame embeddings are assumed position-encoded).

Shapes: seq_len drives the ENCODER frame length; decoder length = seq/8.
long_500k: SKIP — full attention.  Decode runs (enc-dec has a decoder).
"""
from ..models import LayerSpec, ModelConfig

_D = LayerSpec(mixer="attn", attn_kind="global", mlp="dense", causal=True)


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium", family="audio",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
        d_ff=4096, vocab=51865,
        pattern=(_D,), mlp_act="gelu2",
        encoder_decoder=True, n_enc_layers=24, dec_ratio=8,
        audio_frontend=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=512,
        pattern=(_D,), mlp_act="gelu2",
        encoder_decoder=True, n_enc_layers=2, dec_ratio=4,
        audio_frontend=True, q_block=16, kv_block=32,
    )
