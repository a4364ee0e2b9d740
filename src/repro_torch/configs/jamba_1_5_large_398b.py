"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8,
head_dim=128) d_ff=24576 vocab=65536; Mamba:attention 7:1 interleave (one
attention layer per 8-layer Jamba block), MoE 16 experts top-2 every other
layer, no positional encoding (Mamba carries position).
[arXiv:2403.19887; hf]

Memory policy: bf16 params + 8-bit optimizer state (398B params would not
fit fp32 master + fp32 Adam in 256×16 GB; see DESIGN.md §4).

long_500k: RUN — 7/8 of layers are O(1)-state Mamba; the 9 attention layers
use sequence-sharded KV caches.
"""
from ..models import LayerSpec, ModelConfig

_Md = LayerSpec(mixer="mamba", mlp="dense")
_Mm = LayerSpec(mixer="mamba", mlp="moe")
_Ad = LayerSpec(mixer="attn", attn_kind="global", mlp="dense")


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid",
        n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=24576, vocab=65536,
        rope=False,
        pattern=(_Md, _Mm, _Md, _Mm, _Ad, _Mm, _Md, _Mm),
        n_experts=16, top_k=2, d_state=16,
        param_dtype="bfloat16", opt_8bit=True,
        supports_long_context=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke", family="hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab=512,
        rope=False,
        pattern=(_Md, _Mm, _Ad, _Mm),
        n_experts=4, top_k=2, d_state=4,
        q_block=16, kv_block=32, supports_long_context=True,
    )
