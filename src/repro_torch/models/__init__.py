"""The LM stack (counterpart of `repro.models`): the functional nn
substrate, GQA attention, MoE, SSM and xLSTM mixers, pattern-stacked
blocks with cross-attention, and the LM wrapper.  It serves and trains
every family of the ten configs; it is not re-exported from
`repro_torch`, as `repro.models` is not from `repro`."""
from .model import LM, LayerSpec, ModelConfig
from .transformer import MeshCtx

__all__ = ["LM", "LayerSpec", "MeshCtx", "ModelConfig"]
