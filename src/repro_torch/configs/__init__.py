"""The assigned architecture configs (counterpart of `repro.configs`), the
same data against `repro_torch.models`.  `get_config(name)` returns the
exact published config; `get_smoke_config(name)` a reduced same-family
config for CPU tests.  Every name has both; `LM(cfg)` refuses a family
this slice does not serve."""
from __future__ import annotations

from . import (
    command_r_35b,
    gemma3_4b,
    internvl2_1b,
    jamba_1_5_large_398b,
    llama4_scout_17b_a16e,
    minitron_4b,
    qwen3_14b,
    qwen3_moe_30b_a3b,
    whisper_medium,
    xlstm_350m,
)

__all__ = ["ALIASES", "ARCHS", "get_config", "get_smoke_config"]

ARCHS = [
    "gemma3_4b",
    "qwen3_14b",
    "minitron_4b",
    "command_r_35b",
    "llama4_scout_17b_a16e",
    "qwen3_moe_30b_a3b",
    "xlstm_350m",
    "whisper_medium",
    "internvl2_1b",
    "jamba_1_5_large_398b",
]

ALIASES = {a.replace("_", "-"): a for a in ARCHS}

_MODULES = {m.__name__.rsplit(".", 1)[1]: m for m in (
    command_r_35b, gemma3_4b, internvl2_1b, jamba_1_5_large_398b, llama4_scout_17b_a16e,
    minitron_4b, qwen3_14b, qwen3_moe_30b_a3b, whisper_medium, xlstm_350m)}


def _mod(name: str):
    return _MODULES[ALIASES.get(name, name)]


def get_config(name: str):
    return _mod(name).config()


def get_smoke_config(name: str):
    return _mod(name).smoke_config()
