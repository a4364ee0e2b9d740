"""Deterministic synthetic LM data (counterpart of `repro.data`)."""
from .pipeline import SyntheticBatches, SyntheticTokens, host_shard_slice

__all__ = ["SyntheticBatches", "SyntheticTokens", "host_shard_slice"]
