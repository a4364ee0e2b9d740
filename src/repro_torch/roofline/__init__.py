"""Roofline bounds for the port's card and collective-byte accounting."""
from .collectives import collective_bytes, wire_bytes
from .model import H100_SXM5, HWTarget, model_flops, roofline_terms

__all__ = ["H100_SXM5", "HWTarget", "collective_bytes", "model_flops", "roofline_terms",
           "wire_bytes"]
