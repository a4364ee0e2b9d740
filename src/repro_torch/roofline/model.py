"""Three-term roofline model (counterpart of `repro.roofline.model`) for
the port's card, the NVIDIA H100 SXM5 at its 700 W power limit (NVIDIA's
data sheet): compute, HBM and interconnect time of one step, each the
step's per-device work over the per-device peak.
"""
from __future__ import annotations

import dataclasses

__all__ = ["H100_SXM5", "HWTarget", "model_flops", "roofline_terms"]


@dataclasses.dataclass(frozen=True)
class HWTarget:
    name: str
    peak_flops: float   # per device, of the arithmetic the workload runs on
    hbm_bw: float       # bytes/s per device
    link_bw: float      # bytes/s per device over the interconnect, one direction


#: MTTKRP's multiply-adds run on the CUDA cores, not the tensor cores, so
#: the peak is float32 outside the tensor cores (66.9 TFLOP/s); HBM3 at
#: 3.35 TB/s; NVLink 4 at 450 GB/s per direction for the whole GPU.
H100_SXM5 = HWTarget("nvidia-h100-80gb-hbm3", 66.9e12, 3.35e12, 450e9)


def roofline_terms(per_device_flops: float, per_device_bytes: float,
                   per_device_wire_bytes: float, hw: HWTarget = H100_SXM5) -> dict:
    compute_s = per_device_flops / hw.peak_flops
    memory_s = per_device_bytes / hw.hbm_bw
    collective_s = per_device_wire_bytes / hw.link_bw
    terms = dict(compute_s=compute_s, memory_s=memory_s,
                 collective_s=collective_s)
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    return dict(
        **terms,
        dominant=dominant,
        step_time_lower_bound_s=bound,
        roofline_fraction=(compute_s / bound) if bound > 0 else 0.0,
    )


def model_flops(n_params_active: float, tokens: float,
                kind: str = "train") -> float:
    """MODEL_FLOPS = 6·N·D for train (fwd+bwd), 2·N·D for inference."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_params_active * tokens
