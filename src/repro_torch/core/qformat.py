"""Qm.n fixed-point formats (paper §IV-C), in PyTorch (counterpart of
`repro.core.qformat`, whose module imports JAX, so the port keeps its own
copy).

UPMEM DPUs have no floating-point hardware, so PRISM runs the MTTKRP inner
loop in fixed point.  On the GPU the narrow formats cut the bytes of a
memory-bound kernel.

Key paper facts encoded here:
  * factor matrices are L-infinity normalized to [-1, 1], so a QX.f factor
    value has magnitude ≤ 2^f; the product of two factor values fits int32
    for every format the paper uses.
  * Q5.3 (8-bit) is too coarse to converge; Q9.7 (16-bit) is the preferred
    mode-3 format; Q17.15 with prec_shift=3 is used for mode-4/5.
  * tensor values are quantized to 16 bits with a runtime-determined
    precision (the value range is only known after reading the tensor).

`QFormat.quantize` gives the same integers as the reference's: `torch.round`
rounds half to even like `jnp.round`, the scale is a power of two so
`x * scale` is exact in float32, and out-of-range values saturate.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = [
    "CROSS_MODE_SLACK",
    "FIXED_PRESETS",
    "Q5_3",
    "Q9_7",
    "Q17_15",
    "QFormat",
    "accumulator_safe_nnz",
    "cross_mode_error_bound",
    "preset_error_bound",
    "value_qformat",
]


@dataclasses.dataclass(frozen=True)
class QFormat:
    """Signed fixed point with `int_bits` integer bits (incl. sign) and
    `frac_bits` fractional bits; stored in `storage_bits` two's complement."""

    int_bits: int
    frac_bits: int

    @property
    def storage_bits(self) -> int:
        return self.int_bits + self.frac_bits

    @property
    def scale(self) -> int:
        return 1 << self.frac_bits

    @property
    def storage_dtype(self) -> torch.dtype:
        bits = self.storage_bits
        if bits <= 8:
            return torch.int8
        if bits <= 16:
            return torch.int16
        return torch.int32

    @property
    def np_dtype(self):
        bits = self.storage_bits
        if bits <= 8:
            return np.int8
        if bits <= 16:
            return np.int16
        return np.int32

    @property
    def max_abs_error(self) -> float:
        """Worst-case round-trip error for an in-range value: round-to-nearest
        quantization is off by at most half a step, 1/(2·scale)."""
        return 1.0 / (2 * self.scale)

    @property
    def max_int(self) -> int:
        return (1 << (self.storage_bits - 1)) - 1

    @property
    def min_int(self) -> int:
        return -(1 << (self.storage_bits - 1))

    def quantize_np(self, x: np.ndarray) -> np.ndarray:
        q = np.round(np.asarray(x, dtype=np.float64) * self.scale)
        return np.clip(q, self.min_int, self.max_int).astype(self.np_dtype)

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        """Round to the nearest step, saturating, on `x`'s device.  The clamp
        is taken in int64: float32 cannot hold the int32 bounds (2^31 - 1
        rounds up to 2^31, which a float-to-int32 cast would not saturate)."""
        q = torch.round(x.to(torch.float32) * self.scale).clamp(self.min_int, self.max_int)
        return q.to(torch.int64).clamp(self.min_int, self.max_int).to(self.storage_dtype)

    def dequantize(self, q: torch.Tensor) -> torch.Tensor:
        return q.to(torch.float32) / self.scale

    def __str__(self):
        return f"Q{self.int_bits}.{self.frac_bits}"


# The paper's formats.
Q5_3 = QFormat(5, 3)      # 8-bit — shown not to converge; kept for the study.
Q9_7 = QFormat(9, 7)      # 16-bit — preferred for mode-3 tensors.
Q17_15 = QFormat(17, 15)  # 32-bit — preferred for mode-4/5, prec_shift=3.

# (factor format, prec_shift) presets named as in the paper's Fig. 6.
FIXED_PRESETS: dict[str, tuple[QFormat, int]] = {
    "int3": (Q5_3, 0),
    "int7": (Q9_7, 0),
    "int15-12": (Q17_15, 3),
}


#: Headroom when extrapolating a measured anchor-mode MTTKRP error to the
#: un-measured modes (the reference's value; the port's tuner, ROADMAP Queue
#: 1 item 8, will read it).
CROSS_MODE_SLACK = 2.0


def preset_error_bound(preset: str, ndim: int, *, value_frac: int = 7) -> float:
    """First-order element-wise estimate of the relative error of one
    fixed-point MTTKRP (paper Alg. 2) under `FIXED_PRESETS[preset]`, for an
    `ndim`-mode tensor with L∞-normalized factors: the `ndim - 1` gathered
    factor values' half-step errors, the 16-bit value's (`value_frac`
    fractional bits), and the `prec_shift` bits the dequantization drops.
    An estimate, not a guaranteed bound on the output-norm error."""
    qf, prec_shift = FIXED_PRESETS[preset]
    factor_err = (ndim - 1) * qf.max_abs_error
    value_err = 0.5 ** (value_frac + 1)
    dequant_err = (1 << prec_shift) * qf.max_abs_error
    return factor_err + value_err + dequant_err


def accumulator_safe_nnz(preset: str, *, value_frac: int = 7) -> int:
    """Largest per-output-row nonzero count for which the int32 accumulator
    of the fixed MTTKRP (paper Alg. 2) provably cannot overflow.

    After Alg. 2's shifts each accumulated partial is an integer of
    magnitude at most `2^(frac + 15 - value_frac - prec_shift)` (factor
    product ≤ 1.0 for L∞-normalized factors, 16-bit value ≤ 2^15), and the
    accumulator holds 2^31 - 1; a row with more partials than this can wrap,
    silently."""
    qf, prec_shift = FIXED_PRESETS[preset]
    headroom = qf.frac_bits + 15 - value_frac - prec_shift
    return (2**31 - 1) >> max(headroom, 0)


def cross_mode_error_bound(measured: dict[int, float], preset: str, ndim: int, *,
                           value_frac: int = 7) -> float:
    """The relative MTTKRP error of the modes not measured, from those that
    were: the worst measured mode times `CROSS_MODE_SLACK`; with no
    measurement, the analytic estimate with the same headroom."""
    if measured:
        return CROSS_MODE_SLACK * max(measured.values())
    return CROSS_MODE_SLACK * preset_error_bound(preset, ndim, value_frac=value_frac)


def value_qformat(values: np.ndarray, storage_bits: int = 16) -> QFormat:
    """Runtime-determined precision for tensor nonzero values (paper §IV-C:
    'the range of nonzero values cannot be determined before reading the
    tensor').  Chooses the Q format with the most fractional bits that still
    represents max|value| in `storage_bits`."""
    vmax = float(np.max(np.abs(values))) if values.size else 1.0
    int_bits = max(1, math.ceil(math.log2(vmax + 1e-12)) + 1) + 1  # +sign
    int_bits = min(int_bits, storage_bits - 1)
    return QFormat(int_bits, storage_bits - int_bits)
