"""Plain CP-ALS, the yardstick the port's decompositions are held to.

Paper Algorithm 1 written out in plain PyTorch from the problem's definition: a
COO spMTTKRP over every nonzero, the Hadamard product of the other modes' Gram
matrices, its pseudo-inverse (singular values below 10·R·2^-23 of the largest
cut, as the algorithm states), L-infinity normalisation, and each iteration's fit
and mean absolute difference.  It imports nothing of the port and takes nothing
the port made: the coordinates, values and seeds are the benchmark's own inputs,
and the initial factors are drawn from the decomposition's seed by the same numpy
call the algorithm specifies (`init_factors`).

`precision` picks the arithmetic:
  "float64"   every step in float64: the reference the float engines are held to;
  "tf32"      the control: every operand of a product rounded to TF32 (10 mantissa
              bits, ties to even) and sums in float32, the step below float32;
  "int15-12", "int7"
              paper Algorithm 2's fixed point for the spMTTKRP (`FIXED`), a frozen
              copy of the arithmetic, with the dense steps in float64.

`last_step_ref` recomputes only a decomposition's last step from the program's
own final state, for a cell whose trajectory depends on the rounding of every
earlier step (a fixed-point format: a float32 and a float64 dense step quantise
apart, and each iteration carries the difference on).

The nonzeros are processed in blocks of `block` so that the products fit beside
whatever else the device holds.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = ["FIXED", "RefResult", "RefStep", "cp_als_ref", "init_factors", "last_step_ref",
           "value_frac_bits"]

#: Fixed-point presets: (factor fractional bits, factor storage bits, prec_shift).
FIXED = {
    "int3": (3, 8, 0),     # Q5.3
    "int7": (7, 16, 0),    # Q9.7
    "int15-12": (15, 32, 3),  # Q17.15, three bits dropped before the sum
}
VALUE_BITS = 16            # tensor values are stored in 16-bit fixed point
DENSE_LIMIT = 1 << 22      # the mean absolute difference runs over every cell below this


@dataclasses.dataclass
class RefResult:
    factors: list[torch.Tensor]
    lam: torch.Tensor
    fit_history: list[float]
    diff_history: list[float]
    quant_error: float | None


@dataclasses.dataclass
class RefStep:
    factor: torch.Tensor       # the last mode's factor, recomputed
    lam: torch.Tensor
    fit: float                 # on the program's final factors and λ
    diff: float
    quant_error: float | None


def init_factors(shape, rank: int, seed: int) -> list[np.ndarray]:
    """Uniform [0, 1) float32 factors, mode by mode, from one numpy generator."""
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, size=(d, rank)).astype(np.float32) for d in shape]


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32's 10 mantissa bits, ties to even."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def _quantize(x: torch.Tensor, frac: int, bits: int) -> torch.Tensor:
    """Signed fixed point with `frac` fractional bits in `bits`, saturating; int64."""
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    # torch.round rounds half to even
    return torch.round(x.to(torch.float64) * (1 << frac)).clamp(lo, hi).to(torch.int64)


def value_frac_bits(values: np.ndarray) -> int:
    """The most fractional bits a 16-bit format can give while still holding
    max|value| (the value range is known only once the tensor is read)."""
    vmax = float(np.max(np.abs(values))) if values.size else 1.0
    int_bits = max(1, math.ceil(math.log2(vmax + 1e-12)) + 1) + 1
    return VALUE_BITS - min(int_bits, VALUE_BITS - 1)


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    return ((x + (1 << 31)) % (1 << 32)) - (1 << 31)


class _Tensor:
    """The COO tensor on the device, in the arithmetic of one precision."""

    def __init__(self, coords, values, shape, precision: str, block: int):
        self.coords, self.shape, self.block = coords, tuple(shape), block
        self.precision = precision
        self.values64 = values.to(torch.float64)
        if precision == "tf32":
            self.values = _tf32(values)
        elif precision in FIXED:
            self.value_frac = value_frac_bits(values.cpu().numpy())
            self.qvalues = _quantize(values, self.value_frac, VALUE_BITS)
        self.norm2 = float(torch.dot(self.values64, self.values64))

    def blocks(self):
        for s in range(0, self.coords.shape[0], self.block):
            yield slice(s, s + self.block)

    def mttkrp(self, factors, mode: int) -> torch.Tensor:
        if self.precision in FIXED:
            return self._mttkrp_fixed(factors, mode)
        rank = factors[0].shape[1]
        if self.precision == "tf32":
            rows = [_tf32(f) for f in factors]
            out = torch.zeros((self.shape[mode], rank), dtype=torch.float32,
                              device=self.coords.device)
        else:
            rows = [f.to(torch.float64) for f in factors]
            out = torch.zeros((self.shape[mode], rank), dtype=torch.float64,
                              device=self.coords.device)
        vals = self.values if self.precision == "tf32" else self.values64
        for b in self.blocks():
            c = self.coords[b]
            part = vals[b, None].to(out.dtype)
            for m, f in enumerate(rows):
                if m != mode:
                    part = part * f.index_select(0, c[:, m])
                    if self.precision == "tf32":
                        part = _tf32(part)
            out.index_add_(0, c[:, mode], part)
        return out

    def _mttkrp_fixed(self, factors, mode: int) -> torch.Tensor:
        """Algorithm 2: int32 products of the quantized rows, shifted back after
        each, times the 16-bit value, shifted by its fraction and `prec_shift`,
        summed in int32 (wrapping), then scaled back to float."""
        frac, bits, prec_shift = FIXED[self.precision]
        q = [_quantize(f, frac, bits) for f in factors]
        inputs = [m for m in range(len(q)) if m != mode]
        out = torch.zeros((self.shape[mode], factors[0].shape[1]), dtype=torch.int64,
                          device=self.coords.device)
        for b in self.blocks():
            c = self.coords[b]
            part = q[inputs[0]].index_select(0, c[:, inputs[0]])
            for m in inputs[1:]:
                part = _wrap_int32(part * q[m].index_select(0, c[:, m])) >> frac
            part = _wrap_int32(part * self.qvalues[b, None]) >> (self.value_frac + prec_shift)
            out.index_add_(0, c[:, mode], part)
        return _wrap_int32(out).to(torch.float64) / (1 << (frac - prec_shift))

    def reconstruct(self, factors, lam, b) -> torch.Tensor:
        c = self.coords[b]
        prod = lam[None, :]
        for m, f in enumerate(factors):
            prod = prod * f.index_select(0, c[:, m])
        return prod.sum(dim=1)

    def fit_and_diff(self, factors, lam) -> tuple[float, float]:
        """1 - ||X - X̂|| / ||X|| by ||X - X̂||² = ||X||² - 2<X, X̂> + ||X̂||², and
        the mean |X - X̂| over every cell (small tensors) or over the nonzeros."""
        had = lam[:, None] * lam[None, :]
        for f in factors:
            had = had * (f.T @ f)
        inner, abs_sum = 0.0, 0.0
        for b in self.blocks():
            approx = self.reconstruct(factors, lam, b)
            inner += float(torch.dot(approx, self.values64[b]))
            abs_sum += float((self.values64[b] - approx).abs().sum())
        resid = max(self.norm2 - 2.0 * inner + float(had.sum()), 0.0)
        fit = 1.0 - math.sqrt(resid) / max(math.sqrt(self.norm2), 1e-30)
        if math.prod(self.shape) <= DENSE_LIMIT and len(self.shape) <= 7:
            return fit, self._dense_diff(factors, lam)
        return fit, abs_sum / self.coords.shape[0]

    def _dense_diff(self, factors, lam) -> float:
        letters = "abcdefg"[: len(self.shape)]
        approx = torch.einsum(f"r,{','.join(f'{c}r' for c in letters)}->{letters}",
                              lam, *factors)
        dense = torch.zeros(self.shape, dtype=torch.float64, device=lam.device)
        dense.index_put_(tuple(self.coords[:, m].long() for m in range(len(self.shape))),
                         self.values64, accumulate=True)
        return float((dense - approx).abs().mean())


def _pinv(v: torch.Tensor) -> torch.Tensor:
    rank = v.shape[-1]
    return torch.linalg.pinv(v.to(torch.float64), rtol=10 * rank * 2.0**-23)


def cp_als_ref(coords: torch.Tensor, values: torch.Tensor, shape, rank: int, n_iters: int,
               seed: int, *, precision: str = "float64", block: int = 1 << 22) -> RefResult:
    """CP-ALS of the COO tensor (`coords` (nnz, N) int32 and `values` (nnz,)
    float32 on the device that computes) from `init_factors(shape, rank, seed)`."""
    if precision not in ("float64", "tf32", *FIXED):
        raise ValueError(f"unknown precision {precision!r}")
    x = _Tensor(coords, values, shape, precision, block)
    device = coords.device
    n = len(shape)
    factors = [torch.from_numpy(f).to(device, torch.float64)
               for f in init_factors(shape, rank, seed)]
    lam = torch.ones(rank, dtype=torch.float64, device=device)
    fits, diffs, m = [], [], None
    for _ in range(n_iters):
        for mode in range(n):
            m = x.mttkrp(factors, mode)
            v = torch.ones((rank, rank), dtype=torch.float64, device=device)
            for k in range(n):
                if k != mode:
                    f = _tf32(factors[k]) if precision == "tf32" else factors[k]
                    v = v * (f.T @ f).to(torch.float64)
            p = _pinv(v)
            if precision == "tf32":
                a = (_tf32(m) @ _tf32(p)).to(torch.float64)
            else:
                a = m.to(torch.float64) @ p
            lam = a.abs().amax(dim=0)
            lam = torch.where(lam == 0, 1.0, lam)
            factors[mode] = a / lam
        fit, diff = x.fit_and_diff(factors, lam)
        fits.append(fit)
        diffs.append(diff)
    quant_error = None
    if precision in FIXED and m is not None:
        exact = _Tensor(coords, values, shape, "float64", block).mttkrp(factors, n - 1)
        quant_error = float(torch.linalg.vector_norm(m - exact)
                            / (torch.linalg.vector_norm(exact) + 1e-30))
    return RefResult(factors, lam, fits, diffs, quant_error)


def last_step_ref(coords: torch.Tensor, values: torch.Tensor, shape, factors, lam, *,
                  precision: str = "float64", block: int = 1 << 22) -> RefStep:
    """The last step of a decomposition, recomputed from the program's own final
    state: the last mode's update from the other modes' final factors (which it
    reads and nothing after it changes), and the fit, difference and quantisation
    error of the final factors and `lam`.  One step, so no rounding of earlier
    steps is carried into it."""
    if precision not in ("float64", "tf32", *FIXED):
        raise ValueError(f"unknown precision {precision!r}")
    device = coords.device
    x = _Tensor(coords, values, shape, precision, block)
    factors = [f.to(device, torch.float64) for f in factors]
    lam = lam.to(device, torch.float64)
    mode, rank = len(shape) - 1, factors[0].shape[1]
    m = x.mttkrp(factors, mode).to(torch.float64)
    v = torch.ones((rank, rank), dtype=torch.float64, device=device)
    for k in range(mode):
        v = v * (factors[k].T @ factors[k])
    a = m @ _pinv(v)
    step_lam = a.abs().amax(dim=0)
    step_lam = torch.where(step_lam == 0, 1.0, step_lam)
    fit, diff = x.fit_and_diff(factors, lam)
    quant_error = None
    if precision in FIXED:
        exact = _Tensor(coords, values, shape, "float64", block).mttkrp(factors, mode)
        quant_error = float(torch.linalg.vector_norm(m - exact)
                            / (torch.linalg.vector_norm(exact) + 1e-30))
    return RefStep(a / step_lam, step_lam, fit, diff, quant_error)
