"""The comparison that decides a run's `correct`.

Each decomposition in the sample is held to the plain reference run from the same
tensor and seed.  The numbers, each the worst over the sample:

  factor_gap  max |F_port - F_ref| over every entry of every factor.  The factors
              are L-infinity normalised, so this is relative to each column's largest
              entry.
  lam_gap     max over components of |λ_port - λ_ref| / max(|λ_ref|, median |λ_ref|).
  fit_gap     max over iterations of |fit_port - fit_ref|.
  fit1_gap    |fit_port - fit_ref| of the first iteration alone.
  diff_gap    max over iterations of |diff_port - diff_ref| / diff_ref.
  qerr_gap    |quant_error_port - quant_error_ref| / quant_error_ref (lossy engines).

The step numbers hold the program's last step to the reference's recomputation of
that step from the program's own final state (`reference.last_step_ref`):

  step_factor_gap  max |F_port - F_step| over the last mode's factor.
  step_lam_gap     as lam_gap, against the step's λ.
  step_fit_gap     |fit_port - fit_step| of the last iteration.
  step_diff_gap    |diff_port - diff_step| / diff_step of the last iteration.
  step_qerr_gap    as qerr_gap, against the step's quantisation error.

A cell's file names the numbers it compares and the limit of each (`limits`); the
others are printed as readings only.  A decomposition whose outputs are not finite
reads infinity.
"""
from __future__ import annotations

import math

import torch

__all__ = ["judge", "readings", "step_readings"]


def _finite_or_inf(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def _worst(values) -> float:
    """The largest of `values`, or infinity where any is not finite."""
    values = [float(v) for v in values]
    return max(values) if all(math.isfinite(v) for v in values) else math.inf


def readings(port, ref) -> dict[str, float]:
    """The numbers of one decomposition: `port` is the program's result (factors,
    lam, fit_history, diff_history, quant_error), `ref` the reference's."""
    dev = ref.lam.device
    factor_gap = max(float((p.to(dev, torch.float64) - r).abs().max())
                     for p, r in zip(port.factors, ref.factors, strict=True))
    lam_gap = _lam_gap(port.lam, ref.lam)
    n = len(ref.fit_history)
    if len(port.fit_history) != n or len(port.diff_history) != n:
        return dict.fromkeys(("factor_gap", "lam_gap", "fit_gap", "fit1_gap", "diff_gap"),
                             math.inf)
    out = {
        "factor_gap": factor_gap,
        "lam_gap": lam_gap,
        "fit_gap": _worst(abs(a - b) for a, b in zip(port.fit_history, ref.fit_history)),
        "fit1_gap": abs(port.fit_history[0] - ref.fit_history[0]) if n else math.inf,
        "diff_gap": _worst(abs(a - b) / abs(b)
                           for a, b in zip(port.diff_history, ref.diff_history)),
    }
    if ref.quant_error is not None:
        qe = port.quant_error if port.quant_error is not None else math.nan
        out["qerr_gap"] = abs(qe - ref.quant_error) / ref.quant_error
    return {k: _finite_or_inf(v) for k, v in out.items()}


def _lam_gap(lam, ref_lam) -> float:
    scale = torch.maximum(ref_lam.abs(), ref_lam.abs().median())
    return float(((lam.to(ref_lam.device, torch.float64) - ref_lam).abs() / scale).max())


def step_readings(port, step) -> dict[str, float]:
    """The step numbers of one decomposition: `port` the program's result, `step`
    the reference's recomputation of its last step."""
    if not port.fit_history or not port.diff_history:
        return dict.fromkeys(("step_factor_gap", "step_lam_gap", "step_fit_gap",
                              "step_diff_gap"), math.inf)
    dev = step.lam.device
    out = {
        "step_factor_gap": float((port.factors[-1].to(dev, torch.float64)
                                  - step.factor).abs().max()),
        "step_lam_gap": _lam_gap(port.lam, step.lam),
        "step_fit_gap": abs(port.fit_history[-1] - step.fit),
        "step_diff_gap": abs(port.diff_history[-1] - step.diff) / abs(step.diff),
    }
    if step.quant_error is not None:
        qe = port.quant_error if port.quant_error is not None else math.nan
        out["step_qerr_gap"] = abs(qe - step.quant_error) / step.quant_error
    return {k: _finite_or_inf(v) for k, v in out.items()}


def judge(samples: list[dict[str, float]], limits: dict[str, float]):
    """(correct, worst readings): correct when the sample is not empty and every
    limited number's worst reading is at or under its limit."""
    worst = {}
    for r in samples:
        for k, v in r.items():
            worst[k] = max(worst.get(k, -math.inf), v)
    correct = bool(samples) and all(worst.get(k, math.inf) <= lim
                                    for k, lim in limits.items())
    return correct, worst
