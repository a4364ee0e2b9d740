"""Store-calibrated cost model: fit the prior's coefficients to measured
timings (the port's copy of `repro.engine.calibrate`).

The analytic prior (costmodel.py) ranks backends with hard-coded guesses for
bandwidth, chunk padding and dispatch overheads — good enough to spend a
probe budget wisely, but every tuned workload leaves behind exactly the
ground truth those guesses stand in for: the tuning store's
``(workload, backend, mode) → seconds`` observations.  This module closes
the loop, the way the paper's placement decision closes it with an analytic
memory-bound model: cold-start ranking improves with every workload tuned.

The per-backend byte models are linear in the reparametrized coefficients

    seconds ≈ a0·fixed + a1·padded + a2·densified + a3·narrow + a4·indexed
              + dispatch[backend]

with ``a0 = 1/bandwidth``, ``a1 = chunk_padding/bandwidth``,
``a2 = chunk_padding·hetero_overhead/bandwidth``,
``a3 = 1/narrow_bandwidth`` — the per-width bandwidth term: `narrow` counts
bytes moved through quantized int paths, already scaled by each candidate's
preset storage width, so one learned throughput coefficient prices every
Qm.n width (see `costmodel.byte_terms`) — and ``a4 = 1/indexed_bandwidth``,
the throughput of format-index traffic (CSF fiber-tree levels, ALTO key
words), whose design column uses the `FormatStats` persisted with each
entry when present (schema v4) and the balls-in-bins estimate otherwise,
exactly as prediction does.  The fit is one weighted least squares solve —
rows are weighted by ``1/seconds`` to minimize *relative* error, since a
giant tensor must not drown out the small ones the ranking also serves.
Recovered coefficients are sanitized (positivity, physical clamps) and any
unfittable coefficient falls back to the analytic default; a model-selection
guard additionally keeps the analytic coefficients outright when the fit's
in-sample top-1 agreement with the measured winners is worse than the
default's (thin, collinear stores can fit seconds yet mis-rank).  The
residual report says how far to trust the result, and feeds the autotuner's
cross-mode elision margin (a well-fit prior elides aggressively, a sloppy
one re-probes near the decision boundary).

One deliberate deviation from the reference: the reference excludes its
``pallas`` observations, whose interpret-mode timings carry a
multiplicative simulation penalty that is not linear in the coefficients.
The port's ``kernel`` runs on the card, its timings are real, and they
enter the fit.  ``batched`` rows stay excluded.  The fit reads only the
observations measured on one device fingerprint: the tuned device's.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from .costmodel import (
    CostModelPrior,
    WorkloadStats,
    default_prior,
    device_byte_terms,
)
from .persist import Observation, TuningStore, device_fingerprint

__all__ = [
    "CalibratedPrior",
    "CalibrationError",
    "CalibrationReport",
    "MIN_OBSERVATIONS",
    "ranking_accuracy",
]

#: Fewest observations worth fitting: the model has 5 byte coefficients plus
#: one dispatch term per backend, so one full sweep of a 3-D tensor over 4
#: candidates (12 rows) is the floor for a non-degenerate solve (the narrow
#: column is all-zero without lossy candidates, the indexed column without
#: format-backend rows — either drops out of the fit).
MIN_OBSERVATIONS = 12

_BANDWIDTH_RANGE = (1e8, 1e13)   # B/s — below DDR3 single-channel / above HBM3e
_PADDING_RANGE = (1.0, 4.0)      # padding can only add traffic, and not 4x
_HETERO_RANGE = (1.0, 4.0)
_DISPATCH_RANGE = (0.0, 1.0)     # a per-call overhead beyond 1s is not dispatch
_DISPATCH_MIN = 1e-9             # below a nanosecond it's numerical dust


class CalibrationError(ValueError):
    """The store cannot support a fit (missing, empty, or too few rows)."""


#: Memoized fits keyed by store state (path, TTL, device, entry count,
#: newest timestamp): every cold-start autotune against a fat store resolves
#: a prior, and refitting identical data per build is pure waste.  A record()
#: or TTL change alters the token, so staleness is bounded by store writes.
_FIT_CACHE: dict[tuple, CalibratedPrior] = {}
_FIT_CACHE_MAX = 8


def _n_devices(key) -> int:
    return max(1, int(dict(key.device).get("device_count", "1")))


def _design_terms(backend: str, stats: WorkloadStats, rank: int, mode: int,
                  n_devices: int) -> tuple[float, float, float, float, float]:
    """The five byte columns of one observation's design row — the same
    decomposition `CostModelPrior.seconds` predicts with, by construction."""
    return device_byte_terms(backend, stats, rank, mode, n_devices=n_devices)


def _obs_stats(o: Observation) -> WorkloadStats:
    """Training stats for one observation: the entry's persisted
    `FormatStats` when the store recorded them (schema v4), else the
    estimate `WorkloadStats.from_key` falls back to — matching what the
    prior will use at prediction time for a store-only workload."""
    return WorkloadStats.from_key(o.key, format_stats=o.format_stats)


def _base_backend(candidate: str) -> str:
    """Preset candidate ids ("fixed:int7") share their backend's dispatch
    column and exclusion rules — the preset only changes byte widths."""
    return candidate.partition(":")[0]


def _clamp(x: float, lo: float, hi: float) -> float:
    return min(max(x, lo), hi)


def _nnls(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Nonnegative least squares by column elimination: every coefficient is
    a bandwidth reciprocal, a padding factor or a dispatch overhead — all
    physically nonnegative — and an unconstrained solve on collinear,
    dispatch-dominated data happily returns negative values whose clamped
    remains rank *worse* than the analytic defaults.  Solve, drop the most
    negative column, repeat; eliminated columns report 0 (= unfittable, the
    caller falls back to the analytic default for that coefficient)."""
    active = list(range(a.shape[1]))
    sol = np.zeros(0)
    while active:
        sol, *_ = np.linalg.lstsq(a[:, active], b, rcond=None)
        sol = np.nan_to_num(sol, nan=-np.inf)
        if (sol >= 0).all():
            break
        del active[int(np.argmin(sol))]
    theta = np.zeros(a.shape[1])
    if active:
        theta[active] = np.clip(sol, 0.0, None)
    return theta


@dataclasses.dataclass(frozen=True)
class CalibrationReport:
    """What the fit consumed and how well the result explains it."""

    n_observations: int
    n_workloads: int
    backends: tuple[str, ...]
    fitted: dict[str, float]              # coefficient name -> fitted value
    fallbacks: tuple[str, ...]            # coefficients kept at their default
    mean_rel_err: float                   # mean |pred - t| / t over the fit set
    max_rel_err: float
    rmse_s: float
    per_backend_rel_err: dict[str, float]

    def summary(self) -> str:
        head = (f"calibration: {self.n_observations} observations / "
                f"{self.n_workloads} workloads / {len(self.backends)} backends; "
                f"rel err mean={self.mean_rel_err:.1%} max={self.max_rel_err:.1%}")
        coeffs = " ".join(f"{k}={v:.3g}" for k, v in sorted(self.fitted.items()))
        lines = [head, f"  fitted: {coeffs}"]
        if self.fallbacks:
            lines.append("  defaults kept: " + " ".join(self.fallbacks))
        return "\n".join(lines)


@dataclasses.dataclass
class CalibratedPrior(CostModelPrior):
    """A `CostModelPrior` whose coefficients were fitted to a `TuningStore`.

    Build with `CalibratedPrior.from_store(store)`; ranking/`seconds` behave
    exactly like the analytic prior, only with measured coefficients.  The
    attached `calibration` report carries the residuals, and
    `suggested_margin` converts them into the autotuner's cross-mode elision
    margin: candidates predicted within this factor of the per-mode winner
    are re-probed, the rest are elided.
    """

    calibration: CalibrationReport | None = None
    #: False when the model-selection guard rejected the fit and the
    #: analytic default coefficients were kept: the prior then carries real
    #: residuals for *this* store but nothing learned — consumers (the
    #: autotuner's elide=None policy, report labels) must not treat it as a
    #: trusted fit.
    used_fit: bool = True

    @property
    def suggested_margin(self) -> float:
        """1 + k·(mean relative residual), clamped to [1.15, 2.0]."""
        if self.calibration is None:
            return 2.0
        return 1.0 + _clamp(3.0 * self.calibration.mean_rel_err, 0.15, 1.0)

    @classmethod
    def from_store(
        cls,
        store: TuningStore | None,
        *,
        device: dict[str, str] | None = None,
        min_observations: int = MIN_OBSERVATIONS,
        use_cache: bool = True,
    ) -> CalibratedPrior:
        """Fit the coefficients to `store`'s observations for one device
        fingerprint (default: the CUDA card's, `device_fingerprint()`).  Raises `CalibrationError` when
        the store is missing or holds fewer than `min_observations` usable
        rows — callers fall back to the analytic default prior.

        Successful fits are memoized on the store's state (entry count +
        newest timestamp), so repeated cold starts against an unchanged
        store pay the solve once; the returned instance is shared — treat
        it as read-only.
        """
        if store is None:
            raise CalibrationError("no tuning store to calibrate against")
        if device is None:
            device = device_fingerprint()
        token = None
        if use_cache:
            entries = store.entries()
            token = (store.path, store.ttl_s, min_observations,
                     tuple(sorted(device.items())), len(entries),
                     max((e.created for e in entries), default=0.0))
            cached = _FIT_CACHE.get(token)
            if cached is not None:
                return cached
        # "batched" rows are bucket-level timings (a whole batch per probe)
        # — not single-tensor training data for these per-tensor design
        # terms.  The kernel's rows are real card timings and stay in.
        obs = [o for o in store.observations(device=device)
               if _base_backend(o.backend) != "batched"
               and o.seconds > 0.0 and math.isfinite(o.seconds)]
        if len(obs) < min_observations:
            raise CalibrationError(
                f"{len(obs)} usable observations in {store.path!r} "
                f"(need >= {min_observations})")

        # Dispatch columns are per *backend*, not per candidate id: every
        # preset variant shares its family's launch path, so their rows
        # pool into one dispatch coefficient instead of fragmenting.
        backends = tuple(sorted({_base_backend(o.backend) for o in obs}))
        col_of = {b: 5 + i for i, b in enumerate(backends)}
        a = np.zeros((len(obs), 5 + len(backends)))
        t = np.empty(len(obs))
        for i, o in enumerate(obs):
            a[i, :5] = _design_terms(o.backend, _obs_stats(o), o.key.rank,
                                     o.mode, _n_devices(o.key))
            a[i, col_of[_base_backend(o.backend)]] = 1.0
            t[i] = o.seconds
        # Weight by 1/t: minimize relative residuals, not absolute seconds.
        w = 1.0 / t
        theta = _nnls(a * w[:, None], t * w)

        prior = cls._sanitize(theta, backends,
                              has_narrow=bool(a[:, 3].any()),
                              has_indexed=bool(a[:, 4].any()))
        prior.calibration = prior._residual_report(obs, backends)
        # Model-selection guard: a fit on thin, collinear data (a handful of
        # same-scale dispatch-dominated workloads) can explain the *seconds*
        # tolerably yet rank the *winners* worse than the analytic guesses —
        # the one job the prior has.  Deploy the fit only if its in-sample
        # top-1 agreement is no worse than the default's; otherwise keep the
        # analytic coefficients, with the residual report (and therefore a
        # conservative elision margin) still measured against this store.
        fit_hits, total = ranking_accuracy(store, prior, device=device)
        default_hits, _ = ranking_accuracy(store, default_prior, device=device)
        if total and fit_hits < default_hits:
            d = default_prior
            prior = cls(bandwidth=d.bandwidth, chunk_padding=d.chunk_padding,
                        hetero_overhead=d.hetero_overhead,
                        narrow_bandwidth=d.narrow_bandwidth,
                        indexed_bandwidth=d.indexed_bandwidth,
                        dispatch_s=d.dispatch_s,
                        distributed_dispatch_s=d.distributed_dispatch_s,
                        used_fit=False)
            prior._fallbacks = (
                f"all coefficients: fit ranked worse than analytic defaults "
                f"in-sample ({fit_hits}/{total} vs {default_hits}/{total})",)
            prior.calibration = prior._residual_report(obs, backends)
        if token is not None:
            while len(_FIT_CACHE) >= _FIT_CACHE_MAX:
                _FIT_CACHE.pop(next(iter(_FIT_CACHE)))
            _FIT_CACHE[token] = prior
        return prior

    @classmethod
    def _sanitize(cls, theta: np.ndarray, backends: tuple[str, ...], *,
                  has_narrow: bool = False,
                  has_indexed: bool = False) -> CalibratedPrior:
        """Map the raw least-squares solution back to physical coefficients,
        keeping the analytic default for anything unfittable (non-positive,
        non-finite, or outside its physical clamp)."""
        d = default_prior
        a0, a1, a2, a3, a4 = (float(x) for x in theta[:5])
        fallbacks: list[str] = []

        if math.isfinite(a0) and a0 > 0:
            bandwidth = _clamp(1.0 / a0, *_BANDWIDTH_RANGE)
        else:
            bandwidth = d.bandwidth
            fallbacks.append("bandwidth")
        if math.isfinite(a1) and a1 > 0 and a0 > 0:
            chunk_padding = _clamp(a1 / a0, *_PADDING_RANGE)
        else:
            chunk_padding = d.chunk_padding
            fallbacks.append("chunk_padding")
        if math.isfinite(a2) and a2 > 0 and a1 > 0:
            hetero_overhead = _clamp(a2 / a1, *_HETERO_RANGE)
        else:
            hetero_overhead = d.hetero_overhead
            fallbacks.append("hetero_overhead")
        if has_narrow and math.isfinite(a3) and a3 > 0:
            narrow_bandwidth = _clamp(1.0 / a3, *_BANDWIDTH_RANGE)
        else:
            # Without lossy observations the narrow column is all-zero and
            # never enters the solve: price narrow bytes at the *fitted*
            # stream bandwidth (the best-informed guess for this host), and
            # only report a fallback when there was data and the fit failed.
            narrow_bandwidth = bandwidth
            if has_narrow:
                fallbacks.append("narrow_bandwidth")
        if has_indexed and math.isfinite(a4) and a4 > 0:
            indexed_bandwidth = _clamp(1.0 / a4, *_BANDWIDTH_RANGE)
        else:
            # Same policy as `narrow`: no format-backend observations means
            # the indexed column never entered the solve.
            indexed_bandwidth = bandwidth
            if has_indexed:
                fallbacks.append("indexed_bandwidth")

        dispatch: dict[str, float] = {}
        for i, b in enumerate(backends):
            v = float(theta[5 + i])
            if math.isfinite(v) and v > _DISPATCH_MIN:
                dispatch[b] = _clamp(v, *_DISPATCH_RANGE)
            else:
                # 0 means the NNLS eliminated the column (see `_nnls`):
                # charging a backend no dispatch at all would under-rank it
                # on every out-of-sample workload — keep the analytic value.
                fallbacks.append(f"dispatch[{b}]")

        prior = cls(bandwidth=bandwidth, chunk_padding=chunk_padding,
                    hetero_overhead=hetero_overhead,
                    narrow_bandwidth=narrow_bandwidth,
                    indexed_bandwidth=indexed_bandwidth,
                    dispatch_s=d.dispatch_s,
                    distributed_dispatch_s=d.distributed_dispatch_s,
                    dispatch_overheads=dispatch)
        prior._fallbacks = tuple(fallbacks)  # consumed by _residual_report
        return prior

    def _residual_report(self, obs: list[Observation],
                         backends: tuple[str, ...]) -> CalibrationReport:
        rel_errs: list[float] = []
        sq_errs: list[float] = []
        per_backend: dict[str, list[float]] = {}
        for o in obs:
            pred = self.seconds(o.backend, _obs_stats(o), o.key.rank, o.mode,
                                n_devices=_n_devices(o.key))
            rel = abs(pred - o.seconds) / o.seconds
            rel_errs.append(rel)
            sq_errs.append((pred - o.seconds) ** 2)
            # Keyed by candidate id, so "fixed:int3" and "fixed:int7" report
            # separately even though they share one dispatch coefficient.
            per_backend.setdefault(o.backend, []).append(rel)
        fitted = {
            "bandwidth": self.bandwidth,
            "chunk_padding": self.chunk_padding,
            "hetero_overhead": self.hetero_overhead,
            "narrow_bandwidth": self.narrow_bandwidth,
            "indexed_bandwidth": self.indexed_bandwidth,
        }
        fitted.update({f"dispatch[{b}]": v
                       for b, v in sorted(self.dispatch_overheads.items())})
        return CalibrationReport(
            n_observations=len(obs),
            n_workloads=len({o.key for o in obs}),
            backends=backends,
            fitted=fitted,
            fallbacks=getattr(self, "_fallbacks", ()),
            mean_rel_err=float(np.mean(rel_errs)),
            max_rel_err=float(np.max(rel_errs)),
            rmse_s=float(np.sqrt(np.mean(sq_errs))),
            per_backend_rel_err={b: float(np.mean(v))
                                 for b, v in per_backend.items() if v},
        )


def ranking_accuracy(store: TuningStore, prior: CostModelPrior, *,
                     device: dict[str, str] | None = None,
                     ) -> tuple[int, int]:
    """How often `prior`'s top-1 agrees with the store's measured winner.

    For every persisted (workload, mode) with at least two measured
    backends, compare the prior's cheapest prediction *among those measured
    backends* against the measured argmin.  Returns ``(hits, decisions)``.
    `device` is a device fingerprint (default: the CUDA card's).
    """
    if device is None:
        device = device_fingerprint()
    want = tuple(sorted(device.items()))
    hits = total = 0
    for e in store.entries():
        if store.expired(e) or e.key.device != want:
            continue
        stats = WorkloadStats.from_key(e.key, format_stats=e.format_stats)
        nd = _n_devices(e.key)
        for mode in range(e.key.ndim):
            measured = {b: per[mode] for b, per in e.timings.items()
                        if mode in per}
            if len(measured) < 2:
                continue
            winner = min(measured, key=lambda b, t=measured: (t[b], b))
            predicted = min(
                measured,
                key=lambda b, s=stats, r=e.key.rank, m=mode, nd=nd: (
                    prior.seconds(b, s, r, m, n_devices=nd), b))
            hits += predicted == winner
            total += 1
    return hits, total
