"""`TunePolicy` — the autotuner's knobs as one frozen value object (the
port's copy of `repro.engine.tunepolicy`, with the same fields, defaults,
validation and errors).

`build_engine`, `autotune_engine` and `cp_als` accept
``tune: TunePolicy | None``; the nine loose tuning keywords of the
reference survive as deprecated shims that fold into a policy through
`TunePolicy.resolve`.

The field semantics are documented once, here, and referenced everywhere:

  candidates      — candidate ids to tune over ("ref", "fixed:int7", ...);
                    None → every eligible lossless backend (plus, under an
                    accuracy budget, every lossy preset variant).
  warmup / reps   — probe repetitions: `warmup` unmeasured calls drain
                    compilation, `reps` measured calls keep the best.
  store           — persistence: True for the default
                    `~/.cache/repro/autotune.json` (env
                    `REPRO_AUTOTUNE_CACHE` overrides), a path, or a
                    `TuningStore`; None/False → no persistence.
  prior           — cold-start ranking model: "default", "calibrated", a
                    `CostModelPrior` instance, or None (calibrate when the
                    store supports it, else analytic default).
  max_probes      — cold-start probe budget: only the prior's top-k
                    candidates are timed (None: no cap).
  elide           — cross-mode probe elision; None → on exactly when the
                    resolved prior carries a deployed calibration fit.
  elide_margin    — elision decision-boundary width, a slowdown factor
                    >= 1.0 (None: the calibrated prior's suggested margin).
  accuracy_budget — max tolerated per-mode MTTKRP relative error; admits
                    lossy (fixed-point) candidates, each policed against it
                    (None: lossless-only candidate space).
"""
from __future__ import annotations

import dataclasses
import difflib
import warnings

__all__ = ["TUNE_FIELDS", "UNSET", "TunePolicy", "nearest_kwarg_error", "split_tune_kwargs"]


class _Unset:
    """Sentinel distinguishing 'keyword not passed' from an explicit None
    (None is a meaningful value for most tuning fields)."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "<unset>"


UNSET = _Unset()

#: The nine consolidated tuning keywords, in their historical signature
#: order — the deprecated-shim parameters of every entrypoint spell exactly
#: these names, and `split_tune_kwargs` peels them out of a `**kwargs` bag.
TUNE_FIELDS = (
    "candidates",
    "warmup",
    "reps",
    "store",
    "prior",
    "max_probes",
    "elide",
    "elide_margin",
    "accuracy_budget",
)


@dataclasses.dataclass(frozen=True)
class TunePolicy:
    """Frozen bundle of the autotuner's knobs (see the module docstring for
    per-field semantics).  Scalar fields are validated at construction so a
    bad policy fails where it was written, not probes-deep in the tuner."""

    candidates: tuple[str, ...] | None = None
    warmup: int = 1
    reps: int = 2
    store: object = None            # TuningStore | str | bool | None
    prior: object = None            # CostModelPrior | str | None
    max_probes: int | None = None
    elide: bool | None = None
    elide_margin: float | None = None
    accuracy_budget: float | None = None

    def __post_init__(self):
        if self.candidates is not None and not isinstance(self.candidates, tuple):
            object.__setattr__(self, "candidates", tuple(self.candidates))
        if self.warmup < 0:
            raise ValueError(f"warmup must be >= 0 (got {self.warmup})")
        if self.reps < 1:
            raise ValueError(f"reps must be >= 1 (got {self.reps})")
        if self.max_probes is not None and self.max_probes < 1:
            raise ValueError(f"max_probes must be >= 1 (got {self.max_probes})")
        if self.elide_margin is not None and self.elide_margin < 1.0:
            # A margin below 1 would exclude even the unmeasured predicted
            # leader from re-probing, silently deciding every non-anchor
            # mode with zero measurements — the opposite of a "tight margin".
            raise ValueError(
                f"elide_margin is a slowdown factor and must be >= 1.0 "
                f"(got {self.elide_margin}); 1.0 trusts the prior "
                f"completely, larger values re-probe more")
        if self.accuracy_budget is not None and not self.accuracy_budget > 0:
            raise ValueError(
                f"accuracy_budget is a max relative error and must be > 0 (got "
                f"{self.accuracy_budget}); pass None to keep the lossless-only "
                "candidate space")
        # The prior's *type* is a policy property; the cross-field
        # "calibrated needs a store" rule stays in autotune_engine, which
        # owns store resolution.
        from .costmodel import CostModelPrior
        if not (self.prior is None or isinstance(self.prior, CostModelPrior)
                or self.prior in ("default", "calibrated")):
            raise ValueError(
                f"prior must be 'default', 'calibrated', a CostModelPrior "
                f"instance or None (got {self.prior!r})")

    @classmethod
    def resolve(cls, tune: TunePolicy | None, *, caller: str,
                **legacy) -> TunePolicy:
        """Collapse (`tune=`, deprecated keywords) into one policy.

        `legacy` holds the nine shim keywords with `UNSET` marking "not
        passed".  Exactly one spelling may be used: mixing `tune=` with any
        legacy keyword raises (folding silently would hide which one wins),
        and using legacy keywords alone emits ONE `DeprecationWarning` per
        call naming everything that should fold into the policy.
        """
        unknown = sorted(set(legacy) - set(TUNE_FIELDS))
        if unknown:
            raise TypeError(
                f"{caller}: internal error — {unknown} are not tuning "
                f"keywords (expected a subset of {list(TUNE_FIELDS)})")
        passed = {k: v for k, v in legacy.items() if v is not UNSET}
        if tune is not None:
            if not isinstance(tune, TunePolicy):
                raise TypeError(
                    f"{caller}: tune= expects a TunePolicy "
                    f"(got {type(tune).__name__})")
            if passed:
                raise TypeError(
                    f"{caller}: got both tune= and the deprecated tuning "
                    f"keyword(s) {sorted(passed)}; fold the keyword(s) into "
                    "the TunePolicy and pass only tune=")
            return tune
        if not passed:
            return cls()
        warnings.warn(
            f"{caller}: the tuning keyword(s) {', '.join(sorted(passed))} "
            f"are deprecated; pass "
            f"tune=TunePolicy({', '.join(f'{k}=...' for k in sorted(passed))}) "
            "instead",
            DeprecationWarning, stacklevel=3)
        return cls(**passed)


def split_tune_kwargs(kwargs: dict) -> dict:
    """Destructively peel the nine tuning keywords out of a `**kwargs` bag
    (for entrypoints like `cp_als` that historically forwarded them
    blindly).  Returns the peeled {name: value} dict; `kwargs` keeps the
    rest."""
    return {k: kwargs.pop(k) for k in TUNE_FIELDS if k in kwargs}


def nearest_kwarg_error(caller: str, unknown, valid) -> TypeError:
    """A `TypeError` for unknown keyword(s) that names the nearest valid
    spelling — a typo'd `max_prob=` must fail at the call, with a hint, not
    surface as a confusing error deep in the builder."""
    valid = sorted(valid)
    parts = []
    for k in sorted(unknown):
        close = difflib.get_close_matches(k, valid, n=1)
        parts.append(f"{k!r} (did you mean {close[0]!r}?)" if close else repr(k))
    return TypeError(
        f"{caller}() got unexpected keyword argument(s) {', '.join(parts)}; "
        f"valid keywords: {', '.join(valid)}")
