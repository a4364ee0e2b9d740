"""MTTKRP engine subsystem: backend registry + plan cache + empirical
autotuner with persistence and a cost-model prior (counterpart of
`repro.engine`).

    from repro_torch.engine import TunePolicy, build_engine
    eng = build_engine(st, "auto", rank=10)                  # measured selection, on the card
    eng = build_engine(st, "auto", rank=10,                  # persist winners across runs
                       tune=TunePolicy(store=True))
    eng = build_engine(st, "kernel", rank=10)                # the hand-written CUDA kernel
    eng = build_engine(st, "fixed:int15-12", rank=10)        # paper Alg. 2, pinned preset
    eng = build_engine(st, "alto", rank=10)                  # ALTO layout (the paper's CPU role)
    eng = build_engine(st, "hetero", rank=10, dense_fraction=0.5)  # paper §IV-D split
    eng = build_engine(st, "chunked", rank=10, device="cpu")
    out = eng(factors, mode)                                 # (I_mode, R) f32

`cp_als(st, rank, engine="auto", tune=TunePolicy(...))` goes through the
same path.  `TunePolicy` is the one bundle of tuning knobs (candidates,
warmup/reps, store, prior, probe budget, elision, accuracy budget); the
loose keyword arguments of the reference still work but are deprecated
shims that fold into a policy and warn.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable

from . import backends as _backends  # imported for side effect: registers the built-ins
from .autotune import AutotuneReport, autotune_engine
from .calibrate import (
    CalibratedPrior,
    CalibrationError,
    CalibrationReport,
    ranking_accuracy,
)
from .costmodel import (
    CostModelPrior,
    WorkloadStats,
    byte_terms,
    default_prior,
    prior_order,
)
from .persist import (
    DEFAULT_STORE_ENV,
    DEFAULT_TTL_ENV,
    Observation,
    StoredEntry,
    TuningStore,
    WorkloadKey,
    budget_covers,
    device_fingerprint,
    device_fingerprint_id,
)
from .plan import CacheStats, PlanCache, default_plan_cache
from .registry import (
    BackendSpec,
    Engine,
    EngineContext,
    backend_table,
    build_candidate,
    candidate_lossless,
    eligible_backends,
    get_backend,
    parse_candidate,
    preset_candidates,
    register_backend,
    registered_backends,
)
from .tunepolicy import TUNE_FIELDS, UNSET, TunePolicy, nearest_kwarg_error

__all__ = [
    "AutotuneReport",
    "BackendSpec",
    "CacheStats",
    "CalibratedPrior",
    "CalibrationError",
    "CalibrationReport",
    "CostModelPrior",
    "DEFAULT_STORE_ENV",
    "DEFAULT_TTL_ENV",
    "Engine",
    "EngineContext",
    "Observation",
    "PlanCache",
    "StoredEntry",
    "TUNE_FIELDS",
    "TunePolicy",
    "TuningStore",
    "WorkloadKey",
    "WorkloadStats",
    "autotune_engine",
    "backend_table",
    "budget_covers",
    "build_candidate",
    "build_engine",
    "byte_terms",
    "candidate_lossless",
    "default_plan_cache",
    "default_prior",
    "device_fingerprint",
    "device_fingerprint_id",
    "eligible_backends",
    "get_backend",
    "parse_candidate",
    "preset_candidates",
    "prior_order",
    "ranking_accuracy",
    "register_backend",
    "registered_backends",
    "validate_engine_kwargs",
]


def _context_option_names() -> set[str]:
    """EngineContext fields a caller may pass as options (the tensor and the
    rank, which the builder fills itself, excluded)."""
    return {f.name for f in dataclasses.fields(EngineContext)} - {"st", "rank"}


def validate_engine_kwargs(caller: str, options: dict,
                           *, extra: tuple[str, ...] = ()) -> None:
    """Reject unknown engine/tuning keywords with a nearest-match hint.

    The valid set is derived from the live signatures — `EngineContext`'s
    option fields (mem_bytes, chunk_shape, capacity, fixed_preset,
    lockfree_mode, device, dense_fraction, plans, formats) plus the
    `TunePolicy` shim keywords plus `extra` — so it can never drift from
    what the builder actually accepts."""
    valid = _context_option_names() | set(TUNE_FIELDS) | set(extra)
    unknown = set(options) - valid
    if unknown:
        raise nearest_kwarg_error(caller, unknown, valid)


def build_engine(
    st,
    method: str | Callable = "auto",
    rank: int = 10,
    *,
    tune: TunePolicy | None = None,
    autotune_modes: list[int] | None = None,
    candidates=UNSET,
    warmup=UNSET,
    reps=UNSET,
    store=UNSET,
    prior=UNSET,
    max_probes=UNSET,
    elide=UNSET,
    elide_margin=UNSET,
    accuracy_budget=UNSET,
    **options,
) -> Engine:
    """Build an MTTKRP engine through the registry.

    method       — a registered backend name (`ref`, `alto`, `csf`,
                   `chunked`, `kernel`, `fixed`, `hetero`), a preset id
                   (``"fixed:int7"`` pins that Qm.n preset), ``"auto"``
                   (empirical selection over the eligible lossless backends
                   — plus, under `tune.accuracy_budget`, every lossy preset
                   variant), or a callable ``f(factors, mode)``, wrapped
                   unchanged.
    tune         — a `TunePolicy` bundling the autotuner's knobs
                   (candidates, warmup, reps, store, prior, max_probes,
                   elide, elide_margin, accuracy_budget — see
                   `repro_torch.engine.tunepolicy`); None means the policy
                   defaults.  The individual keywords survive as deprecated
                   shims that fold into the policy (`DeprecationWarning`,
                   exactly one per call); mixing them with `tune=` raises.
    autotune_modes — the modes `"auto"` probes (default: all).
    options      — EngineContext fields: mem_bytes, chunk_shape, capacity,
                   fixed_preset (the `fixed` backend's preset, default
                   "int7"; a different one than the method pins raises),
                   lockfree_mode (emulate the paper's lock-free lost
                   updates in `chunked` and `fixed`), device (None → the
                   CUDA card, raising where there is none), dense_fraction
                   (`hetero`: a static densest-first fraction of dense
                   tasks in place of the cost model's split), plans (a
                   PlanCache; default the process-wide one), formats (a
                   FormatCache for `csf`/`alto`; default the process-wide
                   one).  Unknown keywords raise a `TypeError` naming the
                   nearest valid spelling.
    """
    policy = TunePolicy.resolve(
        tune, caller="build_engine",
        candidates=candidates, warmup=warmup, reps=reps, store=store,
        prior=prior, max_probes=max_probes, elide=elide,
        elide_margin=elide_margin, accuracy_budget=accuracy_budget)
    validate_engine_kwargs("build_engine", options)

    if callable(method):
        return Engine(getattr(method, "__name__", "custom"), method)

    if method == "auto":
        ctx = EngineContext(st=st, rank=rank, **options)
        handle, _report = autotune_engine(ctx, tune=policy, modes=autotune_modes)
        return handle
    if policy.accuracy_budget is not None:
        raise ValueError(
            "accuracy_budget only applies to engine='auto' (an explicit "
            f"backend — here {method!r} — is already a format decision); "
            "drop the budget or switch to the autotuner")

    name, preset = parse_candidate(method)
    spec = get_backend(name)
    if preset is not None:
        explicit = options.get("fixed_preset")
        if explicit is not None and explicit != preset:
            raise ValueError(
                f"conflicting presets: method {method!r} pins {preset!r} but "
                f"fixed_preset={explicit!r} was also passed; drop one of the two spellings")
        options = {**options, "fixed_preset": preset}
    ctx = EngineContext(st=st, rank=rank, **options)
    return Engine(method, spec.build(ctx), spec=spec, context=ctx)
