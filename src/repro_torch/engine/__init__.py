"""MTTKRP engine subsystem: backend registry + plan cache.

    from repro_torch.engine import build_engine
    eng = build_engine(st, "kernel", rank=10)                # on the CUDA card
    eng = build_engine(st, "fixed:int15-12", rank=10)        # paper Alg. 2, pinned preset
    eng = build_engine(st, "alto", rank=10)                  # ALTO layout (the paper's CPU role)
    eng = build_engine(st, "hetero", rank=10, dense_fraction=0.5)  # paper §IV-D split
    eng = build_engine(st, "chunked", rank=10, device="cpu")
    out = eng(factors, mode)                                 # (I_mode, R) f32

Only explicit backend names and preset ids are ported so far.  The autotuner (`"auto"`,
`tune=` and the tuning keywords of the reference) is ROADMAP Queue 1 item 8
and raises `NotImplementedError` until it lands.
"""
from __future__ import annotations

import dataclasses
import difflib
from collections.abc import Callable

from . import backends as _backends  # imported for side effect: registers the built-ins
from .plan import CacheStats, PlanCache, default_plan_cache
from .registry import (
    BackendSpec,
    Engine,
    EngineContext,
    backend_table,
    build_candidate,
    candidate_lossless,
    get_backend,
    parse_candidate,
    register_backend,
    registered_backends,
)

__all__ = [
    "BackendSpec",
    "CacheStats",
    "Engine",
    "EngineContext",
    "PlanCache",
    "TUNING_KEYWORDS",
    "backend_table",
    "build_candidate",
    "build_engine",
    "candidate_lossless",
    "default_plan_cache",
    "get_backend",
    "parse_candidate",
    "register_backend",
    "registered_backends",
    "validate_engine_kwargs",
]

#: The reference's autotuning keywords (its `TunePolicy` fields, `tune` and
#: `autotune_modes`): accepted by name so that they fail with a pointer to
#: the roadmap instead of as a typo.
TUNING_KEYWORDS = (
    "tune", "autotune_modes", "candidates", "warmup", "reps", "store", "prior",
    "max_probes", "elide", "elide_margin", "accuracy_budget",
)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP Queue 1 item 8, "
        "the tuning stack); pass an explicit backend name: "
        f"{sorted(registered_backends())}")


def _nearest_kwarg_error(caller: str, unknown, valid) -> TypeError:
    valid = sorted(valid)
    parts = []
    for k in sorted(unknown):
        close = difflib.get_close_matches(k, valid, n=1)
        parts.append(f"{k!r} (did you mean {close[0]!r}?)" if close else repr(k))
    return TypeError(
        f"{caller}() got unexpected keyword argument(s) {', '.join(parts)}; "
        f"valid keywords: {', '.join(valid)}")


def validate_engine_kwargs(caller: str, options: dict, *, extra: tuple[str, ...] = ()) -> None:
    """Raise `NotImplementedError` for the reference's tuning keywords and a
    `TypeError` naming the nearest valid spelling for unknown ones.  Valid
    keywords are the `EngineContext` fields: mem_bytes, chunk_shape,
    capacity, fixed_preset, lockfree_mode, device, dense_fraction, plans,
    formats."""
    tuning = sorted(set(options) & set(TUNING_KEYWORDS))
    if tuning:
        raise _not_ported(f"{caller}: the tuning keyword(s) {tuning}")
    valid = {f.name for f in dataclasses.fields(EngineContext)} - {"st", "rank"} | set(extra)
    unknown = set(options) - valid
    if unknown:
        raise _nearest_kwarg_error(caller, unknown, valid)


def build_engine(st, method: str | Callable = "auto", rank: int = 10, **options) -> Engine:
    """Build an MTTKRP engine through the registry.

    method  — a registered backend name (`ref`, `alto`, `csf`, `chunked`,
              `kernel`, `fixed`, `hetero`), a preset id (``"fixed:int7"`` pins that Qm.n
              preset) or a callable ``f(factors, mode)``, wrapped
              unchanged.  `"auto"` raises `NotImplementedError` (ROADMAP
              Queue 1 item 8).
    options — EngineContext fields: mem_bytes, chunk_shape, capacity,
              fixed_preset (the `fixed` backend's preset, default
              "int7"; a different one than the method pins raises),
              lockfree_mode (emulate the paper's lock-free lost updates in
              `chunked` and `fixed`), device (None → the CUDA card, raising
              where there is none), dense_fraction (`hetero`: a static
              densest-first fraction of dense tasks in place of the cost
              model's split), plans (a PlanCache; default the process-wide
              one), formats (a FormatCache for `csf`/`alto`; default the
              process-wide one).
    """
    validate_engine_kwargs("build_engine", options)
    if callable(method):
        return Engine(getattr(method, "__name__", "custom"), method)
    if method == "auto":
        raise _not_ported("engine='auto' (the autotuner)")
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
