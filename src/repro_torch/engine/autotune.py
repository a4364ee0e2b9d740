"""Empirical backend autotuner (`engine="auto"`) with persistence + prior
(the port's copy of `repro.engine.autotune`).

The software analogue of the paper's PIM-vs-CPU-vs-heterogeneous decision:
rather than predicting the winner from a model, measure it.  For each
eligible backend the tuner runs a few warm MTTKRP calls per (tensor, rank,
mode) — warm, because kernel builds and chunking are amortized across
CP-ALS iterations exactly as the paper amortizes tensor placement — and
selects the fastest backend *per mode* (the paper's finding is per-workload;
mode changes the gather/scatter balance enough to flip winners).

Measurement is only paid once per workload: pass `store=` (a `TuningStore`,
a path, or `True` for the default `~/.cache/repro/autotune.json`) and the
measured winners are persisted under a workload + device fingerprint; an
exact-or-near fingerprint hit on a later run skips the probe phase entirely.
On a cold start, `max_probes=` caps the probe budget to the top-k candidates
of the cost-model prior (costmodel.py), so a fat candidate set doesn't mean
a fat tuning bill.

The prior itself improves with use: once the store holds enough measured
timings, the tuner fits the prior's coefficients to them
(`calibrate.CalibratedPrior`) instead of trusting the analytic guesses —
and a calibrated prior unlocks *cross-mode probe elision*: every candidate
is probed on one representative mode, and the remaining modes are decided
from the prior's per-mode byte ratios anchored to that measurement,
re-probing only candidates whose prediction sits within a confidence margin
of the per-mode decision boundary.  A cold start's probe count drops from
`len(candidates) × ndim` toward `len(candidates)`, the same
measure-once-predict-the-rest structure the paper uses for tensor
placement.

Number format joins the candidate space behind an explicit accuracy budget
(paper Fig. 6): by default lossy backends are excluded — format is an
accuracy choice, and the tuner only makes speed choices for free — but
`accuracy_budget=` (max tolerated per-mode MTTKRP relative error) widens
the candidate space to (backend × fixed-point preset).  Each lossy
candidate's probe then measures error against the float COO reference on a
deterministic nnz sample alongside time; candidates over budget are
rejected before ranking, and under elision the modes never probed are
bounded by the quantization model (`qformat.cross_mode_error_bound`) —
measured on the anchor, modelled on the rest, exactly like the timings.

On the card the tuner chooses among the port's backends: `ref`, `alto`,
`csf`, `chunked`, `kernel` and `hetero` (the last two launch the
hand-written float kernel), and under a budget the `fixed:<preset>`
candidates (the fixed-point kernel).  Each probe ends in a device
synchronisation, so the host clock measures finished work including each
backend's host dispatch.  Where the reference skips any candidate that
raises, two failures propagate, because a broken kernel must never pass
for a slow candidate: a `KernelError` (a CUDA kernel that cannot be built,
loaded or launched), and on a CUDA context any exception from a candidate
whose backend launches a hand-written kernel (`kernel`, `hetero`,
`fixed:<preset>`; `BackendSpec.launches_kernel`).

Under a default process group of more than one rank (the `distributed`
backend's SPMD setting) every rank tunes the same workload and must take
the same decisions, or one rank waits in a collective that the others
never call; the reference's single controller gets this for free.  So the
ranks agree on whether the store holds the workload, and each probe's
seconds and error are the maximum over the ranks (`all_reduce` MAX: an
SPMD step runs at its slowest rank's pace) before any elision, rejection
or winner is taken from them; a candidate that fails on any rank is
skipped, or raised, on every rank.  Only rank 0 saves the store.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from ..core.cpals import init_factors
from ..core.mttkrp import mttkrp_coo
from ..core.qformat import FIXED_PRESETS, cross_mode_error_bound, value_qformat
from ..formats import registered_formats
from ..kernels import KernelError
from ..launch.mesh import world_rank, world_size
from ..obs.tracing import record_span, span, tracing_enabled
from .calibrate import CalibratedPrior, CalibrationError
from .costmodel import CostModelPrior, WorkloadStats, default_prior
from .persist import (
    StoredEntry,
    TuningStore,
    WorkloadKey,
    device_fingerprint,
    resolve_store,
)
from .registry import (
    Engine,
    EngineContext,
    build_candidate,
    candidate_lossless,
    eligible_backends,
    get_backend,
    parse_candidate,
    preset_candidates,
    registered_backends,
)
from .tunepolicy import UNSET, TunePolicy

__all__ = ["AutotuneReport", "autotune_engine"]

#: Upper bound on the deterministic nnz sample the error probes draw; the
#: sampled nonzeros' mode-coordinates select the output rows compared
#: against the float reference (small tensors are compared in full).
_ERROR_SAMPLE_NNZ = 2048


@dataclasses.dataclass
class AutotuneReport:
    """What the tuner measured (or recalled, or inferred) and decided."""

    winners: dict[int, str]               # mode -> backend name
    timings: dict[str, dict[int, float]]  # backend -> mode -> best MEASURED s
    candidates: list[str]                 # what was considered
    skipped: dict[str, str]               # backend -> reason (error/prune text)
    warmup: int
    reps: int
    source: str = "measured"              # "measured" | "persisted" | "cached"
    n_probes: int = 0                     # timing probes charged this build
                                          # (candidates that raised are not)
    prior_order: list[str] | None = None  # cost-model ranking, when consulted
    prior_name: str | None = None         # "default" | "calibrated" | "custom"
    predicted: dict[str, dict[int, float]] = dataclasses.field(
        default_factory=dict)             # anchored predictions (elision path)
    n_elided: int = 0                     # (candidate, mode) probes skipped
    store_path: str | None = None         # persistence store, when used
    accuracy_budget: float | None = None  # max per-mode MTTKRP rel error
    errors: dict[str, dict[int, float]] = dataclasses.field(
        default_factory=dict)             # candidate -> mode -> MEASURED err

    @property
    def chosen(self) -> str:
        """Single display name: the per-mode winners, deduplicated."""
        uniq = sorted(set(self.winners.values()))
        return uniq[0] if len(uniq) == 1 else "+".join(uniq)

    def probe_breakdown(self) -> dict[str, int]:
        """Where the per-mode decisions came from: probes `measured` this
        build, (candidate, mode) pairs `elided` by the anchored prior, and
        modes decided from `persisted` store entries (a warm hit pays zero
        probes, so all its modes count as persisted)."""
        return {
            "measured": self.n_probes,
            "elided": self.n_elided,
            "persisted": (len(self.winners)
                          if self.source == "persisted" else 0),
        }

    def to_dict(self) -> dict:
        """JSON-safe view of the full report: winners, per-candidate
        timings/predictions/errors, skip reasons, and the probe-provenance
        breakdown.  `chip_smoke.py` prints it per bucket; mode keys stay
        ints (json.dumps stringifies them)."""
        return {
            "chosen": self.chosen,
            "winners": {int(m): n for m, n in self.winners.items()},
            "timings": {n: {int(m): float(s) for m, s in per.items()}
                        for n, per in self.timings.items()},
            "predicted": {n: {int(m): float(s) for m, s in per.items()}
                          for n, per in self.predicted.items()},
            "errors": {n: {int(m): float(e) for m, e in per.items()}
                       for n, per in self.errors.items()},
            "candidates": list(self.candidates),
            "skipped": dict(self.skipped),
            "warmup": self.warmup,
            "reps": self.reps,
            "source": self.source,
            "probes": self.probe_breakdown(),
            "prior_order": (list(self.prior_order)
                            if self.prior_order is not None else None),
            "prior_name": self.prior_name,
            "store_path": self.store_path,
            "accuracy_budget": self.accuracy_budget,
        }

    def summary(self) -> str:
        head = f"autotune: warmup={self.warmup} reps={self.reps}"
        if self.source != "measured":
            head += f" source={self.source}"
        head += f" probes={self.n_probes}"
        if self.n_elided:
            head += f" elided={self.n_elided}"
        if self.accuracy_budget is not None:
            head += f" budget={self.accuracy_budget:.3g}"
        if self.prior_name:
            head += f" prior={self.prior_name}"
        if self.store_path:
            head += f" store={self.store_path}"
        pb = self.probe_breakdown()
        lines = [head,
                 "  probes: " + " ".join(f"{k}={pb[k]}" for k in
                                         ("measured", "elided", "persisted"))]
        for name, per_mode in sorted(self.timings.items()):
            t = " ".join(f"m{m}={s * 1e3:.2f}ms" for m, s in sorted(per_mode.items()))
            pred = self.predicted.get(name, {})
            if pred:
                t += "  " + " ".join(f"m{m}~{s * 1e3:.2f}ms"
                                     for m, s in sorted(pred.items())
                                     if m not in per_mode)
            errs = self.errors.get(name, {})
            if errs:
                t += "  err " + " ".join(f"m{m}={e:.2e}"
                                         for m, e in sorted(errs.items()))
            lines.append(f"  {name:12s} {t}")
        for name, why in sorted(self.skipped.items()):
            lines.append(f"  {name:12s} skipped: {why.splitlines()[0]}")
        lines.append("  winners: " + " ".join(
            f"m{m}={n}" for m, n in sorted(self.winners.items())))
        return "\n".join(lines)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        # repro-lint: disable=host-sync -- timing harness: the barrier IS the measurement boundary (warmup drain and every rep)
        torch.cuda.synchronize(device)


def _time_call(engine, factors, mode: int, *, warmup: int, reps: int) -> float:
    """Best host-clock seconds of `reps` calls after `warmup` calls, each
    ended by a synchronisation of the factors' device."""
    device = factors[0].device
    for _ in range(warmup):
        engine(factors, mode)
        _sync(device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        engine(factors, mode)
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def _time_backend(name: str, engine, factors, mode: int, *,
                  warmup: int, reps: int) -> float:
    """Probe seam: identical to `_time_call` but carries the backend name so
    tests can substitute deterministic per-backend timings."""
    return _time_call(engine, factors, mode, warmup=warmup, reps=reps)


def _agree(values: list[float]) -> list[float]:
    """The element-wise maximum of `values` over the ranks of the default
    process group, so that every rank decides from the same numbers
    (unchanged without a group of more than one rank)."""
    if world_size() == 1:
        return values
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    # repro-lint: disable=host-sync -- the ranks' agreement on probe times: one small upload and readback per decision, only under a process group of more than one rank
    t = torch.tensor(values, dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    # repro-lint: disable=host-sync -- the ranks' agreement on probe times: one small upload and readback per decision, only under a process group of more than one rank
    return t.tolist()


def _is_fault(exc: Exception, name: str, ctx: EngineContext) -> bool:
    """Whether a candidate's failure must raise out of the tuner rather
    than disqualify it: a `KernelError` anywhere, or any failure of a
    candidate that launches a hand-written kernel on a CUDA context (its
    wrapper's argument checks, an out-of-memory while its resident arrays
    are built, a fault in `hetero`'s split)."""
    if isinstance(exc, KernelError):
        return True
    spec = registered_backends().get(name.partition(":")[0])
    return ctx.device.type == "cuda" and spec is not None and spec.launches_kernel


def _dispatcher(built: dict, winners: dict[int, str], overall: str | None,
                ndim: int):
    """Route each MTTKRP call to its per-mode winner; untimed modes fall
    back to `overall` when one was retained, else fail loudly — a stale
    mode index must not surface as a bare KeyError from the closure."""
    def engine(factors, mode):
        name = winners.get(mode, overall)
        if name is None:
            raise ValueError(
                f"autotuned engine has no backend for mode {mode}: tuned "
                f"modes are {sorted(winners)} on a {ndim}-mode tensor "
                f"(valid modes: 0..{ndim - 1})")
        return built[name](factors, mode)
    return engine


def _engine_from_entry(
    ctx: EngineContext,
    entry: StoredEntry,
    candidates: list[str],
    modes: list[int],
    store: TuningStore,
) -> tuple[Engine, AutotuneReport] | None:
    """Rebuild the persisted winners without probing.  Returns None — fall
    back to cold measurement — when the entry doesn't cover the requested
    modes or a persisted winner no longer builds on this host; a kernel
    fault (`_is_fault`) propagates."""
    winners = dict(entry.winners)
    if not set(modes) <= set(winners):
        return None
    # Build every persisted winner — not just the requested modes' — so the
    # dispatcher can serve any mode the entry covers (a caller that probed
    # with restricted `modes` may still run CP-ALS over all of them).
    needed = sorted(set(winners.values())
                    | ({entry.overall} if entry.overall else set()))
    built: dict[str, object] = {}
    for name in needed:
        try:
            built[name] = build_candidate(name, ctx)
        except Exception as e:  # a stale winner of any other kind → re-measure
            if _is_fault(e, name, ctx):
                raise
            return None
    report = AutotuneReport(
        winners=winners, timings={n: dict(p) for n, p in entry.timings.items()},
        candidates=list(candidates), skipped={},
        warmup=entry.warmup, reps=entry.reps,
        source="persisted", n_probes=0, store_path=store.path,
        accuracy_budget=entry.budget,
        errors={n: dict(p) for n, p in entry.errors.items()})
    fn = _dispatcher(built, winners, entry.overall, ctx.st.ndim)
    return Engine(f"auto:{report.chosen}", fn, context=ctx, report=report), report


def _prior_label(prior: CalibratedPrior) -> str:
    """A guard-rejected fit keeps the analytic coefficients — the label must
    not read as if something was learned."""
    return "calibrated" if prior.used_fit else "calibrated (analytic fallback)"


def _resolve_prior(
    prior: CostModelPrior | str | None,
    store: TuningStore | None,
    device: dict[str, str] | None = None,
) -> tuple[CostModelPrior, str]:
    """Resolve a *validated* `prior=` argument (see `autotune_engine`, the
    only caller) to a concrete prior instance + label.  A calibration fits
    the store's observations of the device fingerprint `device` (None: the
    CUDA card's).

    None        — calibrate from the store when it holds enough observations
                  for this device, else the analytic default.
    "calibrated"— fit to the store; fall back to the default (with a
                  labelled reason) only when the store is too thin yet.
    "default"   — the analytic default, even with a fat store.
    instance    — used as-is.
    """
    if isinstance(prior, CostModelPrior):
        return prior, (_prior_label(prior)
                       if isinstance(prior, CalibratedPrior) else "custom")
    if prior == "default":
        return default_prior, "default"
    # None or "calibrated": calibrate when the store supports it.
    if store is not None:
        try:
            fitted = CalibratedPrior.from_store(store, device=device)
            return fitted, _prior_label(fitted)
        except CalibrationError as e:
            if prior == "calibrated":
                return default_prior, f"default (calibration unavailable: {e})"
    return default_prior, "default"


def autotune_engine(
    ctx: EngineContext,
    *,
    tune: TunePolicy | None = None,
    modes: list[int] | None = None,
    seed: int = 0,
    candidates=UNSET,
    warmup=UNSET,
    reps=UNSET,
    store=UNSET,
    prior=UNSET,
    max_probes=UNSET,
    elide=UNSET,
    elide_margin=UNSET,
    accuracy_budget=UNSET,
) -> tuple[Engine, AutotuneReport]:
    """Measure candidate backends on `ctx.st` and return a dispatching
    engine that routes each MTTKRP mode to its measured (or, under elision,
    confidently predicted) winner.

    The tuning knobs arrive as one `tune: TunePolicy` (see
    `repro_torch.engine.tunepolicy` for per-field semantics — candidates, warmup,
    reps, store, prior, max_probes, elide, elide_margin, accuracy_budget);
    the individual keywords survive as deprecated shims that fold into the
    policy with a single `DeprecationWarning` per call.  In brief:

    accuracy_budget — max tolerated per-mode MTTKRP relative error, or None
                   (default) to keep the lossless-only candidate space.
                   With a budget, the default candidates additionally
                   include every lossy (backend × preset) variant
                   ("fixed:int3" / "fixed:int7" / "fixed:int15-12"); each
                   probe of a lossy candidate also measures its error
                   against the float COO reference on a deterministic nnz
                   sample, candidates whose measured (or, for un-probed
                   modes, quantization-model-bounded) error exceeds the
                   budget are rejected before ranking, and the budget plus
                   measured errors ride along into the tuning store so a
                   warm hit only applies when its budget covers the request.
    store        — persistence (see persist.py): `True` for the default
                   `~/.cache/repro/autotune.json` (env `REPRO_AUTOTUNE_CACHE`
                   overrides), a path, or a `TuningStore`.  A fingerprint hit
                   skips probing and reuses the persisted winners; a cold
                   start writes its measurements back.
    prior        — cold-start ranking model: a `CostModelPrior` instance,
                   `"default"` (analytic coefficients), `"calibrated"` (fit
                   to the store's measurements), or None — which calibrates
                   whenever the store holds enough observations and falls
                   back to the analytic default otherwise.
    max_probes   — probe only the prior's top-k candidates on a cold start;
                   the rest are recorded in `report.skipped` as pruned.
    elide        — cross-mode probe elision: probe every candidate on one
                   representative mode, decide the remaining modes from the
                   prior's anchored per-mode predictions, and re-probe only
                   candidates within `elide_margin` of the per-mode decision
                   boundary.  Default (None): on exactly when the resolved
                   prior carries a deployed calibration fit — elision is
                   only as good as the prior's cross-mode byte ratios, and
                   a guard-rejected fit (`CalibratedPrior.used_fit=False`)
                   does not qualify.
    elide_margin — boundary width as a slowdown factor, >= 1.0 (default:
                   the calibrated prior's residual-derived
                   `suggested_margin`); 1.0 trusts the prior completely,
                   larger values re-probe more.

    A backend that raises during build or timing is recorded in
    `report.skipped` and excluded — one broken strategy must not take the
    decomposition down with it — and its probes are not charged to
    `report.n_probes`.  The exception is a kernel fault: a `KernelError`
    (a CUDA kernel that cannot be built, loaded or launched), or on a CUDA
    context any failure of a candidate that launches a hand-written kernel,
    raises out of the tuner.
    """
    policy = TunePolicy.resolve(
        tune, caller="autotune_engine",
        candidates=candidates, warmup=warmup, reps=reps, store=store,
        prior=prior, max_probes=max_probes, elide=elide,
        elide_margin=elide_margin, accuracy_budget=accuracy_budget)
    candidates = (list(policy.candidates)
                  if policy.candidates is not None else None)
    warmup, reps = policy.warmup, policy.reps
    store, prior = policy.store, policy.prior
    max_probes, elide = policy.max_probes, policy.elide
    elide_margin = policy.elide_margin
    accuracy_budget = policy.accuracy_budget
    n_devices = world_size()
    if candidates is None:
        candidates = [n for n in eligible_backends(lossless_only=True,
                                                   n_devices=n_devices)
                      if n != "auto"]
        # On a CPU context the kernel wrapper runs its plain version, the
        # `chunked` op again: probing it twice just burns the tuning
        # budget (as the reference drops interpret-mode Pallas).  On the
        # card it competes like everyone else.  Explicit `candidates`
        # overrides.
        if ctx.device.type != "cuda" and "kernel" in candidates:
            candidates.remove("kernel")
        # An accuracy budget widens the space to (backend × preset): every
        # lossy variant competes, each policed by its measured error.
        if accuracy_budget is not None:
            candidates.extend(preset_candidates(n_devices=n_devices))
    else:
        for cand in candidates:
            parse_candidate(cand)  # fail fast on a typo'd backend/preset
    if not candidates:
        raise ValueError("no eligible backends to autotune over")
    # Scalar-field validation (max_probes >= 1, elide_margin >= 1.0, the
    # prior's type, accuracy_budget > 0) lives in TunePolicy.__post_init__ —
    # one home for the rules, whether the caller passed a policy or the
    # deprecated keywords.
    if modes is None:
        modes = list(range(ctx.st.ndim))

    tuning_store = resolve_store(store)
    if prior == "calibrated" and tuning_store is None:
        raise ValueError(
            "prior='calibrated' needs a store= to fit against (pass a "
            "TuningStore/path, or a pre-built CalibratedPrior instance)")
    key = None
    if tuning_store is not None:
        # An explicitly-pinned chunk capacity is part of the fingerprint
        # (schema v5): it changes every chunked backend's padding, so
        # timings tuned under one capacity must not serve another.  The
        # default (capacity=None, partition decider chooses) matches every
        # pre-v5 entry, which could only have been tuned that way.
        key = WorkloadKey.from_tensor(ctx.st, ctx.rank, candidates,
                                      capacity=ctx.capacity, device=ctx.device)
        # The budget gates the hit: an entry tuned under a stricter-or-equal
        # budget serves (its winners' measured errors satisfy this request
        # too); anything else is invisible and the workload re-probes.
        entry = tuning_store.lookup(key, budget=accuracy_budget)
        # Every rank goes warm, or none does.
        if _agree([float(entry is None)]) == [0.0]:
            warm = _engine_from_entry(ctx, entry, candidates, modes,
                                      tuning_store)
            if warm is not None:
                record_span("autotune.decision", 0.0, source="persisted",
                            chosen=warm[1].chosen, probes=0,
                            store=tuning_store.path)
                return warm

    # -- cold start: rank by the prior, probe a budgeted subset ------------
    prior_obj, prior_name = _resolve_prior(prior, tuning_store,
                                           device_fingerprint(ctx.device))
    # When the candidate space holds a format backend (csf/alto — the
    # backend name doubles as its layout's registry name), measure the
    # tensor's layout statistics once and hand the prior a stats-carrying
    # view: the csf/alto byte models then rank on *measured* fiber counts,
    # and the same numbers are persisted with the entry (schema v4) so
    # calibration trains on what prediction used.
    fmt_stats = None
    fmt_names = set(registered_formats()) - {"coo"}
    if any(parse_candidate(c)[0] in fmt_names for c in candidates):
        fmt_stats = ctx.formats.format_stats(ctx.st)
    stats_view = (WorkloadStats(shape=ctx.st.shape, nnz=ctx.st.nnz,
                                format_stats=fmt_stats)
                  if fmt_stats is not None else ctx.st)
    order = prior_obj.order(stats_view, ctx.rank, list(candidates), modes,
                            n_devices=n_devices)
    skipped: dict[str, str] = {}
    probe_list = list(order)
    if max_probes is not None and max_probes < len(probe_list):
        probe_list = order[:max_probes]
        for name in order[max_probes:]:
            skipped[name] = (
                f"pruned by cost-model prior (max_probes={max_probes})")

    # Elision is only as trustworthy as the prior's cross-mode ratios: the
    # default policy requires a fit that was actually deployed (a guard-
    # rejected fit keeps analytic coefficients with evidence they mis-rank
    # this store — worse grounds for elision than no store at all).
    do_elide = (elide if elide is not None
                else isinstance(prior_obj, CalibratedPrior)
                and prior_obj.used_fit)
    margin = (elide_margin if elide_margin is not None
              else getattr(prior_obj, "suggested_margin", 2.0))

    factors = init_factors(ctx.st.shape, ctx.rank, seed, device=ctx.device)
    built: dict[str, object] = {}
    timings: dict[str, dict[int, float]] = {}
    predicted: dict[str, dict[int, float]] = {}
    probe_counts: dict[str, int] = {}
    errors: dict[str, dict[int, float]] = {}

    # -- accuracy probes (lossy candidates under a budget) -----------------
    # The float COO reference and the deterministic nnz sample are shared by
    # every lossy candidate: one reference MTTKRP per probed mode, compared
    # on the output rows that the sampled nonzeros touch.
    lossy = {c for c in candidates if not candidate_lossless(c)}
    value_frac = (value_qformat(ctx.st.values).frac_bits
                  if accuracy_budget is not None and lossy else 7)
    _refs: dict[int, torch.Tensor] = {}
    _rows: dict[int, torch.Tensor] = {}
    _ref_norms: dict[int, float] = {}
    _sample = None

    def _ref_rows(m: int) -> tuple[torch.Tensor, torch.Tensor]:
        nonlocal _sample
        if m not in _refs:
            coords = np.asarray(ctx.st.coords)
            if _sample is None:
                rng = np.random.default_rng(seed)
                n = min(int(ctx.st.nnz), _ERROR_SAMPLE_NNZ)
                _sample = rng.choice(int(ctx.st.nnz), size=n, replace=False)
            rows = np.unique(coords[_sample, m])
            # Output row i of mode m only receives contributions from the
            # nonzeros with coords[:, m] == i, so the reference is computed
            # EXACTLY on that subset — the sample bounds the reference cost,
            # not just the norm comparison.
            touch = np.isin(coords[:, m], rows)
            # repro-lint: disable=host-sync -- error-probe set-up: the sampled reference's inputs are uploaded once per mode per tune
            t_coords = torch.from_numpy(coords[touch]).to(ctx.device)
            # repro-lint: disable=host-sync -- error-probe set-up: the sampled reference's inputs are uploaded once per mode per tune
            t_values = torch.from_numpy(np.asarray(ctx.st.values)[touch]).to(ctx.device)
            ref = mttkrp_coo(factors, t_coords, t_values, mode=m, out_dim=ctx.st.shape[m])
            # Keep only the compared rows, and read the reference norm back
            # ONCE per mode — it is candidate-invariant, so syncing it inside
            # _measure_error would pay a device round-trip per lossy probe.
            # repro-lint: disable=host-sync -- error-probe set-up: the compared rows are uploaded once per mode per tune
            _rows[m] = torch.from_numpy(rows).to(ctx.device)
            _refs[m] = ref[_rows[m]]
            # repro-lint: disable=host-sync -- candidate-invariant norm, read back once per mode (hoisted out of the per-candidate probe loop)
            _ref_norms[m] = float(torch.linalg.vector_norm(_refs[m]))
        return _refs[m], _rows[m]

    def _measure_error(name: str, m: int) -> float:
        ref, rows = _ref_rows(m)
        out = built[name](factors, m)
        diff = torch.linalg.vector_norm(out[rows] - ref)
        # Budget gating is host control flow: one scalar readout per lossy
        # probe is the measurement itself (the reference norm is cached).
        # repro-lint: disable=host-sync -- budget gating is host control flow: one scalar readout per lossy probe is the measurement itself
        return float(diff) / (_ref_norms[m] + 1e-30)

    def _cand_preset(name: str) -> str | None:
        """Preset whose quantization model bounds this candidate's un-probed
        modes; None for a lossy backend outside the Qm.n preset family (a
        user-registered approximate backend has no model to lean on)."""
        base, preset = parse_candidate(name)
        if preset is None and get_backend(base).supports_fixed_point:
            preset = ctx.fixed_preset
        return preset if preset in FIXED_PRESETS else None

    def _cross_bound(name: str, m: int) -> float:
        """Error estimate for an un-probed (candidate, mode): the worst
        measured mode with the quantization model's headroom/cap, or
        infinity for a lossy candidate with no model and no measurement."""
        measured = errors.get(name, {})
        preset = _cand_preset(name)
        if preset is not None:
            return cross_mode_error_bound(measured, preset, ctx.st.ndim,
                                          value_frac=value_frac)
        return max(measured.values(), default=float("inf")) * 2.0

    def _probe(name: str, m: int) -> bool:
        """Measure (name, mode); False + full disqualification on failure —
        a candidate that raised anywhere contributes no timings, no winners
        and no charged probes.  Under an accuracy budget a lossy candidate's
        probe also measures its error; over budget disqualifies the same
        way (the probes already spent are likewise not charged)."""
        probe_sp = span("autotune.probe", candidate=name, mode=m,
                        provenance="measured")
        failure, t, err = None, 0.0, None
        try:
            # The span covers build + warmup + reps + the error probe;
            # `seconds` is this rank's best single measured rep.
            with probe_sp:
                if name not in built:
                    built[name] = build_candidate(name, ctx)
                t = _time_backend(name, built[name], factors, m,
                                  warmup=warmup, reps=reps)
                if accuracy_budget is not None and name in lossy:
                    err = _measure_error(name, m)
                probe_sp.set(seconds=t)
                if err is not None:
                    probe_sp.set(rel_error=err)
        except Exception as e:  # any other failure disqualifies
            failure = e
        # A fault or failure on any rank is one on every rank, and the
        # slowest rank's time and the worst error count.
        fault, failed, t, err = _agree([
            float(failure is not None and _is_fault(failure, name, ctx)),
            float(failure is not None), t, -1.0 if err is None else err])
        err = None if err < 0 else err
        if fault:
            # A broken CUDA kernel is a fault, not a slow candidate.
            if failure is not None:
                raise failure
            raise RuntimeError(f"autotune: candidate {name!r} faulted on another rank")
        if failed:
            skipped[name] = (f"{type(failure).__name__}: {failure}" if failure is not None
                             else "failed on another rank")
            for book in (built, timings, predicted, probe_counts, errors):
                book.pop(name, None)
            return False
        if err is not None:
            errors.setdefault(name, {})[m] = err
            if err > accuracy_budget:
                skipped[name] = (
                    f"over accuracy budget: mode {m} rel err {err:.3g} > "
                    f"{accuracy_budget:.3g}")
                # Keep `errors` — a real measurement of a rejected candidate
                # is still worth reporting (and persisting).
                for book in (built, timings, predicted, probe_counts):
                    book.pop(name, None)
                return False
        timings.setdefault(name, {})[m] = t
        probe_counts[name] = probe_counts.get(name, 0) + 1
        return True

    if not do_elide or len(modes) < 2 or len(probe_list) < 2:
        for name in probe_list:
            for m in modes:
                if not _probe(name, m):
                    break
    else:
        # Anchor phase: one representative mode for every candidate.  The
        # anchor's job is to absorb each backend's absolute scale (the prior
        # only has to get the *cross-mode byte ratios* right), so any mode
        # works; the first requested one keeps the choice deterministic.
        anchor = modes[0]
        alive = [n for n in probe_list if _probe(n, anchor)]
        for n in alive:
            base = prior_obj.seconds(n, stats_view, ctx.rank, anchor,
                                     n_devices=n_devices)
            predicted[n] = {
                m: timings[n][anchor]
                * prior_obj.seconds(n, stats_view, ctx.rank, m,
                                    n_devices=n_devices) / base
                for m in modes if m != anchor}
        # Per-mode elision: re-probe only candidates whose prediction sits
        # within `margin` of the current best estimate; a lone leader means
        # the mode is decided entirely by the prior.
        for m in modes[1:]:
            while True:
                alive_now = [n for n in alive if n in timings]
                if len(alive_now) <= 1:
                    break
                est = {n: timings[n].get(m, predicted[n][m])
                       for n in alive_now}
                best = min(est.values())
                need = [n for n in alive_now
                        if est[n] <= margin * best and m not in timings[n]]
                if not need:
                    break
                for n in need:
                    _probe(n, m)

    if accuracy_budget is not None:
        # Rejection happens BEFORE ranking: a lossy candidate must sit under
        # budget on every requested mode — measured where it was probed,
        # bounded by the quantization model (`cross_mode_error_bound`)
        # where elision skipped the probe.
        for name in [n for n in timings if n in lossy]:
            unmeasured = {m: _cross_bound(name, m) for m in modes
                          if m not in errors.get(name, {})}
            bad = {m: e for m, e in unmeasured.items()
                   if e > accuracy_budget}
            if bad:
                m, e = min(bad.items())
                skipped[name] = (
                    f"over accuracy budget: mode {m} error bound {e:.3g} > "
                    f"{accuracy_budget:.3g} (un-probed mode; quantization-"
                    "model bound)")
                for book in (built, timings, predicted, probe_counts):
                    book.pop(name, None)

    if not timings:
        raise RuntimeError(
            f"autotune: every candidate failed: {skipped}")

    survivors = sorted(timings)
    winners: dict[int, str] = {}
    for m in modes:
        measured = [n for n in survivors if m in timings[n]]
        # A mode nobody measured was fully elided: the prior's anchored
        # prediction decides it.
        winners[m] = (
            min(measured, key=lambda n, m=m: (timings[n][m], n))
            if measured
            else min(survivors,
                     key=lambda n, m=m: (predicted[n].get(m, float("inf")), n)))

    # Untimed modes (when `modes` was restricted) fall back to the overall
    # fastest backend over the requested modes — measured where available,
    # anchored prediction where elided; with every mode covered by `winners`
    # the fallback is unreachable and need not be retained.
    overall = None
    if set(winners) != set(range(ctx.st.ndim)):
        def total(n: str) -> float:
            return sum(
                timings[n].get(m, predicted.get(n, {}).get(m, float("inf")))
                for m in modes)
        overall = min(survivors, key=lambda n: (total(n), n))

    n_probes = sum(probe_counts.get(n, 0) for n in survivors)
    n_elided = sum(1 for n in survivors for m in modes if m not in timings[n])
    report = AutotuneReport(
        winners=winners, timings=timings, candidates=list(candidates),
        skipped=skipped, warmup=warmup, reps=reps,
        source="measured", n_probes=n_probes, prior_order=order,
        prior_name=prior_name, predicted=predicted, n_elided=n_elided,
        store_path=tuning_store.path if tuning_store is not None else None,
        accuracy_budget=accuracy_budget, errors=errors)

    if tracing_enabled():
        # Elided (candidate, mode) probes appear in the trace as
        # zero-duration probe records so the tune-decision breakdown sees
        # them; measured probes were recorded live inside `_probe`.
        for n in survivors:
            for m in modes:
                if m not in timings[n]:
                    record_span("autotune.probe", 0.0, candidate=n, mode=m,
                                provenance="elided",
                                predicted=predicted.get(n, {}).get(m))
        record_span("autotune.decision", 0.0, source="measured",
                    chosen=report.chosen, probes=n_probes, elided=n_elided)

    if tuning_store is not None and key is not None:
        # An unwritable store degrades to per-process tuning.  Every rank
        # records the entry; only rank 0 writes the file.
        with contextlib.suppress(OSError):
            tuning_store.record(key, winners, timings, overall=overall,
                                warmup=warmup, reps=reps,
                                budget=accuracy_budget, errors=errors,
                                format_stats=(fmt_stats.to_json()
                                              if fmt_stats else None),
                                save=world_rank() == 0)

    # Drop losing engines so their device-resident data (reordered copies,
    # densified blocks, ...) doesn't stay alive for the whole CP-ALS run.
    built = {n: e for n, e in built.items()
             if n == overall or n in winners.values()}

    fn = _dispatcher(built, winners, overall, ctx.st.ndim)
    handle = Engine(f"auto:{report.chosen}", fn, context=ctx, report=report)
    return handle, report
