"""One autotune decision per bucket, amortized through the `TuningStore`
(counterpart of `repro.batch.tune`).

A bucket's tuning fingerprint (`bucket_workload_key`) is *canonical* —
built from the bucket's padded dims and the nnz band's lower edge, never
from any member's true stats — so every member of the bucket, in this
process or any later one, computes the byte-identical exact-match key.
The first member to arrive probes the batched kernels and records the
winners; the 2nd..Nth members (and a fresh process loading the store)
dispatch with ``n_probes == 0``.

Bucket candidate ids are spelled ``"batched:<kernel>"`` in the fingerprint
and the recorded timings, which keeps bucket entries disjoint from every
single-tensor workload key and lets the cost-model calibration exclude
them from its fit (`repro_torch.engine.calibrate`).  The fingerprint's
device is the engine's device, as in the port's `autotune_engine`.

`BucketPlanCache` is the in-process layer above the store — the bucket
analogue of the engine's `PlanCache`: a dispatch that already decided a
bucket this process skips even the store read.

Where the reference skips any candidate that raises, on the card a
`RuntimeError` — how torch reports a CUDA error, an out-of-memory (a
subclass) and a cuBLAS/cuSOLVER failure — raises out of `autotune_bucket`:
a bucket must never fall quietly to the other candidate because the card
failed.  Other failures (ALTO's key-width `ValueError`) and every failure
on the CPU disqualify the candidate, as in the reference.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

from ..device import resolve_device
from ..engine.autotune import AutotuneReport, _time_call
from ..engine.persist import (
    StoredEntry,
    WorkloadKey,
    device_fingerprint,
    resolve_store,
)
from ..engine.tunepolicy import TunePolicy
from ..formats import FormatStats
from ..obs.tracing import record_span, span
from .bucketing import PaddedBatch
from .kernels import batched_kernel_names, build_batched_kernel

__all__ = [
    "BucketPlanCache",
    "autotune_bucket",
    "bucket_workload_key",
]

_PREFIX = "batched:"


def _candidate_id(name: str) -> str:
    return name if name.startswith(_PREFIX) else _PREFIX + name


def _kernel_name(candidate: str) -> str:
    return candidate.removeprefix(_PREFIX)


def bucket_workload_key(dims: tuple[int, ...], band: int, rank: int, names, *,
                        device: str | torch.device | None = None) -> WorkloadKey:
    """The bucket's canonical tuning fingerprint on `device` (None: the
    CUDA card).

    Uses the band's lower edge (``2^band``) as the nominal nnz — NOT any
    member's true count — so every member of the bucket builds the same
    exact-match key regardless of where in the band it sits (bands are
    wider than the store's near-match tolerance, so member-keyed
    fingerprints would miss each other)."""
    nominal_nnz = 0 if band < 0 else 1 << band
    return WorkloadKey(
        shape=tuple(int(d) for d in dims),
        nnz=nominal_nnz,
        density=nominal_nnz / math.prod(dims),
        ndim=len(dims),
        rank=int(rank),
        candidates=tuple(sorted(_candidate_id(n) for n in names)),
        device=tuple(sorted(device_fingerprint(device).items())),
        capacity=None,
    )


@dataclasses.dataclass
class BucketPlanCache:
    """In-process (bucket key → tuning decision) cache with hit counters —
    the bucket-level analogue of `repro_torch.engine.PlanCache`.  A decided
    bucket skips the store read entirely on repeat dispatches."""

    entries: dict[WorkloadKey, StoredEntry] = dataclasses.field(
        default_factory=dict)
    hits: int = 0
    misses: int = 0

    def get(self, key: WorkloadKey) -> StoredEntry | None:
        entry = self.entries.get(key)
        if entry is None:
            self.misses += 1
        else:
            self.hits += 1
        return entry

    def put(self, key: WorkloadKey, entry: StoredEntry) -> None:
        self.entries[key] = entry

    def clear(self) -> None:
        self.entries.clear()


def _time_batched(engine, factors, mode: int, *, warmup: int, reps: int) -> float:
    """Probe seam: the best host-clock seconds of `reps` calls after
    `warmup`, each ended by a synchronisation of the factors' device (none
    on the CPU).  Tests substitute deterministic timings here."""
    return _time_call(engine, factors, mode, warmup=warmup, reps=reps)


def _is_card_fault(exc: Exception, device: torch.device) -> bool:
    """Whether a candidate's failure must raise rather than disqualify it:
    any `RuntimeError` on a CUDA device (module docstring)."""
    return device.type == "cuda" and isinstance(exc, RuntimeError)


def _resolve_names(policy: TunePolicy) -> list[str]:
    registered = batched_kernel_names()
    if policy.candidates is None:
        return registered
    names = [_kernel_name(c) for c in policy.candidates]
    unknown = sorted(set(names) - set(registered))
    if unknown:
        raise ValueError(
            f"unknown batched kernel(s) {unknown}; registered: {registered}")
    return sorted(set(names))


def autotune_bucket(
    pb: PaddedBatch,
    rank: int,
    policy: TunePolicy | None = None,
    *,
    seed: int = 0,
    plans: BucketPlanCache | None = None,
    device: str | torch.device | None = None,
):
    """Pick the batched MTTKRP kernel for one bucket on `device` (None: the
    CUDA card) — probing at most once per (bucket fingerprint, store).

    Returns ``(engine, report)`` where ``engine(factors, mode)`` maps the
    batched factors (list of ``(B, dims[m], R)`` on `device`) to
    ``(B, dims[mode], R)`` and ``report`` is an `AutotuneReport`
    (``source="measured"`` with probes charged for the bucket's first
    decision, ``"persisted"`` for a store hit, ``"cached"`` for an
    in-process `BucketPlanCache` hit — the latter two with
    ``n_probes == 0``).

    Policy fields consumed: candidates (``"batched:"`` prefixes optional),
    warmup, reps, store, max_probes.  `accuracy_budget` raises — every
    batched kernel is exact, there is nothing to budget; prior/elide are
    single-tensor cost-model machinery and are ignored here (the batched
    candidate space is two kernels, not a (backend × preset) grid).
    """
    policy = policy if policy is not None else TunePolicy()
    if policy.accuracy_budget is not None:
        raise ValueError(
            "accuracy_budget does not apply to the batched path: every "
            "batched kernel is exact (lossless); drop it from the policy")
    device = resolve_device(device)
    names = _resolve_names(policy)
    modes = list(range(len(pb.dims)))
    key = bucket_workload_key(pb.dims, pb.band, rank, names, device=device)
    store = resolve_store(policy.store)

    entry, source = None, None
    if plans is not None:
        entry = plans.get(key)
        source = "cached" if entry is not None else None
    if entry is None and store is not None:
        # Exact-match only (nnz_tol=0): the canonical fingerprint makes
        # every member's key byte-identical, and adjacent bands must never
        # serve each other.
        entry = store.lookup(key, nnz_tol=0.0, budget=None)
        source = "persisted" if entry is not None else None

    if entry is not None:
        winners = {m: entry.winners[m] for m in modes if m in entry.winners}
        if set(winners) == set(modes):
            built = {c: build_batched_kernel(_kernel_name(c), pb, device)
                     for c in sorted(set(winners.values()))}
            report = AutotuneReport(
                winners=winners,
                timings={n: dict(p) for n, p in entry.timings.items()},
                candidates=[_candidate_id(n) for n in names], skipped={},
                warmup=entry.warmup, reps=entry.reps,
                source=source, n_probes=0,
                store_path=store.path if store is not None else None)
            if plans is not None:
                plans.put(key, entry)
            record_span("autotune.bucket", 0.0, source=source,
                        chosen=report.chosen, band=pb.band,
                        dims=list(pb.dims), size=pb.size, probes=0)
            return _dispatch(built, winners), report

    # -- cold: probe every candidate on every mode -------------------------
    rng = np.random.default_rng(seed)
    draws = [np.asarray(rng.uniform(0, 1, size=(pb.size, d, rank)), dtype=np.float32)
             for d in pb.dims]
    # repro-lint: disable=host-sync -- probe set-up: the probe factors are drawn on the host from the seed and uploaded once per cold tune
    factors = [torch.from_numpy(a).to(device) for a in draws]
    probe_list = list(names)
    skipped: dict[str, str] = {}
    if policy.max_probes is not None and policy.max_probes < len(probe_list):
        for n in probe_list[policy.max_probes:]:
            skipped[_candidate_id(n)] = (
                f"pruned (max_probes={policy.max_probes})")
        probe_list = probe_list[: policy.max_probes]

    timings: dict[str, dict[int, float]] = {}
    engines: dict[str, object] = {}
    n_probes = 0
    for name in probe_list:
        cid = _candidate_id(name)
        try:
            engine = build_batched_kernel(name, pb, device)
            per_mode = {}
            for m in modes:
                probe_sp = span("autotune.probe", candidate=cid, mode=m,
                                provenance="measured")
                with probe_sp:
                    per_mode[m] = _time_batched(engine, factors, m,
                                                warmup=policy.warmup,
                                                reps=policy.reps)
                    probe_sp.set(seconds=per_mode[m])
        except Exception as e:  # blind on the CPU: one broken kernel must not kill the bucket
            if _is_card_fault(e, device):
                raise
            skipped[cid] = f"{type(e).__name__}: {e}"
            continue
        timings[cid] = per_mode
        engines[cid] = engine
        n_probes += len(per_mode)
    del factors
    if not timings:
        raise RuntimeError(f"autotune_bucket: every candidate failed: {skipped}")

    winners = {m: min(timings, key=lambda n, m=m: (timings[n][m], n))
               for m in modes}
    report = AutotuneReport(
        winners=winners, timings=timings,
        candidates=[_candidate_id(n) for n in names], skipped=skipped,
        warmup=policy.warmup, reps=policy.reps,
        source="measured", n_probes=n_probes,
        store_path=store.path if store is not None else None)

    entry = StoredEntry(key=key, winners=dict(winners),
                        timings={n: dict(p) for n, p in timings.items()},
                        warmup=policy.warmup, reps=policy.reps)
    if store is not None:
        # An unwritable store degrades to per-process tuning.  The nominal-
        # nnz FormatStats estimate rides along so the entry documents the
        # bucket's layout statistics like any other workload.
        with contextlib.suppress(OSError):
            entry = store.record(
                key, winners, timings,
                warmup=policy.warmup, reps=policy.reps,
                format_stats=FormatStats.estimate(pb.dims, key.nnz).to_json())
    if plans is not None:
        plans.put(key, entry)
    record_span("autotune.bucket", 0.0, source="measured",
                chosen=report.chosen, band=pb.band, dims=list(pb.dims),
                size=pb.size, probes=n_probes)

    # The probed engines serve the winners; the losers' arrays go with them.
    built = {c: engines[c] for c in sorted(set(winners.values()))}
    return _dispatch(built, winners), report


def _dispatch(built: dict, winners: dict[int, str]):
    """Route each batched MTTKRP call to its per-mode winning kernel."""
    def engine(factors, mode: int):
        name = winners.get(mode)
        if name is None:
            raise ValueError(
                f"bucket engine has no kernel for mode {mode}: tuned modes "
                f"are {sorted(winners)}")
        return built[name](factors, mode)
    return engine
