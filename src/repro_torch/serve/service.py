"""The decomposition service loop: coalesce, bucket, dispatch (counterpart
of `repro.serve.service`).

Shape of the loop (one background worker thread):

  1. Block for the first pending request.
  2. Linger up to `max_wait_ms` collecting more, stopping early at
     `max_batch` — the classic latency/throughput knob pair: linger long
     enough to fill buckets, short enough to keep the tail bounded.
  3. Hand the collected tensors to `repro_torch.batch.cp_als_batched` with
     the service's shared `TunePolicy`, `BucketPlanCache` and device —
     members of a bucket share one batched MTTKRP and one ALS loop; a
     bucket seen before (this process or a warm `TuningStore`) dispatches
     with zero probes.
  4. Resolve each request's `Future` with its own `CPResult` (input order
     within the batch is preserved by `cp_als_batched`).

Every clock in this module is monotonic (`time.monotonic` for deadlines,
`time.perf_counter` for durations) — wall-clock time never steers batching.
The device is resolved once, in the constructor, and handed to every
dispatch: the worker thread never relies on its current CUDA device.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future

import torch

from ..batch import BucketPlanCache, cp_als_batched
from ..core.cpals import CPResult
from ..core.sptensor import SparseTensor
from ..device import resolve_device
from ..engine.tunepolicy import TunePolicy
from ..obs.metrics import MetricsRegistry
from ..obs.tracing import record_span, span, tracing_enabled

__all__ = ["DecomposeService", "ServeStats"]


@dataclasses.dataclass
class ServeStats:
    """Service-lifetime counters (a snapshot copy — see `stats()`).

    `n_probes` counts autotune timing probes charged across all dispatched
    buckets; a service running entirely against a warm store holds it at 0.
    `n_bucket_decisions` counts bucket tuning decisions by source:
    "measured" decisions probed, "persisted"/"cached" ones did not.

    `queue_wait_ms` / `dispatch_ms` / `request_ms` carry p50/p99
    milliseconds estimated from the service's latency histograms
    (`DecomposeService.metrics`) — empty dicts until the first completed
    dispatch.  Queue wait is submit→dispatch-start, dispatch is one
    batch's `cp_als_batched` call, request is submit→result.
    """

    n_requests: int = 0
    n_completed: int = 0
    n_failed: int = 0
    n_batches: int = 0
    n_buckets: int = 0
    n_probes: int = 0
    n_bucket_decisions: dict[str, int] = dataclasses.field(default_factory=dict)
    max_batch_seen: int = 0
    dispatch_seconds: float = 0.0
    queue_wait_ms: dict[str, float] = dataclasses.field(default_factory=dict)
    dispatch_ms: dict[str, float] = dataclasses.field(default_factory=dict)
    request_ms: dict[str, float] = dataclasses.field(default_factory=dict)


class DecomposeService:
    """Coalescing CP-ALS decomposition service.

    Parameters
    ----------
    rank, n_iters, norm, seed:
        Decomposition parameters, shared by every request (requests with
        different parameters belong on different services — mixing ranks in
        one batch would defeat the shared-kernel geometry).
    tune:
        A `TunePolicy` for the per-bucket autotune decision; give it a
        `store=` to share decisions across processes.
    max_batch:
        Dispatch as soon as this many requests are pending.
    max_wait_ms:
        Linger this long after the first pending request before dispatching
        a partial batch.  0 disables coalescing (every request dispatches
        alone — the sequential baseline, useful for benchmarking).

    device:
        Where every batch runs: the CUDA card when None (raising where there
        is none), or ``"cpu"``.  Results' factors live there.

    Use as a context manager, or call `close()`; `submit` returns a
    `concurrent.futures.Future` resolving to the request's `CPResult`.
    """

    def __init__(
        self,
        rank: int,
        n_iters: int = 5,
        *,
        tune: TunePolicy | None = None,
        max_batch: int = 64,
        max_wait_ms: float = 5.0,
        norm: str = "linf",
        seed: int = 0,
        device: str | torch.device | None = None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1 (got {max_batch})")
        if max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0 (got {max_wait_ms})")
        self.rank = int(rank)
        self.n_iters = int(n_iters)
        self.tune = tune if tune is not None else TunePolicy()
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.norm = norm
        self.seed = int(seed)
        self.device = resolve_device(device)
        self.plans = BucketPlanCache()
        # Per-service registry (not the process default): two services'
        # latencies must not blend.  Queue-wait and request latency observe
        # one sample per request, dispatch one per batch.
        self.metrics = MetricsRegistry()
        self._h_queue_wait = self.metrics.histogram("serve.queue_wait_seconds")
        self._h_dispatch = self.metrics.histogram("serve.dispatch_seconds")
        self._h_request = self.metrics.histogram("serve.request_seconds")
        self._queue: queue.Queue = queue.Queue()
        self._stats = ServeStats()
        self._lock = threading.Lock()
        self._closed = False
        self._worker = threading.Thread(target=self._run,
                                        name="repro-torch-decompose-service",
                                        daemon=True)
        self._worker.start()

    # -- client surface ----------------------------------------------------
    def submit(self, st: SparseTensor) -> Future:
        """Enqueue one tensor; returns a Future of its `CPResult`."""
        if not isinstance(st, SparseTensor):
            raise TypeError(
                f"submit expects a SparseTensor, got {type(st).__name__}")
        with self._lock:
            if self._closed:
                raise RuntimeError("DecomposeService is closed")
            self._stats.n_requests += 1
        fut: Future = Future()
        self._queue.put((st, fut, time.perf_counter()))
        return fut

    def decompose(self, st: SparseTensor, timeout: float | None = None) -> CPResult:
        """Synchronous convenience: `submit` and wait."""
        return self.submit(st).result(timeout=timeout)

    def stats(self) -> ServeStats:
        """A deep snapshot of the service counters: every container field is
        copied, so mutating the returned stats (or the service continuing to
        run) never aliases into a previously-taken snapshot."""
        latency = {name: self._latency_ms(h) for name, h in (
            ("queue_wait_ms", self._h_queue_wait),
            ("dispatch_ms", self._h_dispatch),
            ("request_ms", self._h_request))}
        with self._lock:
            return dataclasses.replace(
                self._stats,
                n_bucket_decisions=dict(self._stats.n_bucket_decisions),
                **latency)

    @staticmethod
    def _latency_ms(h) -> dict[str, float]:
        if h.count == 0:
            return {}
        return {"p50": h.percentile(50) * 1e3, "p99": h.percentile(99) * 1e3}

    def close(self, *, timeout: float | None = None) -> None:
        """Stop accepting requests, drain the queue, join the worker."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._queue.put(None)
        self._worker.join(timeout=timeout)

    def __enter__(self) -> DecomposeService:
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- worker ------------------------------------------------------------
    def _collect(self) -> list | None:
        """Block for the first request, then linger: return the coalesced
        [(tensor, future), ...] batch, or None on shutdown."""
        first = self._queue.get()
        if first is None:
            return None
        batch = [first]
        deadline = time.monotonic() + self.max_wait_ms / 1e3
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                # Shutdown mid-linger: dispatch what we have, then have the
                # next _collect() see the sentinel again and exit.
                self._queue.put(None)
                break
            batch.append(item)
        return batch

    def _run(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                return
            self._dispatch(batch)

    def _dispatch(self, batch: list) -> None:
        tensors = [st for st, _, _ in batch]
        futures = [fut for _, fut, _ in batch]
        submits = [ts for _, _, ts in batch]
        t0 = time.perf_counter()
        for ts in submits:
            self._h_queue_wait.observe(t0 - ts)
        batch_sp = span("serve.batch", n_requests=len(batch))
        try:
            # The batch span runs on the worker thread, so the bucket tune
            # decision and the batched iterations nest under it.
            with batch_sp:
                results = cp_als_batched(
                    tensors, self.rank, self.n_iters, tune=self.tune,
                    norm=self.norm, seed=self.seed, plans=self.plans,
                    device=self.device)
        except Exception as e:
            # A batch-level failure (mixed dtypes, every kernel broken)
            # fails every request in the batch with the same cause.
            dt = time.perf_counter() - t0
            self._h_dispatch.observe(dt)
            with self._lock:
                self._stats.n_batches += 1
                self._stats.n_failed += len(futures)
                self._stats.max_batch_seen = max(self._stats.max_batch_seen,
                                                 len(futures))
                self._stats.dispatch_seconds += dt
            for fut in futures:
                fut.set_exception(e)
            return
        t1 = time.perf_counter()
        dt = t1 - t0
        self._h_dispatch.observe(dt)
        for ts in submits:
            self._h_request.observe(t1 - ts)
        if tracing_enabled():
            self._record_request_spans(batch_sp, submits, t0, t1)
        reports = {}
        for r in results:
            if r.tune_report is not None:
                reports[id(r.tune_report)] = r.tune_report
        with self._lock:
            s = self._stats
            s.n_batches += 1
            s.n_completed += len(futures)
            s.max_batch_seen = max(s.max_batch_seen, len(futures))
            s.dispatch_seconds += dt
            s.n_buckets += len(reports)  # one shared report per bucket
            for rep in reports.values():
                s.n_probes += rep.n_probes
                src = rep.source or "measured"
                s.n_bucket_decisions[src] = s.n_bucket_decisions.get(src, 0) + 1
        for fut, res in zip(futures, results, strict=True):
            fut.set_result(res)

    @staticmethod
    def _record_request_spans(batch_sp, submits: list[float],
                              t0: float, t1: float) -> None:
        """One `serve.request` root per request (submit→result) with its
        `serve.queue_wait` child (submit→dispatch-start); both recorded from
        already-taken perf_counter readings, and tagged with the batch
        span's id so the trace links each request to the `serve.batch`
        subtree (tune decision + iterations) that served it."""
        bid = getattr(batch_sp, "span_id", 0)
        for i, ts in enumerate(submits):
            rid = record_span("serve.request", t1 - ts, t_start=ts,
                              parent_id=0, index=i, batch_span=bid)
            record_span("serve.queue_wait", t0 - ts, t_start=ts,
                        parent_id=rid)
