"""repro_torch.obs — tracing + metrics for the port's tune/decompose/serve
stack (the port's own copy of `repro.obs`).

- `tracing` — a process-global, thread-aware span tracer, apart from the
  JAX package's, that is a true no-op when disabled (one attribute check
  on the hot path).  Enable with `enable_tracing()`, the `capture()`
  scope, or ``REPRO_TRACE=1`` / ``REPRO_TRACE_PATH=trace.jsonl`` in the
  environment.
- `metrics` — counters/gauges/histograms; histograms use fixed log-spaced
  buckets so p50/p95/p99 come without storing samples, and registry
  snapshots are consistent cuts.
- `export` — trace JSONL read/write (the reference's schema), Chrome
  trace-event JSON for Perfetto, and the tables behind
  ``python -m repro_torch.obs summarize``.

The instrumented surface: `autotune_engine` emits per-candidate
`autotune.probe` spans and an `autotune.decision` span; `cp_als` emits
`cp_als.decompose` around the whole call and inside it `cp_als.init`,
`cp_als.upload`, `cp_als.norm` (once a call, with `where`), `cp_als.iter`,
`cp_als.mode`, `cp_als.fit`, `cp_als.diff` and, for a lossy engine,
`cp_als.quant_error`
(the iteration span carries the same measurement `CPResult.iter_times`
reports), and counts the bytes it uploads and the calls in
`default_registry`'s `cp_als.upload_bytes` and `cp_als.uploads` while
tracing is on; `cp_als_batched` emits `cp_als_batched.bucket`/`.iter`
spans and `autotune_bucket` an `autotune.bucket` span; `DecomposeService`
emits `serve.batch`, `serve.request` and `serve.queue_wait` spans and
records queue-wait/dispatch/request-latency histograms in its own
`MetricsRegistry` (p50/p99 surfaced in `ServeStats`).
"""
from __future__ import annotations

from .export import (
    read_jsonl,
    span_kind_summary,
    summarize_text,
    to_chrome_trace,
    tune_decision_summary,
    validate_spans,
    write_chrome_trace,
    write_jsonl,
)
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_histogram_bounds,
    default_registry,
)
from .tracing import (
    TRACE_ENV,
    TRACE_PATH_ENV,
    SpanRecord,
    Tracer,
    capture,
    disable_tracing,
    enable_tracing,
    get_tracer,
    record_span,
    span,
    tracing_enabled,
)

__all__ = [
    "TRACE_ENV",
    "TRACE_PATH_ENV",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "SpanRecord",
    "Tracer",
    "capture",
    "default_histogram_bounds",
    "default_registry",
    "disable_tracing",
    "enable_tracing",
    "get_tracer",
    "read_jsonl",
    "record_span",
    "span",
    "span_kind_summary",
    "summarize_text",
    "to_chrome_trace",
    "tracing_enabled",
    "tune_decision_summary",
    "validate_spans",
    "write_chrome_trace",
    "write_jsonl",
]
