"""repro_torch.obs — span tracing for the port's tune/decompose stack (the
port's own copy of `repro.obs.tracing` and `repro.obs.export`).

- `tracing` — a process-global, thread-aware span tracer, apart from the
  JAX package's, that is a true no-op when disabled (one attribute check
  on the hot path).  Enable with `enable_tracing()`, the `capture()`
  scope, or ``REPRO_TRACE=1`` / ``REPRO_TRACE_PATH=trace.jsonl`` in the
  environment.
- `export` — trace JSONL read/write (the reference's schema), Chrome
  trace-event JSON for Perfetto, and the summary tables.

The instrumented surface: `autotune_engine` emits per-candidate
`autotune.probe` spans and an `autotune.decision` span; `cp_als` emits
`cp_als.decompose`, `cp_als.iter`, `cp_als.mode` and `cp_als.fit` spans
(the iteration span carries the same measurement `CPResult.iter_times`
reports).  The metrics registry and the summarize command wait for the
serve stack.
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
    traced,
    tracing_enabled,
)

__all__ = [
    "TRACE_ENV",
    "TRACE_PATH_ENV",
    "SpanRecord",
    "Tracer",
    "capture",
    "disable_tracing",
    "enable_tracing",
    "get_tracer",
    "read_jsonl",
    "record_span",
    "span",
    "span_kind_summary",
    "summarize_text",
    "to_chrome_trace",
    "traced",
    "tracing_enabled",
    "tune_decision_summary",
    "validate_spans",
    "write_chrome_trace",
    "write_jsonl",
]
