"""Span tracing: a process-global, thread-aware tracer with a no-op fast path
(the port's own copy of `repro.obs.tracing`, with its own global tracer).

PRISM's contribution is measurement — the paper characterizes partitioning
strategies and number formats by profiling — and this module gives the
runtime the same discipline: every interesting region (a tuning probe, a
CP-ALS iteration, a coalesced serve batch) is a *span* with wall/monotonic
times, nesting, and structured attributes, exportable to Perfetto
(`repro_torch.obs.export`).

The contract that keeps this safe to leave in the hot paths:

- **Disabled is a true no-op.**  `span(...)` with tracing off costs one
  module-global attribute check and returns a shared singleton whose
  `__enter__`/`__exit__`/`set` do nothing — no allocation, no clock read,
  no lock.  `tests/test_torch_autotune.py` checks that zero spans are emitted.
- **Thread-aware nesting.**  Each thread keeps its own open-span stack
  (`threading.local`), so the serve worker's batch span parents the batched
  ALS iterations it dispatches while client threads' request records stay
  independent.
- **Monotonic timestamps.**  Span times are `time.perf_counter()` offsets
  from the tracer's epoch; one wall-clock anchor (`epoch_wall`) taken at
  enable time lets the exporter place the trace in absolute time without
  wall clocks ever steering a measurement.

Enable programmatically (`enable_tracing()` / the `capture()` context
manager) or by environment: ``REPRO_TRACE=1`` turns the tracer on at
import, and ``REPRO_TRACE_PATH=/path/trace.jsonl`` additionally flushes
the buffer there at interpreter exit.

Never call `span`/`record_span` inside a CUDA graph capture or a
`torch.compile`d region: each emission is host-side Python.  Spans time
the host: a span around device work measures it only when the work ends
in a synchronisation inside the span (as CP-ALS iterations do).
"""
from __future__ import annotations

import atexit
import dataclasses
import os
import threading
import time

__all__ = [
    "SpanRecord",
    "Tracer",
    "TRACE_ENV",
    "TRACE_PATH_ENV",
    "capture",
    "disable_tracing",
    "enable_tracing",
    "get_tracer",
    "record_span",
    "span",
    "tracing_enabled",
]

TRACE_ENV = "REPRO_TRACE"
TRACE_PATH_ENV = "REPRO_TRACE_PATH"

#: JSONL schema version stamped into the meta line by `repro_torch.obs.export`.
SCHEMA_VERSION = 1


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One completed span.

    `t_start` and `duration` are seconds; `t_start` is an offset from the
    tracer's monotonic epoch (`Tracer.epoch_wall` anchors it to wall time
    for export).  `parent_id` is the enclosing span on the same thread (or
    an explicit parent for cross-thread records), 0 for a root.
    """

    name: str
    t_start: float
    duration: float
    span_id: int
    parent_id: int
    thread_id: int
    thread_name: str
    attrs: dict

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "t_start": self.t_start,
            "duration": self.duration,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "thread_id": self.thread_id,
            "thread_name": self.thread_name,
            "attrs": self.attrs,
        }

    @classmethod
    def from_json(cls, d: dict) -> SpanRecord:
        return cls(
            name=d["name"], t_start=float(d["t_start"]),
            duration=float(d["duration"]), span_id=int(d["span_id"]),
            parent_id=int(d["parent_id"]), thread_id=int(d["thread_id"]),
            thread_name=str(d.get("thread_name", "")),
            attrs=dict(d.get("attrs", {})))


class _NullSpan:
    """The disabled-path singleton: every operation is a no-op.  Shared,
    stateless, allocation-free — the whole point of the fast path."""

    __slots__ = ()

    def __enter__(self) -> _NullSpan:
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **attrs) -> _NullSpan:
        return self

    @property
    def duration(self) -> float | None:
        return None


_NULL_SPAN = _NullSpan()


class _Span:
    """An open span (the enabled path of `span(...)`)."""

    __slots__ = ("_attrs", "_name", "_t0", "_tracer", "duration",
                 "parent_id", "span_id")

    def __init__(self, tracer: Tracer, name: str, attrs: dict):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs
        self.duration: float | None = None

    def __enter__(self) -> _Span:
        tr = self._tracer
        stack = tr._stack()
        self.parent_id = stack[-1] if stack else 0
        self.span_id = tr._next_id()
        stack.append(self.span_id)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        t1 = time.perf_counter()
        tr = self._tracer
        stack = tr._stack()
        if stack and stack[-1] == self.span_id:
            stack.pop()
        self.duration = t1 - self._t0
        if exc_type is not None:
            self._attrs.setdefault("error", exc_type.__name__)
        th = threading.current_thread()
        tr._append(SpanRecord(
            name=self._name, t_start=self._t0 - tr.epoch_mono,
            duration=self.duration, span_id=self.span_id,
            parent_id=self.parent_id, thread_id=th.ident or 0,
            thread_name=th.name, attrs=self._attrs))

    def set(self, **attrs) -> _Span:
        """Attach attributes discovered mid-span (a probe's measured time,
        a candidate's rel-error, ...)."""
        self._attrs.update(attrs)
        return self


class Tracer:
    """Process-global span collector.  `enabled` is a plain attribute so the
    hot path pays exactly one attribute check when tracing is off."""

    def __init__(self):
        self.enabled = False
        self.epoch_mono = 0.0
        self.epoch_wall = 0.0
        self._lock = threading.Lock()
        self._spans: list[SpanRecord] = []
        self._ids = 0
        self._local = threading.local()

    # -- lifecycle ---------------------------------------------------------
    def enable(self, *, clear: bool = True) -> None:
        with self._lock:
            if clear:
                self._spans.clear()
                self._ids = 0
            self.epoch_mono = time.perf_counter()
            # One wall-clock anchor per enable: observability metadata that
            # places the monotonic span offsets in absolute time for the
            # Perfetto export; it never enters a measurement or a persisted
            # tuning artifact.
            self.epoch_wall = time.time()  # repro-lint: disable=nondeterminism -- trace epoch anchor: export metadata only, never compared or persisted into tuning state
            self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._ids = 0

    # -- recording ---------------------------------------------------------
    def span(self, name: str, **attrs):
        """Context manager timing a region.  The disabled path returns the
        shared no-op singleton — one attribute check, nothing else."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, attrs)

    def record(self, name: str, duration: float, *,
               t_start: float | None = None, parent_id: int | None = None,
               **attrs) -> int:
        """Record an already-measured region as a completed span.

        The seam for measurements whose boundaries exist anyway (CP-ALS
        `iter_times`, serve request latencies): the caller's perf_counter
        reading becomes the span, so the trace is a *view over the same
        measurement*, not a second clock.  `t_start` is an absolute
        `perf_counter()` reading (defaults to now minus `duration`);
        `parent_id` overrides the thread-local nesting for cross-thread
        records (a request span parenting its queue-wait).  Returns the
        span id (0 when disabled)."""
        if not self.enabled:
            return 0
        if t_start is None:
            t_start = time.perf_counter() - duration
        if parent_id is None:
            stack = self._stack()
            parent_id = stack[-1] if stack else 0
        sid = self._next_id()
        th = threading.current_thread()
        self._append(SpanRecord(
            name=name, t_start=t_start - self.epoch_mono, duration=duration,
            span_id=sid, parent_id=parent_id, thread_id=th.ident or 0,
            thread_name=th.name, attrs=attrs))
        return sid

    # -- reading -----------------------------------------------------------
    def spans(self) -> list[SpanRecord]:
        """Consistent snapshot of everything recorded so far."""
        with self._lock:
            return list(self._spans)

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    # -- internals ---------------------------------------------------------
    def _stack(self) -> list[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _next_id(self) -> int:
        with self._lock:
            self._ids += 1
            return self._ids

    def _append(self, rec: SpanRecord) -> None:
        with self._lock:
            self._spans.append(rec)


_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def tracing_enabled() -> bool:
    return _TRACER.enabled


def enable_tracing(*, clear: bool = True) -> Tracer:
    _TRACER.enable(clear=clear)
    return _TRACER


def disable_tracing() -> None:
    _TRACER.disable()


def span(name: str, **attrs):
    """`with span("cp_als.iter", iter=3): ...` — see the module docstring.
    One attribute check when tracing is off."""
    if not _TRACER.enabled:
        return _NULL_SPAN
    return _Span(_TRACER, name, attrs)


def record_span(name: str, duration: float, *, t_start: float | None = None,
                parent_id: int | None = None, **attrs) -> int:
    """Module-level `Tracer.record` on the global tracer (no-op when off)."""
    if not _TRACER.enabled:
        return 0
    return _TRACER.record(name, duration, t_start=t_start,
                          parent_id=parent_id, **attrs)


class capture:
    """`with capture() as spans:` — enable tracing for a scope and collect
    the spans it emitted (restoring the previous enabled state after).  The
    test/bench harness entrypoint."""

    def __enter__(self) -> list[SpanRecord]:
        self._was_enabled = _TRACER.enabled
        self._start = len(_TRACER)
        _TRACER.enable(clear=False)
        self._spans: list[SpanRecord] = []
        return self._spans

    def __exit__(self, *exc) -> None:
        self._spans.extend(_TRACER.spans()[self._start:])
        if not self._was_enabled:
            _TRACER.disable()


def _truthy(value: str | None) -> bool:
    return (value or "").strip().lower() in ("1", "true", "on", "yes")


def _flush_env_trace() -> None:
    path = os.environ.get(TRACE_PATH_ENV)
    if not path or not len(_TRACER):
        return
    from .export import write_jsonl
    write_jsonl(_TRACER.spans(), path, tracer=_TRACER)


if _truthy(os.environ.get(TRACE_ENV)) or os.environ.get(TRACE_PATH_ENV):
    _TRACER.enable()
    if os.environ.get(TRACE_PATH_ENV):
        atexit.register(_flush_env_trace)
