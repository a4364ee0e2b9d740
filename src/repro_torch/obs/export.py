"""Trace export: JSONL on disk, Chrome trace-event JSON for Perfetto, and
the latency tables of a trace summary (the port's copy of `repro.obs.export`;
the same schema, so a trace of either package reads in the other).

JSONL schema (version 1) — line-delimited JSON, one meta line first::

    {"type": "meta", "version": 1, "epoch_wall": 1754..., "pid": 1234}
    {"type": "span", "name": "cp_als.iter", "t_start": 0.0123,
     "duration": 0.0045, "span_id": 7, "parent_id": 3,
     "thread_id": 140.., "thread_name": "MainThread", "attrs": {...}}

`t_start`/`duration` are seconds; `t_start` is an offset from the tracer's
monotonic epoch, and `epoch_wall` anchors it in absolute time.  The Chrome
trace-event export emits complete ("ph": "X") events in microseconds plus
thread-name metadata, loadable directly in Perfetto (ui.perfetto.dev) or
`chrome://tracing`.
"""
from __future__ import annotations

import json
import os
from collections.abc import Iterable, Sequence
from pathlib import Path

from .tracing import SCHEMA_VERSION, SpanRecord, Tracer, get_tracer

__all__ = [
    "read_jsonl",
    "span_kind_summary",
    "summarize_text",
    "to_chrome_trace",
    "tune_decision_summary",
    "validate_spans",
    "write_chrome_trace",
    "write_jsonl",
]

#: Required keys of a "span" JSONL line.
SPAN_FIELDS = ("name", "t_start", "duration", "span_id", "parent_id",
               "thread_id", "thread_name", "attrs")


def write_jsonl(spans: Iterable[SpanRecord], path: str | os.PathLike, *,
                tracer: Tracer | None = None) -> str:
    """Write `spans` (+ one meta header line) as JSONL; returns the path."""
    tracer = tracer if tracer is not None else get_tracer()
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with p.open("w", encoding="utf-8") as fh:
        fh.write(json.dumps({"type": "meta", "version": SCHEMA_VERSION,
                             "epoch_wall": tracer.epoch_wall,
                             "pid": os.getpid()}) + "\n")
        for rec in spans:
            fh.write(json.dumps({"type": "span", **rec.to_json()}) + "\n")
    return str(p)


def read_jsonl(path: str | os.PathLike) -> tuple[dict, list[SpanRecord]]:
    """Parse a trace JSONL file back into `(meta, spans)`.  Raises
    ValueError on a malformed line or a missing/incompatible meta header."""
    meta: dict | None = None
    spans: list[SpanRecord] = []
    with Path(path).open(encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{lineno}: not JSON: {e}") from None
            kind = d.get("type")
            if kind == "meta":
                if d.get("version") != SCHEMA_VERSION:
                    raise ValueError(
                        f"{path}:{lineno}: trace schema version "
                        f"{d.get('version')!r} != {SCHEMA_VERSION}")
                meta = d
            elif kind == "span":
                missing = [k for k in SPAN_FIELDS if k not in d]
                if missing:
                    raise ValueError(
                        f"{path}:{lineno}: span line missing {missing}")
                spans.append(SpanRecord.from_json(d))
            else:
                raise ValueError(
                    f"{path}:{lineno}: unknown line type {kind!r}")
    if meta is None:
        raise ValueError(f"{path}: no meta header line")
    return meta, spans


def validate_spans(spans: Sequence[SpanRecord]) -> None:
    """Structural checks over parsed spans: unique ids, resolvable parents,
    non-negative times.  Raises ValueError on the first violation."""
    ids = [s.span_id for s in spans]
    if len(set(ids)) != len(ids):
        raise ValueError("duplicate span ids in trace")
    known = set(ids)
    for s in spans:
        if s.duration < 0:
            raise ValueError(f"span {s.span_id} ({s.name}) has negative "
                             f"duration {s.duration}")
        if s.parent_id and s.parent_id not in known:
            raise ValueError(f"span {s.span_id} ({s.name}) references "
                             f"unknown parent {s.parent_id}")
        if not s.name:
            raise ValueError(f"span {s.span_id} has an empty name")


# ---------------------------------------------------------------------------
# Chrome trace-event export (Perfetto / chrome://tracing)
# ---------------------------------------------------------------------------

def to_chrome_trace(spans: Sequence[SpanRecord],
                    meta: dict | None = None) -> dict:
    """Chrome trace-event JSON: complete events in µs, with thread-name
    metadata so Perfetto labels the serve worker vs client threads."""
    pid = (meta or {}).get("pid", os.getpid())
    events: list[dict] = []
    for tid, tname in sorted({(s.thread_id, s.thread_name) for s in spans}):
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": tname}})
    for s in spans:
        args = {k: v for k, v in sorted(s.attrs.items())}
        args["span_id"] = s.span_id
        if s.parent_id:
            args["parent_id"] = s.parent_id
        events.append({
            "ph": "X", "name": s.name, "cat": s.name.split(".")[0],
            "pid": pid, "tid": s.thread_id,
            "ts": s.t_start * 1e6, "dur": s.duration * 1e6,
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(spans: Sequence[SpanRecord],
                       path: str | os.PathLike,
                       meta: dict | None = None) -> str:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(to_chrome_trace(spans, meta)), encoding="utf-8")
    return str(p)


# ---------------------------------------------------------------------------
# summarize: per-span-kind latency table + tune-decision breakdown
# ---------------------------------------------------------------------------

def _pct(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile over already-sorted values (the summarizer
    holds the samples, so no bucketing is needed here)."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, round(q / 100.0 * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def span_kind_summary(spans: Sequence[SpanRecord]) -> list[dict]:
    """One row per span name: count, total seconds, p50/p95/p99 ms."""
    by_name: dict[str, list[float]] = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s.duration)
    rows = []
    for name in sorted(by_name):
        vals = sorted(by_name[name])
        rows.append({
            "span": name,
            "count": len(vals),
            "total_s": sum(vals),
            "p50_ms": _pct(vals, 50) * 1e3,
            "p95_ms": _pct(vals, 95) * 1e3,
            "p99_ms": _pct(vals, 99) * 1e3,
            "max_ms": vals[-1] * 1e3,
        })
    return rows


def tune_decision_summary(spans: Sequence[SpanRecord]) -> dict:
    """The tuning story a trace tells: decisions by source
    (measured/persisted/cached), probes by provenance (measured/elided),
    and total probe seconds."""
    decisions: dict[str, int] = {}
    probes: dict[str, int] = {}
    probe_seconds = 0.0
    for s in spans:
        if s.name in ("autotune.decision", "autotune.bucket"):
            src = str(s.attrs.get("source", "measured"))
            decisions[src] = decisions.get(src, 0) + 1
        elif s.name == "autotune.probe":
            prov = str(s.attrs.get("provenance", "measured"))
            probes[prov] = probes.get(prov, 0) + 1
            if prov == "measured":
                probe_seconds += s.duration
    return {"decisions": decisions, "probes": probes,
            "probe_seconds": probe_seconds}


def _render_table(rows: list[dict], columns: list[str]) -> str:
    cells = [[str(c) for c in columns]]
    for r in rows:
        cells.append([
            f"{r.get(c):.3f}" if isinstance(r.get(c), float) else str(r.get(c, ""))
            for c in columns])
    widths = [max(len(row[i]) for row in cells) for i in range(len(columns))]
    lines = []
    for j, row in enumerate(cells):
        lines.append("  ".join(c.ljust(w) for c, w in zip(row, widths,
                                                          strict=True)))
        if j == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)


def summarize_text(meta: dict, spans: Sequence[SpanRecord]) -> str:
    """The body of a trace summary: per-span latency table and tune decisions."""
    lines = [f"trace: {len(spans)} span(s), schema v{meta.get('version')}, "
             f"pid {meta.get('pid')}"]
    rows = span_kind_summary(spans)
    if rows:
        lines.append("")
        lines.append(_render_table(
            rows, ["span", "count", "total_s", "p50_ms", "p95_ms",
                   "p99_ms", "max_ms"]))
    tune = tune_decision_summary(spans)
    if tune["decisions"] or tune["probes"]:
        lines.append("")
        lines.append("tune decisions: " + (" ".join(
            f"{k}={v}" for k, v in sorted(tune["decisions"].items()))
            or "none"))
        lines.append(
            "probes: " + (" ".join(f"{k}={v}"
                                   for k, v in sorted(tune["probes"].items()))
                          or "none")
            + f"  ({tune['probe_seconds'] * 1e3:.2f}ms measuring)")
    return "\n".join(lines)
