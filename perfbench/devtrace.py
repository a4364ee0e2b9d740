"""The device trace of a traced run, and what is read from it.

`DeviceTrace` wraps `torch.profiler` (CUDA activity only, so the host's operators
cost nothing extra) around the measured window.  Its events come back as
(name, start, end) in seconds on `time.perf_counter`'s clock, the clock the spans
of the program and of the harness use, so a device gap can be set beside what the
host was doing then.  The profiler stamps events with the wall clock; the offset
between the two clocks is read when the trace starts.
"""
from __future__ import annotations

import time
from collections import defaultdict

__all__ = ["DeviceTrace", "busy_intervals", "idle_by_host_span", "short_name", "top_ops"]


def _clock_offset_ns() -> int:
    """time.time_ns() - time.perf_counter_ns(), the tightest of a few reads."""
    best = None
    for _ in range(16):
        a = time.perf_counter_ns()
        w = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, w - (a + b) // 2)
    return best[1]


class DeviceTrace:
    def __init__(self):
        self._prof = None
        self._offset_ns = 0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._offset_ns = _clock_offset_ns()

    def stop(self) -> list[tuple[str, float, float]]:
        """Stop the profiler; every device event as (name, start, end) seconds."""
        from torch.autograd import DeviceType
        self._prof.__exit__(None, None, None)
        out = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            dur = e.duration_ns()
            if dur <= 0:
                continue
            t0 = (e.start_ns() - self._offset_ns) / 1e9
            out.append((e.name(), t0, t0 + dur / 1e9))
        self._prof = None
        return out


def short_name(name: str, limit: int = 120) -> str:
    """A kernel's name without its argument list, cut to `limit` characters."""
    name = name.replace("(anonymous namespace)::", "")
    if not name.startswith(("Memcpy", "Memset")):
        name = name.split("(", 1)[0] or name
    return name[:limit]


def busy_intervals(events, t0: float, t1: float) -> list[tuple[float, float]]:
    """The union of the events' intervals, clipped to [t0, t1], in order."""
    spans = sorted((max(a, t0), min(b, t1)) for _, a, b in events if b > t0 and a < t1)
    merged: list[list[float]] = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _gaps(busy, t0: float, t1: float):
    prev = t0
    for a, b in busy:
        if a > prev:
            yield prev, a
        prev = max(prev, b)
    if t1 > prev:
        yield prev, t1


def idle_by_host_span(busy, t0: float, t1: float, spans) -> list[tuple[str, float]]:
    """Idle device seconds in [t0, t1], each stretch of each gap given to the
    innermost host span open then (`spans`: (name, start, end), nested as one
    thread opens them); largest first."""
    # At one instant spans close before others open, and the longer of two that
    # open together is the outer one.
    bounds = sorted([(s[1], 1, -(s[2] - s[1]), i) for i, s in enumerate(spans)]
                    + [(s[2], 0, s[2] - s[1], i) for i, s in enumerate(spans)])
    total: dict[str, float] = defaultdict(float)
    stack: list[int] = []
    k = 0

    def top() -> str:
        return spans[stack[-1]][0] if stack else "outside every span"

    def step() -> None:
        nonlocal k
        _, opens, _, i = bounds[k]
        if opens:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
        k += 1

    for a, b in _gaps(busy, t0, t1):
        while k < len(bounds) and bounds[k][0] <= a:
            step()
        cur = a
        while k < len(bounds) and bounds[k][0] < b:
            total[top()] += bounds[k][0] - cur
            cur = bounds[k][0]
            step()
        total[top()] += b - cur
    return sorted(((n, v) for n, v in total.items() if v > 0), key=lambda kv: -kv[1])


def top_ops(events, t0: float, t1: float, n: int = 10) -> list[tuple[str, float]]:
    """Device seconds by short kernel name inside [t0, t1], largest first."""
    total: dict[str, float] = defaultdict(float)
    for name, a, b in events:
        if b > t0 and a < t1:
            total[short_name(name)] += min(b, t1) - max(a, t0)
    return sorted(total.items(), key=lambda kv: -kv[1])[:n]
