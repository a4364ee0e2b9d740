"""Counters, gauges, and log-bucketed histograms with consistent snapshots
(the port's own copy of `repro.obs.metrics`, pure Python).

The serving path needs aggregate latencies — request p50/p99, queue
depth, probe counts — without keeping every sample.  `Histogram`
therefore bins observations into **fixed log-spaced buckets** (8 per
decade from 1µs to 1000s by default): percentiles come from the
cumulative bucket counts with log-linear interpolation inside the landing
bucket, so memory is O(buckets) forever and the worst-case percentile
error is one bucket width (a factor of `10^(1/8) ≈ 1.33`;
`tests/test_torch_metrics.py` holds it).

Thread-safety: every mutation takes the owning registry's lock, and
`MetricsRegistry.snapshot()` takes the same lock — a snapshot is a
consistent cut across all metrics, never a torn read of a histogram whose
counts moved under it.  Metrics are host-side Python: they observe host
clock readings, never device tensors (reading one would synchronise).
"""
from __future__ import annotations

import math
import threading

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_histogram_bounds",
]


def default_histogram_bounds(lo: float = 1e-6, hi: float = 1e3,
                             per_decade: int = 8) -> tuple[float, ...]:
    """Log-spaced bucket upper bounds covering [lo, hi] at `per_decade`
    buckets per decade — the fixed geometry every latency histogram shares
    so snapshots from different services aggregate bucket-for-bucket."""
    if not (lo > 0 and hi > lo and per_decade >= 1):
        raise ValueError(f"bad bounds spec: lo={lo} hi={hi} "
                         f"per_decade={per_decade}")
    n = int(round((math.log10(hi) - math.log10(lo)) * per_decade))
    return tuple(10 ** (math.log10(lo) + i / per_decade)
                 for i in range(n + 1))


class Counter:
    """Monotonic counter.  Mutate via `.inc(n)`; read `.value`."""

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def _snapshot(self) -> dict:
        return {"type": "counter", "value": self._value}


class Gauge:
    """Last-write-wins instantaneous value (queue depth, live buckets)."""

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self._value = 0.0

    def set_value(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, delta: float) -> None:
        with self._lock:
            self._value += delta

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _snapshot(self) -> dict:
        return {"type": "gauge", "value": self._value}


class Histogram:
    """Fixed log-spaced-bucket histogram: p50/p95/p99 without samples.

    `bounds[i]` is bucket i's inclusive upper edge; a final overflow bucket
    catches anything past `bounds[-1]`, and observations at or below
    `bounds[0]` land in bucket 0 (sub-resolution values cannot be told
    apart anyway).
    """

    def __init__(self, name: str, lock: threading.Lock,
                 bounds: tuple[float, ...] | None = None):
        self.name = name
        self._lock = lock
        self.bounds = tuple(bounds) if bounds is not None \
            else default_histogram_bounds()
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError("histogram bounds must be strictly increasing")
        self._counts = [0] * (len(self.bounds) + 1)
        self._n = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def _bucket(self, v: float) -> int:
        # Binary search over the fixed edges; the common latency range is
        # small enough that this stays cheap on the dispatch path.
        lo, hi = 0, len(self.bounds)
        while lo < hi:
            mid = (lo + hi) // 2
            if v <= self.bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        return lo

    def observe(self, v: float) -> None:
        v = float(v)
        idx = self._bucket(v)
        with self._lock:
            self._counts[idx] += 1
            self._n += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    @property
    def total(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, q: float) -> float:
        """Estimate the q-th percentile (q in [0, 100]) from the bucket
        cumulative counts, log-interpolating inside the landing bucket.
        Returns 0.0 on an empty histogram."""
        if not 0 <= q <= 100:
            raise ValueError(f"percentile q must be in [0, 100], got {q}")
        with self._lock:
            return self._percentile_locked(q)

    def _percentile_locked(self, q: float) -> float:
        if self._n == 0:
            return 0.0
        target = q / 100.0 * self._n
        cum = 0
        for i, c in enumerate(self._counts):
            cum += c
            if cum >= target and c > 0:
                frac = 1.0 - (cum - target) / c
                lo = self.bounds[i - 1] if i >= 1 else None
                hi = self.bounds[i] if i < len(self.bounds) else None
                if hi is None:           # overflow bucket: no upper edge
                    return self._max
                if lo is None or lo <= 0:  # first bucket
                    lo = min(self._min, hi) if self._min < math.inf else hi
                    lo = max(lo, hi * 1e-9)
                est = 10 ** (math.log10(lo)
                             + frac * (math.log10(hi) - math.log10(lo)))
                # Clamp to the observed range: interpolation must never
                # invent a value outside what was actually seen.
                return min(max(est, self._min), self._max)
        return self._max

    def _snapshot(self) -> dict:
        quantiles = {f"p{q:g}": self._percentile_locked(q)
                     for q in (50, 95, 99)}
        return {
            "type": "histogram",
            "count": self._n,
            "sum": self._sum,
            "min": self._min if self._n else 0.0,
            "max": self._max if self._n else 0.0,
            "mean": self._sum / self._n if self._n else 0.0,
            **quantiles,
            "bounds": list(self.bounds),
            "counts": list(self._counts),
        }


class MetricsRegistry:
    """Named get-or-create home for a subsystem's metrics.

    One lock guards every metric in the registry: increments serialize
    briefly (they are host-side bookkeeping, far off the device dispatch
    path), and `snapshot()` reads all metrics under the same lock so the
    returned dict is one consistent cut — counters and the histograms they
    describe can never disagree inside a snapshot."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    def _get_or_create(self, name: str, kind, **kwargs):
        with self._lock:
            existing = self._metrics.get(name)
        if existing is not None:
            if not isinstance(existing, kind):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(existing).__name__}, not {kind.__name__}")
            return existing
        made = kind(name, self._lock, **kwargs)
        with self._lock:
            # Lost race: keep the first registration (shares our lock).
            return self._metrics.setdefault(name, made)

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def histogram(self, name: str,
                  bounds: tuple[float, ...] | None = None) -> Histogram:
        return self._get_or_create(name, Histogram, bounds=bounds)

    def snapshot(self) -> dict[str, dict]:
        """{name: rendered metric} in name order, one consistent cut."""
        with self._lock:
            return {name: self._metrics[name]._snapshot()
                    for name in sorted(self._metrics)}


#: Process-global default registry (subsystems that want isolation — the
#: serve service — construct their own).
default_registry = MetricsRegistry()
