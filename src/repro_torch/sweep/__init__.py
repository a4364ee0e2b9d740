"""Offline design-space sweep (the port's copy of `repro.sweep`).

The PRISM paper characterizes its design space offline, once per workload
class, so tuning never shows up as a runtime cost.  This package does the
same for the port's (format × execution × preset × capacity × rank ×
tensor band) space: declare a grid (`config`), execute every cell through
the autotuner into a `TuningStore` (`runner` — resumable, concurrency-safe
via the store's advisory save lock), then ship the filled store so a
production cold start on the card warm-hits instead of probing, and report
the Pareto front over (wall time, accuracy, index bytes) with roofline
peak-fraction context (`report`; `hw=H100_SXM5` on the card).
"""
from __future__ import annotations

from .config import (
    SweepCell,
    SweepConfig,
    SweepConfigError,
    TensorBand,
    load_config,
)
from .report import HOST_HW, pareto_front, pareto_report, sweep_points
from .runner import CellOutcome, SweepResult, cell_key, run_sweep

__all__ = [
    "HOST_HW",
    "CellOutcome",
    "SweepCell",
    "SweepConfig",
    "SweepConfigError",
    "SweepResult",
    "TensorBand",
    "cell_key",
    "load_config",
    "pareto_front",
    "pareto_report",
    "run_sweep",
    "sweep_points",
]
