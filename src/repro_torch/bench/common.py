"""Shared benchmark utilities: timing, result tables, output files
(counterpart of `benchmarks/common.py`)."""
from __future__ import annotations

import json
import os
import time

import torch

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results", "bench")


def timeit(fn, *args, device: torch.device, warmup: int = 1, iters: int = 3) -> float:
    """Seconds per call of `fn(*args)`, the mean over `iters` calls after
    `warmup` calls.

    The clock depends on `device`.  On a CUDA card: two CUDA events around
    the `iters` calls, read after one synchronisation at the end, so a row
    carries the stream's time from the first launch to the end of the last
    (device time, the host's enqueueing overlapped with it).  On the CPU:
    the host clock (`time.perf_counter`) around the calls, whose results are
    complete when they return.  `benchmarks/common.py::timeit` reads the host
    clock around `jax.block_until_ready` after every call, so its rows carry
    host wall time, dispatch included."""
    for _ in range(warmup):
        fn(*args)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def save(name: str, payload) -> str:
    """Write `payload` as `results/bench/torch_<name>.json` (the JAX
    harness's files are `<name>.json` beside it); returns the path."""
    os.makedirs(RESULTS_DIR, exist_ok=True)
    path = os.path.join(RESULTS_DIR, f"torch_{name}.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, default=float)
    return path


def table(rows: list[dict], cols: list[str]) -> str:
    widths = {c: max(len(c), *(len(str(r.get(c, ""))) for r in rows))
              for c in cols}
    head = " | ".join(c.ljust(widths[c]) for c in cols)
    sep = "-+-".join("-" * widths[c] for c in cols)
    body = "\n".join(
        " | ".join(str(r.get(c, "")).ljust(widths[c]) for c in cols)
        for r in rows)
    return f"{head}\n{sep}\n{body}"
