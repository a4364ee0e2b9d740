"""One run of one cell: set-up, the measured window, the check, the result line.

The entry the window drives is the one `repro_torch.examples.decompose_tensor`
uses: `decide_partition` with the 256 KiB plan, `build_engine` once in set-up,
then whole decompositions back to back, each `cp_als(st, rank, n_iters,
engine=eng, seed=...)` with the library's defaults.  Decomposition i's seed is
drawn from `--seed` and i (`decomposition_seed`); set-up's warm decomposition
takes an index the window never reaches.

After the window closes the peak device memory is read, the program's state is
freed, and a sample of the window's decompositions, drawn from the seed, is held
to the plain reference (`reference`, `check`).  The metrics are read by the files
under metrics/ from a `RunData`.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time
import traceback

import numpy as np
import torch

from . import check, devtrace, manifest, reference, tensorgen

__all__ = ["FORBIDDEN", "Program", "RunData", "decomposition_seed", "forbidden_modules",
           "import_program", "reference_readings", "run"]

#: Top-level modules no run may load: JAX, and the JAX package and its harness.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro", "benchmarks"})
#: The warm-up decomposition's seed index, beyond any window's count.
WARM_INDEX = 2**40


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & FORBIDDEN)


def import_program():
    """The port's entry points, imported from the checkout's `src`."""
    src = str(manifest.ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    from repro_torch.core import SparseTensor, cp_als, decide_partition
    from repro_torch.engine import build_engine
    from repro_torch.obs import tracing
    return dict(SparseTensor=SparseTensor, cp_als=cp_als, decide_partition=decide_partition,
                build_engine=build_engine, tracing=tracing)


def decomposition_seed(seed: int, index: int) -> int:
    """The seed of the window's decomposition `index`, for run seed `seed`."""
    ss = np.random.SeedSequence([int(seed) % 2**64, int(index)])
    return int(ss.generate_state(1, np.uint64)[0])


@dataclasses.dataclass
class RunData:
    """What a metric's reader reads.  Times are `time.perf_counter` seconds."""

    config: dict
    traffic: dict
    device_name: str
    setup_s: float
    engine_build_s: float
    window: tuple[float, float]
    decomps: list[tuple[float, float, int]]    # (start, end, iterations completed)
    peak_bytes: int | None
    spans: list[tuple[str, float, float]] | None = None         # traced runs
    device_events: list[tuple[str, float, float]] | None = None  # traced runs

    @property
    def iterations(self) -> int:
        return sum(d[2] for d in self.decomps)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


class _Reservoir:
    """A uniform sample of `k` items of a stream of unknown length (Algorithm R)."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.items, self.seen = k, rng, [], 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Program:
    """The system under test, set up for one cell and seed: the tensor made from
    the seed, the partition plan and the engine built once; `decompose(i)` is the
    window's call.  `engine_options` replace the traffic's (the fixed-point
    control switches the program's own int7 path on this way)."""

    def __init__(self, cell: manifest.Cell, seed: int, device, *, engine_options=None):
        p = self.api = import_program()
        self.dev = torch.device(device)
        cfg, trf = cell.config, cell.traffic
        self.seed = seed
        self.shape, self.rank = tuple(cfg["shape"]), int(cfg["rank"])
        self.n_iters = int(trf["n_iters"])
        coords, values = tensorgen.generate(
            self.shape, cfg["nnz"], distribution=cfg["distribution"], seed=seed,
            device=self.dev, zipf_a=cfg.get("zipf_a", 1.3),
            value_scale=cfg.get("value_scale", 1.0))
        # The benchmark's own copy of its inputs, for the reference.
        self.coords, self.values = coords.cpu().numpy(), values.cpu().numpy()
        del coords, values
        self.st = p["SparseTensor"](self.coords, self.values, self.shape)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.dev)
        self.plan = p["decide_partition"](self.st, self.rank, **trf["plan"])
        options = trf.get("engine_options", {}) if engine_options is None else engine_options
        t = time.perf_counter()
        self.eng = p["build_engine"](self.st, trf["engine"], self.rank, device=self.dev,
                                     chunk_shape=self.plan.chunk_shape,
                                     capacity=self.plan.capacity, **options)
        _sync(self.dev)
        self.engine_build_s = time.perf_counter() - t

    def decompose(self, index: int):
        return self.api["cp_als"](self.st, self.rank, n_iters=self.n_iters, engine=self.eng,
                                 seed=decomposition_seed(self.seed, index))

    def free(self) -> None:
        """Drop the engine and the tensor object, and with it the plan cache's
        device arrays, which it keys by that object."""
        self.eng = self.st = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def reference_readings(prog: Program, results, precision: str) -> list[dict]:
    """`check.readings` of each (index, result) against the reference run from
    the benchmark's inputs and the decomposition's seed, in `precision`, with
    `check.step_readings` against its last step recomputed from the result."""
    c = torch.from_numpy(prog.coords).to(prog.dev)
    v = torch.from_numpy(prog.values).to(prog.dev)
    out = []
    for index, res in results:
        ref = reference.cp_als_ref(c, v, prog.shape, prog.rank, prog.n_iters,
                                   decomposition_seed(prog.seed, index), precision=precision)
        step = reference.last_step_ref(c, v, prog.shape, res.factors, res.lam,
                                       precision=precision)
        out.append(check.readings(res, ref) | check.step_readings(res, step))
    _sync(prog.dev)
    return out


def run(cell: manifest.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    """Run `cell` once; returns the result line's object.  `t_start` is the
    `perf_counter` reading at process start."""
    prog = Program(cell, seed, device)
    dev, wl = prog.dev, cell.workload
    t = time.perf_counter()
    prog.decompose(WARM_INDEX)
    _log(f"[perfbench] {cell.name}: tensor {prog.shape} nnz {prog.st.nnz}, plan chunk "
         f"{prog.plan.chunk_shape} capacity {prog.plan.capacity}; engine built in "
         f"{prog.engine_build_s:.3f} s, warm decomposition {time.perf_counter() - t:.3f} s")
    setup_s = time.perf_counter() - t_start

    tracing = prog.api["tracing"]
    sample = _Reservoir(int(wl["sample"]), np.random.default_rng([int(seed) % 2**64, 1]))
    tracer = dtrace = None
    if trace:
        tracer = tracing.enable_tracing()
        if dev.type == "cuda":
            dtrace = devtrace.DeviceTrace()
            dtrace.start()
    decomps, failed = [], 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        s = time.perf_counter()
        index = len(decomps)
        try:
            res = prog.decompose(index)
        except Exception:  # a decomposition that raises never answers: counted, reported
            failed += 1
            res = None
            if failed == 1:
                _log(traceback.format_exc())
        e = time.perf_counter()
        decomps.append((s, e, len(res.fit_history) if res is not None else 0))
        if res is not None:
            sample.offer((index, res))
    window = (t0, decomps[-1][1])
    walls = sorted(e - s for s, e, _ in decomps)
    _log(f"[perfbench] window {window[1] - window[0]:.3f} s: {len(decomps)} decompositions, "
         f"{sum(d[2] for d in decomps)} iterations; wall per call min {walls[0]:.4f} s, "
         f"median {walls[len(walls) // 2]:.4f} s, max {walls[-1]:.4f} s")
    spans = events = None
    if trace:
        events = dtrace.stop() if dtrace is not None else []
        spans = [("perfbench.window", *window)]
        spans += [("perfbench.decompose", s, e) for s, e, _ in decomps]
        spans += [(r.name, tracer.epoch_mono + r.t_start,
                   tracer.epoch_mono + r.t_start + r.duration) for r in tracer.spans()]
        tracing.disable_tracing()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    device_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    prog.free()
    t = time.perf_counter()
    samples = reference_readings(prog, sample.items, cell.traffic["reference"])
    correct, worst = check.judge(samples, wl["limits"])
    correct = correct and failed == 0
    _log(f"[perfbench] reference over {len(samples)} of {len(decomps)} decompositions "
         f"in {time.perf_counter() - t:.3f} s")

    data = RunData(config=cell.config, traffic=cell.traffic, device_name=device_name,
                   setup_s=setup_s, engine_build_s=prog.engine_build_s, window=window,
                   decomps=decomps, peak_bytes=peak, spans=spans, device_events=events)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = manifest.reader(m["name"])(data)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": correct, "attempted": len(decomps), "failed": failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                      "kind": device_name, "count": 1,
                      "memory_peak_bytes": peak if peak is not None else 0}}
    if trace:
        busy = devtrace.busy_intervals(events, *window)
        out["device"]["busy_s"] = sum(b - a for a, b in busy)
        out["device"]["window_s"] = data.window_s
        out["breakdown"] = {
            "device_ops": [list(x) for x in devtrace.top_ops(events, *window)],
            "idle_gaps": [list(x) for x in devtrace.idle_by_host_span(busy, *window, spans)[:10]],
        }
    for k, v in worst.items():
        if k not in wl["limits"]:
            _log(f"reading {k} {v!r} (not compared)")
    out["check"] = {k: {"value": worst.get(k, math.inf), "limit": lim}
                    for k, lim in wl["limits"].items()}
    return out
