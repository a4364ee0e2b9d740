"""MTTKRP backend registry (counterpart of `repro.engine.registry`).

A backend is a *builder*: ``build(ctx: EngineContext) -> engine`` where
``engine(factors, mode) -> (I_mode, R) f32`` on the context's device.
Builders run once per (tensor, rank, options); the returned closure serves
every CP-ALS iteration, with chunking shared through ``ctx.plans``.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable

import torch

from ..core.chunking import ChunkedTensor
from ..core.sptensor import SparseTensor
from ..device import resolve_device
from ..formats.convert import FormatCache, default_format_cache
from ..launch.mesh import world_size
from .plan import PlanCache, default_plan_cache

__all__ = [
    "BackendSpec",
    "Engine",
    "EngineContext",
    "backend_table",
    "build_candidate",
    "candidate_lossless",
    "eligible_backends",
    "get_backend",
    "parse_candidate",
    "preset_candidates",
    "register_backend",
    "registered_backends",
]


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """Capability declaration for one registered execution strategy.

    needs_chunking       — consumes the PRISM chunked format (built once,
                           shared through the plan cache).
    supports_fixed_point — runs the paper's Alg.-2 Qm.n arithmetic.
    lossless             — equal to the float COO reference up to summation
                           order, so CP-ALS may take its fit fast path.
    presets              — the Qm.n presets this backend can run
                           (`FIXED_PRESETS` names); ``"name:preset"`` pins one,
                           and each becomes an autotune candidate under an
                           accuracy budget.
    min_devices          — minimum device count to be eligible: the ranks of
                           the default process group, one card (or CPU
                           process) each, or 1 without a group.
    launches_kernel      — runs a hand-written CUDA kernel on a CUDA
                           context, so the autotuner re-raises its failures
                           there instead of skipping it as a slow candidate.
    """

    name: str
    build: Callable
    needs_chunking: bool = False
    supports_fixed_point: bool = False
    lossless: bool = True
    presets: tuple[str, ...] = ()
    min_devices: int = 1
    launches_kernel: bool = False
    description: str = ""


_REGISTRY: dict[str, BackendSpec] = {}


def register_backend(name: str, *, needs_chunking: bool = False,
                     supports_fixed_point: bool = False, lossless: bool = True,
                     presets: tuple[str, ...] = (), min_devices: int = 1,
                     launches_kernel: bool = False, description: str = ""):
    """Decorator registering a builder under `name` (last wins)."""
    if ":" in name:
        raise ValueError(
            f"backend name {name!r} may not contain ':' — that separator is "
            "reserved for preset candidate ids (e.g. 'fixed:int7')")

    def deco(build: Callable) -> Callable:
        _REGISTRY[name] = BackendSpec(
            name=name, build=build, needs_chunking=needs_chunking,
            supports_fixed_point=supports_fixed_point, lossless=lossless,
            presets=tuple(presets), min_devices=min_devices,
            launches_kernel=launches_kernel, description=description)
        return build
    return deco


def get_backend(name: str) -> BackendSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown engine {name!r}; registered: {sorted(_REGISTRY)}") from None


def registered_backends() -> dict[str, BackendSpec]:
    return dict(_REGISTRY)


# Candidate ids: "backend" or "backend:preset" ("fixed:int7").  These
# helpers alone parse, enumerate and build that spelling, as in the
# reference: the tuning store, cost model and autotuner all come through here.

def parse_candidate(candidate: str) -> tuple[str, str | None]:
    """Split a candidate id into (backend name, preset or None), validating
    both halves against the registry."""
    name, _, preset = candidate.partition(":")
    spec = get_backend(name)
    if not preset:
        return name, None
    if preset not in spec.presets:
        raise ValueError(
            f"backend {name!r} has no preset {preset!r}; "
            f"registered presets: {list(spec.presets) or 'none'}")
    return name, preset


def candidate_lossless(candidate: str) -> bool:
    """Whether a candidate id names a lossless backend.  Unknown candidates
    count as lossy: nothing is known about their output."""
    try:
        name, _preset = parse_candidate(candidate)
    except ValueError:
        return False
    return _REGISTRY[name].lossless


def build_candidate(candidate: str, ctx: EngineContext):
    """Build a candidate id against `ctx`, overriding `ctx.fixed_preset`
    when the id pins one; the pinned context shares the plan cache."""
    name, preset = parse_candidate(candidate)
    if preset is not None and preset != ctx.fixed_preset:
        ctx = dataclasses.replace(ctx, fixed_preset=preset)
    return _REGISTRY[name].build(ctx)


def _n_devices(n_devices: int | None) -> int:
    """`n_devices`, or the ranks of the default process group (1 without
    one).  Only ranks of a group can be members of a mesh, so a process that
    sees several cards still counts as one device; the reference counts the
    devices of its one process."""
    return world_size() if n_devices is None else n_devices


def preset_candidates(*, n_devices: int | None = None) -> list[str]:
    """Every lossy (backend, preset) candidate id this process could build:
    what an accuracy budget adds to the default candidate set, sorted by
    name so that probe order and tie-breaks do not depend on registration."""
    n_devices = _n_devices(n_devices)
    return [f"{s.name}:{p}"
            for s in sorted(_REGISTRY.values(), key=lambda s: s.name)
            if not s.lossless and n_devices >= s.min_devices
            for p in s.presets]


def eligible_backends(*, n_devices: int | None = None,
                      lossless_only: bool = False) -> list[str]:
    """Backends whose device requirements `n_devices` satisfy (None: the
    ranks of the default process group, or 1), sorted by name."""
    n_devices = _n_devices(n_devices)
    return [s.name
            for s in sorted(_REGISTRY.values(), key=lambda s: s.name)
            if n_devices >= s.min_devices and (s.lossless or not lossless_only)]


def backend_table() -> str:
    """Markdown capability table of the registered backends, by name."""
    def mark(flag: bool) -> str:
        return "✓" if flag else "—"

    rows = [
        "| backend | chunked | fixed-point | lossless | presets | min devices | description |",
        "|---------|---------|-------------|----------|---------|-------------|-------------|",
    ]
    for s in sorted(_REGISTRY.values(), key=lambda s: s.name):
        presets = " ".join(f"`{p}`" for p in s.presets) or "—"
        rows.append(f"| `{s.name}` | {mark(s.needs_chunking)} | {mark(s.supports_fixed_point)} "
                    f"| {mark(s.lossless)} | {presets} | {s.min_devices} | {s.description} |")
    return "\n".join(rows)


@dataclasses.dataclass
class EngineContext:
    """Everything a builder may need, with chunking resolved lazily once.

    `chunk_shape`/`capacity` default to the Fig.-5 partition decider's plan
    for (st, rank, mem_bytes); chunk-based backends built from one context
    share one ChunkedTensor and one set of device tensors via `plans`.
    `device` None means the CUDA card (and raises where there is none).
    `fixed_preset` names the `fixed` backend's Qm.n preset
    (`FIXED_PRESETS`); `lockfree_mode` emulates the paper's lock-free lost
    updates in the backends that read it (`chunked`, `fixed`).
    `dense_fraction` overrides the `hetero` backend's cost-model split with a
    static densest-first fraction of tasks; the `csf` and `alto` backends
    take their layouts from `formats`.  `mesh` (a (data, model)
    `DeviceMesh`, None → `make_local_mesh`) and `reduce` ("psum" or
    "psum_scatter") configure the `distributed` backend.
    """

    st: SparseTensor
    rank: int
    mem_bytes: int | None = None
    chunk_shape: tuple[int, ...] | None = None
    capacity: int | None = None
    fixed_preset: str = "int7"
    lockfree_mode: bool = False
    device: torch.device | str | None = None
    dense_fraction: float | None = None
    mesh: object | None = None      # distributed backend; None → local mesh
    reduce: str = "psum"            # distributed reduction strategy
    plans: PlanCache | None = None  # None → the process-wide default_plan_cache
    formats: FormatCache | None = None  # None → the process-wide default_format_cache

    def __post_init__(self):
        if self.plans is None:
            self.plans = default_plan_cache
        if self.formats is None:
            self.formats = default_format_cache
        if self.capacity is not None and self.capacity < 1:
            raise ValueError(
                f"capacity must be >= 1 nonzero slot per chunk task (got "
                f"{self.capacity}); pass capacity=None to let the partition "
                "decider choose")
        self.device = resolve_device(self.device)

    def resolve_chunking(self) -> tuple[tuple[int, ...], int | None]:
        """Fill chunk_shape/capacity from the partition decider if unset."""
        if self.chunk_shape is None:
            plan = self.plans.plan(self.st, self.rank,
                                   mem_bytes=self.mem_bytes or 64 * 1024 * 1024)
            self.chunk_shape = plan.chunk_shape
            if self.capacity is None:
                self.capacity = plan.capacity
        return self.chunk_shape, self.capacity

    def chunked(self) -> ChunkedTensor:
        cs, cap = self.resolve_chunking()
        return self.plans.chunked(self.st, cs, cap)

    def device_arrays(self) -> dict:
        cs, cap = self.resolve_chunking()
        return self.plans.device_arrays(self.st, cs, cap, self.device)


class Engine:
    """Callable engine handle: `engine(factors, mode) -> (I_mode, R)`, with
    its build context and, for an autotuned engine, the tuner's report."""

    def __init__(self, name: str, fn: Callable, *, spec: BackendSpec | None = None,
                 context: EngineContext | None = None, report=None):
        self.name = name
        self.fn = fn  # what the backend's build returned (`distributed`: a DistributedMTTKRP)
        self.spec = spec
        self.context = context
        self.report = report

    def __call__(self, factors, mode: int):
        return self.fn(factors, mode)

    def __repr__(self) -> str:
        return f"Engine({self.name!r})"
