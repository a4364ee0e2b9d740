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

from ..core.sptensor import SparseTensor
from ..device import resolve_device
from .plan import PlanCache, default_plan_cache

__all__ = [
    "BackendSpec",
    "Engine",
    "EngineContext",
    "backend_table",
    "get_backend",
    "register_backend",
    "registered_backends",
]


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """Capability declaration for one registered execution strategy.

    needs_chunking — consumes the PRISM chunked format (built once, shared
                     through the plan cache).
    lossless       — equal to the float COO reference up to summation
                     order, so CP-ALS may take its fit fast path.
    """

    name: str
    build: Callable
    needs_chunking: bool = False
    lossless: bool = True
    description: str = ""


_REGISTRY: dict[str, BackendSpec] = {}


def register_backend(name: str, *, needs_chunking: bool = False,
                     lossless: bool = True, description: str = ""):
    """Decorator registering a builder under `name` (last wins)."""
    def deco(build: Callable) -> Callable:
        _REGISTRY[name] = BackendSpec(name=name, build=build, needs_chunking=needs_chunking,
                                      lossless=lossless, description=description)
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


def backend_table() -> str:
    """Markdown capability table of the registered backends, by name."""
    rows = [
        "| backend | chunked | lossless | description |",
        "|---------|---------|----------|-------------|",
    ]
    for s in sorted(_REGISTRY.values(), key=lambda s: s.name):
        rows.append(f"| `{s.name}` | {'✓' if s.needs_chunking else '—'} "
                    f"| {'✓' if s.lossless else '—'} | {s.description} |")
    return "\n".join(rows)


@dataclasses.dataclass
class EngineContext:
    """Everything a builder may need, with chunking resolved lazily once.

    `chunk_shape`/`capacity` default to the Fig.-5 partition decider's plan
    for (st, rank, mem_bytes); chunk-based backends built from one context
    share one ChunkedTensor and one set of device tensors via `plans`.
    `device` None means the CUDA card (and raises where there is none).
    """

    st: SparseTensor
    rank: int
    mem_bytes: int | None = None
    chunk_shape: tuple[int, ...] | None = None
    capacity: int | None = None
    device: torch.device | str | None = None
    plans: PlanCache | None = None  # None → the process-wide default_plan_cache

    def __post_init__(self):
        if self.plans is None:
            self.plans = default_plan_cache
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

    def device_arrays(self) -> dict:
        cs, cap = self.resolve_chunking()
        return self.plans.device_arrays(self.st, cs, cap, self.device)


class Engine:
    """Callable engine handle: `engine(factors, mode) -> (I_mode, R)`."""

    def __init__(self, name: str, fn: Callable, *, spec: BackendSpec | None = None,
                 context: EngineContext | None = None):
        self.name = name
        self._fn = fn
        self.spec = spec
        self.context = context

    def __call__(self, factors, mode: int):
        return self._fn(factors, mode)

    def __repr__(self) -> str:
        return f"Engine({self.name!r})"
