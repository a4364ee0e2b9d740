"""Sweep runner: execute every declared grid cell through the autotuner
(the port's copy of `repro.sweep.runner`).

Each `SweepCell` is one autotune workload.  The runner builds the cell's
synthetic tensor, runs the existing `autotune_engine` probe machinery over
the declared candidates with *elision and probe pruning off* — an offline
sweep wants the complete (candidate × mode) observation grid, not the
cheapest route to a winner — and lets the tuner record the measurements
into the shared `TuningStore`.

Resumability is fingerprint-native: `random_tensor` guarantees the exact
requested nnz, so a cell's `WorkloadKey` is computable from the config
alone (`cell_key`), and a cell whose key the store already holds is skipped
*before any tensor is built* — a killed sweep restarted against the same
store re-probes nothing it completed.  The store must be opened with
`nnz_tol=0` (the runner enforces it): adjacent nnz-band cells are
deliberate design points and must neither serve each other warm nor dedup
each other away.

`resume=False` is a true re-measure: the runner forgets every declared
cell's entry first, so each cell cold-starts and overwrites.

Cells run on `device` (None: the CUDA card), and their fingerprints carry
that device, so a store filled on the card warms a cold start on the card.
"""
from __future__ import annotations

import dataclasses
import math
import time

import torch

from ..core.sptensor import random_tensor
from ..device import resolve_device
from ..engine.autotune import autotune_engine
from ..engine.persist import (
    TuningStore,
    WorkloadKey,
    device_fingerprint,
    device_fingerprint_id,
)
from ..engine.plan import PlanCache
from ..engine.registry import EngineContext
from ..engine.tunepolicy import TunePolicy
from ..formats.convert import FormatCache
from ..kernels import KernelError
from ..obs.tracing import span
from .config import SweepCell, SweepConfig

__all__ = ["CellOutcome", "SweepResult", "cell_key", "run_sweep"]


def cell_key(cell: SweepCell, config: SweepConfig,
             device: str | torch.device | None = None) -> WorkloadKey:
    """The cell's workload fingerprint on `device` (None: the CUDA card),
    computed WITHOUT building the tensor: `random_tensor` guarantees the
    exact requested nnz, so shape, nnz and density are known from the
    config alone.  Must stay field-for-field identical to what
    `autotune_engine` fingerprints after the build
    (`WorkloadKey.from_tensor`) — test_torch_sweep.py locks the two
    together."""
    shape = tuple(int(d) for d in cell.band.shape)
    nnz = int(cell.nnz)
    return WorkloadKey(
        shape=shape,
        nnz=nnz,
        density=nnz / math.prod(shape),
        ndim=len(shape),
        rank=int(cell.rank),
        candidates=tuple(sorted(config.candidates)),
        device=tuple(sorted(device_fingerprint(device).items())),
        capacity=cell.capacity,
    )


@dataclasses.dataclass
class CellOutcome:
    """What happened to one grid cell this run.

    status — "measured"  probed cold and recorded;
             "complete"  resume skip: the store already held the cell;
             "warm"      the tuner itself answered from the store (exact
                         hit the resume check could not claim — kept
                         distinct so `--require-warm` audits stay honest);
             "failed"    every candidate failed, or the cell raised;
             "deferred"  not executed (past `max_cells` this run).
    """

    cell: str
    band: str
    nnz: int
    rank: int
    capacity: int | None
    status: str
    n_probes: int = 0
    winners: dict[int, str] = dataclasses.field(default_factory=dict)
    seconds: float = 0.0
    error: str | None = None

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SweepResult:
    """One `run_sweep` invocation's ledger (the store holds the data)."""

    config: str
    store_path: str
    device: str                      # device_fingerprint_id() of the cells' device
    outcomes: list[CellOutcome]

    @property
    def n_probes(self) -> int:
        return sum(o.n_probes for o in self.outcomes)

    def count(self, status: str) -> int:
        return sum(1 for o in self.outcomes if o.status == status)

    def to_json(self) -> dict:
        return {
            "config": self.config,
            "store": self.store_path,
            "device": self.device,
            "n_cells": len(self.outcomes),
            "n_probes": self.n_probes,
            "counts": {s: self.count(s)
                       for s in ("measured", "complete", "warm",
                                 "failed", "deferred")},
            "outcomes": [o.to_json() for o in self.outcomes],
        }


def _outcome(cell: SweepCell, status: str, **kw) -> CellOutcome:
    return CellOutcome(cell=cell.label, band=cell.band.name, nnz=cell.nnz,
                       rank=cell.rank, capacity=cell.capacity,
                       status=status, **kw)


def run_sweep(
    config: SweepConfig,
    store: TuningStore | str,
    *,
    resume: bool = True,
    max_cells: int | None = None,
    log=None,
    device: str | torch.device | None = None,
) -> SweepResult:
    """Execute the grid, recording observations into `store`.

    resume    — skip cells whose fingerprint the store already holds (with
                a budget covering the config's).  False forgets every
                declared cell first and re-measures.
    max_cells — stop after executing this many cells (resume skips don't
                count); the rest report "deferred".  The knob CI's pruned
                grid and the kill-and-restart tests lean on.
    log       — optional callable (e.g. `print`) for per-cell progress.
    device    — where the cells run (None: the CUDA card).
    """
    device = resolve_device(device)
    if not isinstance(store, TuningStore):
        store = TuningStore(store, nnz_tol=0.0)
    if store.nnz_tol != 0.0:
        raise ValueError(
            f"sweep stores need nnz_tol=0 (got {store.nnz_tol}): nnz-band "
            "grid cells are deliberate design points, and a near-match "
            "tolerance would let them warm-serve and supersede each other")
    log = log or (lambda _msg: None)
    cells = config.cells()

    if not resume:
        forgot = sum(store.forget(cell_key(c, config, device), save=False)
                     for c in cells)
        if forgot:
            store.save()
            log(f"forgot {forgot} existing cell entr"
                f"{'y' if forgot == 1 else 'ies'} (resume off)")

    outcomes: list[CellOutcome] = []
    executed = 0
    for cell in cells:
        key = cell_key(cell, config, device)
        if resume:
            entry = store.lookup(key, nnz_tol=0.0,
                                 budget=config.accuracy_budget)
            if entry is not None:
                outcomes.append(_outcome(cell, "complete",
                                         winners=dict(entry.winners)))
                log(f"[skip] {cell.label}: already in store")
                continue
        if max_cells is not None and executed >= max_cells:
            outcomes.append(_outcome(cell, "deferred"))
            continue
        executed += 1
        t0 = time.perf_counter()
        # The cell span carries the cell's fingerprint fields, and every
        # probe/decision span the tuner emits for this cell nests under it
        # — a sweep trace is attributable cell-by-cell.
        cell_sp = span("sweep.cell", cell=cell.label, band=cell.band.name,
                       shape=list(cell.band.shape), nnz=int(cell.nnz),
                       rank=int(cell.rank), capacity=cell.capacity,
                       fingerprint=key.fingerprint())
        try:
            with cell_sp:
                st = random_tensor(cell.band.shape, cell.nnz,
                                   distribution=cell.band.distribution,
                                   seed=cell.band.seed)
                # Fresh per-cell caches: chunk plans and format layouts are
                # shared across this cell's candidates but must not pin
                # every swept tensor in memory for the whole grid.
                ctx = EngineContext(st=st, rank=cell.rank,
                                    mem_bytes=config.mem_bytes,
                                    capacity=cell.capacity, device=device,
                                    plans=PlanCache(), formats=FormatCache())
                _engine, rep = autotune_engine(ctx, tune=TunePolicy(
                    candidates=tuple(config.candidates),
                    warmup=config.warmup, reps=config.reps,
                    store=store, prior="default",
                    # The sweep's whole point is the complete observation
                    # grid: no probe pruning, no cross-mode elision.
                    max_probes=None, elide=False,
                    accuracy_budget=config.accuracy_budget))
                cell_sp.set(status="warm" if rep.source == "persisted"
                            else "measured", probes=rep.n_probes)
        except KernelError:
            raise  # a kernel that cannot build or launch breaks every cell
        except Exception as e:  # blind by design: one broken cell must not kill the grid
            outcomes.append(_outcome(
                cell, "failed", seconds=time.perf_counter() - t0,
                error=f"{type(e).__name__}: {e}"))
            log(f"[FAIL] {cell.label}: {type(e).__name__}: {e}")
            continue
        status = "warm" if rep.source == "persisted" else "measured"
        outcomes.append(_outcome(
            cell, status, n_probes=rep.n_probes,
            winners=dict(rep.winners), seconds=time.perf_counter() - t0))
        log(f"[{status}] {cell.label}: probes={rep.n_probes} "
            f"winners={rep.chosen}")

    return SweepResult(config=config.name, store_path=store.path,
                       device=device_fingerprint_id(device_fingerprint(device)),
                       outcomes=outcomes)
