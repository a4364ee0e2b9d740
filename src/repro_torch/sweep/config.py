"""Declarative design-space sweep configuration (the port's copy of
`repro.sweep.config`).

The PRISM paper characterizes its (partitioning × format × execution)
design space offline, once per workload class, so tuning never shows up
as a runtime cost.  This module is the declarative half of that idea: a
small schema — TOML file or plain dict — enumerating a grid over

    (synthetic-tensor band × nnz × rank × chunk capacity)  cells
  × (format × execution × Qm.n preset)                     candidates

where each *cell* is one autotune workload (one `WorkloadKey` fingerprint)
and the candidate axes are tuned *within* the cell by `autotune_engine`'s
probes.  The runner (runner.py) executes every cell and records the
observations into a `TuningStore`; the report stage (report.py) turns the
filled store into a Pareto front.

Candidates are the port's candidate ids: `kernel` (the hand-written CUDA
kernel) stands where the reference says `pallas`.

TOML schema (every key under a single `[sweep]` table)::

    [sweep]
    name = "ci-pruned"
    ranks = [8]
    capacities = [0, 64]        # 0 means "partition decider chooses"
    candidates = ["ref", "chunked", "kernel", "csf", "alto", "fixed:int7"]
    accuracy_budget = 0.2       # required when any candidate is lossy
    mem_bytes = 262144          # partition-decider budget (optional)
    warmup = 1
    reps = 2

    [[sweep.tensors]]
    name = "uniform-band"
    shape = [60, 50, 40]
    nnz = [2000, 4000]          # scalar or list — the nnz band
    distribution = "uniform"    # or "powerlaw"
    seed = 0

TOML has no null, so the capacity sentinel is ``0`` (an illegal real
capacity — `EngineContext` requires >= 1), mapped to None = "the Fig.-5
partition decider chooses".  `random_tensor` guarantees the *exact*
requested nnz, so a cell's workload fingerprint is computable from the
config alone — the runner's resume check never builds a tensor for a cell
the store already holds.

Parsing prefers the stdlib ``tomllib`` and falls back to a deliberately
small TOML-subset parser (`_toml_subset_loads`) covering exactly the
grammar above — scalar keys, flat arrays, `[table]` and
`[[array-of-tables]]` headers.
"""
from __future__ import annotations

import dataclasses
import itertools
import json

from ..engine.registry import candidate_lossless, parse_candidate

__all__ = [
    "SweepCell",
    "SweepConfig",
    "SweepConfigError",
    "TensorBand",
    "load_config",
]

_DISTRIBUTIONS = ("uniform", "powerlaw")


class SweepConfigError(ValueError):
    """A sweep config that cannot mean what it says."""


@dataclasses.dataclass(frozen=True)
class TensorBand:
    """One synthetic-tensor family: a fixed (shape, distribution, seed)
    swept over an nnz band.  Each nnz in the band is its own grid cell —
    ALTO-style studies (PAPERS.md) show winners flip with nnz, so the band
    is enumerated, never interpolated."""

    name: str
    shape: tuple[int, ...]
    nnz: tuple[int, ...]
    distribution: str = "uniform"
    seed: int = 0

    def __post_init__(self):
        if not self.name:
            raise SweepConfigError("tensor band needs a non-empty name")
        if not self.shape or any(d < 1 for d in self.shape):
            raise SweepConfigError(
                f"tensor band {self.name!r}: shape must be positive dims "
                f"(got {self.shape})")
        if not self.nnz or any(n < 1 for n in self.nnz):
            raise SweepConfigError(
                f"tensor band {self.name!r}: nnz band must be positive "
                f"(got {self.nnz})")
        if self.distribution not in _DISTRIBUTIONS:
            raise SweepConfigError(
                f"tensor band {self.name!r}: unknown distribution "
                f"{self.distribution!r} (choose from {_DISTRIBUTIONS})")

    @classmethod
    def from_dict(cls, d: dict) -> TensorBand:
        d = dict(d)
        nnz = d.get("nnz")
        if isinstance(nnz, (int, float)):
            nnz = [nnz]
        try:
            return cls(
                name=str(d["name"]),
                shape=tuple(int(x) for x in d["shape"]),
                nnz=tuple(int(n) for n in nnz or ()),
                distribution=str(d.get("distribution", "uniform")),
                seed=int(d.get("seed", 0)),
            )
        except KeyError as e:
            raise SweepConfigError(
                f"tensor band is missing required key {e.args[0]!r} "
                f"(got keys {sorted(d)})") from None


@dataclasses.dataclass(frozen=True)
class SweepCell:
    """One grid cell = one autotune workload.  The candidate axes live
    inside the cell (the autotuner probes all of them per mode); the cell
    axes are what change the workload fingerprint."""

    band: TensorBand
    nnz: int
    rank: int
    capacity: int | None

    @property
    def label(self) -> str:
        cap = "auto" if self.capacity is None else str(self.capacity)
        return f"{self.band.name}/nnz={self.nnz}/rank={self.rank}/cap={cap}"


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """The full declared grid.  `cells()` enumerates the cross product in
    a deterministic order (band → nnz → rank → capacity), which is also
    the resume order."""

    name: str
    tensors: tuple[TensorBand, ...]
    ranks: tuple[int, ...]
    candidates: tuple[str, ...]
    capacities: tuple[int | None, ...] = (None,)
    accuracy_budget: float | None = None
    mem_bytes: int = 256 * 1024
    warmup: int = 1
    reps: int = 2

    def __post_init__(self):
        if not self.tensors:
            raise SweepConfigError("sweep declares no tensor bands")
        if not self.ranks or any(r < 1 for r in self.ranks):
            raise SweepConfigError(
                f"ranks must be positive (got {self.ranks})")
        if not self.candidates:
            raise SweepConfigError("sweep declares no candidates")
        for c in self.candidates:
            try:
                parse_candidate(c)
            except ValueError as e:
                raise SweepConfigError(f"bad candidate id {c!r}: {e}") from None
        lossy = [c for c in self.candidates if not candidate_lossless(c)]
        if lossy and self.accuracy_budget is None:
            raise SweepConfigError(
                f"candidates {lossy} are lossy but the sweep declares no "
                "accuracy_budget — format is an accuracy choice, and the "
                "tuner only makes it against a declared error budget")
        if self.accuracy_budget is not None and not self.accuracy_budget > 0:
            raise SweepConfigError(
                f"accuracy_budget must be > 0 (got {self.accuracy_budget})")
        for cap in self.capacities:
            if cap is not None and cap < 1:
                raise SweepConfigError(
                    f"capacity must be >= 1, or 0/None for the partition "
                    f"decider (got {cap})")
        if self.warmup < 0 or self.reps < 1:
            raise SweepConfigError(
                f"need warmup >= 0 and reps >= 1 (got warmup={self.warmup}, "
                f"reps={self.reps})")

    def cells(self) -> list[SweepCell]:
        return [
            SweepCell(band=band, nnz=nnz, rank=rank, capacity=cap)
            for band, rank, cap in itertools.product(
                self.tensors, self.ranks, self.capacities)
            for nnz in band.nnz
        ]

    @classmethod
    def from_dict(cls, d: dict) -> SweepConfig:
        d = dict(d.get("sweep", d))  # accept the [sweep] wrapper or the body
        caps = d.get("capacities", [0])
        budget = d.get("accuracy_budget")
        try:
            return cls(
                name=str(d.get("name", "sweep")),
                tensors=tuple(TensorBand.from_dict(t)
                              for t in d.get("tensors", ())),
                ranks=tuple(int(r) for r in d.get("ranks", ())),
                candidates=tuple(str(c) for c in d.get("candidates", ())),
                # TOML has no null: 0 is the "partition decider" sentinel.
                capacities=tuple(None if int(c) == 0 else int(c)
                                 for c in caps),
                accuracy_budget=float(budget) if budget is not None else None,
                mem_bytes=int(d.get("mem_bytes", 256 * 1024)),
                warmup=int(d.get("warmup", 1)),
                reps=int(d.get("reps", 2)),
            )
        except (TypeError, ValueError) as e:
            if isinstance(e, SweepConfigError):
                raise
            raise SweepConfigError(f"malformed sweep config: {e}") from None


# ---------------------------------------------------------------------------
# TOML loading, with a subset fallback for pythons without tomllib.
# ---------------------------------------------------------------------------

def _strip_comment(line: str) -> str:
    """Drop a trailing ``# comment``, respecting double-quoted strings."""
    out, in_str = [], False
    for ch in line:
        if ch == '"':
            in_str = not in_str
        elif ch == "#" and not in_str:
            break
        out.append(ch)
    return "".join(out).strip()


def _toml_scalar(tok: str, lineno: int):
    if tok.startswith("[") and tok.endswith("]"):
        inner = tok[1:-1].strip()
        if not inner:
            return []
        return [_toml_scalar(t.strip(), lineno) for t in inner.split(",")
                if t.strip()]
    if len(tok) >= 2 and tok[0] == '"' and tok[-1] == '"':
        return tok[1:-1]
    if tok in ("true", "false"):
        return tok == "true"
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        raise SweepConfigError(
            f"TOML-subset parser: unsupported value {tok!r} on line "
            f"{lineno} (supported: int, float, bool, \"string\", flat "
            "arrays thereof)") from None


def _descend(root: dict, path: list[str]) -> dict:
    node = root
    for k in path:
        node = node.setdefault(k, {})
        if isinstance(node, list):  # array-of-tables: descend into newest
            node = node[-1]
    return node


def _toml_subset_loads(text: str) -> dict:
    """Parse the TOML subset the sweep schema needs: ``key = value`` with
    int/float/bool/string/flat-array values, ``[a.b]`` table headers and
    ``[[a.b]]`` array-of-tables headers, comments.  Multiline arrays,
    inline tables, escapes and dates are out of scope — `load_config`
    prefers the real ``tomllib`` whenever the interpreter has one."""
    root: dict = {}
    current = root
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw)
        if not line:
            continue
        if line.startswith("[["):
            if not line.endswith("]]"):
                raise SweepConfigError(
                    f"TOML-subset parser: bad table header on line {lineno}: "
                    f"{raw.strip()!r}")
            path = [p.strip() for p in line[2:-2].strip().split(".")]
            parent = _descend(root, path[:-1])
            arr = parent.setdefault(path[-1], [])
            if not isinstance(arr, list):
                raise SweepConfigError(
                    f"line {lineno}: {path[-1]!r} is both a table and an "
                    "array of tables")
            current = {}
            arr.append(current)
        elif line.startswith("["):
            if not line.endswith("]"):
                raise SweepConfigError(
                    f"TOML-subset parser: bad table header on line {lineno}: "
                    f"{raw.strip()!r}")
            path = [p.strip() for p in line[1:-1].strip().split(".")]
            current = _descend(root, path)
        else:
            key, sep, val = line.partition("=")
            if not sep or not key.strip():
                raise SweepConfigError(
                    f"TOML-subset parser: expected `key = value` on line "
                    f"{lineno}: {raw.strip()!r}")
            current[key.strip().strip('"')] = _toml_scalar(val.strip(), lineno)
    return root


def _load_toml(path: str) -> dict:
    try:
        import tomllib
    except ImportError:
        try:
            import tomli as tomllib
        except ImportError:
            tomllib = None
    if tomllib is not None:
        with open(path, "rb") as f:
            return tomllib.load(f)
    with open(path, encoding="utf-8") as f:
        return _toml_subset_loads(f.read())


def load_config(path: str) -> SweepConfig:
    """Load a sweep config from a ``.toml`` (or ``.json``) file."""
    if str(path).endswith(".json"):
        with open(path, encoding="utf-8") as f:
            return SweepConfig.from_dict(json.load(f))
    return SweepConfig.from_dict(_load_toml(str(path)))
