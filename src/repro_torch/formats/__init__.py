"""Pluggable sparse-format subsystem (counterpart of `repro.formats`): how
the tensor's nonzeros are laid out in memory, decoupled from how the MTTKRP
executes over them.  Layout is a registered axis, mirroring the engine's
backend registry:

  coo   — the baseline coordinate list (`repro_torch.core.SparseTensor`).
  csf   — per-mode fiber trees (csf.py): fiber-level factor reuse.
  alto  — one bit-interleaved linearized index serving every mode (alto.py).

`FormatStats` summarizes the layout-relevant statistics of a tensor — fiber
counts per mode, interleave key width, index bytes per layout — and is what
a cost model's byte terms consume to rank layouts on a cold start.  The
registry, `FormatStats` and the layouts are numpy copies of the
reference's, so both packages give the same tables and statistics.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Callable

from ..core.sptensor import SparseTensor
from .alto import (
    MAX_KEY_BITS,
    ALTOTensor,
    alto_index_bytes,
    alto_key_bits,
    alto_positions,
    alto_to_coo,
    build_alto,
)
from .convert import (
    FormatCache,
    FormatCacheStats,
    alto_to_csf,
    coo_to_alto,
    coo_to_csf,
    csf_to_alto,
    default_format_cache,
)
from .csf import (
    CSFModeTree,
    build_csf_tree,
    csf_index_bytes,
    csf_mode_order,
    csf_to_coo,
    fiber_count,
)

__all__ = [
    "ALTOTensor",
    "CSFModeTree",
    "FormatCache",
    "FormatCacheStats",
    "FormatSpec",
    "FormatStats",
    "MAX_KEY_BITS",
    "alto_index_bytes",
    "alto_key_bits",
    "alto_positions",
    "alto_to_coo",
    "alto_to_csf",
    "build_alto",
    "build_csf_tree",
    "coo_to_alto",
    "coo_to_csf",
    "csf_index_bytes",
    "csf_mode_order",
    "csf_to_alto",
    "csf_to_coo",
    "default_format_cache",
    "fiber_count",
    "format_table",
    "get_format",
    "register_format",
    "registered_formats",
]


# ---------------------------------------------------------------------------
# Format registry — the layout analogue of engine/registry.py's backend
# registry: each layout registers a capability declaration + builder, and
# everything downstream (backends, cost model, docs) goes through one API.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FormatSpec:
    """Capability declaration for one registered sparse layout.

    build(st, mode) -> layout object (mode is ignored by mode-agnostic
    layouts — one build serves every MTTKRP mode; per-mode layouts build
    `ndim` structures, typically lazily and cached).

    mode_agnostic — one built structure serves every MTTKRP mode (ALTO's
                    selling point; COO trivially; CSF needs one tree per
                    output mode).
    sorted_reduce — nonzeros are stored so the MTTKRP reduction runs over
                    sorted segments (enables `indices_are_sorted=True`).
    """

    name: str
    build: Callable
    mode_agnostic: bool = True
    sorted_reduce: bool = False
    description: str = ""


_REGISTRY: dict[str, FormatSpec] = {}


def register_format(
    name: str,
    *,
    mode_agnostic: bool = True,
    sorted_reduce: bool = False,
    description: str = "",
):
    """Decorator registering a layout builder under `name` (last wins, as in
    the backend registry, so tests and downstream code can override)."""
    def deco(build: Callable) -> Callable:
        _REGISTRY[name] = FormatSpec(
            name=name,
            build=build,
            mode_agnostic=mode_agnostic,
            sorted_reduce=sorted_reduce,
            description=description,
        )
        return build
    return deco


def get_format(name: str) -> FormatSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown format {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def registered_formats() -> dict[str, FormatSpec]:
    return dict(_REGISTRY)


def format_table(docs_base: str | None = "docs/candidates.md") -> str:
    """Markdown capability table (README / `--help` text).  Each layout row
    cites its candidate documentation anchor (the format registry names
    double as autotune candidate ids); `docs_base=None` for plain text."""
    def _name(n: str) -> str:
        return f"[`{n}`]({docs_base}#{n})" if docs_base else f"`{n}`"

    rows = [
        "| format | mode-agnostic | sorted reduce | description |",
        "|--------|---------------|---------------|-------------|",
    ]
    rows.extend(
        f"| {_name(s.name)} | {'✓' if s.mode_agnostic else '—'} "
        f"| {'✓' if s.sorted_reduce else '—'} "
        f"| {s.description} |"
        for s in sorted(_REGISTRY.values(), key=lambda s: s.name)
    )
    return "\n".join(rows)


@register_format(
    "coo", mode_agnostic=True,
    description="baseline coordinate list (repro_torch.core.SparseTensor)")
def _build_coo(st: SparseTensor, mode: int = 0) -> SparseTensor:
    return st


@register_format(
    "csf", mode_agnostic=False, sorted_reduce=True,
    description="per-mode fiber trees; interior factor rows fetched once per fiber")
def _build_csf(st: SparseTensor, mode: int = 0) -> CSFModeTree:
    return build_csf_tree(st, mode)


@register_format(
    "alto", mode_agnostic=True,
    description="bit-interleaved linearized index, one copy serving all modes")
def _build_alto_fmt(st: SparseTensor, mode: int = 0) -> ALTOTensor:
    return build_alto(st)


# ---------------------------------------------------------------------------
# FormatStats — the layout statistics the cost model's byte terms consume.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FormatStats:
    """Layout-relevant statistics of one tensor.

    fiber_counts — per-mode CSF fiber count (distinct root+interior
                   prefixes under `csf_mode_order`).
    key_bits     — ALTO interleaved key width for the shape.
    key_words    — uint32 words the packed key occupies.
    measured     — True when counted from real coordinates, False for the
                   balls-in-bins estimate (`estimate`) used when only
                   (shape, nnz) survive — e.g. a persisted workload key.
    """

    shape: tuple[int, ...]
    nnz: int
    fiber_counts: tuple[int, ...]
    key_bits: int
    key_words: int
    measured: bool = True

    # -- index bytes per layout (what the cost model charges); the csf/alto
    # formulas delegate to the layouts' own single-source helpers ------------
    def coo_index_bytes(self) -> float:
        return 4.0 * self.nnz * len(self.shape)

    def csf_index_bytes(self, mode: int) -> float:
        """Index bytes of the mode-`mode` tree (`csf.csf_index_bytes`)."""
        return float(csf_index_bytes(self.nnz, len(self.shape),
                                     self.fiber_counts[mode]))

    def alto_index_bytes(self) -> float:
        return float(alto_index_bytes(self.nnz, self.key_words))

    @classmethod
    def from_tensor(cls, st: SparseTensor,
                    fiber_counts: tuple[int, ...] | None = None) -> FormatStats:
        """Exact statistics of `st`; `fiber_counts`, when given, are the
        fiber counts already known per mode (built trees' `n_fibers`)."""
        bits = alto_key_bits(st.shape)
        return cls(
            shape=st.shape,
            nnz=st.nnz,
            fiber_counts=(tuple(fiber_counts) if fiber_counts is not None
                          else tuple(fiber_count(st, m) for m in range(st.ndim))),
            key_bits=bits,
            key_words=max(1, -(-bits // 32)),
            measured=True,
        )

    @classmethod
    def estimate(cls, shape: tuple[int, ...], nnz: int) -> FormatStats:
        """Balls-in-bins fiber estimate from (shape, nnz) alone: `nnz`
        nonzeros thrown uniformly at the K = prod(prefix dims) possible
        fibers occupy K·(1 - (1 - 1/K)^nnz) of them in expectation.  Exact
        for nothing, consistent for everything — the cost model uses the
        same estimator at train and predict time whenever real counts are
        unavailable, so the two can never drift apart."""
        shape = tuple(int(d) for d in shape)
        counts = []
        for mode in range(len(shape)):
            root, mids, _inner = csf_mode_order(shape, mode)
            k = float(math.prod(shape[m] for m in (root, *mids)))
            if nnz == 0:
                occupied = 0
            elif k <= 1.0:
                occupied = 1
            else:
                # -k·expm1(nnz·log1p(-1/k)) = k·(1-(1-1/k)^nnz), stable for
                # k up to ~1e16 where the naive power underflows to 0.
                occupied = int(round(-k * math.expm1(nnz * math.log1p(-1.0 / k))))
            counts.append(max(min(occupied, nnz), 1 if nnz else 0))
        bits = alto_key_bits(shape)
        return cls(
            shape=shape,
            nnz=int(nnz),
            fiber_counts=tuple(min(c, nnz) for c in counts),
            key_bits=bits,
            key_words=max(1, -(-bits // 32)),
            measured=False,
        )

    # -- persistence (the reference's tuning store keeps it, schema v4) ----
    def to_json(self) -> dict:
        return {
            "shape": list(self.shape),
            "nnz": self.nnz,
            "fiber_counts": list(self.fiber_counts),
            "key_bits": self.key_bits,
            "key_words": self.key_words,
            "measured": self.measured,
        }

    @classmethod
    def from_json(cls, d: dict) -> FormatStats:
        return cls(
            shape=tuple(int(x) for x in d["shape"]),
            nnz=int(d["nnz"]),
            fiber_counts=tuple(int(x) for x in d["fiber_counts"]),
            key_bits=int(d["key_bits"]),
            key_words=int(d.get("key_words", 1)),
            measured=bool(d.get("measured", True)),
        )
