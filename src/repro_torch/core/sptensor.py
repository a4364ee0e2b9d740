"""Sparse tensor container + synthetic dataset generators (numpy, host side).

A copy of `repro.core.sptensor` that produces byte-identical arrays from the
same seed.  One change: `_dedup` merges duplicates through raveled int64
keys whenever the cell count fits in int64, which is several times faster
than the row-wise `np.unique(..., axis=0)` at tens of millions of nonzeros
and gives the same rows in the same order with the same sums.

The paper evaluates on FROSTT tensors (Table I).  `table1_tensor` generates
synthetic tensors whose mode count, relative dimension shape and nonzero
distribution (balanced vs imbalanced) match each Table-I entry, scaled down.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = [
    "SparseTensor",
    "random_tensor",
    "table1_tensor",
    "TABLE1",
]


@dataclasses.dataclass(frozen=True)
class SparseTensor:
    """COO sparse tensor. Coordinates are (nnz, N) int32, values (nnz,) f32."""

    coords: np.ndarray
    values: np.ndarray
    shape: tuple[int, ...]

    def __post_init__(self):
        if self.coords.ndim != 2 or self.coords.shape[1] != len(self.shape):
            raise ValueError(
                f"coords must be (nnz, {len(self.shape)}); got {self.coords.shape}")
        if self.values.shape != (self.coords.shape[0],):
            raise ValueError(
                f"values must be ({self.coords.shape[0]},); got {self.values.shape}")

    @property
    def nnz(self) -> int:
        return self.coords.shape[0]

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def density(self) -> float:
        return self.nnz / math.prod(self.shape)

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=np.float64)
        np.add.at(out, tuple(self.coords.T), self.values.astype(np.float64))
        return out.astype(np.float32)

    def norm(self) -> float:
        return float(np.linalg.norm(self.values.astype(np.float64)))


#: Collision top-up policy (see `random_tensor`): after this many exact-
#: shortfall rejection rounds, small tensors switch to an exact fill from
#: the not-yet-used cells; tensors too large to enumerate raise after the
#: round cap instead of hanging.
_TOPUP_EXACT_AFTER = 16
_TOPUP_EXACT_CELLS = 1 << 24
_TOPUP_MAX_ROUNDS = 1024


def _dedup(coords: np.ndarray, values: np.ndarray,
           shape: tuple[int, ...]) -> tuple[np.ndarray, np.ndarray]:
    """Merge duplicate coordinates by summing values (keeps COO canonical).

    Row-major raveled keys sort exactly as the rows do lexicographically, so
    the key path returns the rows of `np.unique(coords, axis=0)` in the same
    order, and `np.add.at` sums each group in the same draw order.  Shapes
    with 2**63 cells or more cannot ravel into int64 and take the row-wise
    unique instead."""
    if math.prod(shape) < 2**63:
        keys = np.ravel_multi_index(tuple(coords.T), shape)
        ukeys, inv = np.unique(keys, return_inverse=True)
        uniq = np.stack(np.unravel_index(ukeys, shape), axis=1)
    else:
        uniq, inv = np.unique(coords, axis=0, return_inverse=True)
    out = np.zeros(uniq.shape[0], dtype=values.dtype)
    np.add.at(out, inv.reshape(-1), values)
    return uniq.astype(np.int32), out


def random_tensor(
    shape: tuple[int, ...],
    nnz: int,
    *,
    distribution: str = "uniform",
    value_scale: float = 1.0,
    seed: int = 0,
    zipf_a: float = 1.3,
) -> SparseTensor:
    """Synthetic sparse tensor with EXACTLY `nnz` nonzeros (capped at the
    number of cells); the draws match `repro.core.random_tensor` exactly.

    distribution:
      "uniform"  — nonzeros spread evenly (the paper's "well-balanced").
      "powerlaw" — Zipf-distributed coordinates per mode (imbalanced).

    Duplicate draws are merged and the shortfall topped up with fresh draws
    until the target is met.
    """
    rng = np.random.default_rng(seed)
    shape = tuple(int(d) for d in shape)
    target = min(int(nnz), math.prod(shape))
    # Powerlaw scatter permutations are drawn once per mode and shared by
    # every draw batch, so top-ups hit the same hot rows as the first batch.
    perms = [rng.permutation(dim) if distribution == "powerlaw" else None
             for dim in shape]

    def draw(n: int) -> np.ndarray:
        cols = []
        for dim, perm in zip(shape, perms, strict=True):
            if distribution == "uniform":
                c = rng.integers(0, dim, size=n, dtype=np.int64)
            elif distribution == "powerlaw":
                raw = rng.zipf(zipf_a, size=n) - 1
                c = perm[np.minimum(raw, dim - 1)]
            else:
                raise ValueError(f"unknown distribution {distribution!r}")
            cols.append(c)
        return np.stack(cols, axis=1).astype(np.int32)

    def values_for(n: int) -> np.ndarray:
        return rng.uniform(-value_scale, value_scale, size=n).astype(np.float32)

    coords, values = _dedup(draw(int(nnz)), values_for(int(nnz)), shape)
    for rounds in range(_TOPUP_MAX_ROUNDS):
        if coords.shape[0] >= target:
            break
        need = target - coords.shape[0]
        # Rejection sampling stalls near the cell count (coupon collector);
        # such requests only arise on small, enumerable tensors, so fill the
        # shortfall exactly from the missing cells instead.
        if rounds >= _TOPUP_EXACT_AFTER and math.prod(shape) <= _TOPUP_EXACT_CELLS:
            missing = np.setdiff1d(
                np.arange(math.prod(shape), dtype=np.int64),
                np.ravel_multi_index(tuple(coords.T), shape).astype(np.int64),
                assume_unique=True)
            pick = rng.choice(missing, size=need, replace=False)
            extra = np.stack(np.unravel_index(pick, shape), axis=1).astype(np.int32)
        else:
            extra = draw(need)
        coords, values = _dedup(
            np.concatenate([coords, extra]),
            np.concatenate([values, values_for(need)]), shape)
    else:
        raise ValueError(
            f"random_tensor could not reach nnz={target} on shape {shape} "
            f"({distribution!r}) within {_TOPUP_MAX_ROUNDS} top-up rounds; "
            "lower nnz")
    return SparseTensor(coords, values, shape)


# Table I of the paper, scaled so the relative mode sizes and the balanced /
# imbalanced character survive at a few tens of thousands of nonzeros.
TABLE1: dict[str, dict] = {
    "nell2": dict(shape=(605, 460, 1440), nnz=50_000, distribution="uniform"),
    "nell1": dict(shape=(2900, 2100, 25500), nnz=60_000, distribution="powerlaw"),
    "amazon": dict(shape=(4800, 1800, 1800), nnz=60_000, distribution="uniform"),
    "delicious": dict(shape=(533, 17300, 2500, 140), nnz=40_000, distribution="powerlaw"),
    "lbnl": dict(shape=(160, 420, 160, 420, 868), nnz=30_000, distribution="powerlaw"),
    "5d_large": dict(shape=(10000, 1000, 3000, 4000, 500), nnz=80_000, distribution="uniform"),
}


def table1_tensor(name: str, *, seed: int = 0, nnz: int | None = None) -> SparseTensor:
    spec = TABLE1[name]
    return random_tensor(
        tuple(spec["shape"]),
        nnz if nnz is not None else spec["nnz"],
        distribution=spec["distribution"],
        seed=seed,
    )
