"""Bucketing: group small tensors whose geometry can share one batched
MTTKRP and one autotune decision (a numpy copy of `repro.batch.bucketing`
that gives byte-identical arrays).

Two tensors land in the same bucket iff they agree on

  * **shape class** — every dimension rounded up to the next power of two
    (`shape_class`).  Pow-2 rounding keeps the number of distinct padded
    geometries logarithmic in the dimension range while bounding the
    padding waste per dimension below 2x.
  * **nnz band** — the power-of-two band ``[2^k, 2^{k+1})`` holding the
    nonzero count (`nnz_band`; a count sitting exactly on a boundary
    ``2^k`` belongs to band ``k``, computed with integer ``bit_length`` so
    no float rounding can flip it).  Banding bounds the nonzero padding a
    member pays to the bucket maximum, and gives every member the same
    canonical tuning fingerprint (`tune.bucket_workload_key`).

Within a bucket, every member is zero-padded to the common geometry
(`pad_bucket`): coordinates pad with 0 and values with 0.0, so padded slots
contribute ``0 * F[0] * ...`` to every scatter-add/segment-sum MTTKRP —
a no-op — and factor rows beyond a member's true dimension stay exactly
zero through ALS (a zero MTTKRP row solves to a zero factor row; L-inf/L2
column norms are unaffected by extra zero rows).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.sptensor import SparseTensor

__all__ = [
    "Bucket",
    "BucketKey",
    "PaddedBatch",
    "bucket_tensors",
    "nnz_band",
    "pad_bucket",
    "shape_class",
]


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length() if n > 1 else 1


def shape_class(shape: tuple[int, ...]) -> tuple[int, ...]:
    """The bucket's common dimensions: each dim rounded up to a power of
    two (identity on dims that already are one)."""
    return tuple(_next_pow2(int(d)) for d in shape)


def nnz_band(nnz: int) -> int:
    """Band index k with ``2^k <= nnz < 2^{k+1}``; -1 for an all-zero
    tensor.  `bit_length` keeps the boundary exact: nnz=2^k is band k,
    nnz=2^k - 1 is band k-1."""
    if nnz < 0:
        raise ValueError(f"nnz must be >= 0 (got {nnz})")
    return int(nnz).bit_length() - 1


#: A bucket's identity: (shape class dims, nnz band index).
BucketKey = tuple[tuple[int, ...], int]


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One (shape class, nnz band) group of input tensors.

    `indices` are the members' positions in the original input list, so
    results can be scattered back into input order after the per-bucket
    dispatch."""

    dims: tuple[int, ...]        # shape class (pow-2 padded dims)
    band: int                    # nnz band index (nnz_band)
    tensors: tuple[SparseTensor, ...]
    indices: tuple[int, ...]

    @property
    def key(self) -> tuple[tuple[int, ...], int]:
        return (self.dims, self.band)

    @property
    def size(self) -> int:
        return len(self.tensors)


@dataclasses.dataclass(frozen=True)
class PaddedBatch:
    """A bucket materialized as batched arrays, ready for the batched kernels.

    coords — (B, P, N) int32, rows past a member's true nnz are 0.
    values — (B, P) float32, entries past a member's true nnz are 0.0
             (a zero value makes the padded slot a no-op in every
             scatter-add / segment-sum MTTKRP).
    mask   — (B, P) float32, 1.0 on true nonzeros, 0.0 on padding — for
             metrics that must not count the padded slots (diff tracking).
    nnz    — per-member true nonzero counts.
    """

    dims: tuple[int, ...]
    band: int
    coords: np.ndarray
    values: np.ndarray
    mask: np.ndarray
    shapes: tuple[tuple[int, ...], ...]   # members' true shapes
    nnz: tuple[int, ...]

    @property
    def size(self) -> int:
        return self.values.shape[0]

    @property
    def pad_nnz(self) -> int:
        return self.values.shape[1]


def _check_dtypes(tensors) -> None:
    """Reject mixed dtypes up front: `np.stack` would silently upcast a
    stray float64 member and every member would pay for it — and int64
    coordinates would defeat the device int32 contract."""
    vdtypes = sorted({str(t.values.dtype) for t in tensors})
    if len(vdtypes) > 1:
        raise TypeError(
            f"cp_als_batched: mixed value dtypes across the batch "
            f"({', '.join(vdtypes)}); cast every tensor's values to one "
            "dtype (float32) before batching")
    cdtypes = sorted({str(t.coords.dtype) for t in tensors})
    if len(cdtypes) > 1:
        raise TypeError(
            f"cp_als_batched: mixed coordinate dtypes across the batch "
            f"({', '.join(cdtypes)}); cast every tensor's coords to one "
            "dtype (int32) before batching")


def bucket_tensors(tensors) -> dict[tuple[tuple[int, ...], int], Bucket]:
    """Group `tensors` into buckets keyed by (shape class, nnz band).

    Every input must be a `SparseTensor`; all members of the batch must
    share one ndim-independent value dtype and one coordinate dtype
    (mixed dtypes raise `TypeError` — see `_check_dtypes`).  Buckets come
    back ordered by key so downstream dispatch is deterministic.
    """
    tensors = list(tensors)
    for i, t in enumerate(tensors):
        if not isinstance(t, SparseTensor):
            raise TypeError(
                f"cp_als_batched: input {i} is {type(t).__name__}, "
                "expected SparseTensor")
    if not tensors:
        return {}
    _check_dtypes(tensors)
    groups: dict[tuple[tuple[int, ...], int], list[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault((shape_class(t.shape), nnz_band(t.nnz)), []).append(i)
    return {
        key: Bucket(dims=key[0], band=key[1],
                    tensors=tuple(tensors[i] for i in idx),
                    indices=tuple(idx))
        for key, idx in sorted(groups.items())
    }


def pad_bucket(bucket: Bucket) -> PaddedBatch:
    """Materialize a bucket as batched, zero-padded host arrays.

    The nonzero dimension pads to the bucket's max member nnz (at least 1,
    so an all-zero bucket still has a non-degenerate kernel geometry).
    """
    b = bucket.size
    pad_nnz = max(1, *(t.nnz for t in bucket.tensors))
    n = len(bucket.dims)
    coords = np.zeros((b, pad_nnz, n), dtype=np.int32)
    values = np.zeros((b, pad_nnz), dtype=np.float32)
    mask = np.zeros((b, pad_nnz), dtype=np.float32)
    for i, t in enumerate(bucket.tensors):
        k = t.nnz
        coords[i, :k] = t.coords.astype(np.int32, copy=False)
        values[i, :k] = t.values.astype(np.float32, copy=False)
        mask[i, :k] = 1.0
    return PaddedBatch(
        dims=bucket.dims, band=bucket.band,
        coords=coords, values=values, mask=mask,
        shapes=tuple(t.shape for t in bucket.tensors),
        nnz=tuple(t.nnz for t in bucket.tensors))
