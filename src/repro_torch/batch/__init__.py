"""Batched many-small-tensor CP-ALS on the port (counterpart of
`repro.batch`).

The paper targets one large sparse tensor per spMTTKRP invocation; the
production scenario is the opposite — millions of *small* per-user tensors
(arxiv 2503.18198 accelerates exactly this regime by batching many small
decompositions onto one device).  This package:

  1. buckets incoming tensors by (shape class, nnz band) — `bucketing`;
  2. zero-pads every member to the bucket's common geometry (padded values
     are 0.0, a no-op in every scatter-add MTTKRP) — `bucketing`;
  3. runs the whole bucket's MTTKRP as one set of tensor ops over the
     flattened batch — `kernels` (plain PyTorch: the reference vmaps plain
     ops there, no Pallas kernel);
  4. makes ONE autotune decision per bucket: the first member probes, every
     later member (and every later process) hits the `TuningStore`
     fingerprint with zero probes — `tune`;
  5. runs the whole bucket through one batched CP-ALS — `cpals` — whose
     per-member factors follow the sequential `cp_als` path to float
     tolerance (padding rows are zero and never disturb grams, norms, or
     the fit identity).

Everything runs on the CUDA card unless the caller passes
``device="cpu"``.  Public surface: `cp_als_batched` (also re-exported from
`repro_torch.core` and `repro_torch`), plus the bucketing/tuning primitives
the serving loop (`repro_torch.serve`) composes.
"""
from __future__ import annotations

from .bucketing import (
    Bucket,
    BucketKey,
    PaddedBatch,
    bucket_tensors,
    nnz_band,
    pad_bucket,
    shape_class,
)
from .cpals import cp_als_batched
from .kernels import batched_kernel_names, build_batched_kernel
from .tune import BucketPlanCache, autotune_bucket, bucket_workload_key

__all__ = [
    "Bucket",
    "BucketKey",
    "BucketPlanCache",
    "PaddedBatch",
    "autotune_bucket",
    "batched_kernel_names",
    "bucket_tensors",
    "bucket_workload_key",
    "build_batched_kernel",
    "cp_als_batched",
    "nnz_band",
    "pad_bucket",
    "shape_class",
]
