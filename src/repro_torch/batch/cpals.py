"""Batched CP-ALS: one ALS loop decomposing a whole bucket at once
(counterpart of `repro.batch.cpals`).

The math is member-wise the sequential `repro_torch.core.cp_als`: every
step (MTTKRP, Gram Hadamard, pinv solve, normalization, the sparse fit
identity) is the same computation with a leading batch axis, and each
member's factors start from `init_factors(member.shape, rank, seed)` — the
sequential initializer on the member's TRUE shape, zero-padded to the
bucket dims.  Padded factor rows receive zero MTTKRP contributions, solve
to zero, and never disturb column norms or grams, so the per-member results
follow the sequential path to float tolerance (not bit for bit: batched
and sequential solves and sums may round differently).

Where the sequential `cp_als` re-decides its engine per tensor, this loop
makes ONE decision per bucket (`tune.autotune_bucket`): the first member
probes, everyone after dispatches warm with zero probes.  Each iteration
ends in one device synchronisation (the `iter_times` barrier); the fits
stay on the device and are read back once per bucket.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..core.cpals import CPResult, _pinv, init_factors
from ..device import resolve_device
from ..engine.tunepolicy import TunePolicy
from ..obs.tracing import span
from .bucketing import Bucket, bucket_tensors, pad_bucket
from .tune import BucketPlanCache, autotune_bucket

__all__ = ["cp_als_batched"]


def _normalize_batched(f: torch.Tensor, norm: str):
    """Batched `core.cpals._normalize`: f (B, I, R) → (f/λ, λ (B, R))."""
    if norm == "linf":
        lam = f.abs().amax(dim=1)
    elif norm == "l2":
        lam = torch.linalg.vector_norm(f, dim=1)
    else:
        raise ValueError(norm)
    lam = torch.where(lam == 0, 1.0, lam)
    return f / lam[:, None, :], lam


def _gram(f: torch.Tensor) -> torch.Tensor:
    """(B, I, R) → (B, R, R) per-member FᵀF."""
    return torch.einsum("bir,bis->brs", f, f)


def _fit_batched(norm_x2, factors, lam, mlast):
    """Batched sparse fit identity (see `core.cpals.fit_value`):
    ||X - X̂||² = ||X||² - 2<X, X̂> + ||X̂||², with the <X, X̂> fast path from
    the last mode's MTTKRP output — every batched kernel is exact, so the
    fast path always qualifies.  Returns (B,) fits, on the device."""
    had = lam[:, :, None] * lam[:, None, :]
    for f in factors:
        had = had * _gram(f)
    norm_approx2 = had.sum(dim=(1, 2))
    inner = (mlast * (factors[-1] * lam[:, None, :])).sum(dim=(1, 2))
    resid = (norm_x2 - 2.0 * inner + norm_approx2).clamp_min(0.0)
    return 1.0 - resid.sqrt() / norm_x2.sqrt().clamp_min(1e-30)


def _diff_batched(values, mask, nnz, coords, factors, lam):
    """Nonzero-only mean |X - X̂| per member, masking the padded slots (the
    reconstruction is NOT zero at a padded slot's (0,...,0) coordinate, so
    the mask — not the padded values — keeps padding out of the metric).
    Returns (B,) on the device."""
    prod = lam[:, None, :]
    for m, f in enumerate(factors):
        idx = coords[:, :, m].to(torch.int64)[..., None].expand(-1, -1, f.shape[-1])
        prod = prod * torch.gather(f, 1, idx)
    recon = prod.sum(dim=2)
    return ((values - recon).abs() * mask).sum(dim=1) / nnz.clamp_min(1)


def _init_batched(bucket: Bucket, rank: int, seed: int) -> list[np.ndarray]:
    """Sequential-compatible init: each member draws
    `init_factors(member.shape, rank, seed)` — byte-identical to what
    `cp_als(member, rank, seed=seed)` starts from — zero-padded to the
    bucket dims and stacked over the batch axis.  The draw depends only on
    (shape, rank, seed), so members of one shape share one draw."""
    stacked = [np.zeros((bucket.size, dim, rank), dtype=np.float32) for dim in bucket.dims]
    by_shape: dict[tuple[int, ...], list[int]] = {}
    for i, t in enumerate(bucket.tensors):
        by_shape.setdefault(tuple(t.shape), []).append(i)
    for shape, idx in by_shape.items():
        for m, f in enumerate(init_factors(shape, rank, seed, device="cpu")):
            stacked[m][idx, : shape[m]] = f.numpy()
    return stacked


def cp_als_batched(
    tensors,
    rank: int,
    n_iters: int = 5,
    *,
    tune: TunePolicy | None = None,
    norm: str = "linf",
    seed: int = 0,
    track_diff: bool = False,
    plans: BucketPlanCache | None = None,
    device: str | torch.device | None = None,
) -> list[CPResult]:
    """Decompose many small tensors with one ALS loop per bucket, on
    `device` (None: the CUDA card, raising where there is none).

    Tensors are grouped by (shape class, nnz band) — see
    `repro_torch.batch.bucketing` — padded within each bucket, and driven
    through a batched MTTKRP chosen by ONE autotune decision per bucket
    (`tune=` carries the `TunePolicy`; with a `store` in the policy, the
    bucket's first-ever member probes and every later member — in any
    process — dispatches with zero probes).

    Returns one `CPResult` per input, in input order.  Per-result notes:
    `factors` and `lam` are the member's own tensors on the device (copies,
    so that a result does not keep its bucket alive); `engine` is the
    bucket's winning batched kernel (e.g. ``"batched:ref"``); `tune_report`
    is the BUCKET's report (shared by every member of the bucket —
    `n_probes` is the bucket's total, charged once, not per member); and
    `iter_times` are bucket-level wall-clock seconds (the whole batch's
    iteration, not a per-member share).  `diff_history` is tracked only when
    `track_diff=True` (off by default — it is a diagnostic pass over every
    nonzero per iteration) and uses the nonzero-only metric for every
    member.  Convergence `tol` is not supported: members of one batch would
    converge at different iterations.

    `plans` is an optional in-process `BucketPlanCache` so repeat
    dispatches of a decided bucket skip even the store read (the serving
    loop passes a per-service cache).
    """
    device = resolve_device(device)
    policy = tune if tune is not None else TunePolicy()
    buckets = bucket_tensors(tensors)
    results: list[CPResult | None] = [None] * sum(
        b.size for b in buckets.values())
    for bucket in buckets.values():
        for idx, res in zip(bucket.indices,
                            _decompose_bucket(bucket, rank, n_iters,
                                              policy=policy, norm=norm,
                                              seed=seed,
                                              track_diff=track_diff,
                                              plans=plans, device=device),
                            strict=True):
            results[idx] = res
    return results


def _decompose_bucket(
    bucket: Bucket,
    rank: int,
    n_iters: int,
    *,
    policy: TunePolicy,
    norm: str,
    seed: int,
    track_diff: bool,
    plans: BucketPlanCache | None,
    device: torch.device,
) -> list[CPResult]:
    pb = pad_bucket(bucket)
    bucket_sp = span("cp_als_batched.bucket", dims=list(pb.dims),
                     band=pb.band, size=pb.size, rank=rank, n_iters=n_iters)
    with bucket_sp:
        engine, report = autotune_bucket(pb, rank, policy, seed=seed,
                                         plans=plans, device=device)
        bucket_sp.set(engine=report.chosen, tune_source=report.source)
        n = len(pb.dims)

        factors = [torch.from_numpy(f).to(device)
                   for f in _init_batched(bucket, rank, seed)]
        lam = torch.ones((pb.size, rank), dtype=torch.float32, device=device)
        values = torch.from_numpy(pb.values).to(device)
        norm_x2 = (values * values).sum(dim=1)
        if track_diff:
            mask = torch.from_numpy(pb.mask).to(device)
            coords = torch.from_numpy(pb.coords).to(device)
            nnz = torch.tensor(pb.nnz, dtype=torch.float32, device=device)

        fits: list[torch.Tensor] = []
        diffs: list[torch.Tensor] = []
        iter_times: list[float] = []
        for it in range(n_iters):
            iter_sp = span("cp_als_batched.iter", iter=it)
            with iter_sp:
                t0 = time.perf_counter()
                for mode in range(n):
                    m = engine(factors, mode)
                    v = torch.ones((pb.size, rank, rank), dtype=torch.float32, device=device)
                    for k in range(n):
                        if k != mode:
                            v = v * _gram(factors[k])
                    factors[mode], lam = _normalize_batched(m @ _pinv(v), norm)
                    mlast = m
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                dt = time.perf_counter() - t0
                # Same measurement the CPResults report as iter_times.
                iter_times.append(dt)
                iter_sp.set(seconds=dt)
            fits.append(_fit_batched(norm_x2, factors, lam, mlast))
            if track_diff:
                diffs.append(_diff_batched(values, mask, nnz, coords, factors, lam))

    # One host readout per bucket: (B, n_iters) fits (and diffs).
    empty = [[] for _ in range(pb.size)]
    fit_rows = torch.stack(fits, dim=1).tolist() if fits else empty
    diff_rows = torch.stack(diffs, dim=1).tolist() if diffs else empty
    return [CPResult(
        factors=[factors[m][i, : t.shape[m]].clone() for m in range(n)],
        lam=lam[i].clone(),
        fit_history=fit_rows[i],
        diff_history=diff_rows[i],
        iter_times=list(iter_times),
        engine=report.chosen,
        quant_error=None,
        tune_report=report,
    ) for i, t in enumerate(bucket.tensors)]
