"""CP-ALS (paper Algorithm 1) with pluggable MTTKRP engines, in PyTorch
(counterpart of `repro.core.cpals`).

Everything except MTTKRP — Gram matrices, Hadamard products, the
pseudo-inverse solve, normalization, the fit — is dense float32 work on the
engine's device.  The engine is any backend name registered in
`repro_torch.engine` (`ref`, `alto`, `csf`, `chunked`, `kernel`, `fixed`,
`hetero`) or preset id (`"fixed:int15-12"`), `"auto"` (the autotuner:
it measures the eligible backends per (tensor, rank, mode) and dispatches
each mode to its winner; `tune=TunePolicy(...)` sets its knobs), an
`Engine` from `build_engine`, or a callable ``f(factors, mode) -> (I_mode, R)``.
When tracing is on (`repro_torch.obs`) the run emits `cp_als.decompose`
around the whole call after the engine is built; inside it `cp_als.init`
(the host draw of the initial factors), `cp_als.upload` (their copy to the
device, and the COO arrays' where the call reads them: its attribute `coo` is
`"resident"` where the engine's plan cache already holds them on the device,
`"copied"` where the call copies them, `"none"` where it reads none),
`cp_als.norm` (‖X‖², once a call: reduced on the device from the COO's
values, `where="device"`, or on the host where the call reads no COO,
`where="host"`), per iteration `cp_als.iter` with its `cp_als.mode` spans,
`cp_als.fit` and `cp_als.diff`, and for a lossy engine `cp_als.quant_error`;
the counters `cp_als.upload_bytes` and `cp_als.uploads` of
`obs.metrics.default_registry` count the bytes `cp_als.upload` copies and
the calls that copied them.

Normalization is L-infinity by default (paper §IV-C); L2 is available.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections.abc import Callable

import numpy as np
import torch

from ..device import resolve_device
from ..obs import metrics as _metrics
from ..obs.tracing import span, tracing_enabled
from .sptensor import SparseTensor

__all__ = [
    "CPResult",
    "avg_abs_diff",
    "cp_als",
    "fit_value",
    "init_factors",
    "reconstruct_nnz",
]


@dataclasses.dataclass
class CPResult:
    factors: list[torch.Tensor]
    lam: torch.Tensor
    fit_history: list[float]
    diff_history: list[float]
    iter_times: list[float]
    engine: str
    #: Measured MTTKRP relative error of the quantized (lossy) engine that
    #: produced the factors — the autotuner's per-mode error measurements
    #: when available, else one direct comparison against the float COO
    #: reference on the final factors.  None for exact engines.
    quant_error: float | None = None
    #: The autotuner's report (winners, timings, errors) when engine="auto"
    #: built the engine in this call (or a prebuilt autotuned engine was
    #: passed); None otherwise.
    tune_report: object | None = None


#: Values `init_factors` draws at a time into its float64 scratch (8 MiB).
_DRAW_SLICE = 1 << 20


def init_factors(shape, rank: int, seed: int = 0, *,
                 device: str | torch.device | None = None) -> list[torch.Tensor]:
    """Random init in [0, 1), drawn exactly as the reference draws it:
    `default_rng(seed).uniform(0, 1, (d, rank))` mode after mode, cast to
    float32.  `uniform(0, 1)` is `random()` (0 + 1·u, one draw a value), so
    the stream is filled slice by slice through one small float64 scratch
    straight into the float32 factors: the same bits without a float64 array
    of each factor's size (1.6 GB a call at FROSTT Delicious's size)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    scratch = np.empty(_DRAW_SLICE)
    out = []
    for d in shape:
        f = np.empty((d, rank), np.float32)
        flat = f.reshape(-1)
        for s in range(0, flat.size, _DRAW_SLICE):
            part = scratch[: min(_DRAW_SLICE, flat.size - s)]
            rng.random(out=part)
            flat[s : s + part.size] = part
        # repro-lint: disable=host-sync -- init: the factors are drawn on the host (byte-identical to the reference's draw) and uploaded once per decomposition
        out.append(torch.from_numpy(f).to(device))
    return out


def _upload_factors(host: list[torch.Tensor], device: torch.device) -> list[torch.Tensor]:
    """`init_factors(..., device="cpu")`'s factors on `device`."""
    # repro-lint: disable=host-sync -- the factors are CPU tensors: `.numpy()` is a view of their memory, no transfer
    arrays = [f.numpy() for f in host]
    # repro-lint: disable=host-sync -- init: the factors drawn on the host are uploaded once per decomposition
    return [torch.from_numpy(a).to(device) for a in arrays]


def _normalize(f: torch.Tensor, norm: str):
    if norm == "linf":
        lam = f.abs().amax(dim=0)
    elif norm == "l2":
        lam = torch.linalg.vector_norm(f, dim=0)
    else:
        raise ValueError(norm)
    lam = torch.where(lam == 0, 1.0, lam)
    return f / lam, lam


def _pinv(v: torch.Tensor) -> torch.Tensor:
    """Pseudo-inverse of the (..., R, R) Gram Hadamard products with the
    cutoff of `jnp.linalg.pinv`: the hand-written kernel on the card (no host
    synchronisation), torch's SVD on the CPU (`kernels.gram_pinv`)."""
    from ..kernels.gram_pinv import gram_pinv  # the kernels package imports core

    return gram_pinv(v)


def _coo_tensors(st: SparseTensor, device: torch.device):
    # repro-lint: disable=host-sync -- bare-callable engine, which brings no plan cache: the COO arrays are uploaded once per decomposition, for the fit and diff
    return (torch.from_numpy(st.coords).to(device), torch.from_numpy(st.values).to(device))


def _call_coo(eng, st: SparseTensor, device: torch.device, upload_sp):
    """The COO arrays on `device` for one call, and the bytes the call copied
    for them.  They come from the engine's plan cache, which keeps them on the
    device while `st` lives (`coo="resident"` on `upload_sp`, or `"copied"` on
    the cache's first request); a bare callable brings no plan cache, so the
    call copies them for itself (`"copied"`)."""
    plans = getattr(getattr(eng, "context", None), "plans", None)
    if plans is None:
        coo, how = _coo_tensors(st, device), "copied"
    else:
        misses = plans.stats.coo_misses
        coo = plans.device_coo(st, device)
        how = "copied" if plans.stats.coo_misses > misses else "resident"
    upload_sp.set(coo=how)
    return coo, sum(t.nbytes for t in coo) if how == "copied" else 0


def _count_upload(nbytes: int) -> None:
    """A traced call's copies in `obs.metrics.default_registry`: the counter
    `cp_als.upload_bytes` adds their bytes and `cp_als.uploads` the call, so
    that a reader can tell one traced window's bytes from earlier windows'."""
    _metrics.default_registry.counter("cp_als.upload_bytes").inc(nbytes)
    _metrics.default_registry.counter("cp_als.uploads").inc()


def reconstruct_nnz(factors, lam, coords) -> torch.Tensor:
    """x̂ at the given coordinates: Σ_r λ_r ∏_m F_m[c_m, r]."""
    prod = lam[None, :]
    for m, f in enumerate(factors):
        prod = prod * f.index_select(0, coords[:, m])
    return prod.sum(dim=1)


def avg_abs_diff(st: SparseTensor, factors, lam, *, dense_limit: int = 1 << 22,
                 coo=None) -> float:
    """Paper Fig. 6 metric: mean |X - X̂| over all elements when the tensor is
    small enough (and has at most 7 modes), else over the nonzeros only.
    `coo` is (coords, values) already on the factors' device, to spare a
    copy per call."""
    device = lam.device
    if math.prod(st.shape) <= dense_limit and st.ndim <= 7:
        # repro-lint: disable=host-sync -- diagnostic API: the dense tensor (at most dense_limit cells) is uploaded per call, as the reference's jnp.asarray does; the readout below syncs anyway
        dense = torch.from_numpy(st.to_dense()).to(device)
        letters = "abcdefg"[: st.ndim]
        sub = ",".join(f"{c}r" for c in letters)
        approx = torch.einsum(f"r,{sub}->{letters}", lam, *factors)
        # repro-lint: disable=host-sync -- diagnostic API returning a host scalar; cp_als reads it once per iteration only with track_diff, after the iteration's timed barrier
        return float((dense - approx).abs().mean())
    coords, values = coo if coo is not None else _coo_tensors(st, device)
    approx = reconstruct_nnz(factors, lam, coords)
    # repro-lint: disable=host-sync -- diagnostic API returning a host scalar; cp_als reads it once per iteration only with track_diff, after the iteration's timed barrier
    return float((values - approx).abs().mean())


def _sum_squares(values: torch.Tensor) -> torch.Tensor:
    """||X||² of the uploaded float32 values as a 0-d float64 tensor on their
    device, squared and summed in float64 with no host synchronisation: the
    hand-written kernel on the card, the plain version on the CPU
    (`kernels.sum_squares`)."""
    from ..kernels.sum_squares import sum_squares  # the kernels package imports core

    return sum_squares(values)


def fit_value(st: SparseTensor, factors, lam, mlast=None, last_mode=None, *,
              coo=None, norm_x2=None) -> float:
    """fit = 1 - ||X - X̂||_F / ||X||_F, using the sparse identity
    ||X - X̂||² = ||X||² - 2<X, X̂> + ||X̂||².  With `mlast`, the last mode's
    MTTKRP output, <X, X̂> = Σ λ_r Σ_i M[i,r]·F_last[i,r] skips the O(nnz·R)
    reconstruction (exact engines only).  `norm_x2` is ||X||², a constant of
    the tensor that `cp_als` computes once a call: a host float, or a 0-d
    float64 device tensor (`_sum_squares`) read back with the residual;
    None computes it here on the host (`st.norm() ** 2`).  The residual is
    float32 on the factors' device, ||X||² entering it rounded to float32;
    the last step is float64 on the host.  One host readout."""
    if norm_x2 is None:
        norm_x2 = st.norm() ** 2
    had = lam[:, None] * lam[None, :]
    for f in factors:
        had = had * (f.T @ f)
    norm_approx2 = had.sum()
    if mlast is not None and last_mode is not None:
        inner = (mlast * (factors[last_mode] * lam[None, :])).sum()
    else:
        coords, values = coo if coo is not None else _coo_tensors(st, lam.device)
        inner = torch.dot(reconstruct_nnz(factors, lam, coords), values)
    if isinstance(norm_x2, torch.Tensor):
        resid = norm_x2.to(torch.float32) - 2.0 * inner + norm_approx2
        # repro-lint: disable=host-sync -- fit is a host scalar by contract: one fused readout per iteration (the residual with the float64 ||X||²), after the iteration's timed barrier
        resid, norm_x2 = torch.stack((resid.to(torch.float64), norm_x2)).tolist()
    else:
        # repro-lint: disable=host-sync -- fit is a host scalar by contract: one fused readout per iteration, after the iteration's timed barrier
        resid = float(norm_x2 - 2.0 * inner + norm_approx2)
    resid = max(resid, 0.0)
    return 1.0 - math.sqrt(resid) / max(math.sqrt(norm_x2), 1e-30)


def _engine_device(eng, device) -> torch.device:
    """The device a prebuilt engine runs on; a conflicting `device` raises."""
    ctx = getattr(eng, "context", None)
    if ctx is None:
        return resolve_device(device)
    if device is not None and torch.device(device) != ctx.device:
        raise ValueError(f"engine {eng.name!r} runs on {ctx.device}, not {device}")
    return ctx.device


def _exact_mttkrp(eng) -> bool:
    """True when the engine's MTTKRP output is the exact float operand, so
    the fit fast path (inner product from `mlast`) matches the slow path.
    Lossy backends (fixed point, by name or preset id) and lock-free
    collision dropping give approximate MTTKRPs, whose noise must not bias
    the reported fit; an autotuned engine qualifies when every winner it
    dispatches to is lossless; a bare callable is unknown, so it does not."""
    ctx = getattr(eng, "context", None)
    if ctx is not None and ctx.lockfree_mode:
        return False
    spec = getattr(eng, "spec", None)
    if spec is not None:
        return spec.lossless
    report = getattr(eng, "report", None)
    if report is not None:  # autotuned: every dispatched winner must be exact
        from ..engine import candidate_lossless
        return all(candidate_lossless(n) for n in set(report.winners.values()))
    return False


def _lossy_winners(eng) -> list[str]:
    """The quantized candidates an engine dispatches to: the spec itself for
    an explicit lossy engine, the lossy subset of the autotuned winners."""
    spec = getattr(eng, "spec", None)
    if spec is not None:
        return [] if spec.lossless else [eng.name]
    report = getattr(eng, "report", None)
    if report is not None:
        from ..engine import candidate_lossless
        return [n for n in sorted(set(report.winners.values()))
                if not candidate_lossless(n)]
    return []


def _measured_quant_error(eng, lossy: list[str], st: SparseTensor, factors, mlast,
                          coo) -> float:
    """Measured MTTKRP relative error of a lossy engine, for CPResult.

    Prefers the autotuner's per-mode error probes (measured against the
    float reference during tuning); without them, compares the engine's
    output in the last mode (for an autotuned engine: the last mode a lossy
    winner serves) against the float COO reference on the final factors.
    The last mode's MTTKRP does not read the last factor, so the final
    iteration's output `mlast` is the engine's output on the final factors:
    reusing it spares one launch.  `lossy` is `_lossy_winners(eng)`, not
    empty."""
    report = getattr(eng, "report", None)
    mode = st.ndim - 1
    if report is not None:
        errs = [e for n in lossy for e in getattr(report, "errors", {}).get(n, {}).values()]
        if errs:
            return max(errs)
        # No recorded errors (a lossy candidate admitted with no budget):
        # measure a mode the lossy winner serves — the dispatcher may route
        # other modes to a lossless backend.
        mode = max(m for m, w in report.winners.items() if w in lossy)
    from .mttkrp import mttkrp_coo
    out = mlast if mlast is not None and mode == st.ndim - 1 else eng(factors, mode)
    coords, values = coo
    ref = mttkrp_coo(factors, coords, values, mode=mode, out_dim=st.shape[mode])
    # repro-lint: disable=host-sync -- one-shot quant-error readout after tuning, reported on CPResult; never in the iteration loop
    return float(torch.linalg.vector_norm(out - ref) / (torch.linalg.vector_norm(ref) + 1e-30))


def cp_als(
    st: SparseTensor,
    rank: int,
    n_iters: int = 5,
    *,
    engine: str | Callable = "ref",
    norm: str = "linf",
    seed: int = 0,
    track_diff: bool = True,
    tol: float | None = None,
    device: str | torch.device | None = None,
    tune=None,
    **engine_kwargs,
) -> CPResult:
    """Decompose `st` into `rank` components by alternating least squares.

    `device` None means the CUDA card (and raises where there is none);
    a prebuilt engine brings its own.  `tune` is a
    `repro_torch.engine.TunePolicy` bundling the autotuner's knobs
    (candidates, warmup, reps, store, prior, max_probes, elide,
    elide_margin, accuracy_budget); its `accuracy_budget` (with
    engine="auto") admits the fixed-point preset candidates, each held to
    that max per-mode MTTKRP relative error.  The nine tuning keywords are
    still accepted inside `engine_kwargs` as deprecated shims (one
    `DeprecationWarning` per call folds them into the policy); the rest
    must be `build_engine` options (mem_bytes, chunk_shape, capacity,
    fixed_preset, lockfree_mode, dense_fraction, plans, formats,
    autotune_modes — unknown keywords raise a `TypeError` naming the
    nearest valid spelling).

    Each iteration ends in one device synchronisation, so `iter_times` holds
    finished work, and the fit adds one host readout.  A lossy engine
    (fixed point) keeps the factors-only fit and reports `quant_error`."""
    from ..engine import build_engine, validate_engine_kwargs
    from ..engine.tunepolicy import TunePolicy, split_tune_kwargs

    legacy = split_tune_kwargs(engine_kwargs)
    validate_engine_kwargs("cp_als", engine_kwargs, extra=("autotune_modes",))
    policy = TunePolicy.resolve(tune, caller="cp_als", **legacy)
    if callable(engine):
        if policy.accuracy_budget is not None:
            raise ValueError(
                "accuracy_budget only applies to engine='auto'; a prebuilt "
                "engine has already made its format decision")
        if engine_kwargs:
            raise TypeError(f"engine options {sorted(engine_kwargs)} need an engine name")
        eng = engine
        device = _engine_device(eng, device)
        eng_name = getattr(engine, "name", None) or getattr(engine, "__name__", "custom")
    else:
        eng = build_engine(st, engine, rank, tune=policy, device=device, **engine_kwargs)
        device = eng.context.device
        eng_name = eng.name  # e.g. "chunked", "auto:hetero"

    n = st.ndim
    fit_fast = _exact_mttkrp(eng)
    fit_history, diff_history, iter_times = [], [], []
    prev_fit = -np.inf
    mlast = None
    quant_error = None
    decompose_sp = span("cp_als.decompose", engine=eng_name, shape=list(st.shape),
                        nnz=int(st.nnz), rank=rank, n_iters=n_iters)
    with decompose_sp:
        # Drawn on the host first, so that the draw and the copies time apart.
        with span("cp_als.init"):
            host = init_factors(st.shape, rank, seed, device="cpu")
        with span("cp_als.upload") as upload_sp:
            factors = _upload_factors(host, device)
            if fit_fast and not track_diff:
                coo, coo_bytes = None, 0
                upload_sp.set(coo="none")
            else:
                coo, coo_bytes = _call_coo(eng, st, device, upload_sp)
            if tracing_enabled():
                _count_upload(sum(t.nbytes for t in factors) + coo_bytes)
        del host
        # ‖X‖² once a call, on the device where the values are.
        with span("cp_als.norm", where="host" if coo is None else "device"):
            norm_x2 = st.norm() ** 2 if coo is None else _sum_squares(coo[1])
        lam = torch.ones((rank,), dtype=torch.float32, device=device)
        for it in range(n_iters):
            iter_sp = span("cp_als.iter", iter=it)
            with iter_sp:
                t0 = time.perf_counter()
                for mode in range(n):
                    # Mode spans bound host dispatch only: the device
                    # synchronisation sits at the iteration's end.
                    with span("cp_als.mode", mode=mode):
                        m = eng(factors, mode)
                        # A = M (∘_{k≠mode} F_kᵀF_k)†  (Alg. 1 l.5-7)
                        v = torch.ones((rank, rank), dtype=torch.float32, device=device)
                        for k in range(n):
                            if k != mode:
                                v = v * (factors[k].T @ factors[k])
                        a, lam = _normalize(m @ _pinv(v), norm)
                        factors[mode] = a
                        mlast = m
                if device.type == "cuda":
                    # repro-lint: disable=host-sync -- timing barrier: iter_times must measure completed device work, not dispatch
                    torch.cuda.synchronize(device)
                dt = time.perf_counter() - t0
                # One measurement, two views: `iter_times` and the span's
                # `seconds` attribute carry the same number.
                iter_times.append(dt)
                iter_sp.set(seconds=dt)

            with span("cp_als.fit", iter=it, fast=fit_fast):
                f = fit_value(st, factors, lam,
                              mlast=mlast if fit_fast else None,
                              last_mode=n - 1 if fit_fast else None, coo=coo,
                              norm_x2=norm_x2)
            fit_history.append(f)
            if track_diff:
                with span("cp_als.diff", iter=it):
                    diff_history.append(avg_abs_diff(st, factors, lam, coo=coo))
            if tol is not None and abs(f - prev_fit) < tol:
                break
            prev_fit = f
        decompose_sp.set(fit=fit_history[-1] if fit_history else None)
        lossy = _lossy_winners(eng)
        if lossy:
            with span("cp_als.quant_error"):
                quant_error = _measured_quant_error(eng, lossy, st, factors, mlast, coo)

    return CPResult(factors, lam, fit_history, diff_history, iter_times, eng_name, quant_error,
                    tune_report=getattr(eng, "report", None))
