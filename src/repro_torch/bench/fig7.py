"""Paper Fig. 7 — spMTTKRP execution time + peak-performance fraction across
implementations, all modes, rank 10 (counterpart of `benchmarks/fig7.py`).

Device roles on the card: the PRISM chunked engine plays UPMEM PIM, through
the plain PyTorch ops (`chunked`) and through the hand-written CUDA kernel
(`kernel`, the JAX suite's `pallas` backend); the fixed-point kernel (paper
Alg. 2, int7); the paper's heterogeneous split (`hetero`); the ALTO
linearized format plays the CPU baseline, CSF fiber trees the
tree-compressed CPU layout, plain COO scatter the GPU (BLCO) baseline; and
the autotuner picks among them.  The row labels of the roles the JAX suite
also times are its own.  Peak-performance fraction is useful FLOPs / (time
× the H100's float32 peak, `roofline.H100_SXM5`), beside the least time the
function's bytes take at the card's memory rate; a CPU run reports no
fraction (the port has no host peak).  `engine_rows` times one prebuilt
tensor, so a caller that already holds a large tensor's chunking and
layouts (case (a), NELL-2 at its published size) reuses them.
"""
from __future__ import annotations

import os
import tempfile
import time

import torch

from ..core import decide_partition, init_factors, random_tensor, table1_tensor
from ..engine import (
    CalibratedPrior,
    CalibrationError,
    PlanCache,
    TunePolicy,
    TuningStore,
    build_engine,
    default_prior,
    device_fingerprint,
    ranking_accuracy,
)
from ..formats import FormatCache
from ..roofline import H100_SXM5
from .common import save, table, timeit

RANK = 10
TABLE1_MEM = 256 * 1024
TENSORS = ["nell2", "nell1", "amazon", "delicious", "lbnl", "5d_large"]
FAST_TENSORS = ["nell2", "delicious"]
#: (row label, backend).  `prism-kernel` is the hand-written CUDA kernel,
#: the counterpart of the JAX suite's `pallas` backend, which that suite
#: does not time; `prism-hetero` the paper's split.
ENGINES = [("prism-chunked", "chunked"), ("prism-kernel", "kernel"),
           ("prism-fixed", "fixed"), ("prism-hetero", "hetero"),
           ("alto-cpu", "alto"), ("csf-fiber", "csf"),
           ("coo-gpu-style", "ref"), ("autotuned", "auto")]
#: Keys a row carries beyond the JAX suite's.
PORT_KEYS = ("device", "time_per_mode_ms", "bytes_bound_ms")
#: Case (a): NELL-2's published dims and nonzeros, uniform, seed 0, under
#: the 256 KiB plan of examples/decompose_tensor.py.
NELL2_A = dict(shape=(12092, 9184, 28818), nnz=76_879_419, distribution="uniform")


def mttkrp_flops(st, rank: int) -> float:
    # per nonzero: (N-1) hadamard mults + 1 value mult + 1 add, × rank
    return st.nnz * rank * (st.ndim + 1.0)


def mttkrp_bytes(st, rank: int, mode: int) -> int:
    """Bytes one mode's MTTKRP must move: each nonzero's int32 coordinates
    and float32 value read once, each input factor read once, the (I_mode,
    R) output written once (`chip_smoke.kernel_bound`'s count, with the
    full output in place of the kernel's per-task partials)."""
    n = st.ndim
    return (st.nnz * (4 * n + 4)
            + sum(st.shape[m] * rank * 4 for m in range(n) if m != mode)
            + st.shape[mode] * rank * 4)


def case_a_tensor():
    return random_tensor(NELL2_A["shape"], NELL2_A["nnz"],
                         distribution=NELL2_A["distribution"], seed=0)


def case_a_chunking(st) -> dict:
    """The chunking examples/decompose_tensor.py builds: the Fig. 5
    decider's plan for 256 KiB with the rank axis at R."""
    plan = decide_partition(st, RANK, mem_bytes=TABLE1_MEM, rank_axis=RANK)
    return dict(chunk_shape=plan.chunk_shape, capacity=plan.capacity)


def engine_rows(label: str, st, *, chunking: dict, plans: PlanCache, formats: FormatCache,
                tstore: TuningStore, device: torch.device, iters: int) -> list[dict]:
    """One row per engine on the prebuilt tensor `st`: every engine built
    with `chunking` (engine options: `mem_bytes`, or `chunk_shape` and
    `capacity`) on one plan cache and one format cache, as in a real CP-ALS
    run; `auto` tuned cold and then warm against `tstore`."""
    factors = init_factors(st.shape, RANK, 0, device=device)
    flops = mttkrp_flops(st, RANK)
    bound_ms = 1e3 * sum(mttkrp_bytes(st, RANK, m) for m in range(st.ndim)) / H100_SXM5.hbm_bw
    opts = dict(chunking, plans=plans, formats=formats, device=device)
    rows = []
    for ename, engine in ENGINES:
        extra = {}
        if engine == "auto":
            t0 = time.perf_counter()
            eng = build_engine(st, engine, RANK, tune=TunePolicy(store=tstore), **opts)
            tune_s = time.perf_counter() - t0
            # Re-build against the now-warm store: the fingerprint hit
            # must skip every probe, so warm tuning overhead ≈ build.
            t0 = time.perf_counter()
            warm = build_engine(st, engine, RANK, tune=TunePolicy(store=tstore), **opts)
            warm_s = time.perf_counter() - t0
            extra = dict(
                tune_ms=tune_s * 1e3,
                tune_probes=eng.report.n_probes,
                tune_source=eng.report.source,
                tune_warm_ms=warm_s * 1e3,
                tune_warm_probes=warm.report.n_probes,
            )
            print(f"[fig7] {label} tuning: {eng.report.source} "
                  f"probes={eng.report.n_probes} ({extra['tune_ms']:.2f}ms) "
                  f"→ warm probes={warm.report.n_probes} "
                  f"({extra['tune_warm_ms']:.2f}ms)", flush=True)
        else:
            eng = build_engine(st, engine, RANK, **opts)
        per_mode = [timeit(eng, factors, mode, device=device, warmup=1, iters=iters)
                    for mode in range(st.ndim)]
        total = sum(per_mode)
        frac = (f"{flops * st.ndim / (total * H100_SXM5.peak_flops):.2e}"
                if device.type == "cuda" else None)
        rows.append(dict(
            tensor=label, engine=eng.name if engine == "auto" else ename,
            time_all_modes_ms=total * 1e3,
            peak_fraction=frac,
            device=str(device),
            time_per_mode_ms=[t * 1e3 for t in per_mode],
            bytes_bound_ms=bound_ms,
            **extra,
        ))
        print(f"[fig7] {label} {rows[-1]['engine']}: "
              f"{rows[-1]['time_all_modes_ms']:.4f}ms", flush=True)
    return rows


def prior_eval(tstore: TuningStore, tensors: list[str], fast: bool, *,
               device: torch.device) -> dict:
    """Calibrated-vs-default prior scorecard over the store the suite just
    populated, plus a store-less elided cold start per tensor (the
    calibrated prior decides most modes from one anchor probe; only
    boundary candidates re-probe).  On the card the scorecard is for
    reading: the analytic prior ranks the candidates nearly in reverse of
    what the card measures."""
    fingerprint = device_fingerprint(device)
    try:
        calib = CalibratedPrior.from_store(tstore, device=fingerprint)
    except CalibrationError as e:
        print(f"[fig7] prior calibration unavailable: {e}")
        # Always (over)write the scorecard: a reader must see *this* run's
        # outcome, not a stale payload from a previous run.
        save("fig7_prior", {})
        return {}
    for line in calib.calibration.summary().splitlines():
        print(f"[fig7] {line}")
    calib_hits, decisions = ranking_accuracy(tstore, calib, device=fingerprint)
    default_hits, _ = ranking_accuracy(tstore, default_prior, device=fingerprint)
    rows = []
    for tname in tensors:
        st = table1_tensor(tname, nnz=8000 if fast else None)
        # Two store-less cold starts back to back: a full probe sweep as the
        # live baseline, then the elided run under the calibrated prior.
        plans = PlanCache()
        full = build_engine(st, "auto", RANK, mem_bytes=TABLE1_MEM, plans=plans, device=device,
                            tune=TunePolicy(prior="default", elide=False))
        # elide=True with a fixed moderate margin: this is the elision
        # demonstration, and must exercise the mechanism even when the
        # production margin saturates or the guard kept analytic coefficients.
        eng = build_engine(st, "auto", RANK, mem_bytes=TABLE1_MEM, plans=plans, device=device,
                           tune=TunePolicy(prior=calib, elide=True, elide_margin=1.35))
        rep = eng.report
        agree = ok = 0
        for mode, fwin in full.report.winners.items():
            picked = rep.winners.get(mode)
            agree += picked == fwin
            # A pick is ok when it matches, or when the full sweep's own
            # timings put it within 2x of its winner.
            per = {b: t[mode] for b, t in full.report.timings.items() if mode in t}
            ok += (picked == fwin
                   or (picked in per and per[picked] <= 2.0 * per[fwin]))
        rows.append(dict(
            tensor=tname, prior=rep.prior_name,
            probes_full=full.report.n_probes, probes_elided=rep.n_probes,
            n_elided=rep.n_elided,
            winners_agree=f"{agree}/{st.ndim}",
            winners_ok=ok == st.ndim,
        ))
        print(f"[fig7] {tname} elided cold start: {rep.n_probes} probes vs "
              f"{full.report.n_probes} full sweep, winners agree "
              f"{agree}/{st.ndim}", flush=True)
    payload = dict(
        accuracy=dict(calibrated=calib_hits, default=default_hits, decisions=decisions),
        residual=dict(mean_rel_err=calib.calibration.mean_rel_err,
                      max_rel_err=calib.calibration.max_rel_err,
                      n_observations=calib.calibration.n_observations),
        fitted=calib.calibration.fitted,
        fallbacks=list(calib.calibration.fallbacks),
        tensors=rows,
    )
    print(f"\n== Fig. 7 prior scorecard: calibrated top-1 "
          f"{calib_hits}/{decisions} vs default {default_hits}/{decisions} ==")
    print(table(rows, ["tensor", "prior", "probes_full", "probes_elided",
                       "n_elided", "winners_agree", "winners_ok"]))
    save("fig7_prior", payload)
    return payload


def run(fast: bool = False, store: str | TuningStore | None = None, *,
        device: torch.device, case_a: bool = False):
    """`store` — autotune persistence path shared with the CLI (None → an
    ephemeral per-invocation store, so numbers never depend on hidden
    machine state).  Each tensor's `auto` engine is built twice against
    that store, cold then warm.  `case_a` adds the rows of NELL-2 at its
    published size under the 256 KiB plan (minutes of host set-up: the
    chunking and the ALTO and CSF layouts)."""
    if isinstance(store, TuningStore):
        tstore = store
    elif store is None:
        tstore = TuningStore(os.path.join(tempfile.mkdtemp(prefix="repro-torch-fig7-"),
                                          "autotune.json"))
    else:
        tstore = TuningStore(store)
    tensors = FAST_TENSORS if fast else TENSORS
    rows = []
    for tname in tensors:
        st = table1_tensor(tname, nnz=8000 if fast else None)
        rows += engine_rows(tname, st, chunking=dict(mem_bytes=TABLE1_MEM), plans=PlanCache(),
                            formats=FormatCache(), tstore=tstore, device=device,
                            iters=2 if fast else 3)
    if case_a:
        st = case_a_tensor()
        rows += engine_rows("nell2-a", st, chunking=case_a_chunking(st), plans=PlanCache(),
                            formats=FormatCache(), tstore=tstore, device=device, iters=3)
    shown = [{**r, "time_all_modes_ms": f"{r['time_all_modes_ms']:.4f}",
              "bytes_bound_ms": f"{r['bytes_bound_ms']:.4f}",
              **{k: f"{r[k]:.2f}" for k in ("tune_ms", "tune_warm_ms") if k in r}}
             for r in rows]
    print("\n== Fig. 7: spMTTKRP time + peak-performance fraction ==")
    print(table(shown, ["tensor", "engine", "time_all_modes_ms", "bytes_bound_ms",
                        "peak_fraction", "tune_ms", "tune_warm_ms"]))
    save("fig7", rows)
    # The store now holds this run's measurements: score the calibrated
    # prior against them and demonstrate cross-mode elision per tensor.
    prior_eval(tstore, tensors, fast, device=device)
    return rows

