"""Serving benchmark: batched decomposition service vs a sequential loop
(counterpart of `benchmarks/serve_bench.py`).

Drives synthetic concurrent load — many small sparse tensors across a few
(shape class, nnz band) buckets — through three paths:

  sequential — `cp_als` one tensor at a time (the pre-batching baseline);
  batched    — one `cp_als_batched` call over the whole set;
  service    — `DecomposeService` under concurrent client threads, with
               request coalescing, measuring per-request latency.

Reports throughput (tensors/s, host clock; the card's paths synchronise
before the clock stops), p50/p99 request latency for the service path,
per-path probe counts, and per-tensor parity between the batched and
sequential paths.  The parity gate is the port's member rule: factors and
λ/max(1, |λ|) within max(1e-5, κ·2^-17), fits within max(1e-6, κ·2^-20)
per iteration, κ the condition number of the Gram Hadamard product an
update inverts (`solve_kappa`).  Batched and sequential runs round
differently and ALS magnifies that by κ, so the JAX suite's flat 1e-5 fails
for a few percent of members at scale; the rule is never looser than it.
JSON lands in `results/bench/torch_serve_bench.json`.

  PYTHONPATH=src python -m repro_torch.bench.serve_bench --fast \
      --store "$TMPDIR/serve-store.json"
"""
from __future__ import annotations

import argparse
import threading
import time

import numpy as np
import torch

from ..batch import BucketPlanCache, cp_als_batched
from ..core import SparseTensor, cp_als
from ..device import resolve_device
from ..engine import TunePolicy, build_engine
from ..obs import enable_tracing, get_tracer, read_jsonl, summarize_text, write_jsonl
from ..serve import DecomposeService
from .common import save, table

RANK = 5
N_ITERS = 3
#: Member parity (see the module docstring): floors and κ factors.
FACTOR_ATOL, FACTOR_KAPPA = 1e-5, 2.0 ** -17
FIT_ATOL, FIT_KAPPA = 1e-6, 2.0 ** -20


def synthetic_load(n: int, seed: int = 0) -> list[SparseTensor]:
    """`n` small tensors drawn from three shape/nnz families, shuffled — the
    arrival order interleaves buckets the way concurrent users would."""
    rng = np.random.default_rng(seed)
    families = [
        ((12, 10, 8), (40, 70)),     # 3-D, band 5/6
        ((16, 16, 16), (90, 120)),   # pow-2 dims, band 6
        ((24, 24), (50, 60)),        # 2-D, band 5
    ]
    tensors = []
    for i in range(n):
        shape, (lo, hi) = families[i % len(families)]
        nnz = int(rng.integers(lo, hi))
        coords = np.stack([rng.integers(0, d, size=nnz) for d in shape],
                          axis=1).astype(np.int32)
        values = rng.uniform(-1, 1, size=nnz).astype(np.float32)
        tensors.append(SparseTensor(coords, values, shape))
    order = rng.permutation(n)
    return [tensors[i] for i in order]


def solve_kappa(factors) -> float:
    """The largest condition number, over the modes, of the matrix each ALS
    update inverts: the Hadamard product of the other modes' Grams (float64,
    from the given factors)."""
    fs = [np.asarray(f, dtype=np.float64) for f in factors]
    worst = 1.0
    for mode in range(len(fs)):
        v = np.ones((fs[0].shape[1],) * 2)
        for k, f in enumerate(fs):
            if k != mode:
                v = v * (f.T @ f)
        worst = max(worst, float(np.linalg.cond(v)))
    return worst


def member_gap(got, want) -> dict:
    """Two CPResults of one tensor held together: the largest |Δ factor| or
    |Δλ|/max(1, |λ|) (`gap`), the largest |Δ fit| per iteration, κ from
    `want`'s factors, and the larger of the two gaps over its tolerance
    (`ratio`: at most 1 passes)."""
    fa = [f.cpu().numpy() for f in got.factors]
    fb = [f.cpu().numpy() for f in want.factors]
    la, lb = got.lam.cpu().numpy(), want.lam.cpu().numpy()
    kappa = solve_kappa(fb)
    gap = max(max(float(np.abs(x - y).max()) for x, y in zip(fa, fb, strict=True)),
              float((np.abs(la - lb) / np.maximum(np.abs(lb), 1.0)).max()))
    fit = max(abs(x - y) for x, y in zip(got.fit_history, want.fit_history, strict=True))
    ratio = max(gap / max(FACTOR_ATOL, FACTOR_KAPPA * kappa),
                fit / max(FIT_ATOL, FIT_KAPPA * kappa))
    return dict(gap=gap, fit=fit, kappa=kappa, ratio=ratio)


def _probes(results) -> int:
    """Total autotune probes across the unique bucket reports."""
    reports = {id(r.tune_report): r.tune_report for r in results if r.tune_report is not None}
    return sum(rep.n_probes for rep in reports.values())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_sequential(tensors, *, device: torch.device):
    t0 = time.perf_counter()
    results = [cp_als(t, RANK, n_iters=N_ITERS, engine="ref", track_diff=False, device=device)
               for t in tensors]
    _sync(device)
    wall = time.perf_counter() - t0
    return results, dict(path="sequential", wall_s=wall, throughput=len(tensors) / wall,
                         n_probes=0)


def run_batched(tensors, tune: TunePolicy, *, device: torch.device):
    t0 = time.perf_counter()
    results = cp_als_batched(tensors, RANK, n_iters=N_ITERS, tune=tune,
                             plans=BucketPlanCache(), device=device)
    _sync(device)
    wall = time.perf_counter() - t0
    return results, dict(path="batched", wall_s=wall, throughput=len(tensors) / wall,
                         n_probes=_probes(results))


def run_service(tensors, tune: TunePolicy, *, max_batch: int, max_wait_ms: float,
                clients: int, device: torch.device):
    """Concurrent load: `clients` threads each submit a slice of the
    tensors and wait; per-request latency is submit→result."""
    latencies = [0.0] * len(tensors)
    with DecomposeService(RANK, N_ITERS, tune=tune, max_batch=max_batch,
                          max_wait_ms=max_wait_ms, device=device) as svc:
        t0 = time.perf_counter()

        def client(idxs):
            for i in idxs:
                ts = time.perf_counter()
                svc.decompose(tensors[i], timeout=600)
                latencies[i] = time.perf_counter() - ts

        threads = [threading.Thread(target=client, args=(range(c, len(tensors), clients),))
                   for c in range(clients)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=3600)
        if any(th.is_alive() for th in threads):
            raise RuntimeError("a serve_bench client did not finish within an hour")
        wall = time.perf_counter() - t0
        stats = svc.stats()
    lat = np.asarray(latencies)
    return dict(path="service", wall_s=wall,
                throughput=len(tensors) / wall,
                p50_ms=float(np.percentile(lat, 50) * 1e3),
                p99_ms=float(np.percentile(lat, 99) * 1e3),
                n_probes=stats.n_probes,
                n_batches=stats.n_batches,
                n_buckets=stats.n_buckets,
                max_batch_seen=stats.max_batch_seen,
                bucket_decisions=stats.n_bucket_decisions,
                # Service-side histogram estimates (submit→dispatch and
                # submit→result), alongside the client-measured percentiles.
                svc_queue_wait_ms=stats.queue_wait_ms,
                svc_request_ms=stats.request_ms)


def parity(batched, sequential) -> dict:
    """The worst member of `batched` against `sequential` (`member_gap`'s
    keys, each the largest over the members)."""
    gaps = [member_gap(b, s) for b, s in zip(batched, sequential, strict=True)]
    return {k: max(g[k] for g in gaps) for k in ("gap", "fit", "kappa", "ratio")}


def matched_sequential(tensors, batched_results, *, device: torch.device):
    """Per-tensor sequential `cp_als` runs through the SAME kernel the
    batched path picked for that tensor's bucket, so that the parity gate
    compares like with like."""
    out = []
    for t, rb in zip(tensors, batched_results, strict=True):
        names = {w.removeprefix("batched:") for w in rb.tune_report.winners.values()}
        if len(names) == 1:
            engine = names.pop()
        else:  # per-mode mixed winners: route each mode to its kernel
            per_mode = {m: build_engine(t, w.removeprefix("batched:"), RANK, device=device)
                        for m, w in rb.tune_report.winners.items()}

            def engine(factors, mode, _e=per_mode):
                return _e[mode](factors, mode)
        out.append(cp_als(t, RANK, n_iters=N_ITERS, engine=engine, track_diff=False,
                          device=device))
    return out


def run(n: int, *, store, max_batch: int, max_wait_ms: float, clients: int,
        device: torch.device, seed: int = 0):
    tune = TunePolicy(store=store)
    tensors = synthetic_load(n, seed=seed)
    # One throwaway batched pass over a tiny prefix, so that neither timed
    # path pays one-time set-up (the kernels' build on the card).
    cp_als_batched(tensors[: min(3, n)], RANK, n_iters=1, device=device)

    seq_results, seq_row = run_sequential(tensors, device=device)
    bat_results, bat_row = run_batched(tensors, tune, device=device)
    svc_row = run_service(tensors, tune, max_batch=max_batch, max_wait_ms=max_wait_ms,
                          clients=clients, device=device)

    worst = parity(bat_results, matched_sequential(tensors, bat_results, device=device))
    bat_row["parity_max_abs"] = worst["gap"]
    rows = [seq_row, bat_row, svc_row]
    bucket_reports = {id(r.tune_report): r.tune_report
                      for r in bat_results if r.tune_report is not None}
    payload = dict(
        n_tensors=n, rank=RANK, n_iters=N_ITERS, device=str(device),
        max_batch=max_batch, max_wait_ms=max_wait_ms, clients=clients,
        parity_max_abs=worst["gap"], parity_max_fit=worst["fit"],
        parity_max_kappa=worst["kappa"], parity_max_ratio=worst["ratio"],
        parity_ok=worst["ratio"] <= 1.0,
        batched_speedup=seq_row["wall_s"] / bat_row["wall_s"],
        bucket_reports=[rep.to_dict() for rep in bucket_reports.values()],
        rows=rows,
    )
    print(table([{k: (f"{v:.4g}" if isinstance(v, float) else v) for k, v in r.items()}
                 for r in rows],
                ["path", "wall_s", "throughput", "p50_ms", "p99_ms",
                 "n_probes", "parity_max_abs"]))
    print(f"[serve_bench] batched speedup over sequential: "
          f"{payload['batched_speedup']:.2f}x; parity {worst['gap']:.2e}, "
          f"{worst['ratio']:.3f} of the member tolerance max(1e-5, κ·2^-17) "
          f"(κ up to {worst['kappa']:.1f}) ({'OK' if payload['parity_ok'] else 'FAIL'})")
    return payload


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=64,
                    help="number of synthetic tensors (default 64)")
    ap.add_argument("--fast", action="store_true",
                    help="pruned load (24 tensors, 2 clients)")
    ap.add_argument("--store", default=None,
                    help="TuningStore path shared across runs (warm gating)")
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--max-wait-ms", type=float, default=20.0)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="enable span tracing and write the trace JSONL here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"serve_bench: {e}") from e
    n = 24 if args.fast else args.n
    # Closed-loop clients: each waits for its result before submitting the
    # next request, so client concurrency caps the coalesced batch size.
    clients = 2 if args.fast else args.clients
    if args.trace:
        enable_tracing()
    payload = run(n, store=args.store, max_batch=args.max_batch,
                  max_wait_ms=args.max_wait_ms, clients=clients, device=device,
                  seed=args.seed)
    path = save("serve_bench", payload)
    print(f"[serve_bench] wrote {path}")
    if args.trace:
        tracer = get_tracer()
        trace_path = write_jsonl(tracer.spans(), args.trace, tracer=tracer)
        print(f"[serve_bench] wrote {trace_path} ({len(tracer)} spans)")
        print(summarize_text(*read_jsonl(trace_path)))
    if not payload["parity_ok"]:
        raise SystemExit("parity gate failed")
    return payload


if __name__ == "__main__":
    main()
