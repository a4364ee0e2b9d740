#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device check: a CUDA card is required; print its name and power limit;
  2. build the CUDA kernel with nvcc and print what ptxas reports;
  3. hold the kernel against its plain PyTorch version on the card, every
     mode, local partials and the full op, for
       (a) NELL-2's published dims and nnz, uniform, seed 0, R = 10, under the
           256 KiB plan of examples/decompose_tensor.py,
       (b) the same tensor under the engine's default 64 MiB plan,
       (c) LBNL's published dims and nnz, powerlaw, under the 256 KiB plan
           (5 modes, hot chunks split by nonzero partitioning);
  4. the main path: cp_als on tensor (a) through the `kernel` engine built as
     the example builds it; the kernel must launch n_iters × 3 times, and
     the fit and factors must follow the plain `chunked` engine on the card;
     then, on the small TABLE1 nell2, the kernel engine on the card must
     follow the CPU path that the CPU tests hold to the JAX reference;
  5. time the kernel per mode at case (a) with CUDA events beside its plain
     version and its bound;
  6. print the `kernels` line, then, last, the device line.

Tolerance (phases 3 and 4): the kernel forms each nonzero's product in the
plain version's order and differs only in the order of its atomic float32
sums.  Each entry is held to 1e-4 of the sum of the absolute values of its
terms: a float32 sum of k terms reordered moves by at most 2·(k-1)·2^-24 of
that, which is 1e-4 for k ≈ 840, and its typical error (∝ √k) stays far
below it for the few thousand terms per entry seen here.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import repro_torch as rt  # noqa: E402
from repro_torch.engine import PlanCache, default_plan_cache  # noqa: E402
from repro_torch.kernels import _build, mttkrp_kernel  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402

RANK = 10
N_ITERS = 5
EXAMPLE_MEM = 256 * 1024           # examples/decompose_tensor.py's plan
DEFAULT_MEM = 64 * 1024 * 1024     # EngineContext's plan without chunking options
NELL2 = dict(shape=(12092, 9184, 28818), nnz=76_879_419, distribution="uniform")
LBNL = dict(shape=(1605, 4198, 1631, 4209, 868131), nnz=1_698_825, distribution="powerlaw")
REL_TOL = 1e-4                     # of the sum of |terms| per entry (see above)
ABS_FLOOR = 1e-6
FIT_ATOL = 1e-5                    # per iteration, kernel vs plain engine
FACTOR_ATOL = 1e-3                 # final L∞-normalized factors, kernel vs plain engine
SMALL_ATOL = 1e-6                  # fit and diff on TABLE1 nell2, card vs CPU (as the CPU tests)
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
F32_FLOPS = 67e12                  # H100 SXM, float32 outside the tensor cores
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/mttkrp.cu"
REPLACES = "src/repro/kernels/mttkrp_kernel.py:59"


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def sum_order_error(got, want, abs_terms) -> tuple[float, int]:
    """(max |got - want|, entries outside REL_TOL·Σ|terms| + ABS_FLOOR)."""
    err = (got - want).abs()
    bad = int((err > REL_TOL * abs_terms + ABS_FLOOR).sum())
    return (float(err.max()) if err.numel() else 0.0), bad


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over `reps` calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_bound(st, ct, mode: int) -> tuple[float, str, float, float]:
    """Least time for one local launch: each live nonzero's coordinates and
    value read once, each input factor read once, each partial written once,
    over the memory rate; (N-1)·R multiplies + R adds per nonzero over the
    float32 rate.  Returns (ms, bound_by, bytes, operations)."""
    n = st.ndim
    nbytes = (st.nnz * (4 * n + 4)
              + sum(st.shape[m] * RANK * 4 for m in range(n) if m != mode)
              + ct.num_tasks * ct.chunk_shape[mode] * RANK * 4)
    ops = st.nnz * RANK * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def check_case(label, st, ct, dev, device) -> float:
    """Phase 3 for one case: kernel vs plain, local partials and full op,
    every mode.  Returns the largest absolute difference seen."""
    cs = ct.chunk_shape
    log(f"[3] case {label}: dims={st.shape} nnz={st.nnz} chunk={cs} "
        f"T={ct.num_tasks} P={ct.capacity} fill={st.nnz / (ct.num_tasks * ct.capacity):.3f}")
    factors = rt.init_factors(st.shape, RANK, seed=0, device=device)
    abs_factors = [f.abs() for f in factors]
    padded = [rt.pad_factor(f, cs[m]) for m, f in enumerate(factors)]
    abs_padded = [rt.pad_factor(f, cs[m]) for m, f in enumerate(abs_factors)]
    tc, cr, vals = dev["task_chunk"], dev["coords_rel"], dev["values"]
    abs_vals = vals.abs()
    worst = 0.0
    for mode in range(st.ndim):
        got = rt.mttkrp_local(padded, tc, cr, vals, mode=mode, chunk_shape=cs)
        want = kref.mttkrp_local_ref(padded, tc, cr, vals, mode=mode, chunk_shape=cs)
        terms = kref.mttkrp_local_ref(abs_padded, tc, cr, abs_vals, mode=mode, chunk_shape=cs)
        torch.cuda.synchronize()
        local_err, local_bad = sum_order_error(got, want, terms)
        del got, want, terms
        out_dim = st.shape[mode]
        got = rt.mttkrp_kernel_op(factors, tc, cr, vals, mode=mode, chunk_shape=cs,
                                  out_dim=out_dim)
        want = rt.mttkrp_chunked(factors, tc, cr, vals, mode=mode, chunk_shape=cs,
                                 out_dim=out_dim)
        terms = rt.mttkrp_chunked(abs_factors, tc, cr, abs_vals, mode=mode, chunk_shape=cs,
                                  out_dim=out_dim)
        torch.cuda.synchronize()
        op_err, op_bad = sum_order_error(got, want, terms)
        finite = bool(torch.isfinite(got).all())
        log(f"[3]   mode {mode}: local max|err|={local_err:.3e} outside={local_bad}  "
            f"op max|err|={op_err:.3e} outside={op_bad} max|out|={float(want.abs().max()):.3e}")
        del got, want, terms
        if local_bad or op_bad or not finite:
            fail(f"case {label} mode {mode}: kernel disagrees with its plain version")
        worst = max(worst, local_err, op_err)
    return worst


def main() -> int:
    # 1. Device check.
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi.splitlines()[0])
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    # Full float32 matrix products (the reference's precision), never TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 2. Build.
    t0 = time.perf_counter()
    _build.build(["mttkrp"])
    log(f"[2] built csrc/mttkrp.cu in {time.perf_counter() - t0:.1f}s")
    for line in _build.build_log("mttkrp").splitlines():
        if "ptxas" in line or "spill" in line:
            log(f"[2]   {line.strip()}")

    # 3. Kernel vs plain, cases (a), (b), (c).
    t0 = time.perf_counter()
    st_a = rt.random_tensor(NELL2["shape"], NELL2["nnz"], distribution=NELL2["distribution"],
                            seed=0)
    t_gen = time.perf_counter() - t0
    plan_a = rt.decide_partition(st_a, RANK, mem_bytes=EXAMPLE_MEM, rank_axis=RANK)
    t0 = time.perf_counter()
    ct_a = default_plan_cache.chunked(st_a, plan_a.chunk_shape, plan_a.capacity)
    t_chunk = time.perf_counter() - t0
    log(f"[3] host set-up (a): random_tensor {t_gen:.1f}s, chunk_tensor {t_chunk:.1f}s")
    dev_a = default_plan_cache.device_arrays(st_a, plan_a.chunk_shape, plan_a.capacity, device)
    worst = check_case("a (NELL-2, 256 KiB plan)", st_a, ct_a, dev_a, device)

    side = PlanCache()  # (b) and (c) are freed before the main path
    plan_b = side.plan(st_a, RANK, mem_bytes=DEFAULT_MEM)
    worst = max(worst, check_case(
        "b (NELL-2, default 64 MiB plan)", st_a, side.chunked(st_a, plan_b.chunk_shape, plan_b.capacity),
        side.device_arrays(st_a, plan_b.chunk_shape, plan_b.capacity, device), device))
    t0 = time.perf_counter()
    st_c = rt.random_tensor(LBNL["shape"], LBNL["nnz"], distribution=LBNL["distribution"], seed=0)
    plan_c = rt.decide_partition(st_c, RANK, mem_bytes=EXAMPLE_MEM, rank_axis=RANK)
    ct_c = side.chunked(st_c, plan_c.chunk_shape, plan_c.capacity)
    log(f"[3] host set-up (c): {time.perf_counter() - t0:.1f}s")
    if ct_c.num_tasks <= len(np.unique(ct_c.task_chunk, axis=0)):
        fail("case c: no chunk was split by nonzero partitioning")
    worst = max(worst, check_case("c (LBNL, 256 KiB plan)", st_c, ct_c,
                                  side.device_arrays(st_c, plan_c.chunk_shape, plan_c.capacity,
                                                     device), device))
    del side, st_c, ct_c
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # 4. Main path: cp_als through the kernel engine, as the example builds it.
    mttkrp_kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    engine = rt.build_engine(st_a, "kernel", RANK, chunk_shape=plan_a.chunk_shape,
                             capacity=plan_a.capacity)
    res = rt.cp_als(st_a, RANK, n_iters=N_ITERS, engine=engine, seed=0)
    t_main = time.perf_counter() - t0
    launches = mttkrp_kernel.launches
    peak_bytes = torch.cuda.max_memory_allocated()
    log(f"[4] cp_als engine={res.engine} in {t_main:.1f}s, kernel launches={launches}")
    log(f"[4]   fit_history={res.fit_history}")
    log(f"[4]   diff_history={res.diff_history}")
    log(f"[4]   iter_times={res.iter_times}")
    log(f"[4]   device memory: resident before {base_bytes / 2**30:.3f} GiB, "
        f"peak {peak_bytes / 2**30:.3f} GiB")
    if launches != N_ITERS * st_a.ndim:
        fail(f"kernel launched {launches} times in the main path, expected {N_ITERS * st_a.ndim}")
    if len(res.fit_history) != N_ITERS or not all(math.isfinite(f) for f in res.fit_history):
        fail(f"fit_history is not {N_ITERS} finite values")
    for m, f in enumerate(res.factors):
        if tuple(f.shape) != (st_a.shape[m], RANK) or not bool(torch.isfinite(f).all()):
            fail(f"factor {m} has shape {tuple(f.shape)} or non-finite entries")
    plain = rt.cp_als(st_a, RANK, n_iters=N_ITERS, engine="chunked", seed=0,
                      chunk_shape=plan_a.chunk_shape, capacity=plan_a.capacity)
    fit_gap = [abs(a - b) for a, b in zip(res.fit_history, plain.fit_history, strict=True)]
    log(f"[4]   plain chunked fit_history={plain.fit_history}")
    log(f"[4]   plain chunked iter_times={plain.iter_times}")
    log(f"[4]   |fit kernel - fit plain| per iteration={fit_gap} (tolerance {FIT_ATOL})")
    if max(fit_gap) > FIT_ATOL:
        fail("the kernel engine's fit left the plain engine's")
    # A uniform random tensor has no low-rank structure: its fit sits near
    # the float32 resolution of the residual, so the factors are compared too.
    factor_gap = max(float((a - b).abs().max()) for a, b in zip(res.factors, plain.factors,
                                                                 strict=True))
    log(f"[4]   max |factor kernel - factor plain| = {factor_gap:.3e} (tolerance {FACTOR_ATOL})")
    if factor_gap > FACTOR_ATOL:
        fail("the kernel engine's factors left the plain engine's")
    del plain
    # A small input whose fit stands far above the residual's float32
    # resolution: the kernel engine on the card against the plain engine on
    # the CPU, which the CPU tests hold against the JAX package.
    small = rt.table1_tensor("nell2")
    on_card = rt.cp_als(small, RANK, n_iters=3, engine="kernel")
    on_cpu = rt.cp_als(small, RANK, n_iters=3, engine="chunked", device="cpu")
    small_gap = max(abs(a - b) for a, b in zip(on_card.fit_history + on_card.diff_history,
                                               on_cpu.fit_history + on_cpu.diff_history,
                                               strict=True))
    log(f"[4]   TABLE1 nell2: card fit={on_card.fit_history} cpu fit={on_cpu.fit_history} "
        f"max gap (fit, diff)={small_gap:.3e} (tolerance {SMALL_ATOL})")
    if small_gap > SMALL_ATOL:
        fail("the kernel engine on the card left the CPU path on TABLE1 nell2")

    # 5. Timing at case (a)'s shapes, plain and kernel in turns.
    factors = [rt.pad_factor(f, plan_a.chunk_shape[m])
               for m, f in enumerate(rt.init_factors(st_a.shape, RANK, seed=0, device=device))]
    tc, cr, vals = dev_a["task_chunk"], dev_a["coords_rel"], dev_a["values"]
    modes = []
    for mode in range(st_a.ndim):
        def kernel(mode=mode):
            return rt.mttkrp_local(factors, tc, cr, vals, mode=mode, chunk_shape=ct_a.chunk_shape)

        def plain_local(mode=mode):
            return kref.mttkrp_local_ref(factors, tc, cr, vals, mode=mode,
                                         chunk_shape=ct_a.chunk_shape)

        def full_op(mode=mode):
            return rt.mttkrp_kernel_op(factors, tc, cr, vals, mode=mode,
                                       chunk_shape=ct_a.chunk_shape, out_dim=st_a.shape[mode])
        p1, k1, k2, p2 = (time_ms(plain_local, 3), time_ms(kernel, 10),
                          time_ms(kernel, 10), time_ms(plain_local, 3))
        op = time_ms(full_op, 10)
        bound, bound_by, nbytes, ops = kernel_bound(st_a, ct_a, mode)
        row = dict(mode=mode, ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, op_ms=op,
                   bound_ms=bound, bound_by=bound_by, bytes=nbytes, ops=ops,
                   ms_runs=[k1, k2], plain_ms_runs=[p1, p2])
        modes.append(row)
        log(f"[5] mode {mode}: " + json.dumps(row))
    smi_after = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    log(f"[5] after timing: {smi_after}")
    log("[5] library call: none (no single PyTorch call computes MTTKRP)")
    log(f"[6] total {time.perf_counter() - t_start:.1f}s")

    # 6. Kernels line (ms/plain_ms/bound_ms: the 3 launches of one CP-ALS
    # iteration at case (a)'s shapes, summed over the modes).
    print(json.dumps({"kernels": [{
        "name": "mttkrp_local_f32",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": worst,
        "ms": sum(r["ms"] for r in modes),
        "plain_ms": sum(r["plain_ms"] for r in modes),
        "bound_ms": sum(r["bound_ms"] for r in modes),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in modes) else "operations",
        "library_ms": None,
    }]}), flush=True)
    # 7. Device line, last.
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
