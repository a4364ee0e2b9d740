#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device check: a CUDA card is required; print its name and power limit;
  2. build both CUDA kernels with nvcc (one process each, started together)
     and print what ptxas reports for each kernel instantiation (registers,
     spills);
  3. hold the float kernel against its plain PyTorch version on the card,
     every mode, local partials and the full op (with `nnz_per_task`, as
     the engines call them), printing each launch's tier, blocks per task
     and shared-memory bytes, for
       (a) NELL-2's published dims and nnz, uniform, seed 0, R = 10, under the
           256 KiB plan of examples/decompose_tensor.py,
       (b) the same tensor under the engine's default 64 MiB plan,
       (c) LBNL's published dims and nnz, powerlaw, under the 256 KiB plan
           (5 modes, hot chunks split by nonzero partitioning);
     3f. hold the fixed-point kernel (paper Alg. 2) against its plain version
     bit for bit on the same cases: presets int7 and int15-12 everywhere,
     int3 (int8 factors) in (a); print each preset's accumulator bound
     beside the largest per-output-row nonzero count; then time both
     kernels per mode at (b) (float, int7) and (c) (float, int15-12)
     beside their bounds;
  4. the float path: cp_als on tensor (a) through the `kernel` engine built
     as the example builds it; the float kernel must launch n_iters × 3
     times (the fixed one never), and the fit and factors must follow the
     plain `chunked` engine on the card; then, on the small TABLE1 nell2,
     the kernel engine on the card must follow the CPU path that the CPU
     tests hold to the JAX reference;
     4f. the fixed-point path: cp_als through the `fixed` engine on (a) with
     int7 and on (c) with int15-12; the fixed kernel must launch n_iters × N
     times (the float one never), and fit, diff and factors must equal, bit
     for bit, those of the same run through the plain `mttkrp_chunked_fixed`
     on the card (quant_error within 1e-4: its float reference sums with
     atomics); then, on TABLE1 nell2 (int7) and
     lbnl (int15-12), the card must follow the CPU path;
     4d. (run after phase 4, before 4f) the `distributed` engine at (a)
     through `build_engine`, `psum` and `psum_scatter`, on the default
     (1, 1) mesh of a one-rank NCCL group (the host has one card; NCCL
     refuses two ranks on one device), on the plan cache's resident arrays
     (checked: no second copy): every mode within 1e-5 of Σ|terms| of the
     `kernel` engine (`index_add_` sums in no fixed order), timed with CUDA
     events in turns against the kernel op; cp_als for n_iters (n_iters × 3
     float-kernel launches, fit within 1e-5 and factors within 1e-3 of
     phase 4's `kernel` run), the NCCL version, the collectives' log through
     `roofline.collective_bytes` (0 wire bytes at group size 1) and the
     peak memory;
     4g. the paper's Fig. 6 claim (int15-12 tracks float, int7 stays
     bounded) on tests/test_cpals.py's planted low-rank tensor, and a
     planted rank-3 cube of side 180 (every cell present) where the fit
     means something;
     4h. the paper's other execution roles: the `alto` and `csf` engines
     against `ref` on the card in every mode at (a) and (c), with each
     layout's host build time and index bytes (on (c) ALTO needs 68 key
     bits and takes the ALTO-ordered COO baseline, and each tree's fiber
     count is checked against `fiber_count`); cp_als on (a) through `alto`,
     `csf` and `hetero` (every task sparse there: n_iters × 3 float-kernel
     launches), fit and factors against the `kernel` run of phase 4; then
     `hetero` on the planted cube under the 256 KiB plan, with the cost
     model's split (every task dense: no launch) and with dense_fraction
     0.5 (n_iters × 3 launches), fit against `kernel` on the same plan;
  5. time both kernels per mode at case (a) with CUDA events beside their
     plain versions, their global tier (the first design, without
     `nnz_per_task`) in turns (plain, global, kernel, kernel, global,
     plain) and their bounds, and the engines' steady iterations;
     5h. time each role's MTTKRP per mode at case (a) in turns (ref, alto,
     csf, plain chunked, the kernel's full op, hetero, then back), beside
     the bytes each must move (its index bytes, the values, the factor
     rows read and the output written), and ALTO's de-interleave alone;
     4a. the autotuner (`engine="auto"`), after 5h so that the roles'
     timings stay undisturbed, reusing 5h's layouts; every store lives in a
     fresh temporary directory, and every tune fails the run if it skips a
     candidate for any reason but the prior's pruning or an accuracy
     budget: the README's quickstart
     `cp_als(table1_tensor("nell2"), 10, n_iters=5, engine="auto")` against
     a `kernel` run; a cold tune at (a) (no lossless candidate skipped,
     every mode won by `kernel` or `hetero`, the two backends that launch
     the float kernel), then cp_als through it (n_iters × 3 float-kernel
     launches, fit and factors against phase 4's `kernel` run); a warm hit
     (0 probes, the same winners); the analytic prior's pruning with
     max_probes=3 (printed, not held); the six TABLE1 tensors tuned into
     one store, the calibrated prior fitted to it and a cold calibrated,
     elided tune at (a) (every winner a float-kernel backend); and an
     accuracy budget of 1e-2 over kernel, fixed:int7 and fixed:int15-12
     (int7 rejected over budget, the fixed kernel launched by the probes);
     4w. (after 4a) the offline sweep: benchmarks/sweep_ci.toml (read with
     the port's `load_config`) plus the `kernel` candidate, swept into a
     fresh store on the card (every cell measured), swept again (0 probes,
     every cell complete), and its Pareto report against
     `roofline.H100_SXM5` (a non-empty front, every peak_fraction in [0,
     1.05]); cells, probes, wall time and winners printed;
     4s. the serving path, `DecomposeService` over `cp_als_batched` (plain
     tensor ops: it launches neither kernel, which is checked): benchmarks/
     serve_bench.py's load (three shape/nnz families, 4096 requests from
     seed 0, rank 5, 3 iterations) from 8 closed-loop client threads,
     max_batch=256, max_wait_ms=20, on a cold store in a fresh temporary
     directory, then a second service on the same store over the first 512
     requests (0 probes, only persisted/cached decisions); no request may
     fail; every result held against the cold service's (the warm ones),
     against one cp_als_batched call over the same tensors on the same store,
     and 32 sampled ones against the sequential cp_als(engine="ref"); it
     prints tensors/s of the service, the batched call and the sequential
     loop (extrapolated), p50/p99 of queue wait, dispatch and request,
     batches, max_batch_seen and each bucket's tune report;
     4b. one cp_als_batched call over 65,536 tensors of the same families
     (the batch package serves millions of small per-user tensors; 2^16
     keeps the script inside its time limit), its host steps timed apart
     first (bucketing, padding, init, each candidate's build and upload, the
     cold tune per bucket), then the call on the warm store: tensors/s, its
     iterations against the rest, steady iteration ms per bucket, the
     padded arrays' bytes and the call's peak device memory; 64 sampled
     members held against the sequential `ref`;
  6. print the `kernels` line, then, last, the device line.

Tolerance (phases 3 and 4): the float kernel forms each nonzero's product
in the plain version's order and differs only in the order of its atomic
float32 sums.  Each entry is held to 1e-4 of the sum of the absolute values
of its terms: a float32 sum of k terms reordered moves by at most
2·(k-1)·2^-24 of that, which is 1e-4 for k ≈ 840, and its typical error
(∝ √k) stays far below it for the few thousand terms per entry seen here.
The fixed kernel sums integers, so phases 3f and 4f compare exactly; card
against CPU (4, 4f) uses the CPU tests' tolerances against the JAX package.
Phase 4h holds `alto` and `csf` to `ref` with the same 1e-4 of Σ|terms|:
they form the same products, CSF grouping a fiber's before the interior
factor multiplies them, and sum them in another order.
Phases 4s and 4b hold two runs of one small tensor (batched in other
company, or sequential) member by member.  Their roundings differ, and ALS
magnifies a difference by up to κ, the condition number of the Gram
Hadamard product an update inverts (`solve_kappa`; up to a few hundred on
this load), so serve_bench's flat 1e-5 on factors fails for a few percent
of members at this scale (phase 4s prints how many); the JAX package's own
batched and sequential runs are not bit-identical either.  Factors and
λ/max(1, |λ|) are held to max(1e-5, κ·2^-17) and fits to max(1e-6,
κ·2^-20) per iteration: the flat values where the solve is well
conditioned, about 64 float32 roundings (2^-23) magnified by κ where it is
not (an eighth of that on the fit, a scalar of the whole reconstruction).
A member's mix-up or a wrong padding moves them by orders of magnitude more.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import repro_torch as rt  # noqa: E402
from repro_torch.batch import (  # noqa: E402
    autotune_bucket,
    bucket_tensors,
    build_batched_kernel,
    pad_bucket,
)
from repro_torch.batch.cpals import _init_batched  # noqa: E402
from repro_torch.engine import PlanCache, TuningStore, default_plan_cache  # noqa: E402
from repro_torch.core.mttkrp import _alto_decode  # noqa: E402
from repro_torch.engine.calibrate import MIN_OBSERVATIONS  # noqa: E402
from repro_torch.obs import capture  # noqa: E402
from repro_torch.formats import MAX_KEY_BITS  # noqa: E402
from repro_torch.kernels import _build, mttkrp_fixed_kernel, mttkrp_kernel, tiles  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.launch import mesh_axes  # noqa: E402
from repro_torch.roofline import H100_SXM5, collective_bytes  # noqa: E402

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
DIST_REL_TOL = 1e-5                # distributed vs kernel engine, of Σ|terms| per entry (phase 4d)
# quant_error of the fixed engine against the plain op's, both on the card:
# its float COO reference sums with float atomics (`index_add_`) in an order
# that changes from run to run, so it is held to the 1e-4 of the float
# kernel's reordered sums, relative; fit, diff and factors stay bit-exact.
QUANT_CARD_RTOL = 1e-4
# The fixed engine, card vs CPU: fit and diff within 1e-5 + 1e-3·|cpu|,
# quant_error within 1% (the tolerances of tests/test_torch_fixed.py).
FIXED_SMALL_ATOL, FIXED_SMALL_RTOL, QUANT_RTOL = 1e-5, 1e-3, 1e-2
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
F32_FLOPS = 67e12                  # H100 SXM, float32 outside the tensor cores
# 132 SMs × 64 INT32 lanes × 1.98 GHz boost (Hopper white paper; the same
# clock gives the data sheet's 67 TFLOP/s float32 from 128 FP32 lanes).
I32_OPS = 132 * 64 * 1.98e9
PLANTED_SIDE = 180                 # 5.8 M cells; side² nonzeros per output row (phase 4g)
PLANTED_RANK = 3
# hetero against kernel on the planted cube, fit per iteration (phase 4h).
# Rank 5 on rank-3 data leaves two components that the data do not pin down,
# and ALS amplifies rounding along them: on the CPU the plain `ref` and
# `chunked` engines, which differ only in summation order, give fits up to
# 9.1e-5 apart on this cube.  The bound is ten times that.
PLANTED_FIT_ATOL = 1e-3
KERNELS = {
    "float": dict(name="mttkrp_local_f32", source="src/repro_torch/kernels/csrc/mttkrp.cu",
                  replaces="src/repro/kernels/mttkrp_kernel.py:59"),
    "fixed": dict(name="mttkrp_fixed_local_i32",
                  source="src/repro_torch/kernels/csrc/mttkrp_fixed.cu",
                  replaces="src/repro/kernels/mttkrp_fixed_kernel.py:62"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def sum_order_error(got, want, abs_terms) -> tuple[float, int]:
    """(max |got - want|, entries outside REL_TOL·Σ|terms| + ABS_FLOOR)."""
    err = (got - want).abs()
    bad = int((err > REL_TOL * abs_terms + ABS_FLOOR).sum())
    return (float(err.max()) if err.numel() else 0.0), bad


def int_error(got, want) -> int:
    """Largest |got - want| of two int32 tensors, exactly."""
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) if got.numel() else 0


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


def bound(nbytes: float, ops: float, op_rate: float) -> tuple[float, str]:
    """(least ms, what bounds it) for `nbytes` moved and `ops` done."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / op_rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_bound(st, ct, mode: int) -> tuple[float, str, float, float]:
    """Least time for one float local launch: each live nonzero's coordinates
    and value read once, each input factor read once, each partial written
    once, over the memory rate; (N-1)·R multiplies + R adds per nonzero over
    the float32 rate.  Returns (ms, bound_by, bytes, operations)."""
    n = st.ndim
    nbytes = (st.nnz * (4 * n + 4)
              + sum(st.shape[m] * RANK * 4 for m in range(n) if m != mode)
              + ct.num_tasks * ct.chunk_shape[mode] * RANK * 4)
    ops = st.nnz * RANK * n
    return (*bound(nbytes, ops, F32_FLOPS), nbytes, ops)


def fixed_kernel_bound(st, ct, mode: int, live: int, factor_bytes: int,
                       value_bytes: int) -> tuple[float, str, float, float]:
    """Least time for one fixed-point local launch: each live nonzero's
    (nonzero qvalue) coordinates and qvalue read once, each input factor once
    at its storage width, each int32 partial written once, over the memory
    rate; per live nonzero and r, (N-2) multiplies and shifts, one multiply
    by the qvalue, one shift and one add, over the int32 rate."""
    n = st.ndim
    nbytes = (live * (4 * n + value_bytes)
              + sum(st.shape[m] * RANK * factor_bytes for m in range(n) if m != mode)
              + ct.num_tasks * ct.chunk_shape[mode] * RANK * 4)
    ops = live * RANK * (2 * (n - 1) + 1)
    return (*bound(nbytes, ops, I32_OPS), nbytes, ops)


def ptxas_summary(build_log: str) -> list[str]:
    """One line per compiled kernel: its template arguments, registers and
    spills, from what `nvcc -Xptxas -v` printed."""
    types = {"a": "int8", "s": "int16", "i": "int32"}
    lines, name = [], None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            kind = "task_kernel" if "task_kernel" in mangled else "global_kernel"
            pol = re.search(r"FixedPolicyI(\w)(\w)E", mangled)
            policy = (f"fixed<{types[pol.group(1)]} factors, {types[pol.group(2)]} values>"
                      if pol else "float")
            n = re.search(r"ELi(\d+)EEEv", mangled)
            modes = "" if n is None else f", N={n.group(1) if n.group(1) != '0' else 'any'}"
            name, spills = f"{kind}<{policy}{modes}>", ""
        elif name and "spill" in line:
            spills = line.strip()
        elif name and "Used" in line:
            lines.append(f"{name}: {line.split('info    :')[-1].strip()}; {spills}")
            name = None
    return lines


def plan_of(st, ct, mode, factor_bytes=4, value_bytes=4, tier=None) -> tiles.LaunchPlan:
    """The launch plan the wrappers take for one mode of a case on this card."""
    return tiles.plan_launch(ct.num_tasks, ct.capacity, ct.chunk_shape, mode, RANK,
                             factor_bytes=factor_bytes, value_bytes=value_bytes,
                             smem_budget=tiles.device_budget(torch.device("cuda", 0)), tier=tier)


def steady(iter_times) -> float:
    """Mean of the iterations after the first (which carries set-up), in ms."""
    return 1e3 * float(np.mean(iter_times[1:]))


def check_case(label, st, ct, dev, device) -> float:
    """Phase 3 for one case: float kernel vs plain, local partials and full
    op, every mode.  Returns the largest absolute difference seen."""
    cs = ct.chunk_shape
    log(f"[3] case {label}: dims={st.shape} nnz={st.nnz} chunk={cs} "
        f"T={ct.num_tasks} P={ct.capacity} fill={st.nnz / (ct.num_tasks * ct.capacity):.3f}")
    factors = rt.init_factors(st.shape, RANK, seed=0, device=device)
    abs_factors = [f.abs() for f in factors]
    padded = [rt.pad_factor(f, cs[m]) for m, f in enumerate(factors)]
    abs_padded = [rt.pad_factor(f, cs[m]) for m, f in enumerate(abs_factors)]
    tc, cr, vals, nnz = dev["task_chunk"], dev["coords_rel"], dev["values"], dev["nnz_per_task"]
    abs_vals = vals.abs()
    worst = 0.0
    for mode in range(st.ndim):
        log(f"[3]   mode {mode}: {plan_of(st, ct, mode)}")
        got = rt.mttkrp_local(padded, tc, cr, vals, mode=mode, chunk_shape=cs, nnz_per_task=nnz)
        want = kref.mttkrp_local_ref(padded, tc, cr, vals, mode=mode, chunk_shape=cs)
        terms = kref.mttkrp_local_ref(abs_padded, tc, cr, abs_vals, mode=mode, chunk_shape=cs)
        torch.cuda.synchronize()
        local_err, local_bad = sum_order_error(got, want, terms)
        del got, want, terms
        out_dim = st.shape[mode]
        got = rt.mttkrp_kernel_op(factors, tc, cr, vals, mode=mode, chunk_shape=cs,
                                  out_dim=out_dim, nnz_per_task=nnz)
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


def fixed_inputs(st, ct, device, preset):
    """Quantized inputs as the `fixed` engine makes them: `init_factors`
    L∞-normalized (as cp_als feeds them), quantized on the card; the values
    in the runtime 16-bit format.  Returns (qfactors, qvalues, shift kwargs)."""
    qf, prec_shift = rt.FIXED_PRESETS[preset]
    factors = rt.init_factors(st.shape, RANK, seed=0, device=device)
    qfactors = [qf.quantize(f / f.abs().amax(dim=0)) for f in factors]
    vq = rt.value_qformat(st.values)
    qvalues = torch.from_numpy(vq.quantize_np(ct.values)).to(device)
    return qfactors, qvalues, dict(matrix_frac=qf.frac_bits, value_frac=vq.frac_bits,
                                   prec_shift=prec_shift)


def check_fixed_case(label, st, ct, dev, device, presets) -> int:
    """Phase 3f for one case: fixed kernel vs plain, bit for bit, local
    partials and full op, every mode and preset.  Returns the largest
    absolute difference seen (0 when they agree)."""
    cs = ct.chunk_shape
    row_nnz = [int(np.bincount(st.coords[:, m], minlength=st.shape[m]).max())
               for m in range(st.ndim)]
    tc, cr, nnz = dev["task_chunk"], dev["coords_rel"], dev["nnz_per_task"]
    worst = 0
    for preset in presets:
        qfactors, qvalues, q = fixed_inputs(st, ct, device, preset)
        safe = rt.accumulator_safe_nnz(preset, value_frac=q["value_frac"])
        log(f"[3f] case {label} {preset}: value_frac={q['value_frac']} largest per-output-row "
            f"nnz per mode={row_nnz} accumulator_safe_nnz={safe} "
            f"({'within' if max(row_nnz) <= safe else 'EXCEEDED: the int32 sums may wrap'})")
        padded = [rt.pad_factor(f, cs[m]) for m, f in enumerate(qfactors)]
        for mode in range(st.ndim):
            log(f"[3f]   mode {mode}: "
                f"{plan_of(st, ct, mode, qfactors[0].element_size(), qvalues.element_size())}")
            got = rt.mttkrp_fixed_local(padded, tc, cr, qvalues, mode=mode, chunk_shape=cs,
                                        nnz_per_task=nnz, **q)
            want = kref.mttkrp_fixed_local_ref(padded, tc, cr, qvalues, mode=mode,
                                               chunk_shape=cs, **q)
            local_ok, local_err = bool(torch.equal(got, want)), int_error(got, want)
            del got, want
            out_dim = st.shape[mode]
            got = rt.mttkrp_fixed_kernel_op(qfactors, tc, cr, qvalues, mode=mode, chunk_shape=cs,
                                            out_dim=out_dim, nnz_per_task=nnz, **q)
            want = rt.mttkrp_chunked_fixed(qfactors, tc, cr, qvalues, mode=mode, chunk_shape=cs,
                                           out_dim=out_dim, **q)
            op_ok, op_err = bool(torch.equal(got, want)), int_error(got, want)
            log(f"[3f]   mode {mode}: local equal={local_ok} op equal={op_ok} "
                f"max|out|={int(want.abs().max())}")
            del got, want
            worst = max(worst, local_err, op_err)
            if not (local_ok and op_ok):
                fail(f"case {label} {preset} mode {mode}: the fixed kernel differs from its "
                     f"plain version by up to {max(local_err, op_err)}")
    return worst


def time_case(label, st, ct, dev, device, preset) -> None:
    """Per-mode kernel times of a case beside their bounds: the float kernel
    and the fixed one with `preset`, each as the engines launch it."""
    cs, tc, cr = ct.chunk_shape, dev["task_chunk"], dev["coords_rel"]
    nnz = dev["nnz_per_task"]
    factors = [rt.pad_factor(f, cs[m])
               for m, f in enumerate(rt.init_factors(st.shape, RANK, seed=0, device=device))]
    qfactors, qvalues, q = fixed_inputs(st, ct, device, preset)
    qfactors = [rt.pad_factor(f, cs[m]) for m, f in enumerate(qfactors)]
    live = int(torch.count_nonzero(qvalues))
    for mode in range(st.ndim):
        ms = time_ms(lambda mode=mode: rt.mttkrp_local(
            factors, tc, cr, dev["values"], mode=mode, chunk_shape=cs, nnz_per_task=nnz), 10)
        fms = time_ms(lambda mode=mode: rt.mttkrp_fixed_local(
            qfactors, tc, cr, qvalues, mode=mode, chunk_shape=cs, nnz_per_task=nnz, **q), 10)
        b, by, _, _ = kernel_bound(st, ct, mode)
        fb, fby, _, _ = fixed_kernel_bound(st, ct, mode, live, qfactors[0].element_size(),
                                           qvalues.element_size())
        plan = plan_of(st, ct, mode)
        fplan = plan_of(st, ct, mode, qfactors[0].element_size(), qvalues.element_size())
        log(f"[5{label}] mode {mode}: " + json.dumps(dict(
            float_ms=ms, float_bound_ms=b, float_bound_by=by, float_tier=plan.tier,
            float_blocks_per_task=plan.blocks_per_task, fixed_preset=preset, fixed_ms=fms,
            fixed_bound_ms=fb, fixed_bound_by=fby, fixed_tier=fplan.tier,
            fixed_blocks_per_task=fplan.blocks_per_task)))


def plain_fixed_engine(engine: rt.Engine) -> rt.Engine:
    """The same fixed-point engine with the plain `mttkrp_chunked_fixed` in
    place of the kernel op, on the same device arrays."""
    ctx = engine.context
    qf, prec_shift = rt.FIXED_PRESETS[ctx.fixed_preset]
    dev = ctx.device_arrays()
    vq = rt.value_qformat(ctx.st.values)
    qvalues = torch.from_numpy(vq.quantize_np(ctx.chunked().values)).to(ctx.device)

    def fn(factors, mode):
        qout = rt.mttkrp_chunked_fixed(
            [qf.quantize(f) for f in factors], dev["task_chunk"], dev["coords_rel"], qvalues,
            mode=mode, chunk_shape=ctx.chunk_shape, out_dim=ctx.st.shape[mode],
            matrix_frac=qf.frac_bits, value_frac=vq.frac_bits, prec_shift=prec_shift)
        return rt.dequantize_output(qout, qf.frac_bits, prec_shift)
    return rt.Engine(f"{engine.name} (plain)", fn, spec=engine.spec)


def fixed_main_run(label, st, plan, preset) -> tuple[rt.CPResult, int]:
    """Phase 4f for one tensor: cp_als through the `fixed` engine, its
    launches counted from 0, against the same run through the plain op.
    Returns the result and the fixed kernel's launches."""
    mttkrp_kernel.launches = 0
    mttkrp_fixed_kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    engine = rt.build_engine(st, "fixed", RANK, fixed_preset=preset,
                             chunk_shape=plan.chunk_shape, capacity=plan.capacity)
    res = rt.cp_als(st, RANK, n_iters=N_ITERS, engine=engine, seed=0)
    t_run = time.perf_counter() - t0
    launches, float_launches = mttkrp_fixed_kernel.launches, mttkrp_kernel.launches
    peak_bytes = torch.cuda.max_memory_allocated()
    want = N_ITERS * st.ndim
    log(f"[4f] {label}: cp_als engine={res.engine} preset={preset} in {t_run:.1f}s, "
        f"fixed kernel launches={launches} (expected {want}), float kernel launches="
        f"{float_launches}")
    log(f"[4f]   fit_history={res.fit_history}")
    log(f"[4f]   diff_history={res.diff_history}")
    log(f"[4f]   quant_error={res.quant_error}")
    log(f"[4f]   iter_times={res.iter_times} steady={steady(res.iter_times):.3f} ms")
    log(f"[4f]   device memory: resident before {base_bytes / 2**30:.3f} GiB, "
        f"peak {peak_bytes / 2**30:.3f} GiB")
    if launches != want or float_launches != 0:
        fail(f"{label}: the fixed path launched the fixed kernel {launches} times (expected "
             f"{want}) and the float kernel {float_launches} times (expected 0)")
    if not all(math.isfinite(v) for v in res.fit_history + res.diff_history + [res.quant_error]):
        fail(f"{label}: non-finite fit, diff or quant_error")
    for m, f in enumerate(res.factors):
        if tuple(f.shape) != (st.shape[m], RANK) or not bool(torch.isfinite(f).all()):
            fail(f"{label}: factor {m} has shape {tuple(f.shape)} or non-finite entries")
    plain = rt.cp_als(st, RANK, n_iters=N_ITERS, engine=plain_fixed_engine(engine), seed=0)
    same = {"fit_history": res.fit_history == plain.fit_history,
            "diff_history": res.diff_history == plain.diff_history,
            "factors": all(bool(torch.equal(a, b)) for a, b in zip(res.factors, plain.factors,
                                                                   strict=True))}
    quant_gap = abs(res.quant_error - plain.quant_error) / plain.quant_error
    log(f"[4f]   plain op: fit_history={plain.fit_history} quant_error={plain.quant_error} "
        f"steady={steady(plain.iter_times):.3f} ms; bit-identical to the kernel run: {same}; "
        f"quant_error {quant_gap:.3e} apart (tolerance {QUANT_CARD_RTOL} relative)")
    if not all(same.values()) or quant_gap > QUANT_CARD_RTOL:
        fail(f"{label}: the fixed engine left the plain op's run")
    return res, launches


def planted_lowrank(shape, rank: int, seed: int) -> rt.SparseTensor:
    """A fully observed exactly-rank-`rank` tensor (factors uniform(-1, 1),
    every cell present), built as tests/test_cpals.py builds one: sparse
    CP-ALS counts absent cells as zeros, so every cell must be there for a
    high fit."""
    rng = np.random.default_rng(seed)
    factors = [rng.uniform(-1, 1, (d, rank)).astype(np.float32) for d in shape]
    coords = np.indices(shape, dtype=np.int32).reshape(len(shape), -1).T.copy()
    prod = np.ones((coords.shape[0], rank), np.float32)
    for m, f in enumerate(factors):
        prod *= f[coords[:, m]]
    return rt.SparseTensor(coords, prod.sum(1).astype(np.float32), tuple(shape))


def planted_runs(label, st, **engine_kwargs) -> tuple[rt.CPResult, ...]:
    """cp_als at rank 5, 5 iterations, seed 5, through `kernel` (float),
    `fixed:int15-12` and `fixed:int7`; logs and returns the three results."""
    runs = [rt.cp_als(st, 5, n_iters=N_ITERS, engine=eng, seed=5, **engine_kwargs)
            for eng in ("kernel", "fixed:int15-12", "fixed:int7")]
    for r in runs:
        log(f"[4g]   {label} {r.engine}: fit={r.fit_history} diff={r.diff_history} "
            f"quant_error={r.quant_error} steady={steady(r.iter_times):.3f} ms")
    return tuple(runs)


def planted_check() -> rt.SparseTensor:
    """Phase 4g, the paper's Fig. 6 claim on the card.

    (1) tests/test_cpals.py's own Fig. 6 case, (12, 10, 12) at rank 3, held
    to that test's criteria: int15-12's final diff within 5% of float's and
    its fit within 0.01; int7's final diff at least int15-12's and below 3×
    its first.
    (2) a cube of side PLANTED_SIDE (side² nonzeros per output row, within
    both presets' accumulator bound), the same runs, held to the same
    criteria but one, and to converge as
    tests/test_cpals.py::test_cpals_converges_on_lowrank asks (final fit
    above 0.8 and not below the first) in float and int15-12.  Int15-12's
    diff within 5% of float's is printed, not held: here float converges
    below int15-12's quantization floor (diff about 3e-3), a property of
    the reference's arithmetic, which the fixed MTTKRP reproduces bit for
    bit.  Returns the cube."""
    def fig6(label, f_, q15, q7, *, diff_within_5pct: bool) -> None:
        rel15 = abs(q15.diff_history[-1] - f_.diff_history[-1]) / max(f_.diff_history[-1], 1e-9)
        log(f"[4g]   {label}: int15-12's final diff is {rel15:.4f} of float's away "
            f"({'held to' if diff_within_5pct else 'printed, not held to'} 0.05), its fit "
            f"{abs(q15.fit_history[-1] - f_.fit_history[-1]):.3e} away; int7's final diff "
            f"{q7.diff_history[-1]:.4e} (int15-12's {q15.diff_history[-1]:.4e}, 3 × int7's "
            f"first {3 * q7.diff_history[0]:.4e})")
        if not ((rel15 < 0.05 or not diff_within_5pct)
                and abs(q15.fit_history[-1] - f_.fit_history[-1]) < 0.01
                and q7.diff_history[-1] >= q15.diff_history[-1]
                and q7.diff_history[-1] < 3 * q7.diff_history[0]):
            fail(f"the Fig. 6 check failed on {label}")

    st = planted_lowrank((12, 10, 12), PLANTED_RANK, seed=4)
    runs = planted_runs("test_cpals (12, 10, 12)", st, chunk_shape=(8, 8, 8), capacity=512)
    fig6("tests/test_cpals.py's tensor", *runs, diff_within_5pct=True)

    t0 = time.perf_counter()
    st = planted_lowrank((PLANTED_SIDE,) * 3, PLANTED_RANK, seed=4)
    value_frac = rt.value_qformat(st.values).frac_bits
    safe = {p: rt.accumulator_safe_nnz(p, value_frac=value_frac) for p in ("int7", "int15-12")}
    log(f"[4g] planted rank-{PLANTED_RANK} cube side {PLANTED_SIDE}: nnz={st.nnz}, "
        f"value_frac={value_frac}, per-row nnz {PLANTED_SIDE ** 2} vs accumulator_safe_nnz "
        f"{safe} (built in {time.perf_counter() - t0:.1f}s)")
    if PLANTED_SIDE ** 2 > min(safe.values()):
        fail("the planted cube's rows exceed a preset's accumulator bound")
    runs = planted_runs(f"cube {PLANTED_SIDE}", st)
    fig6(f"the planted cube of side {PLANTED_SIDE}", *runs, diff_within_5pct=False)
    if not all(r.fit_history[-1] > 0.8 and r.fit_history[-1] >= r.fit_history[0]
               for r in runs[:2]):
        fail("float or int15-12 cp_als did not converge on the planted cube")
    return st

def format_checks(label, st, device, formats) -> dict:
    """Phase 4h per-mode checks for one case: the `alto` and `csf` engines
    against `ref` on the card, every mode, with each layout's host build
    time and index bytes.  Returns the three engines."""
    ref = rt.build_engine(st, "ref", RANK)
    bits = rt.alto_key_bits(st.shape)
    t0 = time.perf_counter()
    alto = rt.build_engine(st, "alto", RANK, formats=formats)
    t_alto = time.perf_counter() - t0
    stats = rt.FormatStats.estimate(st.shape, st.nnz)
    if bits > MAX_KEY_BITS:
        if formats.stats.alto_misses:
            fail(f"case {label}: an ALTO layout was built for a {bits}-bit key")
        log(f"[4h] {label}: alto_key_bits={bits} > {MAX_KEY_BITS}: the alto engine took the "
            f"ALTO-ordered COO baseline (alto_order + upload {t_alto:.1f}s; COO index bytes "
            f"{int(stats.coo_index_bytes())})")
    else:
        at = formats.alto(st)
        log(f"[4h] {label}: ALTO layout built and moved in {t_alto:.1f}s: key_bits={bits} "
            f"words={at.n_words} index_bytes={at.index_bytes} (COO {int(stats.coo_index_bytes())})")
    csf = rt.build_engine(st, "csf", RANK, formats=formats)
    for mode in range(st.ndim):
        t0 = time.perf_counter()
        tree = formats.csf(st, mode)
        t_tree = time.perf_counter() - t0
        log(f"[4h] {label}: CSF tree mode {mode} (inner mode {tree.inner_mode}) built in "
            f"{t_tree:.1f}s: n_fibers={tree.n_fibers} nonzeros per fiber="
            f"{st.nnz / max(tree.n_fibers, 1):.3f} index_bytes={tree.index_bytes} "
            f"(balls-in-bins estimate {stats.fiber_counts[mode]} fibers)")
    factors = rt.init_factors(st.shape, RANK, seed=0, device=device)
    abs_factors = [f.abs() for f in factors]
    coords = torch.from_numpy(st.coords).to(device)
    abs_values = torch.from_numpy(np.abs(st.values)).to(device)
    for mode in range(st.ndim):
        want = ref(factors, mode)
        terms = rt.mttkrp_coo(abs_factors, coords, abs_values, mode=mode, out_dim=st.shape[mode])
        for name, eng in (("alto", alto), ("csf", csf)):
            got = eng(factors, mode)
            torch.cuda.synchronize()
            err, bad = sum_order_error(got, want, terms)
            finite = bool(torch.isfinite(got).all())
            log(f"[4h]   {label} mode {mode} {name} vs ref: max|err|={err:.3e} outside={bad}")
            if bad or not finite or tuple(got.shape) != tuple(want.shape):
                fail(f"case {label} mode {mode}: the {name} engine disagrees with ref")
        del want, terms, got
    return dict(ref=ref, alto=alto, csf=csf)


def format_main_runs(st, plan, engines, kernel_run) -> int:
    """Phase 4h at case (a): cp_als through `alto`, `csf` and `hetero`, each
    with its launches counted from 0, fit and factors against the `kernel`
    run of phase 4.  Returns hetero's float-kernel launches."""
    split = rt.split_tasks(default_plan_cache.chunked(st, plan.chunk_shape, plan.capacity), RANK)
    log(f"[4h] hetero split at (a): dense tasks={split.dense_idx.size} sparse tasks="
        f"{split.sparse_idx.size} (chunk volume {math.prod(plan.chunk_shape)} > "
        f"MAX_DENSE_VOLUME {rt.MAX_DENSE_VOLUME}: every task sparse)")
    if split.dense_idx.size:
        fail("hetero at (a): a chunk past MAX_DENSE_VOLUME went dense")
    hetero_launches = 0
    for name in ("alto", "csf", "hetero"):
        mttkrp_kernel.launches = 0
        mttkrp_fixed_kernel.launches = 0
        torch.cuda.reset_peak_memory_stats()
        base_bytes = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        res = rt.cp_als(st, RANK, n_iters=N_ITERS, engine=engines[name], seed=0)
        t_run = time.perf_counter() - t0
        launches, fixed_launches = mttkrp_kernel.launches, mttkrp_fixed_kernel.launches
        want = N_ITERS * st.ndim if name == "hetero" else 0
        fit_gap = max(abs(a - b) for a, b in zip(res.fit_history, kernel_run.fit_history,
                                                 strict=True))
        factor_gap = max(float((a - b).abs().max())
                         for a, b in zip(res.factors, kernel_run.factors, strict=True))
        log(f"[4h] cp_als engine={res.engine} at (a) in {t_run:.1f}s: float kernel launches="
            f"{launches} (expected {want}), fixed kernel launches={fixed_launches}")
        log(f"[4h]   fit_history={res.fit_history} |fit - fit kernel| max={fit_gap:.3e} "
            f"(tolerance {FIT_ATOL}); max |factor - factor kernel|={factor_gap:.3e} "
            f"(tolerance {FACTOR_ATOL})")
        log(f"[4h]   iter_times={res.iter_times} steady={steady(res.iter_times):.3f} ms; device "
            f"memory resident before {base_bytes / 2**30:.3f} GiB, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        if launches != want or fixed_launches != 0:
            fail(f"{name} at (a) launched the float kernel {launches} times (expected {want}) "
                 f"and the fixed one {fixed_launches} times (expected 0)")
        if not all(math.isfinite(v) for v in res.fit_history) or fit_gap > FIT_ATOL \
                or factor_gap > FACTOR_ATOL:
            fail(f"cp_als through {name} at (a) left the kernel run")
        if name == "hetero":
            hetero_launches = launches
    return hetero_launches


def planted_hetero(st) -> int:
    """Phase 4h on the planted cube of phase 4g under the 256 KiB plan:
    cp_als at rank 5 through `hetero` with the cost model's split (every
    task dense: no kernel launch) and with dense_fraction 0.5 (the sparse
    half: n_iters × 3 launches), fit against `kernel` on the same plan.
    Returns the launches of both runs."""
    plan = rt.decide_partition(st, 5, mem_bytes=EXAMPLE_MEM, rank_axis=5)
    chunking = dict(chunk_shape=plan.chunk_shape, capacity=plan.capacity)
    ct = default_plan_cache.chunked(st, plan.chunk_shape, plan.capacity)
    density = ct.nnz_per_task / math.prod(ct.chunk_shape)
    kern = rt.cp_als(st, 5, n_iters=N_ITERS, engine="kernel", seed=5, **chunking)
    log(f"[4h] cube {PLANTED_SIDE}, 256 KiB plan: chunk={ct.chunk_shape} T={ct.num_tasks} "
        f"density {density.min():.3f}-{density.max():.3f}; kernel fit={kern.fit_history} "
        f"steady={steady(kern.iter_times):.3f} ms")
    total = 0
    for fraction in (None, 0.5):
        split = rt.split_tasks(ct, 5, dense_fraction=fraction)
        mttkrp_kernel.launches = 0
        mttkrp_fixed_kernel.launches = 0
        res = rt.cp_als(st, 5, n_iters=N_ITERS, engine="hetero", seed=5,
                        dense_fraction=fraction, **chunking)
        launches, fixed_launches = mttkrp_kernel.launches, mttkrp_fixed_kernel.launches
        want = N_ITERS * st.ndim if split.sparse_idx.size else 0
        gap = max(abs(a - b) for a, b in zip(res.fit_history, kern.fit_history, strict=True))
        log(f"[4h]   hetero dense_fraction={fraction}: dense tasks={split.dense_idx.size} "
            f"sparse tasks={split.sparse_idx.size}; float kernel launches={launches} (expected "
            f"{want}); fit={res.fit_history} max |fit - fit kernel|={gap:.3e} (tolerance "
            f"{PLANTED_FIT_ATOL}); steady={steady(res.iter_times):.3f} ms")
        split_ok = (split.sparse_idx.size == 0 if fraction is None
                    else split.dense_idx.size and split.sparse_idx.size)
        if not split_ok:
            fail(f"cube: the hetero split for dense_fraction={fraction} is not the one expected")
        if launches != want or fixed_launches or gap > PLANTED_FIT_ATOL:
            fail(f"cube: hetero with dense_fraction={fraction} launched the float kernel "
                 f"{launches} times (expected {want}) and the fixed one {fixed_launches} times, "
                 f"or left kernel's fit")
        total += launches
    return total


def path_bytes(st, mode: int, index_bytes: float) -> float:
    """Bytes one MTTKRP must move: its index structure and the values read
    once, every input factor read once and the output written once."""
    return (index_bytes + 4 * st.nnz
            + sum(st.shape[m] * RANK * 4 for m in range(st.ndim) if m != mode)
            + st.shape[mode] * RANK * 4)


def time_roles(st, ct, dev, engines, formats, device) -> dict:
    """Phase 5h: each execution role's MTTKRP per mode at case (a), timed in
    turns (each path once forward and once back), beside the bytes it must
    move and their bound; and ALTO's de-interleave of all modes alone.
    Returns each path's mean ms per mode."""
    trees = [formats.csf(st, m) for m in range(st.ndim)]
    stats = rt.FormatStats(shape=st.shape, nnz=st.nnz,
                           fiber_counts=tuple(t.n_fibers for t in trees),
                           key_bits=rt.alto_key_bits(st.shape),
                           key_words=formats.alto(st).n_words)
    factors = rt.init_factors(st.shape, RANK, seed=0, device=device)
    cs = ct.chunk_shape
    tc, cr, vals, nnz = dev["task_chunk"], dev["coords_rel"], dev["values"], dev["nnz_per_task"]
    key_words = formats.device_alto(st, device)["key_words"]
    words = [key_words[:, w].contiguous() for w in range(key_words.shape[1])]
    positions = formats.alto(st).positions
    paths = {
        "ref": engines["ref"], "alto": engines["alto"], "csf": engines["csf"],
        "chunked": lambda f, mode: rt.mttkrp_chunked(f, tc, cr, vals, mode=mode, chunk_shape=cs,
                                                     out_dim=st.shape[mode]),
        "kernel_op": lambda f, mode: rt.mttkrp_kernel_op(f, tc, cr, vals, mode=mode,
                                                         chunk_shape=cs, out_dim=st.shape[mode],
                                                         nnz_per_task=nnz),
        "hetero": engines["hetero"],
        # ALTO's de-interleave of every mode alone, to split its time
        "alto_decode": lambda f, mode: [_alto_decode(words, p) for p in positions],
    }
    reps = dict(ref=3, alto=3, csf=3, chunked=3, kernel_op=10, hetero=10, alto_decode=3)
    mean_ms = {name: [] for name in paths}
    for mode in range(st.ndim):
        runs = {name: [] for name in paths}
        for name in [*paths, *reversed(paths)]:
            runs[name].append(time_ms(lambda name=name, mode=mode: paths[name](factors, mode),
                                      reps[name]))
        index = dict(ref=stats.coo_index_bytes(), alto=stats.alto_index_bytes(),
                     csf=stats.csf_index_bytes(mode), chunked=stats.coo_index_bytes(),
                     kernel_op=stats.coo_index_bytes(), hetero=stats.coo_index_bytes())
        row = {}
        for name, times in runs.items():
            # the decode reads the key words once and writes N coordinate columns
            nbytes = (stats.alto_index_bytes() + stats.coo_index_bytes() if name == "alto_decode"
                      else path_bytes(st, mode, index[name]))
            row[name] = dict(ms=float(np.mean(times)), runs=times, bytes=nbytes,
                             bound_ms=1e3 * nbytes / HBM_BYTES_PER_S)
            mean_ms[name].append(row[name]["ms"])
        log(f"[5h] mode {mode}: " + json.dumps(row))
    return mean_ms


FLOAT_KERNEL_BACKENDS = ("kernel", "hetero")   # the auto candidates that launch the float kernel
LOSSLESS = ("ref", "alto", "csf", "chunked", "kernel", "hetero")
ROLE_OF = dict(ref="ref", alto="alto", csf="csf", chunked="chunked", kernel="kernel_op",
               hetero="hetero")   # autotune candidate -> phase 5h path


def measured_order(report) -> list[str]:
    """The probed candidates by their measured seconds summed over the modes."""
    return sorted(report.timings, key=lambda n: (sum(report.timings[n].values()), n))


def log_report(tag, report, role_ms=None) -> None:
    """A tune's summary, prior and measured orders, and each probe's time
    (beside phase 5h's time for the same path, where given)."""
    for line in report.summary().splitlines():
        log(f"[4a]   {tag}: {line}")
    log(f"[4a]   {tag}: prior={report.prior_name} prior order={report.prior_order} "
        f"measured order={measured_order(report)} probes={report.probe_breakdown()}")
    for name, per in sorted(report.timings.items()):
        beside = ""
        if role_ms is not None and name in ROLE_OF:
            beside = " | 5h " + " ".join(f"m{m}={t:.3f}ms" for m, t in enumerate(role_ms[ROLE_OF[name]]))
        log(f"[4a]   {tag}: {name:16s} " + " ".join(f"m{m}={t * 1e3:.3f}ms"
                                                   for m, t in sorted(per.items())) + beside)


#: The only reasons a phase-4a tune may skip a candidate; any other is a failure.
ALLOWED_SKIPS = ("pruned by cost-model prior", "over accuracy budget")


def require_allowed_skips(tag, report) -> None:
    """Fail unless every skipped candidate was pruned by the prior or
    rejected over an accuracy budget."""
    bad = {n: why for n, why in report.skipped.items() if not why.startswith(ALLOWED_SKIPS)}
    if bad:
        fail(f"the {tag} tune skipped candidates for a failure: {bad}")


def autotune_checks(st, plan, formats, kernel_run, role_ms, device) -> int:
    """Phase 4a: the autotuner on the card (see the module docstring).
    Returns the float kernel's launches in cp_als through the tuned engine
    at (a)."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_autotune_")
    try:
        return _autotune_checks(st, plan, formats, kernel_run, role_ms, device, Path(tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _autotune_checks(st, plan, formats, kernel_run, role_ms, device, tmp: Path) -> int:
    chunking = dict(chunk_shape=plan.chunk_shape, capacity=plan.capacity)
    fp = rt.engine.device_fingerprint(device)
    log(f"[4a] device_fingerprint={fp} id={rt.engine.device_fingerprint_id(fp)}")

    # 1. The README's quickstart on the card, against a `kernel` run.
    small = rt.table1_tensor("nell2")
    t0 = time.perf_counter()
    quick = rt.cp_als(small, 10, n_iters=5, engine="auto")
    t_quick = time.perf_counter() - t0
    kern = rt.cp_als(small, 10, n_iters=5, engine="kernel")
    gap = max(abs(a - b) for a, b in zip(quick.fit_history + quick.diff_history,
                                         kern.fit_history + kern.diff_history, strict=True))
    log(f"[4a] quickstart cp_als(table1_tensor('nell2'), 10, n_iters=5, engine='auto') in "
        f"{t_quick:.2f}s: engine={quick.engine} fit={quick.fit_history}; kernel fit="
        f"{kern.fit_history}; max gap (fit, diff)={gap:.3e} (tolerance {SMALL_ATOL})")
    log_report("quickstart", quick.tune_report)
    require_allowed_skips("quickstart", quick.tune_report)
    if gap > SMALL_ATOL or not quick.engine.startswith("auto:"):
        fail("the quickstart's auto run left the kernel run")

    # 2. Cold tune at (a), then cp_als through the tuned engine.  The tuner
    # measures the tensor's FormatStats once (exact fiber counts, from 5h's
    # cached CSF trees, in `formats`); they are taken first here, so that
    # their host time shows apart from the probes'.
    t0 = time.perf_counter()
    stats = rt.engine.WorkloadStats(st.shape, st.nnz, formats.format_stats(st))
    log(f"[4a] FormatStats of (a) measured in {time.perf_counter() - t0:.1f}s: fibers "
        f"{stats.format_stats.fiber_counts}; analytic prior order at (a): "
        f"{rt.engine.prior_order(stats, RANK, list(LOSSLESS))}")
    cold_store = tmp / "cold.json"
    t0 = time.perf_counter()
    cold = rt.build_engine(st, "auto", RANK, formats=formats,
                           tune=rt.TunePolicy(store=rt.TuningStore(cold_store)), **chunking)
    t_cold = time.perf_counter() - t0
    rep = cold.report
    log(f"[4a] cold tune at (a) in {t_cold:.2f}s: engine={cold.name}")
    log_report("cold", rep, role_ms)
    require_allowed_skips("cold", rep)
    lost = sorted(set(LOSSLESS) & set(rep.skipped))
    if lost:
        fail(f"cold tune at (a) skipped {lost}: {[rep.skipped[n] for n in lost]}")
    if not set(rep.winners.values()) <= set(FLOAT_KERNEL_BACKENDS):
        fail(f"cold tune at (a) chose {rep.winners}, not the float-kernel backends")
    mttkrp_kernel.launches = 0
    mttkrp_fixed_kernel.launches = 0
    t0 = time.perf_counter()
    res = rt.cp_als(st, RANK, n_iters=N_ITERS, engine=cold, seed=0)
    t_run = time.perf_counter() - t0
    launches, fixed_launches = mttkrp_kernel.launches, mttkrp_fixed_kernel.launches
    fit_gap = max(abs(a - b) for a, b in zip(res.fit_history, kernel_run.fit_history, strict=True))
    factor_gap = max(float((a - b).abs().max())
                     for a, b in zip(res.factors, kernel_run.factors, strict=True))
    log(f"[4a] cp_als engine={res.engine} at (a) in {t_run:.1f}s: float kernel launches="
        f"{launches} (expected "
        f"{N_ITERS * st.ndim}), fixed kernel launches={fixed_launches}; |fit - fit kernel| max="
        f"{fit_gap:.3e} (tolerance {FIT_ATOL}); max |factor - factor kernel|={factor_gap:.3e} "
        f"(tolerance {FACTOR_ATOL})")
    log(f"[4a]   steady iteration: auto {steady(res.iter_times):.3f} ms, kernel "
        f"{steady(kernel_run.iter_times):.3f} ms; iter_times={res.iter_times}")
    if launches != N_ITERS * st.ndim or fixed_launches:
        fail(f"cp_als through the auto engine launched the float kernel {launches} times "
             f"(expected {N_ITERS * st.ndim}) and the fixed one {fixed_launches} times")
    if fit_gap > FIT_ATOL or factor_gap > FACTOR_ATOL:
        fail("cp_als through the auto engine left the kernel run")

    # 3. Warm hit on the same store.
    t0 = time.perf_counter()
    warm = rt.build_engine(st, "auto", RANK, formats=formats,
                           tune=rt.TunePolicy(store=rt.TuningStore(cold_store)), **chunking)
    t_warm = time.perf_counter() - t0
    wrep = warm.report
    log(f"[4a] warm hit in {t_warm:.3f}s (cold {t_cold:.2f}s): source={wrep.source} "
        f"probes={wrep.n_probes} winners={wrep.winners}")
    require_allowed_skips("warm", wrep)
    if wrep.source != "persisted" or wrep.n_probes != 0 or wrep.winners != rep.winners:
        fail("the warm tune at (a) was not a zero-probe hit with the cold winners")

    # 4. Pruning by the analytic prior: printed, not held.
    t0 = time.perf_counter()
    pruned = rt.build_engine(st, "auto", RANK, formats=formats, **chunking,
                             tune=rt.TunePolicy(max_probes=3,
                                                store=rt.TuningStore(tmp / "pruned.json")))
    prep = pruned.report
    log(f"[4a] max_probes=3 in {time.perf_counter() - t0:.2f}s: probed {sorted(prep.timings)} "
        f"(prior order {prep.prior_order}); "
        f"picked {prep.winners}; the full measurement picked {rep.winners}")
    require_allowed_skips("max_probes=3", prep)

    # 5. Calibration on the six TABLE1 tensors, then a calibrated, elided tune.
    cal_store = rt.TuningStore(tmp / "calibration.json")
    t0 = time.perf_counter()
    for name in rt.TABLE1:
        eng = rt.build_engine(rt.table1_tensor(name), "auto", RANK,
                              tune=rt.TunePolicy(store=cal_store, prior="default"))
        log(f"[4a] TABLE1 {name}: winners={eng.report.winners} probes={eng.report.n_probes} "
            f"skipped={eng.report.skipped}")
        require_allowed_skips(f"TABLE1 {name}", eng.report)
    n_obs = len(cal_store.observations(device=fp))
    log(f"[4a] calibration store: {len(cal_store)} workloads, {n_obs} observations "
        f"(MIN_OBSERVATIONS {MIN_OBSERVATIONS}) in {time.perf_counter() - t0:.1f}s")
    cal = rt.CalibratedPrior.from_store(cal_store)
    for line in cal.calibration.summary().splitlines():
        log(f"[4a]   {line}")
    hits = rt.engine.ranking_accuracy(cal_store, cal)
    base = rt.engine.ranking_accuracy(cal_store, rt.engine.default_prior)
    log(f"[4a]   used_fit={cal.used_fit} suggested_margin={cal.suggested_margin:.3f} "
        f"ranking accuracy: calibrated {hits[0]}/{hits[1]}, default {base[0]}/{base[1]}")
    log(f"[4a]   calibrated order at (a): {cal.order(stats, RANK, list(LOSSLESS))}")
    t0 = time.perf_counter()
    calibrated = rt.build_engine(st, "auto", RANK, formats=formats, **chunking,
                                 tune=rt.TunePolicy(store=cal_store, prior="calibrated"))
    crep = calibrated.report
    log(f"[4a] calibrated cold tune at (a) in {time.perf_counter() - t0:.2f}s: "
        f"probes={crep.n_probes} elided={crep.n_elided} "
        f"(full sweep {len(rep.timings) * st.ndim}); winners equal to the cold tune's: "
        f"{crep.winners == rep.winners}")
    log_report("calibrated", crep, role_ms)
    require_allowed_skips("calibrated", crep)
    if crep.source != "measured" or not set(crep.winners.values()) <= set(FLOAT_KERNEL_BACKENDS):
        fail(f"the calibrated tune at (a) chose {crep.winners}, not the float-kernel backends")

    # 6. Accuracy budget at (a): int7 over budget, the fixed kernel probed.
    mttkrp_fixed_kernel.launches = 0
    t0 = time.perf_counter()
    budgeted = rt.build_engine(st, "auto", RANK, formats=formats, **chunking,
                               tune=rt.TunePolicy(candidates=("kernel", "fixed:int7",
                                                              "fixed:int15-12"),
                                                  accuracy_budget=1e-2,
                                                  store=rt.TuningStore(tmp / "budget.json")))
    brep = budgeted.report
    probe_launches = mttkrp_fixed_kernel.launches
    log(f"[4a] accuracy_budget=1e-2 at (a) in {time.perf_counter() - t0:.1f}s (host: the "
        f"values quantized per preset, the error sample's exact subset): errors={brep.errors} "
        f"skipped={brep.skipped} "
        f"winners={brep.winners}; fixed kernel launches during the probes={probe_launches}")
    require_allowed_skips("budgeted", brep)
    if "over accuracy budget" not in brep.skipped.get("fixed:int7", ""):
        fail("fixed:int7 was not rejected over the 1e-2 budget at (a)")
    if probe_launches == 0:
        fail("the budgeted tune at (a) never launched the fixed kernel")
    return launches


# ---------------------------------------------------------------------------
# Phases 4s and 4b: the serving path (DecomposeService over cp_als_batched).
# ---------------------------------------------------------------------------

SERVE_RANK, SERVE_ITERS = 5, 3     # benchmarks/serve_bench.py's RANK and N_ITERS
SERVE_N, SERVE_CLIENTS, SERVE_MAX_BATCH, SERVE_MAX_WAIT_MS = 4096, 8, 256, 20.0
SERVE_WARM_N = 512                 # the warm second service's share of the load
SEQ_SAMPLE, BATCH_SAMPLE = 32, 64  # members held against the sequential `ref` run
BATCH_N = 65536                    # phase 4b: 2^16 tensors in one cp_als_batched call
# Parity of two batched or sequential runs of the same tensor (see the module
# docstring): factors and λ/max(1, |λ|) within max(1e-5, κ·2^-17), fits within
# max(1e-6, κ·2^-20) per iteration, κ from `solve_kappa`.
BATCH_FACTOR_ATOL, BATCH_FACTOR_KAPPA = 1e-5, 2.0 ** -17
BATCH_FIT_ATOL, BATCH_FIT_KAPPA = 1e-6, 2.0 ** -20


def synthetic_load(n: int, seed: int = 0) -> list[rt.SparseTensor]:
    """`n` small tensors drawn from three shape/nnz families, shuffled — the
    arrival order interleaves buckets the way concurrent users would (a
    copy of benchmarks/serve_bench.py's load)."""
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
        tensors.append(rt.SparseTensor(coords, values, shape))
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


def hold_gap(tag: str, got, want, against: str) -> None:
    """Hold two lists of CPResults of the same tensors together, each member
    at its own tolerances (BATCH_FACTOR_*, BATCH_FIT_*; κ from `want`)."""
    worst_gap = worst_fit = worst_ratio = worst_kappa = 0.0
    over_floor = 0
    for a, b in zip(got, want, strict=True):
        fa = [f.cpu().numpy() for f in a.factors]
        fb = [f.cpu().numpy() for f in b.factors]
        la, lb = a.lam.cpu().numpy(), b.lam.cpu().numpy()
        kappa = solve_kappa(fb)
        gap = max(max(float(np.abs(x - y).max()) for x, y in zip(fa, fb, strict=True)),
                  float((np.abs(la - lb) / np.maximum(np.abs(lb), 1.0)).max()))
        fit = max(abs(x - y) for x, y in zip(a.fit_history, b.fit_history, strict=True))
        over_floor += gap > BATCH_FACTOR_ATOL
        worst_ratio = max(worst_ratio,
                          gap / max(BATCH_FACTOR_ATOL, BATCH_FACTOR_KAPPA * kappa),
                          fit / max(BATCH_FIT_ATOL, BATCH_FIT_KAPPA * kappa))
        worst_gap, worst_fit = max(worst_gap, gap), max(worst_fit, fit)
        worst_kappa = max(worst_kappa, kappa)
    log(f"[{tag}]   {len(got)} results against {against}: max |Δ factor or Δλ/max(1,|λ|)|="
        f"{worst_gap:.3e} (above {BATCH_FACTOR_ATOL} in {over_floor}), max |Δ fit|="
        f"{worst_fit:.3e}, max κ={worst_kappa:.1f}; max gap/tolerance={worst_ratio:.3f}")
    if worst_ratio > 1.0:
        fail(f"phase {tag}: the results left {against}")


def sequential_ref(tensors, device) -> tuple[list[rt.CPResult], float]:
    """cp_als(engine="ref") one tensor at a time; (results, seconds)."""
    t0 = time.perf_counter()
    out = [rt.cp_als(t, SERVE_RANK, SERVE_ITERS, engine="ref", track_diff=False, device=device)
           for t in tensors]
    torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def drive_service(tensors, tune, device) -> tuple[list[rt.CPResult], rt.ServeStats, float, dict]:
    """serve_bench's closed-loop load: SERVE_CLIENTS threads, each submitting
    its share one request at a time and waiting for each result.  Returns
    (results in input order, stats, wall seconds, metrics snapshot); any
    failed request fails the run."""
    results: list = [None] * len(tensors)
    errors: list[str] = []
    svc = rt.DecomposeService(SERVE_RANK, SERVE_ITERS, tune=tune, max_batch=SERVE_MAX_BATCH,
                              max_wait_ms=SERVE_MAX_WAIT_MS, device=device)
    try:
        def client(idxs):
            for i in idxs:
                try:
                    results[i] = svc.decompose(tensors[i], timeout=600)
                except Exception as e:  # recorded, then fatal below
                    errors.append(f"request {i}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=client, args=(range(c, len(tensors), SERVE_CLIENTS),))
                   for c in range(SERVE_CLIENTS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        wall = time.perf_counter() - t0
    finally:
        svc.close(timeout=120)
    stats = svc.stats()
    if errors or any(th.is_alive() for th in threads) or stats.n_failed \
            or stats.n_completed != len(tensors):
        fail(f"phase 4s: {stats.n_failed} failed, {stats.n_completed} of {len(tensors)} "
             f"completed; client errors {errors[:3]}")
    return results, stats, wall, svc.metrics.snapshot()


def log_service(tag: str, stats, wall: float, n: int) -> None:
    log(f"[4s] {tag}: {n} requests in {wall:.2f}s = {n / wall:.1f} tensors/s; "
        f"batches={stats.n_batches} max_batch_seen={stats.max_batch_seen} "
        f"buckets={stats.n_buckets} probes={stats.n_probes} "
        f"decisions={stats.n_bucket_decisions} dispatch_seconds={stats.dispatch_seconds:.2f}")
    log(f"[4s]   {tag}: queue_wait_ms={stats.queue_wait_ms} dispatch_ms={stats.dispatch_ms} "
        f"request_ms={stats.request_ms}")


def bucket_reports(results) -> dict:
    """The distinct bucket reports among `results`, by identity."""
    return {id(r.tune_report): r.tune_report for r in results}


def distributed_checks(st, plan, kernel_run, device) -> int:
    """Phase 4d: the `distributed` engine at case (a) on a (1, 1) mesh of a
    one-rank NCCL group (the card's host has one card, and NCCL refuses two
    ranks on one device), reusing the plan cache's layouts.  Returns the
    float kernel's launches in its cp_als runs."""
    chunking = dict(chunk_shape=plan.chunk_shape, capacity=plan.capacity)
    cs = plan.chunk_shape
    dev = default_plan_cache.device_arrays(st, cs, plan.capacity, device)
    kern = rt.build_engine(st, "kernel", RANK, **chunking)
    factors = rt.init_factors(st.shape, RANK, seed=0, device=device)
    abs_factors = [f.abs() for f in factors]
    tc, cr, vals, nnz = (dev["task_chunk"], dev["coords_rel"], dev["values"],
                         dev["nnz_per_task"])
    launches = 0
    try:
        for reduce in ("psum", "psum_scatter"):
            t0 = time.perf_counter()
            eng = rt.build_engine(st, "distributed", RANK, reduce=reduce, **chunking)
            t_build = time.perf_counter() - t0
            dmt = eng.fn
            if dist.get_backend() != "nccl" or mesh_axes(dmt.mesh) != {"data": 1, "model": 1}:
                fail(f"phase 4d: mesh {mesh_axes(dmt.mesh)} on {dist.get_backend()}, expected "
                     "(1, 1) on nccl")
            if dmt.arrays["values"].data_ptr() != vals.data_ptr():
                fail("phase 4d: the distributed engine moved a second copy of the tensor")
            log(f"[4d] reduce={reduce}: built in {t_build:.2f}s, nccl "
                f"{'.'.join(map(str, torch.cuda.nccl.version()))}, mesh {mesh_axes(dmt.mesh)}")
            for mode in range(st.ndim):
                got, want = eng(factors, mode), kern(factors, mode)
                terms = rt.mttkrp_chunked(abs_factors, tc, cr, vals.abs(), mode=mode,
                                          chunk_shape=cs, out_dim=st.shape[mode])
                torch.cuda.synchronize()
                err = (got - want).abs()
                bad = int((err > DIST_REL_TOL * terms).sum())
                k1, d1, d2, k2 = (
                    time_ms(lambda mode=mode: rt.mttkrp_kernel_op(
                        factors, tc, cr, vals, mode=mode, chunk_shape=cs,
                        out_dim=st.shape[mode], nnz_per_task=nnz), 10),
                    time_ms(lambda mode=mode: eng(factors, mode), 10),
                    time_ms(lambda mode=mode: eng(factors, mode), 10),
                    time_ms(lambda mode=mode: rt.mttkrp_kernel_op(
                        factors, tc, cr, vals, mode=mode, chunk_shape=cs,
                        out_dim=st.shape[mode], nnz_per_task=nnz), 10))
                log(f"[4d]   mode {mode}: max|dist - kernel|={float(err.max()):.3e} "
                    f"outside {DIST_REL_TOL}·Σ|terms|={bad}; ms distributed {d1:.3f} / {d2:.3f}, "
                    f"kernel op {k1:.3f} / {k2:.3f}")
                if bad or tuple(got.shape) != (st.shape[mode], RANK):
                    fail(f"phase 4d {reduce} mode {mode}: the distributed engine left `kernel`")
                del got, want, terms, err
            dmt.log.clear()
            mttkrp_kernel.launches = 0
            torch.cuda.reset_peak_memory_stats()
            res = rt.cp_als(st, RANK, n_iters=N_ITERS, engine=eng, seed=0)
            n = mttkrp_kernel.launches
            peak = torch.cuda.max_memory_allocated()
            wire = collective_bytes(dmt.log)
            fit_gap = max(abs(a - b) for a, b in zip(res.fit_history, kernel_run.fit_history,
                                                      strict=True))
            factor_gap = max(float((a - b).abs().max())
                             for a, b in zip(res.factors, kernel_run.factors, strict=True))
            log(f"[4d]   cp_als reduce={reduce}: kernel launches={n}, fit_history="
                f"{res.fit_history}, iter_times={res.iter_times}, |fit - kernel fit| max "
                f"{fit_gap:.3e} (tolerance {FIT_ATOL}), |factors - kernel's| max "
                f"{factor_gap:.3e} (tolerance {FACTOR_ATOL}), peak {peak / 2**30:.3f} GiB")
            log(f"[4d]   collectives: {json.dumps(wire)}")
            if n != N_ITERS * st.ndim:
                fail(f"phase 4d: the float kernel launched {n} times, expected "
                     f"{N_ITERS * st.ndim}")
            if fit_gap > FIT_ATOL or factor_gap > FACTOR_ATOL:
                fail(f"phase 4d {reduce}: cp_als left phase 4's kernel run")
            if wire["count"] != len(dmt.log) or wire["count"] == 0 or wire["total_wire_bytes"]:
                fail(f"phase 4d: collectives {wire} (expected some, 0 wire bytes at group size 1)")
            launches += n
            del eng, dmt, res
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return launches


def sweep_checks(device) -> None:
    """Phase 4w: the CI grid of benchmarks/sweep_ci.toml plus the `kernel`
    candidate swept into a fresh store on the card, swept again (0
    probes), and its Pareto report against the card's roofline."""
    ci = rt.load_config(ROOT / "benchmarks" / "sweep_ci.toml")
    spec = dataclasses.asdict(ci)
    spec["candidates"] = [*ci.candidates, "kernel"]
    spec["capacities"] = [c or 0 for c in ci.capacities]  # TOML's "decider" sentinel
    cfg = rt.SweepConfig.from_dict(spec)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_sweep_"))
    try:
        store_path = tmp / "sweep.json"
        t0 = time.perf_counter()
        first = rt.run_sweep(cfg, store_path)
        t_first = time.perf_counter() - t0
        for o in first.outcomes:
            log(f"[4w] {o.cell}: {o.status} probes={o.n_probes} winners={o.winners} "
                f"{o.seconds:.2f}s{' ' + o.error if o.error else ''}")
        log(f"[4w] sweep of {len(first.outcomes)} cells over {list(cfg.candidates)}: "
            f"{first.n_probes} probes in {t_first:.2f}s")
        if first.count("measured") != len(cfg.cells()):
            fail(f"phase 4w: cells {first.to_json()['counts']}, expected every one measured")
        t0 = time.perf_counter()
        second = rt.run_sweep(cfg, store_path)
        log(f"[4w] resumed sweep: {second.n_probes} probes, {second.to_json()['counts']} in "
            f"{time.perf_counter() - t0:.2f}s")
        if second.n_probes or second.count("complete") != len(cfg.cells()):
            fail("phase 4w: the resumed sweep measured again")
        report = rt.pareto_report(TuningStore(store_path, nnz_tol=0.0), hw=H100_SXM5)
        fractions = [p["peak_fraction"] for p in report["points"]]
        log(f"[4w] pareto: {report['n_points']} points, {report['n_pareto']} on the front, "
            f"peak_fraction {min(fractions):.3e}..{max(fractions):.3e} against {report['hw']}")
        for p in report["front"]:
            log(f"[4w]   front {p['cell']} {p['candidate']}: {p['time_s'] * 1e3:.3f} ms, "
                f"rel_error {p['rel_error']:.3e}, index {p['index_bytes']:.0f} B")
        if not report["front"] or not all(0.0 <= f <= 1.05 for f in fractions):
            fail("phase 4w: empty Pareto front or a peak_fraction outside [0, 1.05]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def serve_checks(device) -> None:
    """Phase 4s: DecomposeService on the card (see the module docstring)."""
    t0 = time.perf_counter()
    tensors = synthetic_load(SERVE_N, seed=0)
    log(f"[4s] synthetic_load({SERVE_N}, seed=0) in {time.perf_counter() - t0:.2f}s; rank "
        f"{SERVE_RANK}, {SERVE_ITERS} iterations, {SERVE_CLIENTS} closed-loop clients, "
        f"max_batch={SERVE_MAX_BATCH}, max_wait_ms={SERVE_MAX_WAIT_MS}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        store = Path(tmp) / "serve.json"
        results, stats, wall, snap = drive_service(
            tensors, rt.TunePolicy(store=rt.TuningStore(store)), device)
        log_service("cold service", stats, wall, len(tensors))
        for name in ("serve.queue_wait_seconds", "serve.dispatch_seconds",
                     "serve.request_seconds"):
            h = snap[name]
            log(f"[4s]   {name}: count={h['count']} p50={h['p50'] * 1e3:.3f}ms "
                f"p99={h['p99'] * 1e3:.3f}ms max={h['max'] * 1e3:.3f}ms")
        if stats.n_probes == 0 or "measured" not in stats.n_bucket_decisions:
            fail("phase 4s: the cold service on a fresh store made no measured decision")

        warm_res, wstats, wwall, _ = drive_service(
            tensors[:SERVE_WARM_N], rt.TunePolicy(store=rt.TuningStore(store)), device)
        log_service("warm service (second service, same store)", wstats, wwall, SERVE_WARM_N)
        if wstats.n_probes != 0 or not set(wstats.n_bucket_decisions) <= {"persisted", "cached"}:
            fail(f"phase 4s: the warm service probed ({wstats.n_probes} probes, decisions "
                 f"{wstats.n_bucket_decisions})")
        hold_gap("4s", warm_res, results[:SERVE_WARM_N], "the cold service's")

        # One batched call over the same tensors, warm on the same store, so
        # that it runs the kernels the service ran.
        t0 = time.perf_counter()
        batched = rt.cp_als_batched(tensors, SERVE_RANK, SERVE_ITERS,
                                    tune=rt.TunePolicy(store=rt.TuningStore(store)), device=device)
        torch.cuda.synchronize(device)
        t_batched = time.perf_counter() - t0
    reports = bucket_reports(batched)
    log(f"[4s] one cp_als_batched call: {len(tensors)} tensors in {t_batched:.2f}s = "
        f"{len(tensors) / t_batched:.1f} tensors/s; {len(reports)} buckets, probes="
        f"{sum(r.n_probes for r in reports.values())}")
    # The cold service's first decision per bucket, and one warm decision.
    shown = [rep for rep in bucket_reports(results).values() if rep.source == "measured"]
    shown += [next(iter(bucket_reports(warm_res).values()))]
    for rep in shown:
        log("[4s]   bucket report: " + json.dumps(rep.to_dict(), sort_keys=True))
    hold_gap("4s", results, batched, "the one cp_als_batched call's")

    sample = np.random.default_rng(0).choice(len(tensors), SEQ_SAMPLE, replace=False)
    seq, t_seq = sequential_ref([tensors[i] for i in sample], device)
    log(f"[4s] sequential cp_als(engine='ref'): {SEQ_SAMPLE} tensors in {t_seq:.2f}s = "
        f"{SEQ_SAMPLE / t_seq:.1f} tensors/s (extrapolated to {len(tensors)}: "
        f"{len(tensors) * t_seq / SEQ_SAMPLE:.1f}s); service {len(tensors) / wall:.1f}, "
        f"batched {len(tensors) / t_batched:.1f} tensors/s")
    hold_gap("4s", [results[i] for i in sample], seq, "the sequential `ref` runs'")


def batched_scale(device) -> None:
    """Phase 4b: one cp_als_batched call over BATCH_N tensors (see the
    module docstring), its host steps timed apart first."""
    t0 = time.perf_counter()
    tensors = synthetic_load(BATCH_N, seed=1)
    log(f"[4b] synthetic_load({BATCH_N}, seed=1) in {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    buckets = bucket_tensors(tensors)
    log(f"[4b] bucket_tensors: {len(buckets)} buckets in {time.perf_counter() - t0:.2f}s")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_batch_") as tmp:
        store = Path(tmp) / "batch.json"
        host_bytes = 0
        for (dims, band), bucket in buckets.items():
            t0 = time.perf_counter()
            pb = pad_bucket(bucket)
            t_pad = time.perf_counter() - t0
            t0 = time.perf_counter()
            init = _init_batched(bucket, SERVE_RANK, 0)
            t_init = time.perf_counter() - t0
            built = {}
            for name in ("ref", "alto"):
                t0 = time.perf_counter()
                build_batched_kernel(name, pb, device)
                torch.cuda.synchronize(device)
                built[name] = time.perf_counter() - t0
            t0 = time.perf_counter()
            _, rep = autotune_bucket(pb, SERVE_RANK, rt.TunePolicy(store=rt.TuningStore(store)),
                                     device=device)
            torch.cuda.synchronize(device)
            t_tune = time.perf_counter() - t0
            nbytes = (pb.coords.nbytes + pb.values.nbytes + pb.mask.nbytes
                      + sum(f.nbytes for f in init))
            host_bytes += nbytes
            log(f"[4b] bucket dims={dims} band={band}: B={pb.size} P={pb.pad_nnz} "
                f"(nnz {min(pb.nnz)}-{max(pb.nnz)}); host s: pad {t_pad:.3f}, init {t_init:.3f}, "
                f"ref build+upload {built['ref']:.3f}, alto build+upload {built['alto']:.3f}; "
                f"cold tune {t_tune:.3f}s ({rep.n_probes} probes) winners={rep.winners}; "
                f"padded arrays + factors {nbytes / 2**20:.2f} MiB")
            log("[4b]   bucket report: " + json.dumps(rep.to_dict(), sort_keys=True))
        del pb, init
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        # Traced: each bucket's span covers its tune lookup, winner build,
        # init, uploads and iterations; bucketing, padding and the
        # per-member results fall outside.
        t0 = time.perf_counter()
        with capture() as spans:
            results = rt.cp_als_batched(tensors, SERVE_RANK, SERVE_ITERS, device=device,
                                        tune=rt.TunePolicy(store=rt.TuningStore(store)))
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) - base
    for (dims, band), bucket in buckets.items():
        first = results[bucket.indices[0]]
        log(f"[4b] bucket dims={dims} band={band}: {first.engine} "
            f"(source={first.tune_report.source}) iter_times "
            f"{[round(t * 1e3, 3) for t in first.iter_times]} ms, steady "
            f"{steady(first.iter_times):.3f} ms")
    iter_s = sum(s.duration for s in spans if s.name == "cp_als_batched.iter")
    bucket_s = sum(s.duration for s in spans if s.name == "cp_als_batched.bucket")
    log(f"[4b] one cp_als_batched call: {BATCH_N} tensors in {wall:.2f}s = {BATCH_N / wall:.1f} "
        f"tensors/s (warm store); iterations (each ended by a synchronisation) {iter_s:.3f}s; "
        f"the rest of the bucket spans (tune lookup, winner build, init, uploads, fits) "
        f"{bucket_s - iter_s:.3f}s; outside them (bucketing, padding, per-member results) "
        f"{wall - bucket_s:.3f}s; padded arrays + factors {host_bytes / 2**20:.2f} MiB; peak "
        f"device memory of the call {peak / 2**20:.1f} MiB")
    sample = np.random.default_rng(1).choice(BATCH_N, BATCH_SAMPLE, replace=False)
    seq, t_seq = sequential_ref([tensors[i] for i in sample], device)
    log(f"[4b] sequential cp_als(engine='ref'): {BATCH_SAMPLE} tensors in {t_seq:.2f}s = "
        f"{BATCH_SAMPLE / t_seq:.1f} tensors/s")
    hold_gap("4b", [results[i] for i in sample], seq, "the sequential `ref` runs'")


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
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}, "
        f"shared memory per block {tiles.device_budget(device)} B")
    # Full float32 matrix products (the reference's precision), never TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 2. Build both kernels, one nvcc each, in parallel.
    t0 = time.perf_counter()
    sources = ["mttkrp", "mttkrp_fixed"]
    _build.build(sources)
    log(f"[2] built csrc/{{{', '.join(sources)}}}.cu in {time.perf_counter() - t0:.1f}s")
    for name in sources:
        for line in ptxas_summary(_build.build_log(name)):
            log(f"[2]   {name}: {line}")

    # 3. Kernels vs plain, cases (a), (b), (c).
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
    worst_fixed = check_fixed_case("a", st_a, ct_a, dev_a, device, ["int7", "int15-12", "int3"])

    side = PlanCache()  # (b) is freed before the main paths
    plan_b = side.plan(st_a, RANK, mem_bytes=DEFAULT_MEM)
    ct_b = side.chunked(st_a, plan_b.chunk_shape, plan_b.capacity)
    dev_b = side.device_arrays(st_a, plan_b.chunk_shape, plan_b.capacity, device)
    worst = max(worst, check_case("b (NELL-2, default 64 MiB plan)", st_a, ct_b, dev_b, device))
    worst_fixed = max(worst_fixed, check_fixed_case("b", st_a, ct_b, dev_b, device,
                                                    ["int7", "int15-12"]))
    time_case("b", st_a, ct_b, dev_b, device, "int7")
    del side, ct_b, dev_b
    t0 = time.perf_counter()
    st_c = rt.random_tensor(LBNL["shape"], LBNL["nnz"], distribution=LBNL["distribution"], seed=0)
    plan_c = rt.decide_partition(st_c, RANK, mem_bytes=EXAMPLE_MEM, rank_axis=RANK)
    ct_c = default_plan_cache.chunked(st_c, plan_c.chunk_shape, plan_c.capacity)
    log(f"[3] host set-up (c): {time.perf_counter() - t0:.1f}s")
    if ct_c.num_tasks <= len(np.unique(ct_c.task_chunk, axis=0)):
        fail("case c: no chunk was split by nonzero partitioning")
    dev_c = default_plan_cache.device_arrays(st_c, plan_c.chunk_shape, plan_c.capacity, device)
    worst = max(worst, check_case("c (LBNL, 256 KiB plan)", st_c, ct_c, dev_c, device))
    worst_fixed = max(worst_fixed, check_fixed_case("c", st_c, ct_c, dev_c, device,
                                                    ["int7", "int15-12"]))
    time_case("c", st_c, ct_c, dev_c, device, "int15-12")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # 4. Float path: cp_als through the kernel engine, as the example builds it.
    mttkrp_kernel.launches = 0
    mttkrp_fixed_kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    engine = rt.build_engine(st_a, "kernel", RANK, chunk_shape=plan_a.chunk_shape,
                             capacity=plan_a.capacity)
    res = rt.cp_als(st_a, RANK, n_iters=N_ITERS, engine=engine, seed=0)
    t_main = time.perf_counter() - t0
    launches = mttkrp_kernel.launches
    fixed_in_float = mttkrp_fixed_kernel.launches
    peak_bytes = torch.cuda.max_memory_allocated()
    float_iter_times = res.iter_times
    log(f"[4] cp_als engine={res.engine} in {t_main:.1f}s, kernel launches={launches}, "
        f"fixed kernel launches={fixed_in_float}")
    log(f"[4]   fit_history={res.fit_history}")
    log(f"[4]   diff_history={res.diff_history}")
    log(f"[4]   iter_times={res.iter_times}")
    log(f"[4]   device memory: resident before {base_bytes / 2**30:.3f} GiB, "
        f"peak {peak_bytes / 2**30:.3f} GiB")
    if launches != N_ITERS * st_a.ndim or fixed_in_float != 0:
        fail(f"kernel launched {launches} times in the main path, expected "
             f"{N_ITERS * st_a.ndim}; the fixed kernel {fixed_in_float} times, expected 0")
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
    kernel_run = res
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

    # 4d. The distributed engine at (a) on a one-rank NCCL mesh.
    t0 = time.perf_counter()
    dist_launches = distributed_checks(st_a, plan_a, kernel_run, device)
    log(f"[4d] phase took {time.perf_counter() - t0:.1f}s")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # 4f. Fixed-point path: int7 on NELL-2 (the paper's mode-3 format),
    # int15-12 on LBNL (its mode-5 format).
    res_fa, launches_fa = fixed_main_run("a (NELL-2)", st_a, plan_a, "int7")
    fixed_iter_times = res_fa.iter_times
    del res_fa
    _, launches_fc = fixed_main_run("c (LBNL)", st_c, plan_c, "int15-12")
    fixed_launches = launches_fa + launches_fc
    for name, preset in [("nell2", "int7"), ("lbnl", "int15-12")]:
        small = rt.table1_tensor(name)
        on_card = rt.cp_als(small, RANK, n_iters=3, engine="fixed", fixed_preset=preset)
        on_cpu = rt.cp_als(small, RANK, n_iters=3, engine="fixed", fixed_preset=preset,
                           device="cpu")
        got = np.array(on_card.fit_history + on_card.diff_history)
        want = np.array(on_cpu.fit_history + on_cpu.diff_history)
        gap = float(np.abs(got - want).max())
        ok = (bool(np.all(np.abs(got - want) <= FIXED_SMALL_ATOL + FIXED_SMALL_RTOL * np.abs(want)))
              and abs(on_card.quant_error - on_cpu.quant_error)
              <= QUANT_RTOL * abs(on_cpu.quant_error))
        log(f"[4f]  TABLE1 {name} {preset}: card fit={on_card.fit_history} cpu fit="
            f"{on_cpu.fit_history} max gap (fit, diff)={gap:.3e} quant_error card="
            f"{on_card.quant_error} cpu={on_cpu.quant_error} (tolerance {FIXED_SMALL_ATOL} + "
            f"{FIXED_SMALL_RTOL}·|cpu|, quant_error {QUANT_RTOL} relative)")
        if not ok:
            fail(f"the fixed engine on the card left the CPU path on TABLE1 {name}")
    del ct_c, dev_c
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # 4g. Planted low-rank cube: the paper's Fig. 6 claim on the card.
    cube = planted_check()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # 4h. The paper's other roles: ALTO, CSF and the hetero split.
    engines_c = format_checks("c (LBNL)", st_c, device, rt.FormatCache())
    for mode in range(st_c.ndim):
        tree = engines_c["csf"].context.formats.csf(st_c, mode)
        counted = rt.fiber_count(st_c, mode)
        log(f"[4h] c (LBNL) mode {mode}: fiber_count={counted} tree n_fibers={tree.n_fibers}")
        if counted != tree.n_fibers:
            fail(f"case c mode {mode}: fiber_count disagrees with the built tree")
    del st_c, engines_c  # (c)'s cache entries go with st_c
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    formats_a = rt.FormatCache()
    engines = format_checks("a (NELL-2)", st_a, device, formats_a)
    engines["hetero"] = rt.build_engine(st_a, "hetero", RANK, chunk_shape=plan_a.chunk_shape,
                                        capacity=plan_a.capacity)
    hetero_launches = format_main_runs(st_a, plan_a, engines, kernel_run)
    hetero_launches += planted_hetero(cube)
    del cube
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # 5. Timing at case (a)'s shapes: plain, global tier (the first
    # design: no nnz_per_task), kernel as the engine launches it, in turns.
    factors = [rt.pad_factor(f, plan_a.chunk_shape[m])
               for m, f in enumerate(rt.init_factors(st_a.shape, RANK, seed=0, device=device))]
    tc, cr, vals, nnz = (dev_a["task_chunk"], dev_a["coords_rel"], dev_a["values"],
                         dev_a["nnz_per_task"])
    cs = ct_a.chunk_shape

    def in_turns(plain, kernel, global_tier) -> dict:
        p1, g1, k1, k2, g2, p2 = (time_ms(plain, 3), time_ms(global_tier, 10),
                                  time_ms(kernel, 10), time_ms(kernel, 10),
                                  time_ms(global_tier, 10), time_ms(plain, 3))
        return dict(ms=(k1 + k2) / 2, global_ms=(g1 + g2) / 2, plain_ms=(p1 + p2) / 2,
                    ms_runs=[k1, k2], global_ms_runs=[g1, g2], plain_ms_runs=[p1, p2])

    modes = []
    for mode in range(st_a.ndim):
        g_plan = plan_of(st_a, ct_a, mode, tier="global")
        times = in_turns(
            lambda mode=mode: kref.mttkrp_local_ref(factors, tc, cr, vals, mode=mode,
                                                    chunk_shape=cs),
            lambda mode=mode: rt.mttkrp_local(factors, tc, cr, vals, mode=mode, chunk_shape=cs,
                                              nnz_per_task=nnz),
            lambda mode=mode, g_plan=g_plan: rt.mttkrp_local(factors, tc, cr, vals, mode=mode,
                                                             chunk_shape=cs, plan=g_plan))
        op = time_ms(lambda mode=mode: rt.mttkrp_kernel_op(
            factors, tc, cr, vals, mode=mode, chunk_shape=cs, out_dim=st_a.shape[mode],
            nnz_per_task=nnz), 10)
        bound_ms, bound_by, nbytes, ops = kernel_bound(st_a, ct_a, mode)
        row = dict(mode=mode, **times, op_ms=op, bound_ms=bound_ms, bound_by=bound_by,
                   bytes=nbytes, ops=ops, share_of_bound=bound_ms / times["ms"],
                   tier=plan_of(st_a, ct_a, mode).tier)
        modes.append(row)
        log(f"[5] mode {mode}: " + json.dumps(row))

    # 5f. The fixed kernel at case (a), int7 (the NELL-2 main path's preset).
    qfactors, qvalues, q = fixed_inputs(st_a, ct_a, device, "int7")
    qpadded = [rt.pad_factor(f, plan_a.chunk_shape[m]) for m, f in enumerate(qfactors)]
    fb, vb = qfactors[0].element_size(), qvalues.element_size()
    live = int(torch.count_nonzero(qvalues))
    fixed_modes = []
    for mode in range(st_a.ndim):
        g_plan = plan_of(st_a, ct_a, mode, fb, vb, tier="global")
        times = in_turns(
            lambda mode=mode: kref.mttkrp_fixed_local_ref(qpadded, tc, cr, qvalues, mode=mode,
                                                          chunk_shape=cs, **q),
            lambda mode=mode: rt.mttkrp_fixed_local(qpadded, tc, cr, qvalues, mode=mode,
                                                    chunk_shape=cs, nnz_per_task=nnz, **q),
            lambda mode=mode, g_plan=g_plan: rt.mttkrp_fixed_local(
                qpadded, tc, cr, qvalues, mode=mode, chunk_shape=cs, plan=g_plan, **q))
        op = time_ms(lambda mode=mode: rt.mttkrp_fixed_kernel_op(
            qfactors, tc, cr, qvalues, mode=mode, chunk_shape=cs, out_dim=st_a.shape[mode],
            nnz_per_task=nnz, **q), 10)
        bound_ms, bound_by, nbytes, ops = fixed_kernel_bound(st_a, ct_a, mode, live, fb, vb)
        row = dict(mode=mode, **times, op_ms=op, bound_ms=bound_ms, bound_by=bound_by,
                   bytes=nbytes, ops=ops, live=live, share_of_bound=bound_ms / times["ms"],
                   tier=plan_of(st_a, ct_a, mode, fb, vb).tier)
        fixed_modes.append(row)
        log(f"[5f] mode {mode}: " + json.dumps(row))
    slower = [kind for kind, rows in (("float", modes), ("fixed", fixed_modes))
              if not all(r["ms"] < r["global_ms"] for r in rows)]
    if slower:
        fail(f"at case (a) the {' and '.join(slower)} kernel is not faster than its global "
             f"tier (the first design) in every mode")
    log(f"[5f] steady cp_als iteration at (a): fixed int7 {steady(fixed_iter_times):.3f} ms, "
        f"float kernel {steady(float_iter_times):.3f} ms")

    # 5h. The execution roles' MTTKRP per mode at case (a), in turns.
    role_ms = time_roles(st_a, ct_a, dev_a, engines, formats_a, device)

    # 4a. The autotuner on the card, after 5h and on its layouts.
    t0 = time.perf_counter()
    auto_launches = autotune_checks(st_a, plan_a, formats_a, kernel_run, role_ms, device)
    log(f"[4a] phase took {time.perf_counter() - t0:.1f}s")

    # 4w. The offline sweep on the card (its probes launch both kernels).
    mttkrp_kernel.launches = 0
    mttkrp_fixed_kernel.launches = 0
    t0 = time.perf_counter()
    sweep_checks(device)
    log(f"[4w] phase took {time.perf_counter() - t0:.1f}s; probes launched the float kernel "
        f"{mttkrp_kernel.launches} times, the fixed one {mttkrp_fixed_kernel.launches} times")

    # 4s and 4b. The serving path: it launches neither kernel.
    mttkrp_kernel.launches = 0
    mttkrp_fixed_kernel.launches = 0
    t0 = time.perf_counter()
    serve_checks(device)
    log(f"[4s] phase took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    batched_scale(device)
    log(f"[4b] phase took {time.perf_counter() - t0:.1f}s")
    if mttkrp_kernel.launches or mttkrp_fixed_kernel.launches:
        fail(f"the serving path launched the float kernel {mttkrp_kernel.launches} times and "
             f"the fixed one {mttkrp_fixed_kernel.launches} times (expected 0)")
    smi_after = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    log(f"[5] after timing: {smi_after}")
    log("[5] library call: none (no single PyTorch call computes MTTKRP)")
    log(f"[6] total {time.perf_counter() - t_start:.1f}s")

    # 6. Kernels line (ms/plain_ms/bound_ms: the 3 launches of one CP-ALS
    # iteration at case (a)'s shapes, summed over the modes; launches: the
    # main paths' runs, the float kernel's through `kernel`, `distributed`,
    # `hetero` and the tuned `auto` engine, the fixed kernel's over both of
    # its runs).
    def entry(kind, rows, n_launches, err):
        return {**KERNELS[kind], "route": "cuda", "launches": n_launches, "max_abs_err": err,
                "ms": sum(r["ms"] for r in rows),
                "plain_ms": sum(r["plain_ms"] for r in rows),
                "bound_ms": sum(r["bound_ms"] for r in rows),
                "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in rows)
                             else "operations"),
                "library_ms": None}
    print(json.dumps({"kernels": [entry("float", modes,
                                        launches + dist_launches + hetero_launches + auto_launches,
                                        worst),
                                  entry("fixed", fixed_modes, fixed_launches,
                                        float(worst_fixed))]}), flush=True)
    # 7. Device line, last.
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
