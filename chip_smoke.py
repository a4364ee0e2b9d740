#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device check: a CUDA card is required; print its name and power limit;
     0a. the port's static analysis (`repro_torch.analysis`, every rule,
     `--strict`) over this checkout: fatal on any unsuppressed finding;
     prints the findings and suppressions per rule and its seconds;
  2. build the four CUDA sources with nvcc (one process each, started
     together) and print what ptxas reports for each kernel instantiation
     (registers, spills); every width of the Gram pseudo-inverse's warp
     tier must be listed with no stack frame and no spill;
  3. hold the float kernel against its plain PyTorch version on the card,
     every mode: the wrapper adding into an (I_pad, R) output that already
     holds numbers (against them plus the summed plain per-task partials)
     and the full op (every task's sums added into one zero-filled output,
     with `nnz_per_task`, as the engines call it), printing each launch's
     tier, blocks per task and shared-memory bytes, for
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
     plain `chunked` engine on the card (the small TABLE1 nell2 on the
     card against the CPU path, which the CPU tests hold to the JAX
     reference, is phase 4e's `--engine kernel` check); every mode
     update's pseudo-inverse
     goes through the Gram pseudo-inverse kernel's warp tier
     (`csrc/gram_pinv.cu`, n_iters × 3 launches), and ||X||² through the
     sum-of-squares kernel once (`csrc/sum_squares.cu`);
     4p. (right after phase 4) the Gram pseudo-inverse kernel against its
     plain version (torch's SVD with jnp's cutoff) on the card at
     max(1e-5, κ·2^-17) of each matrix's largest entry, bitwise symmetric,
     through the warp tier and the block tier (the first design, forced):
     the Grams of phase 4's factors at (a) (R = 10), rank-deficient stacks
     (a zero factor column, two equal columns) and a batched stack of 4096
     at R = 5; the warp tier also bit for bit against its host replay
     (`gram_pinv.jacobi_replay`); R = 160 (the global scratch path); the
     all-zero matrix (zeros) in both tiers; a stack of three whose middle
     member holds a NaN, an off-diagonal +Inf or a diagonal +Inf (all NaN,
     all NaN, all zeros, as jnp's pinv answers) through every tier, the
     warp tier bit for bit its replay; timed at (a)'s three Grams in
     turns (plain, `torch.linalg.pinv(hermitian=True)`, warp tier, block
     tier, then back), with the host µs per call, and at B = 8 and 4096,
     R = 5 (the serving path's stacks) in both tiers; then cp_als through
     phase 4's engine with the block tier and with the plain
     pseudo-inverse, the three runs (with phase 4's warp-tier run) held to
     each other: fits within 1e-6, factors and λ within max(1e-5, κ·2^-17)
     of their largest entry (the fits at (a) are about 1e-7, so the factors
     are the discriminating check), and the runs' steady iteration times;
     4y. (right after phase 4p, on phase 4's `kernel` engine at (a)) each kind of
     call the `host-sync` rule's catalogue rests on runs under
     `torch.cuda.set_sync_debug_mode("warn")` beside the rule's verdict on
     it (a call the rule lets pass must not warn); then two cp_als
     iterations under warn mode: the
     synchronising calls torch reports, grouped by the file and line the
     warning names, per iteration (set-up, then each iteration with its fit
     and diff); every site inside `src/repro_torch/` must be one that phase
     0a's `host-sync` rule reports (suppressed, with its reason); sites in
     torch's own code are printed and not judged; each iteration must wait
     on the host exactly twice (the fit and diff readouts), never in the
     pseudo-inverse, and ||X||² must launch its kernel once;
     4n. (right after phase 4y) the sum-of-squares kernel against its plain
     version (float64 dots over slices of 2^22 values) and numpy's float64
     dot on (a)'s values, within 2·nnz·2^-53 of the sum, its bits repeated
     by a second launch; timed in turns (plain, library, kernel, then back)
     beside its bound (4 bytes a value at 3.35 TB/s), with the host µs per
     call;
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
     4e. (right after 4d, which destroys its group) the example CLIs of
     `repro_torch.examples`, in process with their output captured: the
     quickstart's four rows (ref, chunked, fixed int7, kernel) on the card
     against the same rows on the CPU (float fit and diff within 1e-6,
     fixed within 1e-5 + 1e-3·|cpu|) and their launches (9 float, 9 fixed,
     36 Gram); `decompose_tensor --tensor nell2 --iters 5` through `kernel`
     (15 float-kernel and 15 Gram launches, 5 finite fits, fit and diff
     within 1e-6 of `--device cpu`: the script's one check of the kernel
     engine on the card against the CPU path on TABLE1 nell2), `fixed` through `main` (15 fixed-kernel
     launches), `auto` twice on one fresh store (probes on the first run,
     `probes=0` on the second), `distributed` on a one-rank NCCL group (15
     float-kernel launches, fits within 1e-5 of `kernel`'s) and
     `--list-backends` (`kernel`, no `pallas`); its launches and seconds
     on a `[4e]` line of their own, not on the `kernels` line;
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
     plain versions, their global tier (without `nnz_per_task`) in turns
     (plain, global, kernel, kernel, global, plain), both kernels adding
     into the (I_pad, R) output as the ops launch them, and their bounds,
     and the engines' steady iterations;
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
     4r. (after 4w) the paper's benchmark harness on the card, in process:
     `python -m repro_torch.bench`'s `main` for table1, fig7, fig6 (with
     the JAX CI's accuracy budget, 0.2, for its format-tuning rows: a pick
     over the budget fails) and fig8_9 at their full TABLE1 sizes (their
     output and JSON under results/bench/), then fig7's rows at (a)
     through its row function on phase 4's chunking and 4h's ALTO and CSF
     layouts (nothing rebuilt);
     every suite must exit 0 with finite times, every `auto` row's warm
     build must make 0 probes, and the phase must launch all three kernels
     (counted from 0 before it, read after it); each suite's table and
     seconds printed;
     4s. the serving path, `DecomposeService` over `cp_als_batched` (plain
     tensor ops: it launches neither MTTKRP kernel, which is checked; its
     batched pseudo-inverses launch the Gram kernel): the serving
     benchmark's load (`repro_torch.bench.serve_bench.synthetic_load`:
     three shape/nnz families, 4096 requests from
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
     4l. (after 4b) the LM serving path (`repro_torch.models`,
     `launch.steps.generate`), which reaches none of the three kernels (the
     reference computes it in plain jnp; checked: 0 launches): the example
     `repro_torch.examples.serve_lm --arch <arch> --batch 4` (smoke
     config, prompt 24, gen 12) for gemma3-4b, the MoE, SSM and hybrid
     archs (qwen3-moe-30b-a3b, llama4-scout-17b-a16e, xlstm-350m,
     jamba-1.5-large-398b) and the enc-dec and VLM ones (whisper-medium,
     internvl2-1b); each of these seven smoke configs through
     `generate` on the card and on the CPU from one set of weights, at
     float32 (tokens equal, each teacher-forced step's logits within 1e-4
     of Σ|terms| of the final product) and at bfloat16 (the first step's
     logits within 2^-5 of the CPU's largest |logit|), whisper's decode
     also against a cross cache of 12 seeded keys and values, and
     whisper's and internvl's `prefill` over their frames or image embeds
     (`SyntheticBatches`) within the same bounds; gemma3-4b at full
     width (34 layers, d_model 2560, vocab 262,144, float32 weights from
     `torch.Generator` seed 0 on the card, bfloat16 compute) through
     `generate` at batch 4, prompt 24 (`SyntheticTokens` seed 0), gen 12,
     twice (identical tokens in [0, vocab)), printing ms per decode step
     (host clock around `torch.cuda.synchronize`, mean over steps 4
     onward) beside the step's bytes bound (the weights it reads, once:
     `read_bytes`), generated tokens/s, peak device memory, the parameter
     count, and one step's host waits (torch's sync log), device launches
     and busy time (`torch.profiler`); the ring buffer at full width: 6
     layers (one 5:1 pattern) at float32 over a 1,040-token prompt, past
     the 1,024 window, the teacher-forced decode's last logits within 1e-3
     of the largest |logit| of `LM.prefill` over the same tokens; then the
     same full-width run for the other families, one built and freed after
     the other, at the depths of LM_FAMILIES (qwen3-moe-30b-a3b 24 of 48
     layers, llama4-scout-17b-a16e 4 of 48, xlstm-350m whole,
     jamba-1.5-large-398b 5 of 72 with bfloat16 weights), then
     whisper-medium and internvl2-1b whole, each first timing `prefill` at
     batch 4 (whisper: 1,500 encoder frames and 187 decoder tokens;
     internvl: 256 image tokens and a 24-token prompt), whisper decoding
     against a cross cache of 1,500 seeded keys and values (its bytes in
     the bound);
     4t. (after 4l) the LM training path (`repro_torch.optim`, `checkpoint`,
     `launch.steps.make_train_step`, `launch.elastic`), which also reaches
     none of the three kernels (checked: 0 launches): the five smoke
     configs of 4l, one set of weights each, two steps of grad_accum 2 at
     float32 compute on the card and on the CPU, with float32 and with
     8-bit moments (tolerances at TRAIN_LOSS_REL below); the step's
     lookups whose backward adds into a gradient (`train_sites`: the
     embedding and the MoE's gather of each token's k rows through
     `F.embedding`, the mLSTM's stabiliser through `xlstm._cummax`, and the
     gathers of the MoE's gates and slots and of the loss, whose indices do
     not repeat), each backward run three times at 4t's shapes and held bit
     for bit to its first, beside the indexing the first three replaced;
     gemma3-4b at full width (float32 weights, bfloat16 compute, remat on)
     with 8-bit moments, AdamWConfig(lr=1e-4, use_8bit=True), on one
     `SyntheticTokens` batch (seed 0, batch 4, sequence 256, grad_accum
     2): the first step taken twice from one state (`first_step_twice`,
     the copy in pinned host memory), the two losses equal and every
     parameter and moment leaf `torch.equal`, each state's checksum
     printed (so in every `train_run` below), 3 timed
     (host clock around `torch.cuda.synchronize`) and one under
     `torch.profiler` (the device's busy share, the top device ops, the
     launch count), printing ms per step, trained tokens/s, the losses, the
     peak memory above what was resident, the FLOP bound (6·N·T + 2·N·T for
     the remat forward, over BF16_FLOPS) and the optimizer pass's bytes
     bound; the same widths at 6 layers with float32 moments; `compress_grad`
     on the first layer's MLP up-projection gradient (2560 × 10240, R = 16)
     on the card against the CPU; at 2 layers an `AsyncCheckpointer` save
     while the next step runs, then `elastic_restore` into meta structure:
     bit for bit the snapshot, and the next step's loss equal to the live
     run's; then xlstm-350m whole with float32 moments and
     qwen3-moe-30b-a3b cut to 4 layers with 8-bit moments, the first step
     twice and 3 timed steps each (ms per step, tokens/s, the FLOP bound
     over the parameters a token uses, the losses, which must fall: the
     last below the first, in every `train_run`); then
     whisper-medium (batch 4 × 1,500 frames, 187 decoder tokens) and
     internvl2-1b (batch 4 × (256 image + 256 text tokens)) whole with
     float32 moments, the same way, their FLOP bound each weight times the
     rows it multiplies (`encdec_flops`); the card-against-CPU check runs
     for all seven smoke configs on their `SyntheticBatches`;
     4m. (after 4t) tensor, expert and FSDP parallelism
     (`launch/shardings.py`, `models/comm.py`, the model-axis paths of the
     LM stack), which reaches none of the three kernels either (checked):
     two gloo ranks both on cuda:0 (NCCL refuses two ranks on one device;
     gloo carries the all-gathers, reduce-scatters and all-reduces of
     CUDA tensors) form a (1, 2) mesh; command-r-35b (full width, 4 of 40
     layers, float32 compute, 9.16 GiB of weights a rank) and
     qwen3-moe-30b-a3b (4 of 48 layers, 64 experts a rank) are drawn on
     each rank from seed 0, each rank keeping its blocks; prefill of
     `SyntheticTokens` seed 0 (batch 4, prompt 24) and `generate` (gen 12),
     then (command-r) two train steps with 8-bit moments on 4 × 256; rank 0
     then runs the one-rank path on the same card from the same seed:
     prefill logits within 1e-5 of Σ|terms| of the final product, tokens
     equal, losses within 1e-5 relative (1e-4 after the 8-bit update), the
     MoE's dropped assignments equal to the capacity rule replayed over the
     one-rank routing (none can drop on two model ranks: cap ≥ T·k); one
     decode step's collectives and wire bytes are printed; meanwhile
     `python -m repro_torch.launch.dryrun --all` costs every arch × shape
     on the (16, 16) mesh on meta tensors (records in
     results/dryrun_torch/), which must exit 0;
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
this load), so the JAX serve_bench's flat 1e-5 on factors fails for a few percent
of members at this scale (phase 4s prints how many); the JAX package's own
batched and sequential runs are not bit-identical either.  Factors and
λ/max(1, |λ|) are held to max(1e-5, κ·2^-17) and fits to max(1e-6,
κ·2^-20) per iteration: the flat values where the solve is well
conditioned, about 64 float32 roundings (2^-23) magnified by κ where it is
not (an eighth of that on the fit, a scalar of the whole reconstruction).
A member's mix-up or a wrong padding moves them by orders of magnitude more.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import inspect
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from collections import Counter
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import repro_torch as rt  # noqa: E402
from repro_torch.batch import (  # noqa: E402
    autotune_bucket,
    bucket_tensors,
    build_batched_kernel,
    pad_bucket,
)
from repro_torch.analysis import AnalysisResult, check_source, run_analysis  # noqa: E402
from repro_torch.bench import common as bench_common  # noqa: E402
from repro_torch.bench import fig7 as bench_fig7  # noqa: E402
from repro_torch.bench import serve_bench  # noqa: E402
from repro_torch.bench.__main__ import main as bench_main  # noqa: E402
from repro_torch.bench.serve_bench import member_gap, solve_kappa, synthetic_load  # noqa: E402
from repro_torch.batch.cpals import _init_batched  # noqa: E402
from repro_torch.engine import PlanCache, TuningStore, default_plan_cache  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data import SyntheticBatches, SyntheticTokens  # noqa: E402
from repro_torch.examples import decompose_tensor, quickstart, serve_lm  # noqa: E402
from repro_torch.checkpoint import AsyncCheckpointer  # noqa: E402
from repro_torch.launch.elastic import elastic_restore  # noqa: E402
from repro_torch.launch import steps as train_steps  # noqa: E402
from repro_torch.launch.steps import generate, make_decode_step, make_train_step  # noqa: E402
from repro_torch.models import LM, MeshCtx  # noqa: E402
from repro_torch.models import comm as comm_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import nn as lm_nn  # noqa: E402
from repro_torch.models import xlstm as xlstm_mod  # noqa: E402
from repro_torch.core.mttkrp import _alto_decode  # noqa: E402
from repro_torch.engine.calibrate import MIN_OBSERVATIONS  # noqa: E402
from repro_torch.obs import capture  # noqa: E402
from repro_torch.formats import MAX_KEY_BITS  # noqa: E402
from repro_torch.core import cpals as port_cpals  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    _build,
    gram_pinv,
    mttkrp_fixed_kernel,
    mttkrp_kernel,
    sum_squares,
    tiles,
)
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.launch import mesh_axes  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init, compress_grad, cp_compress_state  # noqa: E402
from repro_torch.roofline import H100_SXM5, collective_bytes  # noqa: E402
from repro_torch.roofline import model_flops as roofline_model_flops  # noqa: E402

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
BF16_FLOPS = 989e12                # H100 SXM data sheet, dense bfloat16 on the tensor cores
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
    # No Pallas counterpart: it ports the reference's `jnp.linalg.pinv` call.
    "pinv": dict(name="gram_pinv_f32", source="src/repro_torch/kernels/csrc/gram_pinv.cu",
                 replaces="src/repro/core/cpals.py:315"),
    # No Pallas counterpart: it replaces the reference's host norm of the values.
    "norm": dict(name="sum_squares_f32", source="src/repro_torch/kernels/csrc/sum_squares.cu",
                 replaces="src/repro/core/cpals.py:124"),
}
F64_FLOPS = 34e12                  # H100 SXM data sheet, float64 outside the tensor cores
# The Gram pseudo-inverse kernel (float64 Jacobi) against its plain version
# (torch's float32 SVD), per matrix, relative to its largest entry: the flat
# value where V is well conditioned, about 64 float32 roundings (2^-23)
# magnified by κ, the condition number over the kept directions, where not.
PINV_ATOL, PINV_KAPPA = 1e-5, 2.0 ** -17
PINV_FIT_ATOL = 1e-6               # cp_als fits, gram_pinv against the plain pseudo-inverse


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


def out_rows(st, ct, mode: int) -> int:
    """Rows of the kernels' direct output: the mode's dim in whole chunks."""
    return -(-st.shape[mode] // ct.chunk_shape[mode]) * ct.chunk_shape[mode]


def kernel_bound(st, ct, mode: int) -> tuple[float, str, float, float]:
    """Least time for one float launch as the op makes it: each live
    nonzero's coordinates and value read once, each input factor read once,
    the (I_pad, R) output written once, over the memory rate; (N-1)·R
    multiplies + R adds per nonzero over the float32 rate.  Returns (ms,
    bound_by, bytes, operations)."""
    n = st.ndim
    nbytes = (st.nnz * (4 * n + 4)
              + sum(st.shape[m] * RANK * 4 for m in range(n) if m != mode)
              + out_rows(st, ct, mode) * RANK * 4)
    ops = st.nnz * RANK * n
    return (*bound(nbytes, ops, F32_FLOPS), nbytes, ops)


def fixed_kernel_bound(st, ct, mode: int, live: int, factor_bytes: int,
                       value_bytes: int) -> tuple[float, str, float, float]:
    """Least time for one fixed-point launch as the op makes it: each live
    nonzero's (nonzero qvalue) coordinates and qvalue read once, each input
    factor once at its storage width, the (I_pad, R) int32 output written
    once, over the memory rate; per live nonzero and r, (N-2) multiplies and
    shifts, one multiply by the qvalue, one shift and one add, over the
    int32 rate."""
    n = st.ndim
    nbytes = (live * (4 * n + value_bytes)
              + sum(st.shape[m] * RANK * factor_bytes for m in range(n) if m != mode)
              + out_rows(st, ct, mode) * RANK * 4)
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
            warp = re.search(r"gram_pinv_warp_kernelILi(\d+)E", mangled)
            if warp:
                name, spills = f"gram_pinv_warp_kernel<W={warp.group(1)}>", ""
                continue
            kind = next((k for k in ("task_kernel", "gram_pinv_kernel", "sum_squares_kernel")
                         if k in mangled),
                        "global_kernel")
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


#: Widths the warp tier is instantiated at (`prism_gram_pinv_warp_f32`).
WARP_WIDTHS = tuple(range(2, gram_pinv.WARP_MAX_RANK + 1, 2))


def check_warp_spills(summary: list[str]) -> None:
    """Phase 2: every warp-tier instantiation is listed and keeps its
    matrix in registers: no stack frame, no spill."""
    seen = {}
    for line in summary:
        m = re.match(r"gram_pinv_warp_kernel<W=(\d+)>: .*; (\d+) bytes stack frame, "
                     r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            seen[int(m.group(1))] = tuple(int(x) for x in m.groups()[1:])
    missing = sorted(set(WARP_WIDTHS) - set(seen))
    spilled = {w: t for w, t in seen.items() if any(t)}
    log(f"[2]   gram_pinv warp tier: {len(seen)} widths, stack frame and spills "
        f"{'0 at every width' if not spilled else spilled}")
    if missing or spilled:
        fail(f"phase 2: warp-tier widths missing from ptxas's report {missing}, or with a "
             f"stack frame or spills (bytes: stack, stores, loads) {spilled}")


def plan_of(st, ct, mode, factor_bytes=4, value_bytes=4, tier=None) -> tiles.LaunchPlan:
    """The launch plan the wrappers take for one mode of a case on this card."""
    return tiles.plan_launch(ct.num_tasks, ct.capacity, ct.chunk_shape, mode, RANK,
                             factor_bytes=factor_bytes, value_bytes=value_bytes,
                             smem_budget=tiles.device_budget(torch.device("cuda", 0)), tier=tier)


def steady(iter_times) -> float:
    """Mean of the iterations after the first (which carries set-up), in ms."""
    return 1e3 * float(np.mean(iter_times[1:]))


def out_base(st, ct, mode: int, dtype, device) -> torch.Tensor:
    """An (I_pad, R) output that already holds numbers, drawn from seed 7:
    float in [-0.5, 0.5), int32 over its whole range."""
    gen = torch.Generator(device=device).manual_seed(7)
    shape = (out_rows(st, ct, mode), RANK)
    if dtype == torch.float32:
        return torch.rand(shape, generator=gen, device=device) - 0.5
    return torch.randint(-2**31, 2**31 - 1, shape, generator=gen, device=device, dtype=dtype)


def summed(local, dev, ct, mode: int, base) -> torch.Tensor:
    """`base` plus the per-task partials summed into their output rows."""
    return base + kref.reduce_local(local, dev["task_chunk"], mode=mode,
                                    chunk_shape=ct.chunk_shape, out_dim=base.shape[0])


def check_case(label, st, ct, dev, device) -> float:
    """Phase 3 for one case: float kernel vs plain, the wrapper adding into
    an output that holds numbers and the full op, every mode.  Returns the
    largest absolute difference seen."""
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
        base = out_base(st, ct, mode, torch.float32, device)
        got = rt.mttkrp_local(padded, tc, cr, vals, mode=mode, chunk_shape=cs, nnz_per_task=nnz,
                              out=base.clone())
        want = summed(kref.mttkrp_local_ref(padded, tc, cr, vals, mode=mode, chunk_shape=cs),
                      dev, ct, mode, base)
        terms = summed(kref.mttkrp_local_ref(abs_padded, tc, cr, abs_vals, mode=mode,
                                             chunk_shape=cs), dev, ct, mode, base.abs())
        del base
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
    """Phase 3f for one case: fixed kernel vs plain, bit for bit, the
    wrapper adding into an output that holds numbers and the full op, every
    mode and preset.  Returns the largest absolute difference seen (0 when
    they agree)."""
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
            base = out_base(st, ct, mode, torch.int32, device)
            got = rt.mttkrp_fixed_local(padded, tc, cr, qvalues, mode=mode, chunk_shape=cs,
                                        nnz_per_task=nnz, out=base.clone(), **q)
            want = summed(kref.mttkrp_fixed_local_ref(padded, tc, cr, qvalues, mode=mode,
                                                      chunk_shape=cs, **q), dev, ct, mode, base)
            del base
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
    and the fixed one with `preset`, each as the engines launch it (adding
    into the (I_pad, R) output)."""
    cs, tc, cr = ct.chunk_shape, dev["task_chunk"], dev["coords_rel"]
    nnz = dev["nnz_per_task"]
    factors = [rt.pad_factor(f, cs[m])
               for m, f in enumerate(rt.init_factors(st.shape, RANK, seed=0, device=device))]
    qfactors, qvalues, q = fixed_inputs(st, ct, device, preset)
    qfactors = [rt.pad_factor(f, cs[m]) for m, f in enumerate(qfactors)]
    live = int(torch.count_nonzero(qvalues))
    for mode in range(st.ndim):
        out = torch.zeros((out_rows(st, ct, mode), RANK), device=device)
        qout = torch.zeros((out_rows(st, ct, mode), RANK), dtype=torch.int32, device=device)
        ms = time_ms(lambda mode=mode, out=out: rt.mttkrp_local(
            factors, tc, cr, dev["values"], mode=mode, chunk_shape=cs, nnz_per_task=nnz,
            out=out), 10)
        fms = time_ms(lambda mode=mode, qout=qout: rt.mttkrp_fixed_local(
            qfactors, tc, cr, qvalues, mode=mode, chunk_shape=cs, nnz_per_task=nnz, out=qout,
            **q), 10)
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
# Phase 4r: the paper's benchmark harness (repro_torch.bench) on the card.
# ---------------------------------------------------------------------------

BENCH_SUITES = ("table1", "fig7", "fig6", "fig8_9")
#: fig6 also tunes the formats under the JAX CI's accuracy budget (0.2).
BENCH_ARGS = dict(fig6=["--accuracy-budget", "0.2"])
#: Each suite's time columns (seconds or milliseconds), all finite and positive.
BENCH_TIMES = dict(table1=(), fig7=("time_all_modes_ms",), fig6=("time_per_iter_s", "total_s"),
                   fig8_9=("time_ms",))


def bench_table(suite: str, rows: list[dict]) -> list[str]:
    """One line per row, the columns a reader compares with the paper."""
    if suite == "fig7":
        return [f"{r['tensor']} {r['engine']}: {r['time_all_modes_ms']:.4f} ms all modes "
                f"({' / '.join(f'{t:.4f}' for t in r['time_per_mode_ms'])}), bytes bound "
                f"{r['bytes_bound_ms']:.4f} ms, peak fraction {r['peak_fraction']}"
                + (f", tune {r['tune_ms']:.1f} ms ({r['tune_probes']} probes) then warm "
                   f"{r['tune_warm_ms']:.2f} ms ({r['tune_warm_probes']} probes)"
                   if "tune_ms" in r else "") for r in rows]
    if suite == "fig6":
        return [f"{r['tensor']} {r['fmt']} {r['locks']}: fit {r['fit']} diff {r['avg_abs_diff']}, "
                f"{r['time_per_iter_s'] * 1e3:.3f} ms per iteration" if "locks" in r else
                f"{r['tensor']} autotune budget={r['budget']}: fit {r['fit']} diff "
                f"{r['avg_abs_diff']}, {r['engine']} picked {r['picked']}, lossy picks "
                f"{r['lossy_picks']} (max error {r['winner_max_error']}), errors {r['errors']}, "
                f"rejected {sorted(r['rejected'])}" for r in rows]
    if suite == "fig8_9":
        return [f"{r['tensor']} R={r['rank']} dense fraction {r['dense_fraction']}: "
                f"{r['time_ms']:.4f} ms, {r['speedup_vs_alto']:.3f}× alto" for r in rows]
    return [json.dumps(r) for r in rows]


def check_bench_rows(suite: str, rows: list[dict]) -> None:
    times = [r[k] for r in rows for k in BENCH_TIMES[suite] if k in r]
    if not rows or not all(math.isfinite(t) and t > 0 for t in times):
        fail(f"phase 4r: {suite} returned {len(rows)} rows, or a time that is not finite")
    warm = [r["tune_warm_probes"] for r in rows if "tune_warm_probes" in r]
    if suite == "fig7" and (not warm or any(warm)):
        fail(f"phase 4r: fig7's warm `auto` builds made {warm} probes, expected 0 each")
    if suite == "fig6" and not all(r["within_budget"] for r in rows if "within_budget" in r):
        fail("phase 4r: a fig6 tune picked a fixed-point format over its accuracy budget")


def bench_checks(st, plan, formats, device) -> None:
    """Phase 4r.  Its launches, autotune probes included, go on a line of
    their own and not on the `kernels` line: the probes a tune makes depend
    on its timings."""
    out = Path(bench_common.RESULTS_DIR)
    out.mkdir(parents=True, exist_ok=True)
    mttkrp_kernel.launches = mttkrp_fixed_kernel.launches = gram_pinv.launches = 0
    t_phase = time.perf_counter()
    for suite in BENCH_SUITES:
        t0 = time.perf_counter()
        with open(out / f"{suite}.log", "w") as f, contextlib.redirect_stdout(f):
            rc = bench_main(["--only", suite, *BENCH_ARGS.get(suite, [])])
        seconds = time.perf_counter() - t0
        if rc != 0:
            fail(f"phase 4r: python -m repro_torch.bench --only {suite} exited {rc} "
                 f"({out / f'{suite}.log'})")
        rows = json.loads((out / f"torch_{suite}.json").read_text())
        check_bench_rows(suite, rows)
        log(f"[4r] {suite}: {len(rows)} rows in {seconds:.1f}s")
        for line in bench_table(suite, rows):
            log(f"[4r]   {line}")
    # fig7 at (a): phase 4's chunking and 4h's layouts, nothing rebuilt.
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bench_") as tmp, \
            open(out / "fig7_a.log", "w") as f, contextlib.redirect_stdout(f):
        rows = bench_fig7.engine_rows(
            "nell2-a", st, chunking=dict(chunk_shape=plan.chunk_shape, capacity=plan.capacity),
            plans=default_plan_cache, formats=formats, tstore=TuningStore(Path(tmp) / "a.json"),
            device=device, iters=3)
    bench_common.save("fig7_a", rows)
    check_bench_rows("fig7", rows)
    log(f"[4r] fig7 at (a): {len(rows)} rows in {time.perf_counter() - t0:.1f}s")
    for line in bench_table("fig7", rows):
        log(f"[4r]   {line}")
    launches = dict(float=mttkrp_kernel.launches, fixed=mttkrp_fixed_kernel.launches,
                    pinv=gram_pinv.launches)
    log(f"[4r] phase took {time.perf_counter() - t_phase:.1f}s; kernel launches {launches} "
        f"(autotune probes included; not on the kernels line)")
    if not all(launches.values()):
        fail(f"phase 4r: the harness did not launch every kernel: {launches}")


# ---------------------------------------------------------------------------
# Phases 4s and 4b: the serving path (DecomposeService over cp_als_batched).
# ---------------------------------------------------------------------------

SERVE_RANK, SERVE_ITERS = serve_bench.RANK, serve_bench.N_ITERS
SERVE_N, SERVE_CLIENTS, SERVE_MAX_BATCH, SERVE_MAX_WAIT_MS = 4096, 8, 256, 20.0
SERVE_WARM_N = 512                 # the warm second service's share of the load
SEQ_SAMPLE, BATCH_SAMPLE = 32, 64  # members held against the sequential `ref` run
BATCH_N = 65536                    # phase 4b: 2^16 tensors in one cp_als_batched call
# Parity of two batched or sequential runs of the same tensor (see the module
# docstring): `serve_bench.member_gap`, the serving benchmark's own rule.


def hold_gap(tag: str, got, want, against: str) -> None:
    """Hold two lists of CPResults of the same tensors together, each member
    at its own tolerances (`serve_bench.member_gap`; κ from `want`)."""
    gaps = [member_gap(a, b) for a, b in zip(got, want, strict=True)]
    worst = {k: max(g[k] for g in gaps) for k in ("gap", "fit", "kappa", "ratio")}
    over_floor = sum(g["gap"] > serve_bench.FACTOR_ATOL for g in gaps)
    log(f"[{tag}]   {len(got)} results against {against}: max |Δ factor or Δλ/max(1,|λ|)|="
        f"{worst['gap']:.3e} (above {serve_bench.FACTOR_ATOL} in {over_floor}), max |Δ fit|="
        f"{worst['fit']:.3e}, max κ={worst['kappa']:.1f}; max gap/tolerance={worst['ratio']:.3f}")
    if worst["ratio"] > 1.0:
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


def run_example(fn, *args):
    """Call an example's `run` or `main` with its output captured; returns
    (its return value, its lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = fn(*args)
    return ret, buf.getvalue().splitlines()


def examples_checks(device) -> dict:
    """Phase 4e: the example CLIs (`repro_torch.examples`) in process, on
    TABLE1 nell2 and the quickstart's tensor.  Returns the phase's kernel
    launches, autotune probes included (not on the `kernels` line)."""
    cpu = torch.device("cpu")
    total = Counter()

    def counted(fn, *args):
        mttkrp_kernel.launches = mttkrp_fixed_kernel.launches = gram_pinv.launches = 0
        ret, lines = run_example(fn, *args)
        n = dict(float=mttkrp_kernel.launches, fixed=mttkrp_fixed_kernel.launches,
                 pinv=gram_pinv.launches)
        total.update(n)
        return ret, lines, n

    # 1. The quickstart's four rows on the card against the CPU.
    card, lines, n = counted(quickstart.run, device)
    on_cpu, _ = run_example(quickstart.run, cpu)
    for line in lines:
        log(f"[4e]   quickstart: {line}")
    for name, res in card.items():
        got = np.array(res.fit_history + res.diff_history)
        want = np.array(on_cpu[name].fit_history + on_cpu[name].diff_history)
        tol = (FIXED_SMALL_ATOL + FIXED_SMALL_RTOL * np.abs(want) if name == "fixed"
               else SMALL_ATOL)
        gap = float(np.abs(got - want).max())
        log(f"[4e] quickstart {name}: card fit={res.fit_history} cpu fit="
            f"{on_cpu[name].fit_history} max gap (fit, diff)={gap:.3e}")
        if not np.all(np.abs(got - want) <= tol):
            fail(f"phase 4e: the quickstart's {name} row on the card left the CPU's")
    log(f"[4e] quickstart launches {n}")
    if n != dict(float=9, fixed=9, pinv=36):
        fail(f"phase 4e: the quickstart launched {n}, expected 9 float (kernel row), 9 fixed "
             "(fixed row), 36 Gram (3 per iteration of each row)")

    def argv(engine, *extra):
        return ["--tensor", "nell2", "--iters", str(N_ITERS), "--engine", engine, *extra]

    def iter_lines(lines):
        return [ln for ln in lines if ln.startswith("  iter ")]

    # 2. --engine kernel on the card against the same command on the CPU.
    want_n = N_ITERS * 3
    kern, lines, n = counted(decompose_tensor.run, decompose_tensor.parse_args(argv("kernel")),
                             device)
    cpu_kern, _ = run_example(decompose_tensor.run, decompose_tensor.parse_args(argv("kernel")),
                              cpu)
    gap = max(abs(a - b) for a, b in zip(kern.fit_history + kern.diff_history,
                                         cpu_kern.fit_history + cpu_kern.diff_history,
                                         strict=True))
    for line in lines:
        log(f"[4e]   kernel: {line}")
    log(f"[4e] decompose_tensor --engine kernel: launches {n}, fits {kern.fit_history}, "
        f"max gap to --device cpu (fit, diff)={gap:.3e} (tolerance {SMALL_ATOL})")
    if n["float"] != want_n or n["pinv"] != want_n or n["fixed"]:
        fail(f"phase 4e: --engine kernel launched {n}, expected {want_n} float and Gram")
    if len(iter_lines(lines)) != N_ITERS or not all(
            math.isfinite(f) for f in kern.fit_history) or len(kern.fit_history) != N_ITERS:
        fail(f"phase 4e: --engine kernel printed {len(iter_lines(lines))} iterations or a "
             "fit that is not finite")
    if gap > SMALL_ATOL:
        fail("phase 4e: --engine kernel on the card left the CPU run")

    # 3. --engine fixed (int7) through main.
    rc, lines, n = counted(decompose_tensor.main, argv("fixed"))
    log(f"[4e] decompose_tensor --engine fixed: exit {rc}, launches {n}; "
        + " | ".join(ln.strip() for ln in iter_lines(lines)))
    if rc != 0 or n["fixed"] != want_n or n["float"] or len(iter_lines(lines)) != N_ITERS:
        fail(f"phase 4e: --engine fixed exited {rc} with launches {n}, expected {want_n} fixed")

    # 4. --engine auto twice on one fresh store: the second run is warm.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as tmp:
        tuned = []
        for run_no in (1, 2):
            rc, lines, n = counted(decompose_tensor.main,
                                   argv("auto", "--store", str(Path(tmp) / "s.json")))
            shown = [ln for ln in lines if ln.startswith(("  winners:", "[decompose] tuning:",
                                                          "[decompose] engine="))]
            log(f"[4e] decompose_tensor --engine auto, run {run_no}: exit {rc}, launches {n}; "
                + " | ".join(ln.strip() for ln in shown))
            tuning = [ln for ln in shown if ln.startswith("[decompose] tuning:")]
            if rc != 0 or len(tuning) != 1 or len(iter_lines(lines)) != N_ITERS:
                fail(f"phase 4e: --engine auto run {run_no} exited {rc} or printed no tuning")
            tuned.append(tuning[0])
    if re.search(r"probes=0\b", tuned[0]) or not re.search(r"probes=0\b", tuned[1]):
        fail(f"phase 4e: the cold and warm --engine auto runs printed {tuned}, expected "
             "probes on the first and probes=0 on the second")

    # 5. --engine distributed on a one-rank NCCL group.
    try:
        res, lines, n = counted(decompose_tensor.run,
                                decompose_tensor.parse_args(argv("distributed")), device)
        backend = dist.get_backend()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    gap = max(abs(a - b) for a, b in zip(res.fit_history, kern.fit_history, strict=True))
    log(f"[4e] decompose_tensor --engine distributed on {backend}: launches {n}, fits "
        f"{res.fit_history}, max |fit - kernel's|={gap:.3e} (tolerance {FIT_ATOL})")
    if backend != "nccl" or n["float"] != want_n or gap > FIT_ATOL:
        fail(f"phase 4e: --engine distributed on {backend} launched {n}, expected {want_n} "
             "float, or its fits left --engine kernel's")

    # 6. --list-backends: `kernel` in the place of `pallas`.
    rc, lines = run_example(decompose_tensor.main, ["--list-backends"])
    names = [ln.split("|")[1].strip().strip("`") for ln in lines[2:]]
    log(f"[4e] decompose_tensor --list-backends: exit {rc}, backends {names}")
    if rc != 0 or "kernel" not in names or "pallas" in names:
        fail(f"phase 4e: --list-backends exited {rc} and listed {names}")
    return dict(total)


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


# ---------------------------------------------------------------------------
# Phase 4l: the LM serving path (repro_torch.models, launch.steps.generate).
# ---------------------------------------------------------------------------

LM_ARCH = "gemma3-4b"              # examples/serve_lm.py's default arch
LM_BATCH, LM_PROMPT, LM_GEN = 4, 24, 12
LM_TIMED_FROM = 4                  # ms per decode step: the mean over steps 4 onward
LM_F32_REL = 1e-4                  # card vs CPU at float32, each logit, of Σ|terms|
# Card vs CPU at bfloat16, the first step's logits, of the CPU's largest
# |logit|: four to eight bfloat16 steps of that logit.  Both sides round
# every elementwise step alike; the float32 sums inside the products and
# reductions differ in order, so a rounding flips now and then.
LM_BF16_REL = 2.0 ** -5
LM_RING_LAYERS, LM_RING_PROMPT = 6, 1040   # one 5:1 pattern; past the 1,024 window
LM_RING_REL = 1e-3                 # decode vs prefill at float32, of the largest |logit|
# The MoE, SSM and hybrid families served at full width, each with the depth
# it is cut to (None: whole) so that its weights fit the card beside the
# residents: qwen3-moe-30b-a3b 24 of 48 layers (15.6 B float32 parameters,
# 58 GiB), llama4-scout-17b-a16e 4 of 48 (one whole pattern: three
# chunked-local layers and the NoPE global one; 10.9 B, 40.5 GiB),
# xlstm-350m whole, jamba-1.5-large-398b 5 of 72 (Mamba+dense, Mamba+MoE,
# Mamba+dense, Mamba+MoE, attention+dense: every kind of block; 24.0 B
# bfloat16 parameters, 44.8 GiB).
LM_FAMILIES = {"qwen3-moe-30b-a3b": 24, "llama4-scout-17b-a16e": 4, "xlstm-350m": None,
               "jamba-1-5-large-398b": 5}
# The enc-dec and VLM archs, served and trained whole at full width:
# whisper-medium (24 encoder and 24 decoder layers, 811 M float32
# parameters, 3.0 GiB) and internvl2-1b (24 layers, 495 M, 1.8 GiB).
# Whisper's prefill runs over 1,500 encoder frames, the published 30 s
# window after its convolution stem (arXiv:2212.04356), and SyntheticBatches'
# 1,500 // 8 = 187 decoder tokens; its decode steps attend to a cross cache
# of 1,500 seeded keys and values (the reference's `generate` leaves it
# empty, and nothing of the reference writes the encoder's into it).
# Internvl's prefill runs over its 256 image tokens and a 24-token prompt.
LM_ENCDEC = ("whisper-medium", "internvl2-1b")
LM_FRAMES = 1500
LM_SMOKE_SEQ = 32                  # card vs CPU prefill: SyntheticBatches' seq_len
LM_SMOKE_ENC_LEN = 12              # card vs CPU decode: the cross cache's length
DECODE_UNREAD = ("enc_layers", "enc_norm", "img_proj")   # decode embeds tokens alone


def arch_batch(cfg, seq_len: int, batch: int, device) -> dict:
    """`SyntheticBatches` step 0, seed 0, as tensors on `device`: tokens
    (B, S) for a decoder-only arch (`SyntheticTokens`' batch), frames (B, S,
    D) and S // dec_ratio tokens for an enc-dec one, image embeds and S -
    n_image_tokens tokens for a VLM."""
    return {k: torch.from_numpy(v).to(device)
            for k, v in SyntheticBatches(cfg, seq_len, batch).batch(0).items()}


def fill_cross(cache, device="cpu", seed: int = 0):
    """Seeded normal draws (scale 0.5) on `device` into every layer's
    cross-attention keys and values (`xk`/`xv`); drawn on the CPU, the
    card's cache and the CPU's get the same.  Returns the cache."""
    g = torch.Generator(device).manual_seed(seed)
    for layer in (c for seg in cache for c in seg):
        for key in ("xk", "xv"):
            if key in layer:
                a = layer[key]
                a.copy_(torch.randn(a.shape, generator=g, device=device).mul_(0.5))
    return cache


@contextlib.contextmanager
def hidden_states(lm):
    """Record every hidden state `lm._logits` is given, as float32."""
    seen, logits_of = [], lm._logits

    def record(p, x, *ctx):
        seen.append(x.float())
        return logits_of(p, x, *ctx)
    lm._logits = record
    try:
        yield seen
    finally:
        del lm._logits


def abs_terms(lm, params, h) -> torch.Tensor:
    """Σ|terms| of each logit's final product: |h| @ |W|."""
    w = params["embed"]["w"].T if lm.cfg.tie_embeddings else params["unembed"]["w"]
    return h.abs() @ w.float().abs()


def lm_decode_logits(lm, params, tokens, enc_len: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced decode over tokens (B, S) on their device, against a
    cross cache of `enc_len` seeded keys and values (`fill_cross`; enc-dec
    only): every step's logits (S, B, V), and Σ|terms| of each logit's
    final product (`abs_terms`)."""
    with hidden_states(lm) as seen:
        b, s = tokens.shape
        cache = fill_cross(lm.init_cache(b, max_len=s + 8, dtype=torch.float32, enc_len=enc_len,
                                         device=tokens.device))
        step = make_decode_step(lm, MeshCtx(mesh=None))
        out = []
        with torch.no_grad():
            for t in range(s):
                logits, cache = step(params, tokens[:, t:t + 1], cache, t)
                out.append(logits.float())
    terms = torch.stack([abs_terms(lm, params, h[:, 0]) for h in seen])
    return torch.stack(out), terms


def lm_prefill_logits(lm, params, batch) -> tuple[torch.Tensor, torch.Tensor]:
    """`LM.prefill` over the arch's batch: the last position's logits (B, V)
    and their Σ|terms|."""
    with hidden_states(lm) as seen, torch.no_grad():
        logits = lm.prefill(params, MeshCtx(mesh=None), batch)[:, 0].float()
    return logits, abs_terms(lm, params, seen[-1][:, 0])


def hold_card(cfg, what: str, got, want, terms) -> bool:
    """Print and judge one card-vs-CPU comparison of logits: float32 within
    LM_F32_REL of Σ|terms| each, bfloat16 within LM_BF16_REL of the CPU's
    largest |logit|."""
    err = (got.cpu() - want).abs()
    if cfg.compute_dtype == "float32":
        ok = bool((err <= LM_F32_REL * terms).all())
        log(f"[4l] card vs CPU, {cfg.name} float32, {what}: max |Δ| {float(err.max()):.3e}, "
            f"max |Δ|/Σ|terms| {float((err / terms).max()):.3e} (tolerance {LM_F32_REL})")
        return ok
    scale = float(want.abs().max())
    log(f"[4l] card vs CPU, {cfg.name} bfloat16, {what}: max |Δ| {float(err.max()):.3e}, "
        f"{float(err.max()) / scale:.3e} of the largest |logit| (tolerance {LM_BF16_REL})")
    return float(err.max()) <= LM_BF16_REL * scale


def lm_card_vs_cpu(device, arch: str = LM_ARCH) -> None:
    """The arch's smoke config through `generate` on the card and the CPU,
    one set of weights, at float32 and at bfloat16; an enc-dec or VLM arch
    also through `prefill` over its frames or image embeds, and an enc-dec
    one's decode also against a cross cache of LM_SMOKE_ENC_LEN seeded
    keys and values."""
    cfg32 = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    params_cpu, _ = LM(cfg32).init(torch.Generator("cpu").manual_seed(0))
    params_card = lm_nn.tree_map(lambda a: a.to(device), params_cpu)
    prompts = torch.from_numpy(SyntheticTokens(cfg32.vocab, LM_PROMPT, LM_BATCH).batch(0))
    batch = arch_batch(cfg32, LM_SMOKE_SEQ, LM_BATCH, "cpu")
    enc_lens = (0, LM_SMOKE_ENC_LEN) if cfg32.encoder_decoder else (0,)
    ctx = MeshCtx(mesh=None)
    for cfg in (cfg32, get_smoke_config(arch)):
        lm = LM(cfg)
        toks_cpu = generate(lm, params_cpu, ctx, prompts, LM_GEN)
        toks_card = generate(lm, params_card, ctx, prompts.to(device), LM_GEN).cpu()
        same = torch.equal(toks_card, toks_cpu)
        if cfg.compute_dtype == "float32":
            # every step of the CPU run, teacher-forced on both sides
            seq = torch.cat([prompts, toks_cpu], dim=1)[:, :-1]
        else:
            seq = prompts[:, :1]   # the first step
        log(f"[4l] card vs CPU, {cfg.name} {cfg.compute_dtype}: generate's tokens equal {same}"
            f"{'' if cfg.compute_dtype == 'float32' else ' (not held)'}")
        ok = same or cfg.compute_dtype != "float32"
        for enc_len in enc_lens:
            want, terms = lm_decode_logits(lm, params_cpu, seq, enc_len)
            got, _ = lm_decode_logits(lm, params_card, seq.to(device), enc_len)
            what = f"{seq.shape[1]} decode steps' logits"
            if cfg.encoder_decoder:
                what += f", cross cache of {enc_len}"
            ok &= hold_card(cfg, what, got, want, terms)
        if cfg.encoder_decoder or cfg.n_image_tokens:
            want, terms = lm_prefill_logits(lm, params_cpu, batch)
            got, _ = lm_prefill_logits(lm, params_card,
                                       {k: v.to(device) for k, v in batch.items()})
            ok &= hold_card(cfg, "prefill over " + ", ".join(
                f"{k} {tuple(v.shape)}" for k, v in batch.items()), got, want, terms)
        if not ok:
            fail(f"phase 4l: the {cfg.compute_dtype} smoke config on the card left the CPU's")


def read_bytes(params, run, rows: int) -> tuple[int, object]:
    """The bytes of the weights `run()` (a decode step of `rows` tokens)
    reads, each once in its stored dtype: every weight but the encoder's
    and the image projection (DECODE_UNREAD: decode embeds tokens alone),
    the rows of an untied embedding table that were not looked up, and the
    experts of an MoE layer that no token was routed to (read from the
    routing `run` does).  Returns (them, run's result)."""
    seen, route = [], moe_mod._route

    def record(*args):
        gates, eids = route(*args)
        seen.append(eids)
        return gates, eids
    moe_mod._route = record
    try:
        out = run()
    finally:
        moe_mod._route = route
    total = sum(a.numel() * a.element_size() for k, v in params.items()
                if k not in DECODE_UNREAD for a in lm_nn.tree_leaves(v))
    if "unembed" in params:   # untied: the lookup reads `rows` rows of the table
        emb = params["embed"]["w"]
        total -= (emb.shape[0] - rows) * emb[0].numel() * emb.element_size()
    moe_layers = [layer["moe"] for seg in params["layers"] for layer in seg if "moe" in layer]
    for moe_p, eids in zip(moe_layers, seen, strict=True):  # one routing per MoE layer, in order
        per_expert = sum(moe_p[k][0].numel() * moe_p[k].element_size() for k in ("wg", "wu", "wd"))
        total -= (moe_p["wg"].shape[0] - len(torch.unique(eids))) * per_expert
    return total, out


def decode_costs(lm, params, prompts) -> dict:
    """One decode step's host waits (torch's sync log), its weights' bytes
    (`read_bytes`), its cross cache's bytes (enc-dec: every key and value,
    read once) and, under `torch.profiler`, its device launches and busy
    time, at positions 1, 2 and 3 of a fresh float32 cache."""
    ctx = MeshCtx(mesh=None)
    cache = lm.init_cache(prompts.shape[0], max_len=8, dtype=torch.float32,
                          device=prompts.device)
    cross = sum(layer[k].numel() * layer[k].element_size() for seg in cache for layer in seg
                for k in ("xk", "xv") if k in layer)
    with torch.no_grad():
        _, cache = lm.decode_step(params, ctx, prompts[:, :1], cache, 0)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                _, cache = lm.decode_step(params, ctx, prompts[:, 1:2], cache, 1)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        prof, _ = profile_call(lambda: lm.decode_step(params, ctx, prompts[:, 2:3], cache, 2))
        nbytes, _ = read_bytes(params, lambda: lm.decode_step(params, ctx, prompts[:, 3:4],
                                                              cache, 3), prompts.shape[0])
    return dict(host_waits=sum(SYNC_WARNING in str(w.message) for w in caught),
                read_bytes=nbytes, cross_bytes=cross, **prof)


def lm_prefill_time(lm, params, device) -> str:
    """An enc-dec or VLM arch's `prefill` at full width: LM_BATCH rows of
    LM_FRAMES frames and their 187 decoder tokens (whisper), or of the 256
    image tokens and an LM_PROMPT-token prompt (internvl); one warm-up
    call, then one timed (host clock around `torch.cuda.synchronize`).
    Returns the line's text."""
    cfg = lm.cfg
    seq = LM_FRAMES if cfg.encoder_decoder else cfg.n_image_tokens + LM_PROMPT
    batch = arch_batch(cfg, seq, LM_BATCH, device)
    ctx = MeshCtx(mesh=None)
    with torch.no_grad():
        lm.prefill(params, ctx, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = lm.prefill(params, ctx, batch)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
    if logits.shape != (LM_BATCH, 1, cfg.vocab) or not bool(torch.isfinite(logits).all()):
        fail(f"phase 4l: {cfg.name}'s prefill gave {tuple(logits.shape)} or values not finite")
    rows = sum(v.shape[0] * v.shape[1] for v in batch.values())
    return ("prefill of " + ", ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items())
            + f": {ms:.3f} ms ({rows / (ms / 1e3):.1f} input rows/s), logits finite")


def lm_full_width(device, smi_line: str, arch: str = LM_ARCH,
                  n_layers: int | None = None) -> None:
    """The arch at its published widths (its depth cut to `n_layers`, if
    given) through `generate`, twice; then one decode step's launches and
    host waits.  An enc-dec or VLM arch first runs `lm_prefill_time`, and
    an enc-dec one decodes against a cross cache of LM_FRAMES seeded keys
    and values (`fill_cross`)."""
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    lm = LM(cfg)
    ctx = MeshCtx(mesh=None)
    if cfg.encoder_decoder:
        init_cache = lm.init_cache
        lm.init_cache = lambda *a, **k: fill_cross(init_cache(*a, enc_len=LM_FRAMES, **k), device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params, _ = lm.init(torch.Generator(device).manual_seed(0))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = lm_nn.param_count(params)
    weight_bytes = sum(a.numel() * a.element_size() for a in lm_nn.tree_leaves(params))
    prompts = torch.from_numpy(SyntheticTokens(cfg.vocab, LM_PROMPT, LM_BATCH, seed=0).batch(0))
    prompts = prompts.to(device)
    prefill = (lm_prefill_time(lm, params, device) if cfg.encoder_decoder or cfg.n_image_tokens
               else None)

    step_s = []
    decode_step = lm.decode_step

    def timed(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = decode_step(*args)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        return out
    lm.decode_step = timed
    try:
        toks1 = generate(lm, params, ctx, prompts, LM_GEN).cpu()
    finally:
        del lm.decode_step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks2 = generate(lm, params, ctx, prompts, LM_GEN).cpu()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    costs = decode_costs(lm, params, prompts)
    step_ms = 1e3 * sum(step_s[LM_TIMED_FROM:]) / len(step_s[LM_TIMED_FROM:])
    bound_ms = 1e3 * (costs["read_bytes"] + costs["cross_bytes"]) / HBM_BYTES_PER_S
    enc = f" + {cfg.n_enc_layers} encoder" if cfg.encoder_decoder else ""
    log(f"[4l] full width {cfg.name}: {cfg.n_layers}{enc} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab}, {n_params} parameters ({weight_bytes / 2**30:.3f} GiB {cfg.param_dtype}), "
        f"init {t_init:.2f}s, compute {cfg.compute_dtype}")
    if prefill:
        log(f"[4l]   {prefill}; on {smi_line}")
    cross = (f" and the {costs['cross_bytes'] / 1e9:.3f} GB of its cross cache of {LM_FRAMES}"
             if cfg.encoder_decoder else "")
    log(f"[4l]   generate batch {LM_BATCH} prompt {LM_PROMPT} gen {LM_GEN}: "
        f"{len(step_s)} decode steps, ms per step (mean of steps {LM_TIMED_FROM}+) "
        f"{step_ms:.3f} (steps {[round(1e3 * x, 3) for x in step_s]}), bytes bound "
        f"{bound_ms:.3f} ms (the {costs['read_bytes'] / 1e9:.3f} GB of weights a step reads, "
        f"each once: all but the encoder, the image projection, the embedding rows not looked "
        f"up and the experts no token was routed to{cross}); untimed run {wall:.3f}s, "
        f"{LM_BATCH * LM_GEN / wall:.1f} generated "
        f"tokens/s; device memory peak {peak / 2**30:.3f} GiB, of which "
        f"{(peak - resident) / 2**30:.3f} GiB above what was resident before the run; on "
        f"{smi_line}")
    log(f"[4l]   one decode step: {costs['host_waits']} host waits, {costs['launches']} device "
        f"launches, {costs['busy_ms']:.3f} ms busy of {costs['wall_ms']:.3f} ms profiled "
        f"({100 * costs['busy_share']:.1f}%); top device kernels (name, self ms, calls) "
        f"{costs['top_kernels']}; top aten ops (name, device ms with children, calls) "
        f"{costs['top_ops']}")
    log(f"[4l]   tokens {toks2.tolist()}")
    if not (torch.equal(toks1, toks2) and toks2.shape == (LM_BATCH, LM_GEN)
            and toks2.dtype == torch.int32
            and bool(((toks2 >= 0) & (toks2 < cfg.vocab)).all())):
        fail(f"phase 4l: {cfg.name}: the two full-width runs gave other tokens, or tokens "
             f"outside the vocab")


def lm_ring(device) -> None:
    """Gemma3-4b's widths at one 5:1 pattern, float32: the teacher-forced
    decode of a prompt past the window (its rings wrap) against prefill."""
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=LM_RING_LAYERS,
                              compute_dtype="float32")
    lm = LM(cfg)
    ctx = MeshCtx(mesh=None)
    params, _ = lm.init(torch.Generator(device).manual_seed(0))
    toks = torch.from_numpy(SyntheticTokens(cfg.vocab, LM_RING_PROMPT, 2, seed=0).batch(0))
    toks = toks.to(device)
    with torch.no_grad():
        want = lm.prefill(params, ctx, {"tokens": toks})[:, 0]
        cache = lm.init_cache(2, max_len=LM_RING_PROMPT + 8, dtype=torch.float32,
                              device=device)
        for t in range(LM_RING_PROMPT):
            got, cache = lm.decode_step(params, ctx, toks[:, t:t + 1], cache, t)
    ring = cache[0][0]["kv"]
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    log(f"[4l] ring: {cfg.n_layers} layers at full width, float32, prompt {LM_RING_PROMPT}; "
        f"local ring {ring['k'].shape[1]} slots holding positions "
        f"{int(ring['pos'].min())}..{int(ring['pos'].max())}; decode vs prefill max |Δ| "
        f"{err:.3e}, {err / scale:.3e} of the largest |logit| (tolerance {LM_RING_REL})")
    if ring["k"].shape[1] != cfg.window or int(ring["pos"].min()) != LM_RING_PROMPT - cfg.window:
        fail("phase 4l: the local layer's ring did not wrap")
    if err > LM_RING_REL * scale:
        fail("phase 4l: the decode past the window left prefill")


def lm_checks(device, smi_line: str) -> None:
    """Phase 4l; fatal on any failure.  None of the three kernels is on
    this path: their counts must stay 0."""
    mttkrp_kernel.launches = 0
    mttkrp_fixed_kernel.launches = 0
    gram_pinv.launches = 0
    # 1. The example at its defaults (the smoke config), on the card, for
    # gemma3-4b and each of the other families.
    for arch in (LM_ARCH, *LM_FAMILIES, *LM_ENCDEC):
        rc, lines = run_example(serve_lm.main, ["--arch", arch, "--batch", str(LM_BATCH)])
        for line in lines:
            log(f"[4l] serve_lm: {line}")
        if rc != 0 or not lines or f"-> ({LM_BATCH}, {LM_GEN})" not in lines[0]:
            fail(f"phase 4l: the serve_lm example ({arch}) exited {rc} or printed {lines[:1]}")
    # 2. Card against CPU, 3. full width, 4. the ring at full width.
    for arch in (LM_ARCH, *LM_FAMILIES, *LM_ENCDEC):
        lm_card_vs_cpu(device, arch)
    torch.cuda.empty_cache()
    lm_full_width(device, smi_line)
    torch.cuda.empty_cache()
    lm_ring(device)
    torch.cuda.empty_cache()
    # 5. The MoE, SSM and hybrid families at full width, then the enc-dec
    # and VLM archs whole, one at a time.
    for arch, n_layers in (*LM_FAMILIES.items(), *((a, None) for a in LM_ENCDEC)):
        t0 = time.perf_counter()
        lm_full_width(device, smi_line, arch, n_layers)
        torch.cuda.empty_cache()
        log(f"[4l]   {arch} took {time.perf_counter() - t0:.1f}s")
    counts = (mttkrp_kernel.launches, mttkrp_fixed_kernel.launches, gram_pinv.launches)
    log(f"[4l] kernel launches (float, fixed, Gram): {counts}")
    if any(counts):
        fail(f"phase 4l: the LM path launched a kernel of the CP-ALS path: {counts}")


# ---------------------------------------------------------------------------
# Phase 4t: the LM training path (repro_torch.optim, checkpoint,
# launch.steps.make_train_step, launch.elastic).
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM = 4, 256, 2
TRAIN_WARMUP, TRAIN_TIMED = 1, 3
TRAIN_LR = 1e-4
TRAIN_F32_LAYERS = 6               # one 5:1 pattern, float32 moments
TRAIN_CKPT_LAYERS = 2              # the checkpoint round trip
TRAIN_CP_RANK = 16
# The other families trained at full width: (arch, depth (None: whole),
# 8-bit moments).  xlstm-350m whole with float32 moments; qwen3-moe-30b-a3b
# cut to 4 layers with 8-bit moments (its backward runs through the sorted
# gather, the per-expert products and the ordered add back).
TRAIN_FAMILIES = (("xlstm-350m", None, False), ("qwen3-moe-30b-a3b", 4, True))
# The enc-dec and VLM archs trained whole with float32 moments, each at its
# own sequence (SyntheticBatches' seq_len): whisper-medium 1,500 frames and
# 187 decoder tokens, internvl2-1b 256 image and 256 text tokens.
TRAIN_ENCDEC = {"whisper-medium": LM_FRAMES, "internvl2-1b": 512}
# Card vs CPU, the smoke config, two steps of grad_accum 2 at float32
# compute.  The losses within 1e-5 relative.  The params: at most 0.1% of
# entries more than 1e-5 apart and none more than 4·lr, since Adam's first
# steps are nearly sign(g)·lr and an entry whose gradient is as small as
# the two sides' rounding differences (float32 sums in another order) may
# move the other way (tests/test_torch_train.py holds the CPU to the JAX
# package so).  8-bit moments: each card step starts from the CPU's state,
# as the CPU tests start each step from the JAX package's.  Run on the
# card with both sides carrying their own 8-bit state, one q that rounds
# the other way at a tie in step 1 moves its block's absmax by one quantum
# in step 2, and so the block's scale by up to 1/127 and many of its q
# (PERF.md §6).  From one state: the int8 q buffers at most 1
# apart, in at most 0.1% of all the state's entries (a rounding tie after
# float32 sums taken in another order), and each scale within one quantum
# (1/127) relative: a larger gap would move the block's largest q by more
# than 1.
TRAIN_SMOKE_LR = 1e-3
TRAIN_LOSS_REL = 1e-5
TRAIN_PARAM_ATOL, TRAIN_PARAM_SHARE = 1e-5, 1e-3
TRAIN_Q8_SHARE, TRAIN_SCALE_RTOL = 1e-3, 1 / 127
# compress_grad on the card against the CPU on one full-width gradient:
# approx and err within 1e-4 of max|g| (float32 products over 10,240
# terms summed in another order, and another QR), q within 1e-3 of its
# largest entry up to the sign of each column.
TRAIN_CP_TOL, TRAIN_CP_Q_TOL = 1e-4, 1e-3
# The train step's lookups whose backward adds into a gradient (train_sites):
# each backward run TRAIN_SITE_RUNS times from the same inputs, and timed
# over TRAIN_SITE_REPS calls.
TRAIN_SITE_RUNS, TRAIN_SITE_REPS = 3, 20
CHECKSUM_WORDS = 1 << 26           # int32 words a state_checksum pass widens at once


def train_tree_gap(got, want) -> tuple[float, float]:
    """(max |Δ|, the share of entries more than TRAIN_PARAM_ATOL apart) of
    two float trees."""
    d = torch.cat([(a.float().cpu() - b.float().cpu()).abs().flatten()
                   for a, b in zip(lm_nn.tree_leaves(got), lm_nn.tree_leaves(want), strict=True)])
    return float(d.max()), float((d > TRAIN_PARAM_ATOL).float().mean())


def train_card_vs_cpu(device, arch: str = LM_ARCH) -> None:
    """The arch's smoke config, one set of weights, two steps of grad_accum
    2 on the card and on the CPU, with float32 moments (each side its own
    state) and with 8-bit moments (each card step from the CPU's state)."""
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    lm = LM(cfg)
    params, _ = lm.init(torch.Generator("cpu").manual_seed(0))
    batch = arch_batch(cfg, 32, TRAIN_BATCH, "cpu")
    ctx = MeshCtx(mesh=None)
    for use_8bit in (False, True):
        opt_cfg = AdamWConfig(lr=TRAIN_SMOKE_LR, use_8bit=use_8bit)
        step = make_train_step(lm, ctx, opt_cfg, grad_accum=TRAIN_ACCUM)
        p_cpu = lm_nn.tree_map(torch.clone, params)
        o_cpu = adamw_init(p_cpu, opt_cfg)
        l_cpu, l_card, q_diff, q_max, s_gap = [], [], 0, 0, 0.0
        for k in range(2):
            if use_8bit or k == 0:
                p_card, o_card = lm_nn.tree_map(lambda a: a.to(device, copy=True), (p_cpu, o_cpu))
            p_card, o_card, loss = step(p_card, o_card, {k: v.to(device) for k, v in batch.items()})
            l_card.append(float(loss))
            p_cpu, o_cpu, loss = step(p_cpu, o_cpu, batch)
            l_cpu.append(float(loss))
            if use_8bit:
                n_q = 0
                for kind in ("m", "v"):
                    for a, b in zip(lm_nn.tree_leaves(o_card[kind]),
                                    lm_nn.tree_leaves(o_cpu[kind]), strict=True):
                        a = a.cpu()
                        if a.dtype == torch.int8:
                            d = (a.to(torch.int32) - b.to(torch.int32)).abs()
                            q_max = max(q_max, int(d.max()))
                            q_diff += int((d > 0).sum())
                            n_q += d.numel()
                        else:
                            s_gap = max(s_gap, float(((a - b).abs() / b.abs()).max()))
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(l_card, l_cpu, strict=True))
        p_max, p_share = train_tree_gap(p_card, p_cpu)
        ok = (loss_gap <= TRAIN_LOSS_REL and p_share <= TRAIN_PARAM_SHARE
              and p_max <= 4 * TRAIN_SMOKE_LR and int(o_card["step"]) == 2)
        what = f"params max |Δ| {p_max:.3e}, share > {TRAIN_PARAM_ATOL}: {p_share:.2e}"
        if use_8bit:
            q_share = q_diff / (2 * n_q)
            ok = ok and q_max <= 1 and q_share <= TRAIN_Q8_SHARE and s_gap <= TRAIN_SCALE_RTOL
            what += (f"; q max |Δ| {q_max}, {q_diff} entries differ over both steps, share "
                     f"{q_share:.2e} (≤ 1, ≤ {TRAIN_Q8_SHARE}), scales {s_gap:.2e} relative "
                     f"(≤ {TRAIN_SCALE_RTOL:.3e})")
        else:
            m_max, _ = train_tree_gap(o_card["m"], o_cpu["m"])
            what += f"; m max |Δ| {m_max:.3e}"
        log(f"[4t] card vs CPU, {cfg.name} float32, {'8-bit' if use_8bit else 'float32'} "
            f"moments, 2 steps of grad_accum {TRAIN_ACCUM}: losses card {l_card} cpu {l_cpu} "
            f"(max {loss_gap:.2e} relative, ≤ {TRAIN_LOSS_REL}); {what} (≤ "
            f"{TRAIN_PARAM_SHARE}, none > {4 * TRAIN_SMOKE_LR})")
        if not ok:
            fail(f"phase 4t: the smoke config's train steps on the card left the CPU's "
                 f"({'8-bit' if use_8bit else 'float32'} moments)")


def train_sites(device) -> None:
    """Each lookup of the train step whose backward adds into a gradient,
    at 4t's shapes on the card (one micro-batch): gemma3-4b's embedding and
    its loss's gather, xlstm-350m's stabiliser (`xlstm._cummax`), and
    qwen3-moe-30b-a3b's gathers of each token's k rows, of the gates and of
    the slots.  Each backward runs TRAIN_SITE_RUNS times from the same
    inputs and upstream gradient, each against the first bit for bit, and
    one forward and backward is timed (CUDA events).  The three lookups the
    step now makes through `F.embedding` and `_cummax` run beside the
    indexing they replaced (`w[rows]`, `torch.cummax`), in turns; whether
    that repeats is printed, not required.  Fatal unless every backward the
    step runs repeats."""
    t0 = time.perf_counter()
    g = torch.Generator(device).manual_seed(0)

    def normal(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=device).to(dtype).requires_grad_()
    cfg, xcfg, mcfg = get_config(LM_ARCH), get_config("xlstm-350m"), get_config(
        "qwen3-moe-30b-a3b")
    b = TRAIN_BATCH // TRAIN_ACCUM
    tok = torch.from_numpy(SyntheticTokens(cfg.vocab, TRAIN_SEQ, b).batch(0)).to(device)
    table, logits = normal(cfg.vocab, cfg.d_model), normal(b, TRAIN_SEQ, cfg.vocab)
    a = normal(b, xcfg.n_heads, TRAIN_SEQ)
    t, k = b * TRAIN_SEQ, mcfg.top_k
    xt = normal(t, mcfg.d_model, dtype=torch.bfloat16)
    gates, slots = normal(t, k, dtype=torch.bfloat16), normal(t, k, mcfg.d_model,
                                                             dtype=torch.bfloat16)
    with torch.no_grad():
        eids = torch.topk(torch.randn(t, mcfg.n_experts, generator=g, device=device), k).indices
    order = torch.argsort(eids.reshape(-1), stable=True)   # by expert, as moe_apply sorts
    rows = order // k                                      # flat_tok[order]
    by_id = torch.argsort(eids, dim=-1)[..., None].expand(t, k, mcfg.d_model)
    sites = [  # (name, the step's forward, its input, the indexing it replaced)
        ("embedding", lambda: F.embedding(tok, table), table, lambda: table[tok]),
        ("stabiliser", lambda: xlstm_mod._cummax(a, 2), a, lambda: torch.cummax(a, 2).values),
        ("MoE rows", lambda: F.embedding(rows, xt), xt, lambda: xt[rows]),
        ("MoE gates", lambda: gates.reshape(-1)[order], gates, None),
        ("MoE slots", lambda: torch.gather(slots, 1, by_id), slots, None),
        ("loss", lambda: torch.gather(logits, -1, tok[..., None]), logits, None),
    ]
    bad = []
    for name, fwd, x, replaced in sites:
        out = fwd()
        up = torch.randn(out.shape, generator=g, device=device).to(out.dtype)
        del out

        def backward(f=fwd, x=x, up=up):
            return torch.autograd.grad(f(), x, up)[0]

        def repeats(bwd):
            first = bwd()
            gaps = [float((bwd().float() - first.float()).abs().max())
                    for _ in range(TRAIN_SITE_RUNS - 1)]
            return first, gaps
        got, gaps = repeats(backward)
        line = (f"{name} {tuple(x.shape)} {str(x.dtype).removeprefix('torch.')}: the step's "
                f"backward, {TRAIN_SITE_RUNS} runs, max |Δ| from the first {gaps}")
        if replaced is None:
            line += f"; {time_ms(backward, TRAIN_SITE_REPS):.4f} ms forward and backward"
        else:
            def old_backward(f=replaced, x=x, up=up):
                return torch.autograd.grad(f(), x, up)[0]
            old, old_gaps = repeats(old_backward)
            ms = [time_ms(f, TRAIN_SITE_REPS)
                  for f in (old_backward, backward, backward, old_backward)]
            line += (f"; the indexing it replaced: max |Δ| from its first {old_gaps}, from the "
                     f"step's {float((old.float() - got.float()).abs().max()):.3e}; ms forward "
                     f"and backward, in turns (replaced, step's, step's, replaced) "
                     f"{[round(m, 4) for m in ms]}")
            del old
        log(f"[4t] site {line}")
        if any(gaps):
            bad.append(name)
        del got
    log(f"[4t] the sites took {time.perf_counter() - t0:.1f}s")
    if bad:
        fail(f"phase 4t: the backward of {bad} does not repeat bit for bit on the card")


def state_checksum(tree) -> str:
    """A checksum of a tree's bits: each leaf's bytes as int32 words (zero
    padded), weighted by 1 + (i·2654435761 mod 2^31) at word i and summed
    modulo 2^64, the leaves folded in `tree_leaves`' order."""
    h = 0
    for leaf in lm_nn.tree_leaves(tree):
        raw = leaf.detach().reshape(-1).view(torch.uint8)
        if raw.numel() % 4:
            raw = torch.cat([raw, raw.new_zeros(-raw.numel() % 4)])
        words = raw.view(torch.int32)
        total = 0
        for i in range(0, words.numel(), CHECKSUM_WORDS):
            w = words[i:i + CHECKSUM_WORDS].long()
            place = torch.arange(i, i + w.numel(), device=w.device) * 2654435761 % 2**31 + 1
            total += int((w * place).sum())
        h = (h * 1000003 + total) % 2**64
    return f"{h:016x}"


def first_step_twice(step, params, opt, batch, tag: str):
    """The first train step taken twice from the same params and optimizer
    state: fatal unless the two losses are equal and every parameter and
    moment leaf is `torch.equal`.  Prints a checksum of each state after
    the step.  The state's copy lives in pinned host memory (gemma3-4b's
    full-width state, 22 GiB, does not fit twice beside its step), released
    afterwards; after the first step it swaps, one leaf at a time, with the
    state, which so starts the second step from the copy while the copy
    keeps the first step's result.  Returns (params, opt, loss) after the
    step."""
    def keep(a):
        return torch.empty(a.shape, dtype=a.dtype, pin_memory=True).copy_(a)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    copy = lm_nn.tree_map(keep, (params, opt))
    params, opt, loss = step(params, opt, batch)
    first = (float(loss), state_checksum((params, opt)))
    leaves = list(zip(lm_nn.tree_leaves((params, opt)), lm_nn.tree_leaves(copy), strict=True))
    with torch.no_grad():
        for live, kept in leaves:
            stepped = live.clone()
            live.copy_(kept)
            kept.copy_(stepped)
            del stepped
    params, opt, loss = step(params, opt, batch)
    again = (float(loss), state_checksum((params, opt)))
    n_equal = sum(bool(torch.equal(live, kept.to(live.device))) for live, kept in leaves)
    del copy, leaves
    torch._C._host_emptyCache()   # hand the pinned pages back to the host
    torch.cuda.synchronize()
    n_leaves = len(lm_nn.tree_leaves((params, opt)))
    log(f"[4t]   {tag}: the first step twice from one state: losses {first[0]!r}, "
        f"{again[0]!r}; checksums "
        f"{first[1]}, {again[1]}; {n_equal} of {n_leaves} parameter and moment leaves equal; "
        f"{time.perf_counter() - t0:.1f}s")
    if first != again or n_equal != n_leaves:
        fail(f"phase 4t: {tag}: the first train step is not reproducible bit for bit")
    return params, opt, loss


def active_params(cfg, params) -> int:
    """Parameters one token's forward uses: an MoE layer's experts count
    top_k / n_experts of theirs (the routed share), all others whole."""
    total = lm_nn.param_count(params)
    if not cfg.n_experts:
        return total
    experts = sum(layer["moe"][k].numel() for seg in params["layers"] for layer in seg
                  if "moe" in layer for k in ("wg", "wu", "wd"))
    return int(total - experts * (1 - cfg.top_k / cfg.n_experts))


def encdec_flops(cfg, params, batch) -> float:
    """One forward's FLOPs of an enc-dec or VLM arch: 2 per weight per row
    it multiplies.  Whisper: the encoder's weights over the frames, each
    decoder layer's cross-attention key and value projections over the
    frames too, the other decoder weights and the unembedding over the
    decoder tokens (the untied embedding is a lookup).  Internvl: `img_proj`
    over the image tokens, the layers over image and text, the tied
    embedding (the unembedding) over the text tail, where the loss is."""
    def n(tree):
        return sum(a.numel() for a in lm_nn.tree_leaves(tree))
    b, s_tok = batch["tokens"].shape
    if cfg.encoder_decoder:
        s_enc = batch["frames"].shape[1]
        kv = sum(n(layer["xattn"][k]) for seg in params["layers"] for layer in seg
                 for k in ("wk", "wv"))
        dec = n(params["layers"]) + n(params["final_norm"]) + n(params["unembed"]) - kv
        return 2.0 * b * ((n(params["enc_layers"]) + n(params["enc_norm"]) + kv) * s_enc
                          + dec * s_tok)
    s_img = batch["image_embeds"].shape[1]
    return 2.0 * b * (n(params["img_proj"]) * s_img
                      + (n(params["layers"]) + n(params["final_norm"])) * (s_img + s_tok)
                      + n(params["embed"]) * s_tok)


def optimizer_bytes(n_params: int, use_8bit: bool) -> int:
    """Bytes one AdamW pass must move: the float32 params read and written,
    the gradients read, each moment read and written (int8 and a float32
    scale per 256, or float32)."""
    moment = (1 + 4 / 256) if use_8bit else 4
    return int(n_params * (4 + 4 + 4 + 2 * 2 * moment))


def _self_us(e) -> float:
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def _total_us(e) -> float:
    return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)


def profile_call(fn, ranges: tuple[str, ...] = ()) -> tuple[dict, object]:
    """`fn()` under `torch.profiler`: the device's busy share of its wall
    time, the top device kernels (self time) and aten ops (with their
    children), the launch count, and each `record_function` range of
    `ranges` opened inside `fn` (its host ms and its device span).
    Returns (those, fn's result)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # A range shows twice: a host event, and a device event spanning its
    # kernels (not a kernel itself: left out of the busy time).
    device = [e for e in events if e.device_type == DeviceType.CUDA and e.key not in ranges]
    ops = [e for e in events if e.device_type != DeviceType.CUDA and e.key.startswith("aten::")]
    busy_us = sum(_self_us(e) for e in device)
    stats = dict(
        wall_ms=1e3 * wall, busy_ms=busy_us / 1e3, busy_share=busy_us / 1e6 / wall,
        launches=sum(e.count for e in device),
        top_kernels=[(e.key[:90], round(_self_us(e) / 1e3, 3), e.count)
                     for e in sorted(device, key=_self_us, reverse=True)[:6]],
        top_ops=[(e.key, round(_total_us(e) / 1e3, 3), e.count)
                 for e in sorted(ops, key=_total_us, reverse=True)[:8]])
    for name in ranges:
        hits = [e for e in events if e.key == name]
        stats[f"{name}_host_ms"] = sum(e.cpu_time_total for e in hits
                                       if e.device_type != DeviceType.CUDA) / 1e3
        stats[f"{name}_span_ms"] = sum(_self_us(e) for e in hits
                                       if e.device_type == DeviceType.CUDA) / 1e3
    return stats, out


def profile_step(step, params, opt, batch) -> tuple[dict, torch.Tensor]:
    """One train step under `profile_call`, with an `adamw_update` range
    around the optimizer's update."""
    from torch.profiler import record_function
    update = train_steps.adamw_update

    def ranged(*args):
        with record_function("adamw_update"):
            return update(*args)
    train_steps.adamw_update = ranged
    try:
        stats, (_, _, loss) = profile_call(lambda: step(params, opt, batch),
                                           ranges=("adamw_update",))
    finally:
        train_steps.adamw_update = update
    stats["adamw_host_ms"] = stats.pop("adamw_update_host_ms")
    stats["adamw_span_ms"] = stats.pop("adamw_update_span_ms")
    return stats, loss


def train_run(cfg, opt_cfg, device, smi_line: str, tag: str, *, profiled: bool,
              seq: int = TRAIN_SEQ):
    """Train `cfg` from `torch.Generator` seed 0 on the card on one
    `SyntheticBatches` batch of seq_len `seq` (seed 0; `SyntheticTokens`'
    for a decoder-only arch): the first step (the warm-up) taken twice from
    one state (`first_step_twice`), then TRAIN_TIMED timed steps (and one under the profiler).  Prints ms
    per step, tokens/s, the losses, the peak memory above what was resident
    (the first step's copies left out), the FLOP bound of the step and the
    bytes bound of its optimizer pass.  Fatal if the first step does not
    repeat bit for bit, if a loss is not finite, or unless the last loss is
    below the first.  Returns (lm, params, opt)."""
    lm = LM(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    params, _ = lm.init(torch.Generator(device).manual_seed(0))
    opt = adamw_init(params, opt_cfg)
    n_params = lm_nn.param_count(params)
    batch = arch_batch(cfg, seq, TRAIN_BATCH, device)
    step = make_train_step(lm, MeshCtx(mesh=None), opt_cfg, grad_accum=TRAIN_ACCUM)
    init_peak = torch.cuda.max_memory_allocated()
    params, opt, loss = first_step_twice(step, params, opt, batch, f"{cfg.name} {tag}")
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [float(loss)], []
    for _ in range(TRAIN_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
    prof = None
    if profiled:
        prof, loss = profile_step(step, params, opt, batch)
        losses.append(float(loss))
    peak = max(init_peak, torch.cuda.max_memory_allocated())
    step_ms = 1e3 * sum(step_s) / len(step_s)
    n_active = active_params(cfg, params)
    rows = {k: v.shape[0] * v.shape[1] for k, v in batch.items()}
    tokens = rows["tokens"]
    if cfg.encoder_decoder or cfg.n_image_tokens:
        # forward, backward (twice the forward) and the remat forward
        flops = 4.0 * encdec_flops(cfg, params, batch)
        flop_rule = "8 per weight per row it multiplies (encdec_flops)"
    else:
        flops = roofline_model_flops(n_active, tokens) + 2.0 * n_active * tokens  # + remat forward
        flop_rule = "6·N·T + 2·N·T remat, N active"
    flop_ms = 1e3 * flops / BF16_FLOPS
    opt_ms = 1e3 * optimizer_bytes(n_params, opt_cfg.use_8bit) / HBM_BYTES_PER_S
    log(f"[4t] {tag}: {cfg.name} {cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab}, {n_params} parameters ({n_active} active per token), "
        f"{cfg.param_dtype} weights, {cfg.compute_dtype} "
        f"compute, remat {cfg.remat}, {'8-bit' if opt_cfg.use_8bit else 'float32'} moments, "
        f"lr {opt_cfg.lr}; batch " + ", ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items())
        + f", grad_accum {TRAIN_ACCUM}")
    per_s = ", ".join(f"{r / (step_ms / 1e3):.1f} {k}" for k, r in rows.items())
    log(f"[4t]   ms per step (mean of {TRAIN_TIMED} after {TRAIN_WARMUP} warm-up) {step_ms:.3f} "
        f"(steps {[round(1e3 * x, 3) for x in step_s]}), trained rows/s: {per_s}; "
        f"losses {losses}; device memory peak {peak / 2**30:.3f} GiB, "
        f"{(peak - resident) / 2**30:.3f} GiB above what was resident; bound: the FLOPs "
        f"({flop_rule} = {flops:.4e}) over {BF16_FLOPS:.3e} bfloat16 FLOP/s "
        f"{flop_ms:.3f} ms, the optimizer pass's bytes "
        f"({optimizer_bytes(n_params, opt_cfg.use_8bit) / 1e9:.3f} GB) over 3.35 TB/s "
        f"{opt_ms:.3f} ms; on {smi_line}")
    if prof:
        log(f"[4t]   profiled step: wall {prof['wall_ms']:.3f} ms, device busy "
            f"{prof['busy_ms']:.3f} ms ({100 * prof['busy_share']:.1f}% of the profiled step, "
            f"{100 * prof['busy_ms'] / step_ms:.1f}% of the unprofiled step's mean), "
            f"{prof['launches']} device launches; the AdamW update: host "
            f"{prof['adamw_host_ms']:.3f} ms, its kernels span {prof['adamw_span_ms']:.3f} ms "
            f"on the device")
        log(f"[4t]   top device kernels (name, self ms, calls) {prof['top_kernels']}")
        log(f"[4t]   top aten ops (name, device ms with children, calls) {prof['top_ops']}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"phase 4t: {tag}: a loss is not finite or the last is not below the first")
    return lm, params, opt


def train_cp_compress(lm, params, device) -> None:
    """compress_grad on the card and on the CPU on the first layer's MLP
    up-projection gradient (2560 × 10240) at R = 16, one batch's."""
    w = params["layers"][0][0]["mlp"]["wu"]
    tracked = lm_nn.tree_map(lambda a: a.detach().requires_grad_(), params)
    batch = {"tokens": torch.from_numpy(SyntheticTokens(
        lm.cfg.vocab, TRAIN_SEQ, TRAIN_BATCH // TRAIN_ACCUM, seed=0).batch(0)).to(device)}
    g, = torch.autograd.grad(lm.loss(tracked, MeshCtx(mesh=None), batch),
                             [tracked["layers"][0][0]["mlp"]["wu"]])
    del tracked
    st_cpu = cp_compress_state({"wu": w.cpu()}, rank=TRAIN_CP_RANK)["wu"]
    st_card = lm_nn.tree_map(lambda a: a.to(device), st_cpu)
    got, got_st = compress_grad(g, st_card)
    want, want_st = compress_grad(g.cpu(), st_cpu)
    scale = float(g.abs().max())
    err_a = float((got.cpu() - want).abs().max())
    err_e = float((got_st["err"].cpu() - want_st["err"]).abs().max())
    q_got, q_want = got_st["q"].cpu(), want_st["q"]
    signs = torch.sign((q_got * q_want).sum(dim=0))
    err_q = float((q_got * signs - q_want).abs().max())
    ms = time_ms(lambda: compress_grad(g, st_card), 20)
    log(f"[4t] compress_grad on {tuple(g.shape)} at R = {TRAIN_CP_RANK}: card vs CPU approx "
        f"{err_a / scale:.2e}, err {err_e / scale:.2e} of max|g| (≤ {TRAIN_CP_TOL}), q up to "
        f"column signs {err_q / float(q_want.abs().max()):.2e} of its largest entry (≤ "
        f"{TRAIN_CP_Q_TOL}); {ms:.3f} ms per call on the card")
    if max(err_a, err_e) > TRAIN_CP_TOL * scale or err_q > TRAIN_CP_Q_TOL * float(
            q_want.abs().max()):
        fail("phase 4t: compress_grad on the card left the CPU's")


def train_checkpoint(device) -> None:
    """Gemma3-4b's widths at TRAIN_CKPT_LAYERS layers, 8-bit moments: one
    step, an async save of the state while the next step runs, then
    `elastic_restore` into a fresh structure: bit for bit the snapshot, and
    one step from it gives that next step's loss."""
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=TRAIN_CKPT_LAYERS)
    opt_cfg = AdamWConfig(lr=TRAIN_LR, use_8bit=True)
    lm = LM(cfg)
    params, _ = lm.init(torch.Generator(device).manual_seed(0))
    opt = adamw_init(params, opt_cfg)
    batch = {"tokens": torch.from_numpy(SyntheticTokens(
        cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0).batch(0)).to(device)}
    step = make_train_step(lm, MeshCtx(mesh=None), opt_cfg, grad_accum=TRAIN_ACCUM)
    params, opt, _ = step(params, opt, batch)
    state = {"params": params, "opt": opt}
    snapshot = lm_nn.tree_map(torch.clone, state)
    n_bytes = sum(a.numel() * a.element_size() for a in lm_nn.tree_leaves(state))
    with tempfile.TemporaryDirectory() as tmp:
        ck = AsyncCheckpointer(tmp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(1, state)
        t_snap = time.perf_counter() - t0
        params, opt, live_loss = step(params, opt, batch)  # while the thread writes
        torch.cuda.synchronize()
        t_step = time.perf_counter() - t0 - t_snap
        ck.wait()
        t_save = time.perf_counter() - t0
        del params, opt, state
        had_group = dist.is_initialized()
        t0 = time.perf_counter()
        try:
            mesh, r_params, r_opt, r_step = elastic_restore(lm, tmp, opt_cfg, device=device)
            torch.cuda.synchronize()
            t_restore = time.perf_counter() - t0
        finally:
            if not had_group and dist.is_initialized():
                dist.destroy_process_group()
    same = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(
        lm_nn.tree_leaves({"params": r_params, "opt": r_opt}), lm_nn.tree_leaves(snapshot),
        strict=True))
    _, _, r_loss = step(r_params, r_opt, batch)
    log(f"[4t] checkpoint: {cfg.name} at {cfg.n_layers} layers, 8-bit moments, "
        f"{n_bytes / 1e9:.3f} GB in {len(lm_nn.tree_leaves(snapshot))} arrays; async save: "
        f"snapshot to the host {t_snap:.2f}s, one train step while it wrote {t_step:.2f}s, "
        f"committed after {t_save:.2f}s; elastic_restore (mesh {mesh_axes(mesh)}, step "
        f"{r_step}) {t_restore:.2f}s; restored equal to the snapshot bit for bit: {same}; the "
        f"next step's loss live {float(live_loss)!r}, from the restored state "
        f"{float(r_loss)!r}")
    if not same or r_step != 1 or float(r_loss) != float(live_loss):
        fail("phase 4t: the restored checkpoint is not the snapshot, or its next step's loss "
             "is not the live run's")


def train_checks(device, smi_line: str) -> None:
    """Phase 4t; fatal on any failure.  None of the three kernels is on
    this path: their counts must stay 0."""
    mttkrp_kernel.launches = 0
    mttkrp_fixed_kernel.launches = 0
    gram_pinv.launches = 0
    # 1. Card against CPU at the smoke size, gemma3-4b's and the other
    # families'.
    for arch in (LM_ARCH, *LM_FAMILIES, *LM_ENCDEC):
        train_card_vs_cpu(device, arch)
    # 1b. The lookups whose backward adds into a gradient, each repeated.
    train_sites(device)
    torch.cuda.empty_cache()
    # 2. Full width, 8-bit moments, with a profiled step.
    cfg = get_config(LM_ARCH)
    train_run(cfg, AdamWConfig(lr=TRAIN_LR, use_8bit=True), device, smi_line,
              "full width, 8-bit moments", profiled=True)
    torch.cuda.empty_cache()
    # 3. Float32 moments at full width, the depth cut to one pattern; its
    # gradient for 5.
    cfg6 = dataclasses.replace(cfg, n_layers=TRAIN_F32_LAYERS)
    lm6, params6, opt6 = train_run(cfg6, AdamWConfig(lr=TRAIN_LR), device, smi_line,
                                f"float32 moments, depth cut to {TRAIN_F32_LAYERS} layers",
                                profiled=False)
    # 5. CP compression on the card.
    train_cp_compress(lm6, params6, device)
    del lm6, params6, opt6   # its float32 moments are 9.2 GiB
    torch.cuda.empty_cache()
    # 4. Checkpoint and resume.
    train_checkpoint(device)
    torch.cuda.empty_cache()
    # 6. The other families at full width.
    for arch, n_layers, use_8bit in TRAIN_FAMILIES:
        t0 = time.perf_counter()
        cfg_f = get_config(arch)
        if n_layers is not None:
            cfg_f = dataclasses.replace(cfg_f, n_layers=n_layers)
        what = ("whole" if n_layers is None else f"depth cut to {n_layers} layers")
        train_run(cfg_f, AdamWConfig(lr=TRAIN_LR, use_8bit=use_8bit), device, smi_line,
                  f"full width, {what}, {'8-bit' if use_8bit else 'float32'} moments",
                  profiled=False)
        torch.cuda.empty_cache()
        log(f"[4t]   {arch} took {time.perf_counter() - t0:.1f}s")
    # 7. The enc-dec and VLM archs whole at full width, float32 moments.
    for arch, seq in TRAIN_ENCDEC.items():
        t0 = time.perf_counter()
        train_run(get_config(arch), AdamWConfig(lr=TRAIN_LR), device, smi_line,
                  "full width, whole, float32 moments", profiled=False, seq=seq)
        torch.cuda.empty_cache()
        log(f"[4t]   {arch} took {time.perf_counter() - t0:.1f}s")
    counts = (mttkrp_kernel.launches, mttkrp_fixed_kernel.launches, gram_pinv.launches)
    log(f"[4t] kernel launches (float, fixed, Gram): {counts}")
    if any(counts):
        fail(f"phase 4t: the LM training path launched a kernel of the CP-ALS path: {counts}")


# ---------------------------------------------------------------------------
# Phase 4p: the Gram pseudo-inverse kernel (csrc/gram_pinv.cu).
# ---------------------------------------------------------------------------

def gram_stack(rank: int, n: int, seed: int, rows: int = 200, edit=None) -> np.ndarray:
    """(n, R, R) float32 Hadamard products of two seeded uniform factors'
    Grams, as CP-ALS forms V; `edit(f)` alters every factor."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        v = np.ones((rank, rank), np.float32)
        for _m in range(2):
            f = rng.uniform(0, 1, (rows, rank)).astype(np.float32)
            if edit is not None:
                edit(f)
            v = v * (f.T @ f)
        out.append(v)
    return np.stack(out)


def mode_grams(factors) -> torch.Tensor:
    """(N, R, R): each mode update's V from the given factors, on their device."""
    grams = [f.T @ f for f in factors]
    out = []
    for mode in range(len(factors)):
        v = torch.ones_like(grams[0])
        for k, g in enumerate(grams):
            if k != mode:
                v = v * g
        out.append(v)
    return torch.stack(out)


def kept_kappa(v: np.ndarray) -> np.ndarray:
    """Per matrix: λ_max / λ_min over the directions jnp's cutoff keeps."""
    lam = np.abs(np.linalg.eigvalsh(v.astype(np.float64)))
    top = lam.max(axis=-1, keepdims=True)
    kept = np.where(lam > kref.gram_pinv_rtol(v.shape[-1]) * top, lam, np.inf)
    return top[..., 0] / kept.min(axis=-1)


def pinv_ops(n: int, r: int) -> int:
    """Float64 operations of the function on n R×R matrices, whatever
    design computes it: a symmetric eigendecomposition with its vectors
    (9·R³, the symmetric QR algorithm's count, Golub & Van Loan §8.3), the
    vectors scaled by 1/λ (R²) and the symmetric product W·diag(1/λ)·Wᵀ
    (2·R per entry of its upper triangle: R²·(R + 1))."""
    return n * (9 * r ** 3 + r * r + r * r * (r + 1))


def pinv_bound(v: np.ndarray) -> tuple[float, str]:
    """Least time for one launch on the stack `v`: each matrix read once
    and written once (2·R²·4 B) over the memory rate, or `pinv_ops` over
    the float64 rate, whichever is larger."""
    r = v.shape[-1]
    return bound(2 * v.shape[0] * r * r * 4, pinv_ops(v.shape[0], r), F64_FLOPS)


def warp_work(v: np.ndarray) -> str:
    """What the warp tier's one-sided Jacobi does on `v`, from its host
    replay (a diagnostic beside the bound, which does not use it): rounds,
    pair checks and rotations, and its float64 operations (6·R per check,
    12·R per rotation, 2·R² for the eigenvalues, 3·R per entry of the
    result's upper triangle) against the function's `pinv_ops`."""
    n, r = v.shape[0], v.shape[-1]
    rp = gram_pinv.jacobi_replay(v)
    ops = int(6 * r * rp.checks.sum() + 12 * r * rp.rotations.sum()
              + n * (2 * r * r + 3 * r * r * (r + 1) // 2))
    return (f"warp tier's own work (host replay): {int(rp.rounds.sum())} rounds, "
            f"{int(rp.checks.sum())} pair checks, {int(rp.rotations.sum())} rotations, "
            f"{ops} float64 operations = {ops / pinv_ops(n, r):.2f}× the function's "
            f"{pinv_ops(n, r)}")


def pinv_plan(rank: int, tier: str | None = None) -> gram_pinv.PinvLaunch:
    return gram_pinv.plan_pinv(rank, tiles.device_budget(torch.device("cuda", 0)), tier)


def hold_pinv(label: str, v: torch.Tensor, tier: str | None = None) -> float:
    """gram_pinv on `v` (through `tier`, the plan's otherwise) against the
    plain version, per matrix at max(PINV_ATOL, κ·PINV_KAPPA) of its
    largest entry, and bitwise symmetric; on the warp tier, also bit for
    bit against its host replay.  Returns the largest absolute difference."""
    plan = pinv_plan(v.shape[-1], tier)
    got = gram_pinv.gram_pinv(v, launch=plan)
    want = kref.gram_pinv_ref(v)
    torch.cuda.synchronize()
    g, w = got.double().cpu().numpy(), want.double().cpu().numpy()
    kappa = kept_kappa(v.cpu().numpy())
    tol = np.maximum(PINV_ATOL, kappa * PINV_KAPPA)
    rel = np.abs(g - w).max(axis=(-2, -1)) / np.abs(w).max(axis=(-2, -1))
    worst = float(np.abs(g - w).max())
    symmetric = bool(torch.equal(got, got.mT))
    replay = ""
    if plan.tier == "warp":
        sample = v[:64].cpu().numpy()
        replayed = np.array_equal(gram_pinv.jacobi_replay(sample).out.view(np.int32),
                                  got[:64].cpu().numpy().view(np.int32))
        replay = f"; bit-equal to its host replay on {len(sample)}: {replayed}"
        if not replayed:
            fail(f"phase 4p: the warp tier left its host replay on {label}")
    log(f"[4p]   {label}: {tuple(v.shape)}, {plan}; "
        f"max |kernel - plain| {worst:.3e}, max relative {rel.max():.3e} (tolerance "
        f"{tol.min():.3e}..{tol.max():.3e}, κ up to {kappa.max():.1f}); symmetric {symmetric}"
        f"{replay}")
    if not (rel <= tol).all() or not symmetric:
        fail(f"phase 4p: the Gram pseudo-inverse kernel ({plan.tier}) left its plain version "
             f"on {label}")
    return worst


#: Member 1 of a (3, R, R) stack of Grams, entries set symmetrically, and
#: what `jnp.linalg.pinv` answers for it: NaN for a NaN anywhere or a ±Inf
#: off the diagonal, zeros for ±Inf only on the diagonal.
NONFINITE_MEMBERS = {
    "a NaN off the diagonal": ([(3, 4, math.nan)], "NaN"),
    "+Inf off the diagonal": ([(3, 4, math.inf)], "NaN"),
    "+Inf on the diagonal": ([(2, 2, math.inf)], "zeros"),
}


def hold_nonfinite(device) -> None:
    """Each of NONFINITE_MEMBERS through every tier against the plain
    version: the same NaN entries, the bad member all NaN or all zeros, the
    others within hold_pinv's tolerance; the warp tier bit for bit its host
    replay, NaN bits included."""
    for label, (entries, expect) in NONFINITE_MEMBERS.items():
        v = gram_stack(RANK, 3, 9)
        for i, j, x in entries:
            v[1, i, j] = v[1, j, i] = x
        vt = torch.from_numpy(v).to(device)
        want = kref.gram_pinv_ref(vt)
        for tier in ("warp", "shared", "global"):
            got = gram_pinv.gram_pinv(vt, launch=pinv_plan(RANK, tier))
            bad = got[1]
            ok = (torch.equal(got.isnan(), want.isnan())
                  and bool(bad.isnan().all() if expect == "NaN" else (bad == 0).all()))
            g, w = got[[0, 2]].double().cpu().numpy(), want[[0, 2]].double().cpu().numpy()
            rel = np.abs(g - w).max(axis=(-2, -1)) / np.abs(w).max(axis=(-2, -1))
            ok &= bool((rel <= np.maximum(PINV_ATOL, kept_kappa(v[[0, 2]]) * PINV_KAPPA)).all())
            replayed = tier != "warp" or np.array_equal(
                gram_pinv.jacobi_replay(v).out.view(np.int32), got.cpu().numpy().view(np.int32))
            log(f"[4p]   {label} in member 1 of (3, {RANK}, {RANK}), {tier} tier: member 1 "
                f"{expect} {ok}, the others' max relative gap {rel.max():.3e}"
                f"{'; bit-equal to its host replay' if tier == 'warp' else ''}: {replayed}")
            if not (ok and replayed):
                fail(f"phase 4p: the {tier} tier left the plain version on {label}")


def _zero_column(f):
    f[:, 3] = 0.0


def _equal_columns(f):
    f[:, 6] = f[:, 5]


def host_us(fn, reps: int = 50) -> float:
    """Host microseconds per enqueue: `reps` calls after a warm-up, without
    a synchronisation inside the clock."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return us


def pinv_checks(st, engine, kernel_run, device) -> dict:
    """Phase 4p.  Returns the kernels line's numbers for the Gram kernel
    (the warp tier, this design): ms/plain_ms/library_ms/bound_ms summed
    over (a)'s three mode updates."""
    grams = mode_grams(kernel_run.factors).contiguous()
    worst = hold_pinv("(a) the Grams of phase 4's factors, R = 10", grams)
    hold_pinv("(a) the Grams of phase 4's factors, R = 10", grams, "shared")
    stacks = [("a zero factor column", gram_stack(RANK, 4, 1, edit=_zero_column)),
              ("two equal factor columns", gram_stack(RANK, 4, 2, edit=_equal_columns)),
              ("B = 4096, R = 5", gram_stack(5, 4096, 4, rows=50))]
    for label, v in stacks:
        for tier in ("warp", "shared"):
            hold_pinv(label, torch.from_numpy(v).to(device), tier)
    hold_pinv("R = 160", torch.from_numpy(gram_stack(160, 2, 3, rows=400)).to(device))
    zero = torch.zeros(3, RANK, RANK, device=device)
    for tier in ("warp", "shared"):
        if not bool((gram_pinv.gram_pinv(zero, launch=pinv_plan(RANK, tier)) == 0).all()):
            fail(f"phase 4p: the {tier} tier's pseudo-inverse of a zero matrix is not zero")
    log("[4p]   the all-zero matrix: both tiers give zeros")
    hold_nonfinite(device)
    # (a)'s three V, one launch each as cp_als makes them, in turns: plain,
    # library, this design, the first design (block tier), then back.
    rtol = kref.gram_pinv_rtol(RANK)
    warp, block = pinv_plan(RANK), pinv_plan(RANK, "shared")
    row = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bound_by=set())
    for mode in range(st.ndim):
        v = grams[mode].contiguous()
        p1, l1, k1, e1, e2, k2, l2, p2 = (
            time_ms(lambda v=v: kref.gram_pinv_ref(v), 50),
            time_ms(lambda v=v: torch.linalg.pinv(v, rtol=rtol, hermitian=True), 50),
            time_ms(lambda v=v: gram_pinv.gram_pinv(v, launch=warp), 50),
            time_ms(lambda v=v: gram_pinv.gram_pinv(v, launch=block), 50),
            time_ms(lambda v=v: gram_pinv.gram_pinv(v, launch=block), 50),
            time_ms(lambda v=v: gram_pinv.gram_pinv(v, launch=warp), 50),
            time_ms(lambda v=v: torch.linalg.pinv(v, rtol=rtol, hermitian=True), 50),
            time_ms(lambda v=v: kref.gram_pinv_ref(v), 50))
        hw, hb = (host_us(lambda v=v: gram_pinv.gram_pinv(v, launch=warp)),
                  host_us(lambda v=v: gram_pinv.gram_pinv(v, launch=block)))
        b_ms, b_by = pinv_bound(v[None].cpu().numpy())
        log(f"[4p]   mode {mode} V (1, {RANK}, {RANK}): warp tier {k1:.4f}/{k2:.4f} ms, block "
            f"tier (first design) {e1:.4f}/{e2:.4f} ms, plain (SVD) {p1:.4f}/{p2:.4f} ms, "
            f"torch.linalg.pinv(hermitian=True) {l1:.4f}/{l2:.4f} ms, bound {b_ms:.3e} ms "
            f"({b_by}); host {hw:.1f} µs per warp-tier call, {hb:.1f} µs per block-tier call; "
            f"{warp_work(v[None].cpu().numpy())}")
        row["ms"] += (k1 + k2) / 2
        row["plain_ms"] += (p1 + p2) / 2
        row["library_ms"] += (l1 + l2) / 2
        row["bound_ms"] += b_ms
        row["bound_by"].add(b_by)
    # The serving path's stacks: a bucket of 8 and 4096 at R = 5, in turns.
    for n in (8, 4096):
        big = torch.from_numpy(gram_stack(5, n, 4, rows=50)).to(device)
        warp5, block5 = pinv_plan(5), pinv_plan(5, "shared")
        k1, e1, e2, k2 = (time_ms(lambda: gram_pinv.gram_pinv(big, launch=warp5), 20),
                          time_ms(lambda: gram_pinv.gram_pinv(big, launch=block5), 20),
                          time_ms(lambda: gram_pinv.gram_pinv(big, launch=block5), 20),
                          time_ms(lambda: gram_pinv.gram_pinv(big, launch=warp5), 20))
        b_ms, b_by = pinv_bound(big.cpu().numpy())
        log(f"[4p]   B = {n}, R = 5 (the serving path's stacks): warp tier {k1:.4f}/{k2:.4f} ms, "
            f"block tier {e1:.4f}/{e2:.4f} ms, plain "
            f"{time_ms(lambda: kref.gram_pinv_ref(big), 5):.4f} ms per call, bound {b_ms:.3e} "
            f"ms ({b_by}); host {host_us(lambda: gram_pinv.gram_pinv(big, launch=warp5)):.1f} "
            f"µs per warp-tier call; {warp_work(big.cpu().numpy())}")
    # cp_als through the first design and through the plain pseudo-inverse,
    # on phase 4's engine, and phase 4's run through the warp tier, held to
    # each other.
    kernel_pinv = port_cpals._pinv
    runs = {"warp tier": kernel_run}
    for name, fn in [("block tier", lambda v: gram_pinv.gram_pinv(v, launch=block)),
                     ("plain pinv", kref.gram_pinv_ref)]:
        port_cpals._pinv = fn
        try:
            runs[name] = rt.cp_als(st, RANK, n_iters=N_ITERS, engine=engine, seed=0)
        finally:
            port_cpals._pinv = kernel_pinv
    kappa = solve_kappa([f.cpu() for f in runs["plain pinv"].factors])
    tol = max(PINV_ATOL, PINV_KAPPA * kappa)
    names = list(runs)
    for i, name_a in enumerate(names):
        for name_b in names[i + 1:]:
            a, b = runs[name_a], runs[name_b]
            fit = max(abs(x - y) for x, y in zip(a.fit_history, b.fit_history, strict=True))
            factor = max(float((x - y).abs().max() / y.abs().max())
                         for x, y in zip(a.factors, b.factors, strict=True))
            lam = float((a.lam - b.lam).abs().max() / b.lam.abs().max())
            log(f"[4p]   cp_als at (a), {name_a} against {name_b}: max |Δ fit|={fit:.3e} "
                f"(tolerance {PINV_FIT_ATOL}; fits {min(b.fit_history):.3e}.."
                f"{max(b.fit_history):.3e}), max |Δ factor| / max |factor|={factor:.3e}, "
                f"max |Δλ| / max |λ|={lam:.3e} (tolerance {tol:.3e}, κ={kappa:.1f})")
            if fit > PINV_FIT_ATOL or factor > tol or lam > tol:
                fail(f"phase 4p: cp_als through the {name_a} left the run through the {name_b}")
    log("[4p]   steady cp_als iteration at (a): "
        + ", ".join(f"{steady(r.iter_times):.3f} ms through the {n}" for n, r in runs.items()))
    row["bound_by"] = "bytes" if row["bound_by"] == {"bytes"} else "operations"
    return dict(row, max_abs_err=worst)


def static_analysis() -> AnalysisResult:
    """Phase 0a: the port's analysis suite over this checkout, strict."""
    t0 = time.perf_counter()
    result = run_analysis(ROOT, strict=True)
    seconds = time.perf_counter() - t0
    active = Counter(f.rule for f in result.findings)
    waived = Counter(f.rule for f in result.suppressed)
    for rule in result.rules:
        log(f"[0a]   {rule}: {active[rule]} finding(s), {waived[rule]} suppressed")
    log(f"[0a] repro_torch.analysis --strict: {len(result.findings)} finding(s), "
        f"{len(result.suppressed)} suppressed, over {result.n_files} files and "
        f"{len(result.rules)} rules in {seconds:.2f}s")
    if not result.ok:
        for f in result.findings:
            log(f"[0a]   {f.render()}")
        fail("phase 0a: the port's static analysis reports unsuppressed findings")
    return result


class _IterationMarks:
    """An engine that records, at each mode-0 call (the start of a CP-ALS
    iteration), how many warnings `rec` holds; everything else is the
    wrapped engine's."""

    def __init__(self, engine, rec: list):
        self._engine, self._rec, self.marks = engine, rec, []

    def __call__(self, factors, mode):
        if mode == 0:
            self.marks.append(len(self._rec))
        return self._engine(factors, mode)

    def __getattr__(self, name):
        return getattr(self._engine, name)


SYNC_ITERS = 2
SYNC_WARNING = "synchronizing CUDA operation"   # torch's sync-debug warning text
SYNC_PER_ITER = 2                               # the fit and diff readouts


#: Kinds of call the host-sync rule's catalogue rests on, each run on the
#: card under warn mode beside the rule's verdict on the same line.
SYNC_PROBES = (
    "torch.from_numpy(host).to(device)",
    "torch.from_numpy(host).pin_memory().to(device, non_blocking=True)",
    "torch.tensor([1, 2], device=device)",
    "float(x.sum())",
    "x.sum().item()",
    "x.cpu()",
    "bool((x > 0).any())",
    "x[x > 0]",
    "torch.nonzero(x > 0)",
    "torch.linalg.pinv(v)",
    "torch.linalg.eigh(v)",
    "torch.cuda.synchronize(device)",
    "torch.linalg.solve_ex(v, x.T)",
    "torch.where(x == 0, 1.0, x)",
    "torch.zeros_like(x).index_add_(0, rows, x)",
)
_PROBE_SOURCE = """import torch


def probe(x: torch.Tensor, v: torch.Tensor, rows: torch.Tensor, host, device):
    return {}
"""


def sync_probe(expr: str, device) -> tuple[bool, list]:
    """(whether the host-sync rule reports `expr`, torch's sync warnings
    when it runs on `device`)."""
    source = _PROBE_SOURCE.format(expr)
    reported = bool(check_source("host-sync", source))
    namespace: dict = {}
    exec(compile(source, "<sync probe>", "exec"), namespace)
    x = torch.arange(640, dtype=torch.float32, device=device).reshape(64, 10).sin()
    args = (x, x.T @ x, torch.arange(64, device=device),
            np.random.default_rng(0).random((1000, 10), dtype=np.float32), device)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            namespace["probe"](*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return reported, [w for w in caught if SYNC_WARNING in str(w.message)]


def sync_sites(st, engine, analysis: AnalysisResult, device) -> tuple[int, int]:
    """Phase 4y: torch's own log of the synchronising calls in SYNC_ITERS
    cp_als iterations of `engine`, held against the `host-sync` rule, and
    SYNC_PER_ITER per iteration, none in the pseudo-inverse.  Returns the
    float kernel's and the Gram kernel's launches."""
    # torch's verdict on each kind of call beside the rule's: a call the
    # rule lets pass must not synchronise (that would be a gap in the rule).
    for expr in SYNC_PROBES:
        reported, probe = sync_probe(expr, device)
        where = sorted({f"{Path(w.filename).name}:{w.lineno}" for w in probe})
        log(f"[4y] probe `{expr}`: host-sync {'reports it' if reported else 'lets it pass'}; "
            f"torch: {len(probe)} sync warning(s) {where}")
        if probe and not reported:
            fail(f"phase 4y: `{expr}` synchronises on this card but the host-sync rule "
                 "lets it pass")
    mttkrp_kernel.launches = 0
    mttkrp_fixed_kernel.launches = 0
    gram_pinv.launches = 0
    sum_squares.launches = 0
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        marked = _IterationMarks(engine, rec)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = rt.cp_als(st, RANK, n_iters=SYNC_ITERS, engine=marked, seed=0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    launches, pinv_launches = mttkrp_kernel.launches, gram_pinv.launches
    if (launches != SYNC_ITERS * st.ndim or mttkrp_fixed_kernel.launches
            or pinv_launches != SYNC_ITERS * st.ndim):
        fail(f"phase 4y: the float kernel launched {launches} times, the Gram kernel "
             f"{pinv_launches} (expected {SYNC_ITERS * st.ndim} each), the fixed one "
             f"{mttkrp_fixed_kernel.launches}")
    if len(marked.marks) != SYNC_ITERS or not all(math.isfinite(f) for f in res.fit_history):
        fail(f"phase 4y: {len(marked.marks)} iterations marked, fit {res.fit_history}")
    if sum_squares.launches != 1:
        fail(f"phase 4y: the sum-of-squares kernel launched {sum_squares.launches} times, "
             "expected 1")
    # A warning recorded before the k-th mark belongs to iteration k - 1
    # (0: the set-up before the first iteration).
    syncs = [(bisect.bisect_right(marked.marks, i), w) for i, w in enumerate(rec)
             if SYNC_WARNING in str(w.message)]
    reported = {(f.path, f.line): f.reason for f in analysis.suppressed if f.rule == "host-sync"}
    port = ROOT / "src" / "repro_torch"
    pinv_lines, pinv_start = inspect.getsourcelines(port_cpals._pinv)
    in_pinv = {(Path(inspect.getsourcefile(port_cpals)).resolve(), line)
               for line in range(pinv_start, pinv_start + len(pinv_lines))}
    pinv_module = Path(inspect.getsourcefile(gram_pinv)).resolve()
    gaps, pinv_syncs = [], []
    for k, label in enumerate(["set-up", *[f"iteration {i}" for i in range(SYNC_ITERS)]]):
        part = Counter((w.filename, w.lineno) for seg, w in syncs if seg == k)
        log(f"[4y] {label}: {sum(part.values())} synchronising call(s)"
            + (f" (expected {SYNC_PER_ITER})" if k else ""))
        if k and sum(part.values()) != SYNC_PER_ITER:
            gaps.append(f"{label}: {sum(part.values())} waits, expected {SYNC_PER_ITER}")
        pinv_syncs += [f"{Path(fn).name}:{ln}" for fn, ln in part
                       if (Path(fn).resolve(), ln) in in_pinv or Path(fn).resolve() == pinv_module]
        for (filename, line), n in sorted(part.items()):
            path = Path(filename).resolve()
            if path.is_relative_to(port):
                rel = path.relative_to(ROOT).as_posix()
                why = reported.get((rel, line))
                log(f"[4y]   {rel}:{line} x{n}: "
                    + (f"host-sync reports it ({why})" if why else "NOT REPORTED by host-sync"))
                if why is None:
                    gaps.append(f"{rel}:{line}")
            else:
                log(f"[4y]   {filename}:{line} x{n}: outside the port, not judged")
    others = Counter(f"{w.category.__name__} at {w.filename}:{w.lineno}: {str(w.message)[:120]}"
                     for w in rec if SYNC_WARNING not in str(w.message))
    for other, n in sorted(others.items()):
        log(f"[4y]   other warning x{n}: {other}")
    log(f"[4y] {len(syncs)} synchronising call(s) in {SYNC_ITERS} iterations, "
        f"{sum(others.values())} other warning(s); fit {res.fit_history}")
    if pinv_syncs:
        fail(f"phase 4y: the pseudo-inverse waited on the host at {sorted(set(pinv_syncs))}")
    if gaps:
        fail(f"phase 4y: synchronising sites the host-sync rule misses, or a wrong count: "
             f"{sorted(set(gaps))}")
    return launches, pinv_launches


def norm_checks(st, device) -> dict:
    """Phase 4n: the sum-of-squares kernel on `st`'s values against its plain
    version and numpy's float64 dot, then timed in turns.  Returns the
    kernels line's numbers (ms/plain_ms/library_ms/bound_ms, the relative
    gap to numpy)."""
    values = torch.from_numpy(st.values).to(device)
    x64 = st.values.astype(np.float64)
    want = float(np.dot(x64, x64))
    tol = 2 * st.nnz * 2.0 ** -53
    got, again = sum_squares.sum_squares(values), sum_squares.sum_squares(values)
    plain = kref.sum_squares_ref(values)
    gaps = {name: abs(float(t) - want) / want for name, t in (("kernel", got), ("plain", plain))}
    log(f"[4n]   {st.nnz} values: kernel {float(got)!r}, plain {float(plain)!r}, numpy {want!r}; "
        f"relative gaps to numpy {gaps} (tolerance {tol:.3e})")
    if not torch.equal(got, again):
        fail("phase 4n: two launches of the sum-of-squares kernel gave different bits")
    if max(gaps.values()) > tol:
        fail(f"phase 4n: the sum of squares left numpy's float64 dot: {gaps}")
    def library():  # one PyTorch call; it widens the whole tensor to float64 first
        return torch.linalg.vector_norm(values, dtype=torch.float64) ** 2

    p1, l1, k1, k2, l2, p2 = (time_ms(lambda: kref.sum_squares_ref(values), 20),
                              time_ms(library, 20),
                              time_ms(lambda: sum_squares.sum_squares(values), 20),
                              time_ms(lambda: sum_squares.sum_squares(values), 20),
                              time_ms(library, 20),
                              time_ms(lambda: kref.sum_squares_ref(values), 20))
    bound = 4 * st.nnz / H100_SXM5.hbm_bw * 1e3
    hk, hp = (host_us(lambda: sum_squares.sum_squares(values)),
              host_us(lambda: kref.sum_squares_ref(values)))
    log(f"[4n]   kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, "
        f"torch.linalg.vector_norm(float64)² {l1:.4f}/{l2:.4f} ms, bound {bound:.4f} ms (bytes); "
        f"host {hk:.1f} µs per kernel call, {hp:.1f} µs per plain call")
    return dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, library_ms=(l1 + l2) / 2,
                bound_ms=bound, bound_by="bytes", max_abs_err=gaps["kernel"])


# ---------------------------------------------------------------------------
# 4m. Tensor, expert and FSDP parallelism: two ranks on a (1, 2) mesh
# ---------------------------------------------------------------------------

TP_MESH = (1, 2)
TP_DEPTHS = {"command-r-35b": 4, "qwen3-moe-30b-a3b": 4}   # full width, depth cut
TP_TRAIN = "command-r-35b"          # one train step (8-bit moments) at (TP_BATCH, TP_SEQ)
TP_BATCH, TP_SEQ = 4, 256
TP_LOGIT_REL = 1e-5                 # prefill logits, mesh against one rank, of Σ|terms|
TP_LOSS_REL = 1e-5                  # losses, mesh against one rank, relative
TP_TRAINED_LOSS_REL = 1e-4          # the loss after the 8-bit update, relative
TP_TIMEOUT = 600


def tp_config(arch: str):
    """The arch at full width, depth cut to TP_DEPTHS, float32 compute."""
    return dataclasses.replace(get_config(arch), n_layers=TP_DEPTHS[arch],
                               compute_dtype="float32")


def tp_prompts(cfg, device) -> torch.Tensor:
    return torch.from_numpy(SyntheticTokens(cfg.vocab, LM_PROMPT, LM_BATCH).batch(0)).to(device)


def tp_train_batch(cfg, device) -> dict:
    return {"tokens": torch.from_numpy(SyntheticTokens(cfg.vocab, TP_SEQ, TP_BATCH).batch(0))
            .to(device)}


def tp_serve(lm, params, ctx, prompts) -> dict:
    """Prefill of the prompts and `generate` at serve_lm's sizes on `ctx`,
    with the collectives of one decode step and the MoE drops."""
    moe_mod.drops = 0
    with torch.no_grad():
        logits = train_steps.make_prefill_step(lm, ctx)(params, {"tokens": prompts})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens = generate(lm, params, train_steps.make_ctx(ctx.mesh, seq_sharded=False)
                      if ctx.mesh is not None else ctx, prompts, LM_GEN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {"logits": logits[:, 0].float().cpu(), "tokens": tokens.cpu(), "drops": moe_mod.drops,
           "generate_s": wall, "steps": LM_PROMPT + LM_GEN - 1}
    if ctx.mesh is not None:  # one decode step's collectives
        cache = lm.init_cache(prompts.shape[0], max_len=LM_PROMPT + 8, dtype=torch.float32,
                              device=prompts.device, ctx=ctx)
        with comm_mod.record() as rec, torch.no_grad():
            lm.decode_step(params, train_steps.make_ctx(ctx.mesh, seq_sharded=False),
                           prompts[:, :1], cache, 0)
        out["decode_collectives"] = collective_bytes(rec)
    return out


def tp_train(lm, params, ctx, device) -> dict:
    """Two train steps (8-bit moments) on one batch: the losses."""
    opt_cfg = AdamWConfig(lr=TRAIN_LR, use_8bit=True)
    specs = train_steps.param_specs(lm, ctx)
    opt = (adamw_init(params, opt_cfg) if specs is None
           else adamw_init(params, opt_cfg, specs=specs, mesh=ctx.mesh))
    step = make_train_step(lm, ctx, opt_cfg)
    batch = tp_train_batch(lm.cfg, device)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
    return {"losses": losses, "train_s": time.perf_counter() - t0}


def tp_worker(rank: int, world: int, init: str, out_dir: str) -> None:
    """One rank of the (1, 2) gloo mesh on cuda:0; rank 0 then runs the
    one-rank path alone and writes both results."""
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    from repro_torch.launch import make_local_mesh
    mesh = make_local_mesh(*TP_MESH, device=device)
    ctx = train_steps.make_ctx(mesh)
    res = {"backend": dist.get_backend(), "mesh": list(mesh.shape), "arch": {}}
    for arch in TP_DEPTHS:
        cfg = tp_config(arch)
        lm = LM(cfg)
        torch.cuda.reset_peak_memory_stats()
        params, _ = lm.init(torch.Generator(device).manual_seed(0), mesh=mesh)
        held = sum(a.numel() * a.element_size() for a in lm_nn.tree_leaves(params))
        r = tp_serve(lm, params, ctx, tp_prompts(cfg, device))
        r["held_bytes"] = held
        if arch == TP_TRAIN:
            r.update(tp_train(lm, params, ctx, device))
        drops = torch.tensor([r["drops"]])
        dist.all_reduce(drops)
        r["drops"] = int(drops)
        r["peak_bytes"] = torch.cuda.max_memory_allocated()
        res["arch"][arch] = r
        del params
        torch.cuda.empty_cache()
    res["launches"] = (mttkrp_kernel.launches, mttkrp_fixed_kernel.launches, gram_pinv.launches)
    dist.barrier()
    if rank == 0:
        one = {}
        for arch in TP_DEPTHS:
            cfg = tp_config(arch)
            lm = LM(cfg)
            params, _ = lm.init(torch.Generator(device).manual_seed(0))
            routes = []
            route = moe_mod._route

            def record(cfg_, xt, router, route=route):
                gates, eids = route(cfg_, xt, router)
                routes.append(eids.cpu())
                return gates, eids
            moe_mod._route = record
            try:
                with hidden_states(lm) as seen:
                    r = tp_serve(lm, params, MeshCtx(mesh=None), tp_prompts(cfg, device))
                r["terms"] = abs_terms(lm, params, seen[0][:, -1]).cpu()
            finally:
                moe_mod._route = route
            r["replayed_drops"] = tp_replay_drops(cfg, routes)
            if arch == TP_TRAIN:
                r.update(tp_train(lm, params, MeshCtx(mesh=None), device))
            one[arch] = r
            del params
            torch.cuda.empty_cache()
        torch.save({"mesh": res, "one": one}, out_dir + "/tp.pt")
    dist.barrier()
    dist.destroy_process_group()


def tp_replay_drops(cfg, routes) -> int:
    """The reference's capacity rule replayed in one process over the
    routing of every MoE call: each of the TP_MESH model ranks keeps
    cap = min(T·k, max(round_up(2·T·k·e_loc/E, 128), 128)) of the
    assignments to its experts; the rest drop."""
    if not cfg.n_experts:
        return 0
    tp = TP_MESH[1]
    e_loc = cfg.n_experts // tp
    dropped = 0
    for eids in routes:
        cap = min(eids.numel(), max(-(-int(eids.numel() * e_loc / cfg.n_experts * 2.0)
                                      // 128) * 128, 128))
        for r in range(tp):
            local = int(((eids >= r * e_loc) & (eids < (r + 1) * e_loc)).sum())
            dropped += max(0, local - cap)
    return dropped


def dryrun_sweep(out: Path) -> subprocess.Popen:
    """`python -m repro_torch.launch.dryrun --all` on the (16, 16) mesh, in
    the background: meta tensors on the host."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
                             "--out", str(out)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def tp_checks(smi_line: str) -> None:
    """Phase 4m: two gloo ranks both on cuda:0 (NCCL refuses two ranks on
    one device) serve command-r-35b and qwen3-moe-30b-a3b at full width on
    a (1, 2) mesh and train command-r-35b one step, held to the one-rank
    path on the same card; the dry run over every arch × shape meanwhile."""
    log(f"[4m] this process holds {torch.cuda.memory_allocated() / 2**30:.3f} GiB on the card")
    sweep_out = ROOT / "results" / "dryrun_torch"
    sweep = dryrun_sweep(sweep_out)
    tmp = tempfile.mkdtemp(prefix="tp_")
    world = TP_MESH[0] * TP_MESH[1]
    # two processes share the card: keep their caching allocators from fragmenting it
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=tp_worker, args=(r, world, f"file://{tmp}/init", tmp))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(TP_TIMEOUT)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    if hung or any(p.exitcode != 0 for p in procs):
        sweep.kill()
        sweep.communicate()
        fail(f"[4m] a rank of the (1, 2) mesh failed or hung: exit codes "
             f"{[p.exitcode for p in procs]}")
    got = torch.load(f"{tmp}/tp.pt")
    shutil.rmtree(tmp, ignore_errors=True)
    mesh, one = got["mesh"], got["one"]
    log(f"[4m] multi-rank part ran: {world} ranks, backend {mesh['backend']}, both on cuda:0, "
        f"mesh {dict(zip(('data', 'model'), mesh['mesh']))}; {time.perf_counter() - t0:.1f}s "
        f"with the one-rank path; on {smi_line}")
    if mesh["launches"] != (0, 0, 0):
        fail(f"[4m] the mesh path launched MTTKRP/Gram kernels: {mesh['launches']}")
    ok = True
    for arch, m in mesh["arch"].items():
        o = one[arch]
        err = (m["logits"] - o["logits"]).abs()
        rel = float((err / o["terms"]).max())
        same = bool(torch.equal(m["tokens"], o["tokens"]))
        d = m["decode_collectives"]
        log(f"[4m] {arch} full width at {TP_DEPTHS[arch]} layers, float32: prefill logits max "
            f"|Δ| {float(err.max()):.3e}, {rel:.3e} of Σ|terms| (tolerance {TP_LOGIT_REL}); "
            f"generate's tokens equal {same}; per rank {m['held_bytes'] / 2**30:.3f} GiB of "
            f"params, peak {m['peak_bytes'] / 2**30:.3f} GiB; one decode step: "
            f"{d['count']} collectives, {d['total_wire_bytes'] / 2**20:.3f} MiB on the wire a "
            f"rank; generate {m['generate_s'] * 1e3 / m['steps']:.3f} ms a step on the mesh, "
            f"{o['generate_s'] * 1e3 / o['steps']:.3f} on one rank")
        ok &= rel <= TP_LOGIT_REL and same
        if tp_config(arch).n_experts:
            log(f"[4m]   {arch}: dropped assignments on the mesh {m['drops']}, the capacity "
                f"rule replayed over the one-rank run's routing {o['replayed_drops']}; on "
                f"{TP_MESH[1]} model ranks cap ≥ T·k, so none can drop")
            ok &= m["drops"] == o["replayed_drops"]
        if "losses" in m:
            l0 = abs(m["losses"][0] - o["losses"][0]) / abs(o["losses"][0])
            l1 = abs(m["losses"][1] - o["losses"][1]) / abs(o["losses"][1])
            log(f"[4m] {arch} train, 8-bit moments, batch ({TP_BATCH}, {TP_SEQ}): losses mesh "
                f"{m['losses']} one rank {o['losses']} (relative {l0:.2e} ≤ {TP_LOSS_REL}, after "
                f"the update {l1:.2e} ≤ {TP_TRAINED_LOSS_REL}); two steps {m['train_s']:.2f}s on "
                f"the mesh, {o['train_s']:.2f}s on one rank")
            ok &= l0 <= TP_LOSS_REL and l1 <= TP_TRAINED_LOSS_REL
    if not ok:
        fail("[4m] the (1, 2) mesh left the one-rank path")
    out, _ = sweep.communicate(timeout=TP_TIMEOUT)
    lines = [ln for ln in out.splitlines() if ln.startswith("[dryrun]")]
    n_ok = sum(": ok " in ln for ln in lines)
    n_skip = sum(": SKIP" in ln for ln in lines)
    log(f"[4m] dry run, every arch × shape on the (16, 16) mesh on meta tensors: {n_ok} costed, "
        f"{n_skip} skipped, exit {sweep.returncode}; records in {sweep_out.relative_to(ROOT)}")
    for ln in lines:
        if "command_r_35b" in ln or "FAIL" in ln:
            log(f"[4m]   {ln}")
    if sweep.returncode != 0 or n_ok + n_skip != len(lines) or not lines:
        fail("[4m] the dry run failed")


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

    # 0a. The port's static analysis over this checkout (host work).
    analysis = static_analysis()

    # 2. Build the kernels, one nvcc each, in parallel.
    t0 = time.perf_counter()
    sources = ["mttkrp", "mttkrp_fixed", "gram_pinv", "sum_squares"]
    _build.build(sources)
    log(f"[2] built csrc/{{{', '.join(sources)}}}.cu in {time.perf_counter() - t0:.1f}s")
    for name in sources:
        summary = ptxas_summary(_build.build_log(name))
        for line in summary:
            log(f"[2]   {name}: {line}")
        if name == "gram_pinv":
            check_warp_spills(summary)

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
    gram_pinv.launches = 0
    sum_squares.launches = 0
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    engine = rt.build_engine(st_a, "kernel", RANK, chunk_shape=plan_a.chunk_shape,
                             capacity=plan_a.capacity)
    res = rt.cp_als(st_a, RANK, n_iters=N_ITERS, engine=engine, seed=0)
    t_main = time.perf_counter() - t0
    launches = mttkrp_kernel.launches
    fixed_in_float = mttkrp_fixed_kernel.launches
    pinv_launches = gram_pinv.launches
    norm_launches = sum_squares.launches
    peak_bytes = torch.cuda.max_memory_allocated()
    float_iter_times = res.iter_times
    log(f"[4] cp_als engine={res.engine} in {t_main:.1f}s, kernel launches={launches}, "
        f"fixed kernel launches={fixed_in_float}, Gram pseudo-inverse kernel launches="
        f"{pinv_launches}, sum-of-squares kernel launches={norm_launches}")
    log(f"[4]   fit_history={res.fit_history}")
    log(f"[4]   diff_history={res.diff_history}")
    log(f"[4]   iter_times={res.iter_times}")
    log(f"[4]   device memory: resident before {base_bytes / 2**30:.3f} GiB, "
        f"peak {peak_bytes / 2**30:.3f} GiB")
    log(f"[4]   the pseudo-inverse's plan at R = {RANK}: {pinv_plan(RANK)}")
    if pinv_plan(RANK).tier != "warp":
        fail(f"the pseudo-inverse at R = {RANK} does not take the warp tier")
    if launches != N_ITERS * st_a.ndim or fixed_in_float != 0 \
            or pinv_launches != N_ITERS * st_a.ndim:
        fail(f"kernel launched {launches} times in the main path and the Gram kernel "
             f"{pinv_launches}, expected {N_ITERS * st_a.ndim} each; the fixed kernel "
             f"{fixed_in_float} times, expected 0")
    if norm_launches != 1:
        fail(f"the sum-of-squares kernel launched {norm_launches} times, expected 1 a call")
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

    # 4p. The Gram pseudo-inverse kernel against its plain version.
    t0 = time.perf_counter()
    pinv_row = pinv_checks(st_a, engine, kernel_run, device)
    log(f"[4p] phase took {time.perf_counter() - t0:.1f}s on {smi.splitlines()[0]}")

    # 4y. torch's sync log over phase 4's engine, against the host-sync rule.
    t0 = time.perf_counter()
    sync_launches, sync_pinv_launches = sync_sites(st_a, engine, analysis, device)
    log(f"[4y] phase took {time.perf_counter() - t0:.1f}s")

    # 4n. The sum-of-squares kernel against its plain version.
    t0 = time.perf_counter()
    norm_row = norm_checks(st_a, device)
    log(f"[4n] phase took {time.perf_counter() - t0:.1f}s")

    # 4d. The distributed engine at (a) on a one-rank NCCL mesh.
    t0 = time.perf_counter()
    dist_launches = distributed_checks(st_a, plan_a, kernel_run, device)
    log(f"[4d] phase took {time.perf_counter() - t0:.1f}s")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # 4e. The example CLIs on the card (their launches stay off the kernels line).
    t0 = time.perf_counter()
    ex_launches = examples_checks(device)
    log(f"[4e] phase took {time.perf_counter() - t0:.1f}s; kernel launches {ex_launches} "
        f"(autotune probes included; not on the kernels line)")

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

    # 5. Timing at case (a)'s shapes: plain, global tier (no nnz_per_task),
    # kernel as the engine launches it (into the (I_pad, R) output), in turns.
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
        out = torch.zeros((out_rows(st_a, ct_a, mode), RANK), device=device)
        times = in_turns(
            lambda mode=mode: kref.mttkrp_local_ref(factors, tc, cr, vals, mode=mode,
                                                    chunk_shape=cs),
            lambda mode=mode, out=out: rt.mttkrp_local(factors, tc, cr, vals, mode=mode,
                                                       chunk_shape=cs, nnz_per_task=nnz, out=out),
            lambda mode=mode, g_plan=g_plan, out=out: rt.mttkrp_local(
                factors, tc, cr, vals, mode=mode, chunk_shape=cs, plan=g_plan, out=out))
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
        qout = torch.zeros((out_rows(st_a, ct_a, mode), RANK), dtype=torch.int32, device=device)
        times = in_turns(
            lambda mode=mode: kref.mttkrp_fixed_local_ref(qpadded, tc, cr, qvalues, mode=mode,
                                                          chunk_shape=cs, **q),
            lambda mode=mode, qout=qout: rt.mttkrp_fixed_local(
                qpadded, tc, cr, qvalues, mode=mode, chunk_shape=cs, nnz_per_task=nnz, out=qout,
                **q),
            lambda mode=mode, g_plan=g_plan, qout=qout: rt.mttkrp_fixed_local(
                qpadded, tc, cr, qvalues, mode=mode, chunk_shape=cs, plan=g_plan, out=qout, **q))
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
             f"tier in every mode")
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

    # 4r. The paper's benchmark harness on the card.
    bench_checks(st_a, plan_a, formats_a, device)

    # 4s and 4b. The serving path: it launches neither MTTKRP kernel; its
    # batched pseudo-inverses go through the Gram kernel.
    mttkrp_kernel.launches = 0
    mttkrp_fixed_kernel.launches = 0
    gram_pinv.launches = 0
    t0 = time.perf_counter()
    serve_checks(device)
    log(f"[4s] phase took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    batched_scale(device)
    log(f"[4b] phase took {time.perf_counter() - t0:.1f}s")
    log(f"[4s] the serving path launched the Gram pseudo-inverse kernel "
        f"{gram_pinv.launches} times")
    if mttkrp_kernel.launches or mttkrp_fixed_kernel.launches or not gram_pinv.launches:
        fail(f"the serving path launched the float kernel {mttkrp_kernel.launches} times, "
             f"the fixed one {mttkrp_fixed_kernel.launches} times (expected 0) and the Gram "
             f"kernel {gram_pinv.launches} times (expected some)")

    # 4l. The LM serving path: every family at full width.
    t0 = time.perf_counter()
    lm_checks(device, smi.splitlines()[0])
    log(f"[4l] phase took {time.perf_counter() - t0:.1f}s on {smi.splitlines()[0]}")

    # 4t. The LM training path: every family trained at full width.
    t0 = time.perf_counter()
    train_checks(device, smi.splitlines()[0])
    log(f"[4t] phase took {time.perf_counter() - t0:.1f}s on {smi.splitlines()[0]}")

    # 4m. Tensor parallelism: two gloo ranks on a (1, 2) mesh, and the dry run.
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tp_checks(smi.splitlines()[0])
    log(f"[4m] phase took {time.perf_counter() - t0:.1f}s on {smi.splitlines()[0]}")
    smi_after = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    log(f"[5] after timing: {smi_after}")
    log("[5] library call: none (no single PyTorch call computes MTTKRP)")
    log(f"[6] total {time.perf_counter() - t_start:.1f}s")

    # 6. Kernels line (ms/plain_ms/bound_ms: the 3 launches of one CP-ALS
    # iteration at case (a)'s shapes, summed over the modes, and the
    # sum-of-squares kernel's one launch a call on (a)'s values; launches: the
    # main paths' runs, the float kernel's through `kernel` (phases 4 and 4y), `distributed`,
    # `hetero` and the tuned `auto` engine, the fixed kernel's over both of
    # its runs, the Gram kernel's and the sum-of-squares kernel's through
    # `kernel` (phases 4 and 4y).  The
    # benchmark harness's launches (4r) stay on their own line: its
    # autotune probes vary from run to run, and these counts do not).
    def entry(kind, rows, n_launches, err):
        return {**KERNELS[kind], "route": "cuda", "launches": n_launches, "max_abs_err": err,
                "ms": sum(r["ms"] for r in rows),
                "plain_ms": sum(r["plain_ms"] for r in rows),
                "bound_ms": sum(r["bound_ms"] for r in rows),
                "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in rows)
                             else "operations"),
                "library_ms": None}
    print(json.dumps({"kernels": [entry("float", modes,
                                        launches + sync_launches + dist_launches
                                        + hetero_launches + auto_launches,
                                        worst),
                                  entry("fixed", fixed_modes,
                                        fixed_launches, float(worst_fixed)),
                                  {**KERNELS["pinv"], "route": "cuda",
                                   "launches": pinv_launches + sync_pinv_launches,
                                   **pinv_row},
                                  {**KERNELS["norm"], "route": "cuda",
                                   "launches": norm_launches + 1, **norm_row}]}), flush=True)
    # 7. Device line, last.
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
