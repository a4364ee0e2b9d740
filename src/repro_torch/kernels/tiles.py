"""Launch plans of the two spMTTKRP kernels, float and fixed point: which
tier a launch takes, how many blocks share a task and how many bytes of
dynamic shared memory it needs; and the one input check and launch both
wrappers make.  Mirrors `csrc/mttkrp_tiles.cuh`, which holds every launch's
plan against its own layout and refuses one that differs.  `plan_launch` is
pure Python, so the CPU tests reach it.

Tiers (see the header's notes):

  staged       a block owns a task, accumulates its (S_mode, R) block in
               shared memory and stages the input modes' (S_m, R) factor
               blocks there, in mode order, as long as the budget lasts;
  accumulator  only the (S_mode, R) block fits: rows come from L2;
  global       not even that fits: one device-memory atomic per run of
               slots on one output row and per r.

Every tier adds its sums straight into the (I_pad, R) output that
`kernels/ops.py` zero-fills, at rows task_chunk[t, mode]·S_mode + [0, S_mode).
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import _build

__all__ = ["SMEM_BUDGET", "TIERS", "LaunchPlan", "plan_launch", "task_smem_bytes"]

#: Dynamic shared memory one block may use on an H100 (227 KB, opt-in).
SMEM_BUDGET = 232_448
#: Tier names; a tier's index is its id in the C interface.
TIERS = ("global", "accumulator", "staged")
RING = 512            # slots per ring stage (kRing)
GLOBAL_TILE = 1024    # slots per block in the global tier (kGlobalTile)
#: Blocks that fill the H100's 132 SMs a few times over: fewer tasks than
#: this are split across blocks.
MIN_BLOCKS = 4 * 132
_MIN_SPAN = 8 * RING  # fewest slots a block of a split task takes
_MODE_INFO_BYTES = 32


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    tier: str
    blocks_per_task: int
    smem_bytes: int
    staged: tuple[int, ...] = ()  # input modes whose factor block is staged

    @property
    def staged_mask(self) -> int:
        return sum(1 << m for m in self.staged)


def _align16(x: int) -> int:
    return (x + 15) & ~15


def task_smem_bytes(chunk_shape, mode: int, rank: int, staged=(), *, factor_bytes: int,
                    value_bytes: int, acc_bytes: int = 4) -> int:
    """Dynamic shared memory of a task-tier block: mode table, two ring
    stages of coordinates and values, the accumulator, the staged blocks."""
    n = len(chunk_shape)
    ring_stage = (_align16(4 * RING * n) + 32) + (_align16(RING * value_bytes) + 32)
    return (_align16(_MODE_INFO_BYTES * n) + 2 * ring_stage
            + _align16(chunk_shape[mode] * rank * acc_bytes)
            + sum(_align16(chunk_shape[m] * rank * factor_bytes) for m in staged))


def plan_launch(num_tasks: int, capacity: int, chunk_shape, mode: int, rank: int, *,
                factor_bytes: int = 4, value_bytes: int = 4, smem_budget: int = SMEM_BUDGET,
                tier: str | None = None) -> LaunchPlan:
    """The launch of one kernel call on (T, P) tasks and slots.

    Without `tier`, the best that fits `smem_budget`: staged if the
    accumulator and at least the first input mode's factor block fit,
    accumulator-only if only the accumulator does, else global.  A named
    `tier` is taken if it fits, else ValueError.  A task tier splits each
    task over `blocks_per_task` blocks when there are fewer than
    MIN_BLOCKS tasks, keeping at least max(4,096, 8·S_mode) slots per block
    so that its flush stays small beside its work.  `smem_budget` is the
    card's (`device_budget`).
    """
    if tier is not None and tier not in TIERS:
        raise ValueError(f"tier must be one of {TIERS}; got {tier!r}")
    n = len(chunk_shape)
    if tier == "global":
        return _global_plan(capacity, n)
    base = task_smem_bytes(chunk_shape, mode, rank, factor_bytes=factor_bytes,
                           value_bytes=value_bytes)
    if base > smem_budget:
        if tier is not None:
            raise ValueError(f"tier {tier!r} needs {base} B of shared memory; the budget is "
                             f"{smem_budget} B")
        return _global_plan(capacity, n)
    staged: list[int] = []
    used = base
    if tier != "accumulator":
        for m in range(min(n, 32)):  # in mode order, while the budget lasts
            if m == mode:
                continue
            block = _align16(chunk_shape[m] * rank * factor_bytes)
            if used + block > smem_budget:
                break
            staged.append(m)
            used += block
    if tier == "staged" and not staged:
        raise ValueError(f"no factor block fits beside the {base} B accumulator tier in "
                         f"{smem_budget} B")
    want = -(-MIN_BLOCKS // max(num_tasks, 1))
    most = max(1, capacity // max(_MIN_SPAN, 8 * chunk_shape[mode]))
    return LaunchPlan("staged" if staged else "accumulator", max(1, min(want, most)), used,
                      tuple(staged))


def _global_plan(capacity: int, n_modes: int) -> LaunchPlan:
    return LaunchPlan("global", max(1, -(-capacity // GLOBAL_TILE)), 3 * n_modes * 8)


def device_budget(device: torch.device) -> int:
    """The dynamic shared memory a block may opt into on `device`."""
    return int(torch.cuda.get_device_properties(device).shared_memory_per_block_optin)


def check_nnz_per_task(nnz_per_task, coords_rel: torch.Tensor) -> None:
    if nnz_per_task is None:
        return
    t = coords_rel.shape[0]
    if nnz_per_task.device != coords_rel.device:
        raise ValueError(f"nnz_per_task is on {nnz_per_task.device}, coords_rel on "
                         f"{coords_rel.device}")
    if nnz_per_task.dtype != torch.int32:
        raise TypeError(f"nnz_per_task must be torch.int32; got {nnz_per_task.dtype}")
    if tuple(nnz_per_task.shape) != (t,) or not nnz_per_task.is_contiguous():
        raise ValueError(f"nnz_per_task must be contiguous ({t},); got "
                         f"{tuple(nnz_per_task.shape)}")


def check_inputs(factors, task_chunk, coords_rel, values, mode: int, chunk_shape, *,
                 names=("factors", "values"), factor_dtype=None, value_dtype=None) -> None:
    """A wrapper's inputs on the card: at least 2 modes, (T, N) int32
    task_chunk, (T, P, N) int32 coords_rel, (T, P) values and (rows >= 1, R)
    factors, all contiguous on coords_rel's CUDA device.  `names` are the
    factors' and values' in the messages; `factor_dtype` and `value_dtype`
    default to the first factor's and the values' own (the caller checks
    those)."""
    if coords_rel.device.type != "cuda":
        raise ValueError(f"no kernel for device {coords_rel.device}")
    fname, vname = names
    n = len(factors)
    if n < 2:
        raise ValueError(f"spMTTKRP needs at least 2 modes; got {n}")
    if not 0 <= mode < n or len(chunk_shape) != n:
        raise ValueError(f"mode {mode} / chunk_shape {chunk_shape} do not fit {n} modes")
    if coords_rel.dim() != 3 or coords_rel.shape[2] != n:
        raise ValueError(f"coords_rel must be (T, P, {n}); got {tuple(coords_rel.shape)}")
    t, p, _ = coords_rel.shape
    if tuple(task_chunk.shape) != (t, n) or tuple(values.shape) != (t, p):
        raise ValueError(
            f"task_chunk {tuple(task_chunk.shape)} / {vname} {tuple(values.shape)} "
            f"do not match coords_rel {tuple(coords_rel.shape)}")
    fdtype = factors[0].dtype if factor_dtype is None else factor_dtype
    rank = factors[0].shape[1]
    for name, x, dtype in [("task_chunk", task_chunk, torch.int32),
                           ("coords_rel", coords_rel, torch.int32),
                           (vname, values, values.dtype if value_dtype is None else value_dtype),
                           *[(f"{fname}[{m}]", f, fdtype) for m, f in enumerate(factors)]]:
        if x.device != coords_rel.device:
            raise ValueError(f"{name} is on {x.device}, coords_rel on {coords_rel.device}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}; got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for m, f in enumerate(factors):
        if f.dim() != 2 or f.shape[1] != rank or (m != mode and f.shape[0] < 1):
            raise ValueError(f"{fname}[{m}] must be (rows >= 1, {rank}); got {tuple(f.shape)}")


def check_out(out: torch.Tensor, dtype, s_mode: int, rank: int, device) -> None:
    """The output: (rows, R), a whole number of S_mode-row chunks,
    contiguous, of `dtype` on `device`.  The caller guarantees that every
    task_chunk[:, mode] < rows / S_mode (reading it would wait on the card)."""
    if out.device != device:
        raise ValueError(f"out is on {out.device}, coords_rel on {device}")
    if out.dtype != dtype:
        raise TypeError(f"out must be {dtype}; got {out.dtype}")
    if out.dim() != 2 or out.shape[1] != rank or out.shape[0] % s_mode:
        raise ValueError(f"out must be (a multiple of {s_mode} rows, {rank}); got "
                         f"{tuple(out.shape)}")
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")


def launch(source: str, symbol: str, factors, task_chunk, coords_rel, values, *, mode: int,
           chunk_shape, nnz_per_task, plan: LaunchPlan | None, out: torch.Tensor,
           trailing=()) -> bool:
    """Adds the spMTTKRP of inputs that passed `check_inputs` into `out`
    (float32 for float values, int32 for integer ones) through the C entry
    `symbol` of csrc/`source`.cu, in `plan` or else the one `plan_launch`
    picks for the card; `trailing` are the entry's last ints.  Returns
    whether it launched: with no task, slot or rank it adds nothing.

    The factor addresses, rows and chunk sizes go to the card as a (3, N)
    int64 table, pinned and copied without blocking, so the launch adds no
    host synchronisation."""
    check_nnz_per_task(nnz_per_task, coords_rel)
    t, p, n = coords_rel.shape
    rank = factors[0].shape[1]
    device = coords_rel.device
    check_out(out, torch.float32 if values.is_floating_point() else torch.int32,
              chunk_shape[mode], rank, device)
    if t == 0 or p == 0 or rank == 0:
        return False
    if plan is None:
        plan = plan_launch(t, p, chunk_shape, mode, rank, factor_bytes=factors[0].element_size(),
                           value_bytes=values.element_size(), smem_budget=device_budget(device))
    meta = torch.tensor(
        [[0 if m == mode else f.data_ptr() for m, f in enumerate(factors)],
         [f.shape[0] for f in factors],
         list(chunk_shape)], dtype=torch.int64).pin_memory()
    meta = meta.to(device, non_blocking=True)
    _build.call(source, symbol, entry_argtypes(len(trailing)), task_chunk.data_ptr(),
                coords_rel.data_ptr(), values.data_ptr(), meta.data_ptr(),
                0 if nnz_per_task is None else nnz_per_task.data_ptr(), out.data_ptr(), t, p, n,
                rank, mode, (ctypes.c_longlong * n)(*chunk_shape), TIERS.index(plan.tier),
                plan.blocks_per_task, plan.staged_mask, plan.smem_bytes, *trailing,
                device=device, context=plan)
    return True


def entry_argtypes(n_trailing_ints: int) -> list:
    """ctypes argument types of a C entry before its stream: the device
    addresses of task_chunk, coords_rel, values, meta, nnz_per_task (or
    null) and the output; T, P; N, R, mode; the host chunk shape; tier,
    blocks per task, staged mask, smem bytes; `n_trailing_ints` ints."""
    return ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
            + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_longlong,
               ctypes.c_uint, ctypes.c_longlong] + [ctypes.c_int] * n_trailing_ints)
