"""Launch plans of the two spMTTKRP kernels, float and fixed point: which
tier a launch takes, how many blocks share a task and how many bytes of
dynamic shared memory it needs.  Mirrors `csrc/mttkrp_tiles.cuh`, which
holds every launch's plan against its own layout and refuses one that
differs.  `plan_launch` is pure Python, so the CPU tests reach it.

Tiers (see the header's notes):

  staged       a block owns a task, accumulates its (S_mode, R) block in
               shared memory and stages the input modes' (S_m, R) factor
               blocks there, in mode order, as long as the budget lasts;
  accumulator  only the (S_mode, R) block fits: rows come from L2;
  global       not even that fits: one device-memory atomic per
               (nonzero, r), the first design.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from ._build import KernelError

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
_LAYOUT_MISMATCH = -1


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    tier: str
    blocks_per_task: int
    smem_bytes: int
    staged: tuple[int, ...] = ()  # input modes whose factor block is staged

    @property
    def staged_mask(self) -> int:
        return sum(1 << m for m in self.staged)

    @property
    def zero_filled(self) -> bool:
        """Whether the output must start at zero: the kernel adds into it
        (global tier, or a task split across blocks) instead of writing
        every block once."""
        return self.tier == "global" or self.blocks_per_task > 1


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


def launch_args(factors, mode: int, chunk_shape, plan: LaunchPlan, device) -> tuple:
    """(meta, chunk, tier id, blocks per task, staged mask, smem bytes) for
    the C entry.  meta is the (3, N) int64 table of factor addresses, rows
    and chunk sizes, pinned and copied without blocking, so the launch adds
    no host synchronisation; chunk is the chunk shape in host memory."""
    meta = torch.tensor(
        [[0 if m == mode else f.data_ptr() for m, f in enumerate(factors)],
         [f.shape[0] for f in factors],
         list(chunk_shape)], dtype=torch.int64).pin_memory()
    meta = meta.to(device, non_blocking=True)
    chunk = (ctypes.c_longlong * len(chunk_shape))(*chunk_shape)
    return (meta, chunk, TIERS.index(plan.tier), plan.blocks_per_task, plan.staged_mask,
            plan.smem_bytes)


def new_output(plan: LaunchPlan, shape, dtype, device) -> torch.Tensor:
    """The (T, S_mode, R) output: zero-filled where the kernel adds into it,
    else left for the kernel to write whole."""
    return (torch.zeros if plan.zero_filled else torch.empty)(shape, dtype=dtype, device=device)


def raise_on(rc: int, lib, name: str, plan: LaunchPlan) -> None:
    if rc == _LAYOUT_MISMATCH:
        raise KernelError(f"{name} kernel refused the launch: the plan's {plan.smem_bytes} B "
                           f"of shared memory disagree with the kernel's layout ({plan})")
    if rc != 0:
        raise KernelError(f"{name} kernel launch failed: "
                           f"{lib.prism_cuda_error_string(rc).decode()} ({rc}; {plan})")


def entry_argtypes(n_trailing_ints: int) -> list:
    """ctypes argument types of a C entry: the device addresses of
    task_chunk, coords_rel, values, meta, nnz_per_task (or null) and the
    output; T, P; N, R, mode; the host chunk shape; tier, blocks per task,
    staged mask, smem bytes; `n_trailing_ints` ints; the stream."""
    return ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
            + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_longlong,
               ctypes.c_uint, ctypes.c_longlong] + [ctypes.c_int] * n_trailing_ints
            + [ctypes.c_void_p])
