"""Pseudo-inverse of CP-ALS's Gram Hadamard products through the
hand-written CUDA kernels of `csrc/gram_pinv.cu`, with no host
synchronisation.

It ports `jnp.linalg.pinv` as the reference's `cp_als` calls it: V, the
Hadamard product of the other modes' Gram matrices, is symmetric positive
semi-definite, so its pseudo-inverse comes from an eigendecomposition, with
jnp's cutoff (`gram_pinv_rtol`).  There is no Pallas counterpart.

Three tiers (`plan_pinv`): `warp` (R ≤ 32: one warp per matrix, one-sided
Jacobi in registers), `shared` (one block per matrix, two-sided Jacobi in
shared memory) and `global` (the same from a device scratch buffer, past
the card's shared memory).  `gram_pinv` launches one for CUDA tensors and
raises if it cannot (a failed build or launch never falls back to the plain
version); for CPU tensors it runs the plain version, `ref.gram_pinv_ref`.
`launches` counts kernel launches of every tier (plain-version calls are
not counted).  `jacobi_replay` repeats the warp tier's arithmetic on the
host, for tests and for the operations bound; no path on the card runs it.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from . import _build, ref, tiles

__all__ = ["gram_pinv", "launches"]

#: Number of times `gram_pinv` has launched a CUDA kernel (either design).
launches = 0

_SOURCE = "gram_pinv"
_LAM_MAX_BYTES = 16  # the block kernel's static shared memory beside its work area
#: Tier names: the warp design, then the block design's two work areas.
TIERS = ("warp", "shared", "global")
#: Widest matrix the warp tier holds (one row per lane).
WARP_MAX_RANK = 32
MAX_SWEEPS = 40  # kMaxSweeps


@dataclasses.dataclass(frozen=True)
class PinvLaunch:
    """One launch's tier and layout: `warp` (R ≤ 32, instantiated at the
    even width R + R % 2); `shared` with `smem_bytes` of dynamic shared
    memory per block; `global` with `scratch_bytes` of device memory per
    matrix (the work area past the card's shared memory)."""

    tier: str
    smem_bytes: int = 0
    scratch_bytes: int = 0


def work_bytes(rank: int) -> int:
    """Bytes of one matrix's float64 work area in the block tiers (A, V, one
    value per index); mirrors `prism_gram_pinv_work_bytes` in the source."""
    return 8 * (2 * rank * rank + rank + (rank & 1))


def plan_pinv(rank: int, smem_budget: int, tier: str | None = None) -> PinvLaunch:
    """The warp tier up to R = 32, then shared memory while the block tier's
    work area fits `smem_budget`, else a global scratch buffer.  `tier`
    forces one."""
    if tier is None:
        tier = ("warp" if rank <= WARP_MAX_RANK
                else "shared" if work_bytes(rank) + _LAM_MAX_BYTES <= smem_budget else "global")
    if tier == "warp":
        if rank > WARP_MAX_RANK:
            raise ValueError(f"the warp tier holds R ≤ {WARP_MAX_RANK}; got R = {rank}")
        return PinvLaunch("warp")
    if tier == "shared":
        return PinvLaunch("shared", smem_bytes=work_bytes(rank))
    if tier == "global":
        return PinvLaunch("global", scratch_bytes=work_bytes(rank))
    raise ValueError(f"unknown tier {tier!r}; expected one of {TIERS}")


#: The C entries' arguments before the stream: v, out, B, R, rtol, and the
#: block design's scratch and shared-memory bytes.
_WARP_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                  ctypes.c_double]
_BLOCK_ARGTYPES = [*_WARP_ARGTYPES, ctypes.c_void_p, ctypes.c_longlong]


def gram_pinv(v: torch.Tensor, *, launch: PinvLaunch | None = None) -> torch.Tensor:
    """Pseudo-inverse of each symmetric positive semi-definite (R, R) matrix
    of `v` ((R, R) or (..., R, R) float32), keeping the directions whose
    |eigenvalue| exceeds `ref.gram_pinv_rtol(R)` times the largest, as
    `jnp.linalg.pinv` does.  Only the upper triangle is read.  `launch`
    forces a tier and layout (`plan_pinv`'s choice otherwise)."""
    global launches
    if v.device.type == "cpu":
        return ref.gram_pinv_ref(v)
    if v.device.type != "cuda":
        raise ValueError(f"no kernel for device {v.device}")
    if v.dim() < 2 or v.shape[-1] != v.shape[-2]:
        raise ValueError(f"v must be (..., R, R); got {tuple(v.shape)}")
    if v.dtype != torch.float32:
        raise TypeError(f"v must be torch.float32; got {v.dtype}")
    if not v.is_contiguous():
        raise ValueError("v must be contiguous")
    rank = v.shape[-1]
    out = torch.empty_like(v)
    n = v.numel() // (rank * rank) if rank else 0
    if n == 0:
        return out
    if launch is None:
        launch = plan_pinv(rank, tiles.device_budget(v.device))
    if launch.tier not in TIERS:
        raise ValueError(f"unknown tier {launch.tier!r}; expected one of {TIERS}")
    scratch = (torch.empty(n * launch.scratch_bytes // 8, dtype=torch.float64, device=v.device)
               if launch.scratch_bytes else None)
    args = (v.data_ptr(), out.data_ptr(), n, rank, ref.gram_pinv_rtol(rank))
    if launch.tier == "warp":
        symbol, argtypes = "prism_gram_pinv_warp_f32", _WARP_ARGTYPES
    else:
        symbol, argtypes = "prism_gram_pinv_f32", _BLOCK_ARGTYPES
        args += (0 if scratch is None else scratch.data_ptr(), launch.smem_bytes)
    _build.call(_SOURCE, symbol, argtypes, *args, device=v.device, context=launch)
    launches += 1
    return out


# ---------------------------------------------------------------------------
# The warp tier's arithmetic on the host.
# ---------------------------------------------------------------------------

def warp_lanes(width: int) -> int:
    """Lanes a butterfly over `width` rows spans (`lanes_for`)."""
    return max(2, 1 << (width - 1).bit_length())


def round_robin_source(c: int, width: int) -> int:
    """The slot whose column moves into slot `c` between two rounds
    (`round_robin_source` in the source)."""
    if c == 0:
        return 0
    if c & 1:
        return (2 if width > 2 else 1) if c == 1 else c - 2
    return c + 2 if c + 2 <= width - 2 else width - 1


def _group_sum(x: np.ndarray) -> np.ndarray:
    """Butterfly sum over the lane axis (axis 1), in the kernel's order."""
    idx = np.arange(x.shape[1])
    h = x.shape[1] // 2
    while h:
        x = x + x[:, idx ^ h]
        h //= 2
    return x[:, 0]


@dataclasses.dataclass(frozen=True)
class Replay:
    """What `jacobi_replay` returns: the float32 result as the kernel writes
    it, and per matrix the rounds run, the pairs rotated, and the pairs of
    real (unpadded) columns checked."""

    out: np.ndarray
    rounds: np.ndarray
    rotations: np.ndarray
    checks: np.ndarray


def jacobi_replay(v: np.ndarray) -> Replay:
    """The warp tier (`gram_pinv_warp_kernel`) on the host, in numpy
    float64: the same ordering (pairs (2j, 2j+1), the round-robin move
    between rounds), butterfly sums, criterion (with its floor: a column
    whose squared norm is at most eps²·‖A‖_F² is numerically zero and does
    not rotate), stopping rule, cutoff and
    result formation, each operation rounded once as the kernel's explicitly
    rounded intrinsics are.  A matrix whose upper triangle holds a NaN or
    an off-diagonal ±Inf comes out all NaN, one with ±Inf only on the
    diagonal all zeros, both after 0 rounds (`ref._nonfinite_members`, as
    `jnp.linalg.pinv` answers).  `v` is (..., R, R) float32 (upper triangle
    read, R ≤ 32)."""
    v = np.asarray(v, np.float32)
    r = v.shape[-1]
    if not 1 <= r <= WARP_MAX_RANK:
        raise ValueError(f"the warp tier holds 1 ≤ R ≤ {WARP_MAX_RANK}; got R = {r}")
    width = r + (r & 1)
    lanes = warp_lanes(width)
    x = np.triu(v.reshape(-1, r, r).astype(np.float64))
    nan, zero = (m.numpy() for m in ref._nonfinite_members(torch.from_numpy(x)))
    x[nan | zero] = 0.0  # such a matrix skips the rounds
    x = x + np.triu(x, 1).transpose(0, 2, 1)
    n = x.shape[0]
    u = np.zeros((n, lanes, width))
    u[:, :r, :r] = x
    w = np.zeros((n, lanes, width))
    w[:, np.arange(width), np.arange(width)] = 1.0
    src = [round_robin_source(c, width) for c in range(width)]
    # A pair of slots holds two real columns unless one is a padded one.
    real = np.zeros((n, width), bool)
    real[:, :r] = True
    quiet = np.zeros(n, np.int64)
    rounds = np.zeros(n, np.int64)
    rotations = np.zeros(n, np.int64)
    checks = np.zeros(n, np.int64)
    active = ~(nan | zero)
    eps = np.finfo(np.float64).eps
    row_sq = np.zeros((n, lanes))
    for c in range(width):
        row_sq = row_sq + u[..., c] * u[..., c]
    tiny = (eps * eps) * _group_sum(row_sq)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        for _ in range(MAX_SWEEPS * (width - 1)):
            if not active.any():
                break
            up, uq, wp, wq = u[..., 0::2], u[..., 1::2], w[..., 0::2], w[..., 1::2]
            a, b, g = _group_sum(up * up), _group_sum(uq * uq), _group_sum(up * uq)
            rot = (g * g > ((eps * eps) * a) * b) & (np.minimum(a, b) > tiny[:, None])
            rot &= active[:, None]
            d, g2 = b - a, 2.0 * g
            m = np.abs(d) + np.sqrt(d * d + g2 * g2)
            inv = 1.0 / np.sqrt(m * m + g2 * g2)
            c, s = m * inv, np.where(d >= 0.0, g2, -g2) * inv
            c, s, m = c[:, None], s[:, None], rot[:, None]
            u[..., 0::2], u[..., 1::2] = (np.where(m, c * up - s * uq, up),
                                          np.where(m, s * up + c * uq, uq))
            w[..., 0::2], w[..., 1::2] = (np.where(m, c * wp - s * wq, wp),
                                          np.where(m, s * wp + c * wq, wq))
            rotations += rot.sum(axis=1)
            checks += np.where(active, (real[:, 0::2] & real[:, 1::2]).sum(axis=1), 0)
            rounds += active
            quiet = np.where(rot.any(axis=1), 0, quiet + 1)
            keep = active[:, None, None]
            u, w = np.where(keep, u[..., src], u), np.where(keep, w[..., src], w)
            real = np.where(active[:, None], real[:, src], real)
            active &= quiet < width - 1
        lam = _group_sum(w * u)
        cutoff = ref.gram_pinv_rtol(r) * np.abs(lam).max(axis=1, initial=0.0)
        d = np.where(np.abs(lam) > cutoff[:, None], 1.0 / lam, 0.0)
    acc = np.zeros((n, r, r))
    for k in range(width):
        acc = acc + d[:, None, None, k] * (w[:, :r, None, k] * w[:, None, :r, k])
    acc[nan] = np.nan
    return Replay(acc.astype(np.float32).reshape(v.shape), rounds, rotations, checks)
