"""The work of a CP-ALS iteration, counted from the problem, and the card's peaks.

The bytes of one spMTTKRP in mode n: every nonzero's N coordinates and its value
read once at the `SparseTensor`'s widths (int32, float32), every input factor
matrix read once and the output matrix written once (float32).  Padding slots,
re-reads and what an implementation stages are not work, so the count is the same
whatever engine computes the product.  The operations (`mttkrp_flops`) never bind on
this card: the bytes bound is some 30 times the operations bound.
"""
from __future__ import annotations

__all__ = ["PEAKS", "bound_s", "iteration_bound_s", "mttkrp_bytes", "mttkrp_flops", "peaks"]

#: Published peaks of one card (NVIDIA's data sheet, SXM part, dense, no sparsity),
#: keyed by a substring of `torch.cuda.get_device_name()`.  float32 outside the
#: tensor cores, since the spMTTKRP's products are not matrix products.
PEAKS = {
    "H100": {"bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12},
}

INDEX_BYTES = 4   # int32 coordinates
VALUE_BYTES = 4   # float32 values and factor entries


def mttkrp_bytes(shape, nnz: int, rank: int, mode: int) -> int:
    """Least bytes one spMTTKRP in `mode` moves (see the module docstring)."""
    n = len(shape)
    tensor = nnz * (n * INDEX_BYTES + VALUE_BYTES)
    inputs = sum(d * rank * VALUE_BYTES for m, d in enumerate(shape) if m != mode)
    output = shape[mode] * rank * VALUE_BYTES
    return tensor + inputs + output


def mttkrp_flops(shape, nnz: int, rank: int) -> int:
    """Operations of one spMTTKRP: per nonzero and rank column, the value times
    the N - 1 input rows (N - 1 products) and one add into the output."""
    return nnz * rank * len(shape)


def peaks(device_name: str) -> dict:
    for key, p in PEAKS.items():
        if key in device_name:
            return p
    raise KeyError(f"no published peaks for {device_name!r}")


def bound_s(nbytes: float, flops: float, device_name: str) -> float:
    """Least time the card takes: the larger of the bytes and operations bounds."""
    p = peaks(device_name)
    return max(nbytes / p["bytes_per_s"], flops / p["f32_flops_per_s"])


def iteration_bound_s(shape, nnz: int, rank: int, device_name: str) -> float:
    """Least time of one CP-ALS iteration's N spMTTKRPs."""
    return sum(bound_s(mttkrp_bytes(shape, nnz, rank, m), mttkrp_flops(shape, nnz, rank),
                       device_name) for m in range(len(shape)))
