"""Sweep report: Pareto front over (wall time, accuracy, index bytes)
(the port's copy of `repro.sweep.report`).

The filled store IS the sweep's dataset — every (cell, candidate, mode)
timing, every measured error, every persisted `FormatStats`.  This module
flattens it into per-(cell, candidate) *points*:

    time_s        — summed per-mode best measured seconds
    rel_error     — worst measured per-mode MTTKRP relative error (0.0 for
                    a lossless candidate: bit-compatible with the COO
                    float reference up to reduction order)
    index_bytes   — resident index-structure footprint of the candidate's
                    layout, from `FormatStats` byte accounting (per-mode
                    CSF trees sum; ALTO holds one copy, falling back to
                    COO accounting past `MAX_KEY_BITS`)
    peak_fraction — roofline context from `repro_torch.roofline`: the
                    model's step-time lower bound over the measured time,
                    against `hw` — `HOST_HW`, a host estimate, by default;
                    the card's callers pass `hw=H100_SXM5`.  Context, not a
                    ranking axis.

and marks the Pareto-efficient set per cell (minimize time, error, bytes
simultaneously): the points a deployer would ever pick, which is exactly
what a shipped warm store should steer dispatch toward.
"""
from __future__ import annotations

import torch

from ..engine.costmodel import default_prior
from ..engine.persist import TuningStore, device_fingerprint, device_fingerprint_id
from ..engine.registry import parse_candidate
from ..formats import MAX_KEY_BITS, FormatStats
from ..roofline.model import HWTarget, roofline_terms

__all__ = ["HOST_HW", "pareto_front", "pareto_report", "sweep_points"]

#: Roofline target for the CPU hosts the sweep actually runs on: peak flops
#: matches benchmarks/fig7.py's HOST_PEAK_FLOPS estimate, bandwidth the cost
#: model's sustained-stream guess.  Single host — no interconnect term.
HOST_HW = HWTarget("cpu-host-estimate", 48e9,
                   default_prior.bandwidth, default_prior.bandwidth)


def _flops(nnz: int, rank: int, ndim: int) -> float:
    """One MTTKRP mode: rank·(ndim-1) multiplies + rank adds + the scatter
    accumulate per nonzero — benchmarks/fig7.py's `mttkrp_flops` per mode."""
    return float(nnz) * rank * (ndim + 1.0)


def _resident_index_bytes(candidate: str, stats: FormatStats) -> float:
    """Index-structure footprint the candidate keeps resident: the Pareto
    memory axis.  Unknown/execution-only candidates consume the COO
    coordinate list."""
    base = candidate.partition(":")[0]
    ndim = len(stats.shape)
    if base == "csf":
        # One fiber tree per output mode — they all stay resident across
        # a CP-ALS iteration.
        return sum(stats.csf_index_bytes(m) for m in range(ndim))
    if base == "alto":
        # Past the packed-key width the ALTO build falls back to COO
        # (docs/candidates.md#alto): account what actually gets built.
        if stats.key_bits <= MAX_KEY_BITS:
            return stats.alto_index_bytes()
        return stats.coo_index_bytes()
    return stats.coo_index_bytes()


def _mode_traffic_bytes(candidate: str, stats: FormatStats, mode: int,
                        rank: int) -> float:
    """Bytes one MTTKRP call of `mode` moves, for the roofline bound:
    index structure read once + f32 values + gathered input-factor rows +
    the output panel.  Deliberately the same flavour of first-order
    accounting as `benchmarks/fig7.py` — a lower bound, not a simulator."""
    ndim = len(stats.shape)
    base = candidate.partition(":")[0]
    if base == "csf":
        index = stats.csf_index_bytes(mode)
    elif base == "alto" and stats.key_bits <= MAX_KEY_BITS:
        index = stats.alto_index_bytes()
    else:
        index = stats.coo_index_bytes()
    values = 4.0 * stats.nnz
    gathers = 4.0 * stats.nnz * rank * (ndim - 1)
    out = 4.0 * stats.shape[mode] * rank
    return index + values + gathers + out


def sweep_points(store: TuningStore, *, hw: HWTarget = HOST_HW) -> list[dict]:
    """Flatten every stored entry into per-(cell, candidate) points.

    Entries from *every* device fingerprint in the store are reported —
    each point carries its short device id, and Pareto grouping keys on it,
    so a store merged across hosts never cross-compares timings measured on
    different silicon."""
    points: list[dict] = []
    for entry in store.entries():
        k = entry.key
        stats = (FormatStats.from_json(entry.format_stats)
                 if entry.format_stats is not None
                 else FormatStats.estimate(k.shape, k.nnz))
        dev = device_fingerprint_id(dict(k.device))
        cell = (f"{dev}/shape={'x'.join(map(str, k.shape))}/nnz={k.nnz}"
                f"/rank={k.rank}"
                f"/cap={'auto' if k.capacity is None else k.capacity}")
        for cand, per_mode in sorted(entry.timings.items()):
            if not per_mode:
                continue
            try:
                parse_candidate(cand)
            except ValueError:
                pass  # foreign/unregistered candidate: still reportable
            modes = sorted(per_mode)
            time_s = sum(per_mode[m] for m in modes)
            errs = entry.errors.get(cand, {})
            rel_error = max((errs[m] for m in errs), default=0.0)
            flops = sum(_flops(k.nnz, k.rank, k.ndim) for _ in modes)
            traffic = sum(_mode_traffic_bytes(cand, stats, m, k.rank)
                          for m in modes)
            roof = roofline_terms(flops, traffic, 0.0, hw=hw)
            bound = roof["step_time_lower_bound_s"]
            points.append({
                "cell": cell,
                "device": dev,
                "shape": list(k.shape),
                "nnz": k.nnz,
                "rank": k.rank,
                "capacity": k.capacity,
                "candidate": cand,
                "modes": modes,
                "winner_modes": sorted(m for m, w in entry.winners.items()
                                       if w == cand),
                "time_s": time_s,
                "rel_error": rel_error,
                "index_bytes": _resident_index_bytes(cand, stats),
                "roofline_bound_s": bound,
                "roofline_dominant": roof["dominant"],
                "peak_fraction": bound / time_s if time_s > 0 else 0.0,
                "budget": entry.budget,
            })
    points.sort(key=lambda p: (p["cell"], p["candidate"]))
    return points


def _dominates(a: dict, b: dict) -> bool:
    """a Pareto-dominates b: no worse on every minimized axis, strictly
    better on at least one."""
    axes = ("time_s", "rel_error", "index_bytes")
    return (all(a[x] <= b[x] for x in axes)
            and any(a[x] < b[x] for x in axes))


def pareto_front(points: list[dict]) -> list[dict]:
    """Mark each point's `pareto` flag (efficiency *within its cell* —
    cross-cell comparisons mix workloads) and return the efficient set."""
    by_cell: dict[str, list[dict]] = {}
    for p in points:
        by_cell.setdefault(p["cell"], []).append(p)
    front: list[dict] = []
    for group in by_cell.values():
        for p in group:
            p["pareto"] = not any(_dominates(q, p) for q in group if q is not p)
            if p["pareto"]:
                front.append(p)
    front.sort(key=lambda p: (p["cell"], p["time_s"]))
    return front


def pareto_report(store: TuningStore, *, hw: HWTarget = HOST_HW,
                  device: str | torch.device | None = None) -> dict:
    """Every point plus the per-cell Pareto front; `device` (None: the CUDA
    card) is the one whose fingerprint id the report names."""
    points = sweep_points(store, hw=hw)
    front = pareto_front(points)
    return {
        "store": store.path,
        "device": device_fingerprint_id(device_fingerprint(device)),
        "hw": {"name": hw.name, "peak_flops": hw.peak_flops,
               "hbm_bw": hw.hbm_bw},
        "n_entries": len(store),
        "n_points": len(points),
        "n_pareto": len(front),
        "points": points,
        "front": front,
    }
