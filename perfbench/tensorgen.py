"""Seeded sparse tensors for the benchmark, drawn on the device.

The arithmetic is that of `repro_torch.core.sptensor.random_tensor`, with the
draws made by a `torch.Generator` on the card instead of numpy on the host:

  * "uniform":  each coordinate uniform over its mode;
  * "powerlaw": each coordinate min(Zipf(a) - 1, dim - 1), scattered through a
    random permutation of the mode drawn once per tensor;
  * values uniform in [-scale, scale);
  * duplicate coordinates merged by summing their values, and the shortfall
    topped up with fresh draws until exactly `nnz` distinct cells hold a value.

Rows come out in lexicographic order, as `np.unique(coords, axis=0)` gives them.
Duplicates are summed as integers (values in fixed point with `_FRAC_BITS`
fractional bits), so the sums do not depend on the order of the device's atomic
adds: the same seed gives the same tensor, bit for bit, on the same card.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["generate", "zeta"]

_FRAC_BITS = 50          # |value| < 2**12 keeps every sum of 2**13 of them inside int64
_MAX_ROUNDS = 1024


def zeta(a: float, terms: int = 1_000_000) -> float:
    """Riemann zeta of a > 1: a direct sum and the Euler-Maclaurin tail."""
    k = np.arange(1, terms + 1, dtype=np.float64)
    head = float(np.sum(k ** -a))
    n = float(terms)
    return head + n ** (1 - a) / (a - 1) - n ** -a / 2 + a * n ** (-a - 1) / 12


def _zipf_cdf(dim: int, a: float, device) -> torch.Tensor:
    """P(min(Zipf(a) - 1, dim - 1) <= j) for j < dim - 1; the rest of the mass
    sits on dim - 1."""
    k = torch.arange(1, dim, dtype=torch.float64, device=device)
    return torch.cumsum(k ** -a, 0) / zeta(a)


class _Drawer:
    def __init__(self, shape, distribution: str, zipf_a: float, value_scale: float,
                 gen: torch.Generator, device):
        if distribution not in ("uniform", "powerlaw"):
            raise ValueError(f"unknown distribution {distribution!r}")
        self.shape, self.distribution, self.gen, self.device = shape, distribution, gen, device
        self.value_scale = value_scale
        self.perms = self.cdfs = None
        if distribution == "powerlaw":
            self.perms = [torch.randperm(d, generator=gen, device=device) for d in shape]
            self.cdfs = [_zipf_cdf(d, zipf_a, device) for d in shape]

    def coords(self, n: int) -> torch.Tensor:
        cols = []
        for m, dim in enumerate(self.shape):
            if self.distribution == "uniform":
                cols.append(torch.randint(0, dim, (n,), generator=self.gen, device=self.device))
            else:
                u = torch.rand(n, generator=self.gen, dtype=torch.float64, device=self.device)
                idx = torch.searchsorted(self.cdfs[m], u, right=True)
                cols.append(self.perms[m][idx])
        return torch.stack(cols, dim=1)

    def values(self, n: int) -> torch.Tensor:
        u = torch.rand(n, generator=self.gen, dtype=torch.float64, device=self.device)
        v = ((2 * u - 1) * self.value_scale).to(torch.float32).to(torch.float64)
        return torch.round(v * 2.0**_FRAC_BITS).to(torch.int64)


def _lex_order(coords: torch.Tensor, shape) -> torch.Tensor:
    """A stable permutation sorting the rows lexicographically."""
    if math.prod(shape) < 2**63:
        key = torch.zeros(coords.shape[0], dtype=torch.int64, device=coords.device)
        for m, dim in enumerate(shape):
            key = key * dim + coords[:, m]
        return torch.sort(key, stable=True).indices
    order = torch.arange(coords.shape[0], device=coords.device)
    for m in reversed(range(len(shape))):
        order = order[torch.sort(coords[order, m], stable=True).indices]
    return order


def _dedup(coords: torch.Tensor, qvalues: torch.Tensor, shape):
    """Distinct rows in lexicographic order, each with the integer sum of its
    duplicates' values."""
    order = _lex_order(coords, shape)
    c = coords[order]
    new = torch.ones(c.shape[0], dtype=torch.bool, device=c.device)
    new[1:] = (c[1:] != c[:-1]).any(dim=1)
    group = torch.cumsum(new.to(torch.int64), 0) - 1
    sums = torch.zeros(int(group[-1]) + 1 if c.shape[0] else 0, dtype=torch.int64,
                       device=c.device)
    sums.index_add_(0, group, qvalues[order])
    return c[new], sums


def generate(shape, nnz: int, *, distribution: str, seed: int, device,
             zipf_a: float = 1.3, value_scale: float = 1.0):
    """(coords (nnz, N) int32, values (nnz,) float32) on `device`: exactly
    min(nnz, cells) distinct cells, drawn from `seed`."""
    shape = tuple(int(d) for d in shape)
    target = min(int(nnz), math.prod(shape))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    draw = _Drawer(shape, distribution, zipf_a, value_scale, gen, device)
    coords, qvalues = _dedup(draw.coords(int(nnz)), draw.values(int(nnz)), shape)
    for _ in range(_MAX_ROUNDS):
        if coords.shape[0] >= target:
            break
        need = target - coords.shape[0]
        coords, qvalues = _dedup(torch.cat([coords, draw.coords(need)]),
                                 torch.cat([qvalues, draw.values(need)]), shape)
    else:
        raise ValueError(f"could not reach {target} distinct cells of {shape} in "
                         f"{_MAX_ROUNDS} rounds of top-up draws")
    values = (qvalues.to(torch.float64) / 2.0**_FRAC_BITS).to(torch.float32)
    return coords.to(torch.int32), values
