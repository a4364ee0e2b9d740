"""Shared partition-plan / chunked-tensor cache (counterpart of
`repro.engine.plan`).

Chunking is the expensive, mode-agnostic preprocessing step: one chunking
serves every MTTKRP mode and every CP-ALS iteration.  The cache lets every
chunk-based backend share one `PartitionPlan`, one `ChunkedTensor` and, per
device, one set of resident tensors, so the chunked arrays go to the card
once.  It also holds, per device, the tensor's plain COO arrays, which the
`ref` backend and `cp_als` (the fit, the difference, ||X||², the quantization
error) read, so those go to the card once too.  Entries are keyed by tensor
identity and evicted when the tensor is garbage collected.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch

from ..core.chunking import ChunkedTensor, chunk_tensor, clamp_capacity
from ..core.mttkrp import chunked_device_arrays
from ..core.partition import PartitionPlan, decide_partition
from ..core.sptensor import SparseTensor

__all__ = ["CacheStats", "PlanCache", "default_plan_cache"]


@dataclasses.dataclass
class CacheStats:
    plan_hits: int = 0
    plan_misses: int = 0
    chunk_hits: int = 0
    chunk_misses: int = 0
    device_hits: int = 0
    device_misses: int = 0
    coo_hits: int = 0
    coo_misses: int = 0


class PlanCache:
    """Caches `decide_partition` plans, `chunk_tensor` results and the
    device tensors derived from them, and the COO arrays on each device, per
    live tensor (and per device)."""

    def __init__(self):
        self._plans: dict = {}
        self._chunked: dict = {}
        self._device: dict = {}
        self._coo: dict = {}
        self._tracked: set[int] = set()
        self.stats = CacheStats()

    def _tensor_key(self, st: SparseTensor) -> int:
        key = id(st)
        # Evict every entry for this tensor once it is collected (id() values
        # are recycled).  The finalizer holds the cache only weakly.
        if key not in self._tracked:
            self._tracked.add(key)
            weakref.finalize(st, _evict_weak, weakref.ref(self), key)
        return key

    def _evict(self, tkey: int) -> None:
        self._tracked.discard(tkey)
        for cache in (self._plans, self._chunked, self._device, self._coo):
            for k in [k for k in cache if k[0] == tkey]:
                del cache[k]

    def plan(self, st: SparseTensor, rank: int, *, mem_bytes: int) -> PartitionPlan:
        k = (self._tensor_key(st), rank, mem_bytes)
        if k in self._plans:
            self.stats.plan_hits += 1
        else:
            self.stats.plan_misses += 1
            self._plans[k] = decide_partition(st, rank, mem_bytes=mem_bytes)
        return self._plans[k]

    def _chunk_key(self, st: SparseTensor, chunk_shape, capacity) -> tuple:
        # Capacities that chunk identically share one entry.
        cap = None if capacity is None else clamp_capacity(st.nnz, capacity)
        return (self._tensor_key(st), tuple(chunk_shape), cap)

    def chunked(self, st: SparseTensor, chunk_shape: tuple[int, ...],
                capacity: int | None) -> ChunkedTensor:
        k = self._chunk_key(st, chunk_shape, capacity)
        if k in self._chunked:
            self.stats.chunk_hits += 1
        else:
            self.stats.chunk_misses += 1
            self._chunked[k] = chunk_tensor(st, tuple(chunk_shape), capacity)
        return self._chunked[k]

    def device_arrays(self, st: SparseTensor, chunk_shape: tuple[int, ...],
                      capacity: int | None, device: torch.device) -> dict:
        """The chunked arrays as tensors on `device`, moved there once."""
        k = (*self._chunk_key(st, chunk_shape, capacity), torch.device(device))
        if k in self._device:
            self.stats.device_hits += 1
        else:
            self.stats.device_misses += 1
            self._device[k] = chunked_device_arrays(
                self.chunked(st, chunk_shape, capacity), device)
        return self._device[k]

    def device_coo(self, st: SparseTensor,
                   device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
        """The tensor's int32 coordinates (nnz, N) and float32 values (nnz,)
        as tensors on `device`, moved there once."""
        k = (self._tensor_key(st), torch.device(device))
        if k in self._coo:
            self.stats.coo_hits += 1
        else:
            self.stats.coo_misses += 1
            # repro-lint: disable=host-sync -- uploaded once, resident across CP-ALS calls on the tensor
            coords = torch.from_numpy(st.coords).to(device)
            # repro-lint: disable=host-sync -- uploaded once, resident across CP-ALS calls on the tensor
            self._coo[k] = (coords, torch.from_numpy(st.values).to(device))
        return self._coo[k]


def _evict_weak(cache_ref: weakref.ref[PlanCache], tkey: int) -> None:
    cache = cache_ref()
    if cache is not None:
        cache._evict(tkey)


#: Process-wide default used when callers don't pass their own cache.
default_plan_cache = PlanCache()
