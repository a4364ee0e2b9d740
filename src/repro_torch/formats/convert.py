"""COO ↔ CSF ↔ ALTO conversion + the per-tensor format cache (counterpart
of `repro.formats.convert`).

Layout construction is the expensive, once-per-tensor step (sorts over the
nonzeros); CP-ALS calls MTTKRP `ndim × n_iters` times against the same
tensor.  `FormatCache` is the format analogue of the engine's `PlanCache`:
built layouts, their tensors on each device and the tensor's `FormatStats`
are cached per live tensor and evicted when the tensor is garbage
collected, so no layout is rebuilt across CP-ALS iterations or repeated
`build_engine` calls, and none is moved to a device twice.
"""
from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from ..core.sptensor import SparseTensor
from .alto import ALTOTensor, alto_to_coo, build_alto
from .csf import CSFModeTree, build_csf_tree, csf_to_coo, fiber_count

__all__ = [
    "FormatCache",
    "FormatCacheStats",
    "alto_to_csf",
    "coo_to_alto",
    "coo_to_csf",
    "csf_to_alto",
    "default_format_cache",
]


# -- conversions -------------------------------------------------------------
# COO is the hub: every layout converts exactly to/from it (multiset of
# (coords, values) preserved), so the cross conversions compose through it.

def coo_to_csf(st: SparseTensor, mode: int) -> CSFModeTree:
    return build_csf_tree(st, mode)


def coo_to_alto(st: SparseTensor) -> ALTOTensor:
    return build_alto(st)


def csf_to_alto(tree: CSFModeTree) -> ALTOTensor:
    return build_alto(csf_to_coo(tree))


def alto_to_csf(at: ALTOTensor, mode: int) -> CSFModeTree:
    return build_csf_tree(alto_to_coo(at), mode)


# -- cache -------------------------------------------------------------------

@dataclasses.dataclass
class FormatCacheStats:
    csf_hits: int = 0
    csf_misses: int = 0
    alto_hits: int = 0
    alto_misses: int = 0
    device_hits: int = 0
    device_misses: int = 0


class FormatCache:
    """Caches CSF mode trees, the ALTO layout, their tensors per device and
    the tensor's `FormatStats`, per live tensor (the identity-keyed,
    finalizer-evicted scheme of `repro_torch.engine.plan.PlanCache`)."""

    def __init__(self):
        self._csf: dict = {}
        self._alto: dict = {}
        self._device: dict = {}
        self._stats: dict = {}
        self._tracked: set[int] = set()
        self.stats = FormatCacheStats()

    def _tensor_key(self, st: SparseTensor) -> int:
        key = id(st)
        if key not in self._tracked:
            self._tracked.add(key)
            weakref.finalize(st, _evict_weak, weakref.ref(self), key)
        return key

    def _evict(self, tkey: int) -> None:
        self._tracked.discard(tkey)
        for cache in (self._csf, self._alto, self._device, self._stats):
            for k in [k for k in cache if k[0] == tkey]:
                del cache[k]

    # -- layouts ------------------------------------------------------------
    def csf(self, st: SparseTensor, mode: int) -> CSFModeTree:
        k = (self._tensor_key(st), mode)
        if k in self._csf:
            self.stats.csf_hits += 1
        else:
            self.stats.csf_misses += 1
            self._csf[k] = build_csf_tree(st, mode)
        return self._csf[k]

    def alto(self, st: SparseTensor) -> ALTOTensor:
        k = (self._tensor_key(st),)
        if k in self._alto:
            self.stats.alto_hits += 1
        else:
            self.stats.alto_misses += 1
            self._alto[k] = build_alto(st)
        return self._alto[k]

    # -- device tensors -----------------------------------------------------
    def device_csf(self, st: SparseTensor, mode: int, device: torch.device) -> dict:
        """The mode tree's operands as tensors on `device` (moved once)."""
        k = (self._tensor_key(st), "csf", mode, torch.device(device))
        if k in self._device:
            self.stats.device_hits += 1
        else:
            self.stats.device_misses += 1
            t = self.csf(st, mode)
            # repro-lint: disable=host-sync -- FormatCache: each layout's operands are uploaded once per device and cached
            self._device[k] = {name: torch.from_numpy(getattr(t, name)).to(device)
                               for name in ("inner_coord", "values", "fiber_ids", "fiber_coords")}
        return self._device[k]

    def device_alto(self, st: SparseTensor, device: torch.device) -> dict:
        """The ALTO operands on `device` (moved once).  `key_words` holds the
        layout's uint32 words reinterpreted as int32 (same bits): torch has
        no right shift for uint32."""
        k = (self._tensor_key(st), "alto", torch.device(device))
        if k in self._device:
            self.stats.device_hits += 1
        else:
            self.stats.device_misses += 1
            at = self.alto(st)
            arrays = dict(key_words=at.key_words.view(np.int32), values=at.values)
            # repro-lint: disable=host-sync -- FormatCache: each layout's operands are uploaded once per device and cached
            self._device[k] = {name: torch.from_numpy(a).to(device) for name, a in arrays.items()}
        return self._device[k]

    # -- stats --------------------------------------------------------------
    def format_stats(self, st: SparseTensor):
        """Measured `FormatStats` for `st` (exact fiber counts; cached).  A
        mode whose CSF tree is cached takes the tree's `n_fibers`, the count
        `fiber_count` would recompute with a sort of every nonzero."""
        from . import FormatStats
        tkey = self._tensor_key(st)
        k = (tkey, "stats")
        if k not in self._stats:
            fibers = tuple(self._csf[(tkey, m)].n_fibers if (tkey, m) in self._csf
                           else fiber_count(st, m) for m in range(st.ndim))
            self._stats[k] = FormatStats.from_tensor(st, fiber_counts=fibers)
        return self._stats[k]

    def clear(self) -> None:
        self._csf.clear()
        self._alto.clear()
        self._device.clear()
        self._stats.clear()
        self._tracked.clear()
        self.stats = FormatCacheStats()


def _evict_weak(cache_ref: weakref.ref[FormatCache], tkey: int) -> None:
    cache = cache_ref()
    if cache is not None:
        cache._evict(tkey)


#: Process-wide default used when callers don't pass their own cache.
default_format_cache = FormatCache()
