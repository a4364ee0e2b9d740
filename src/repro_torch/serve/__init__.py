"""Decomposition serving on the port: request coalescing over the batched
CP-ALS path (counterpart of `repro.serve`).

A `DecomposeService` accepts single-tensor decomposition requests from any
number of threads, coalesces them into batches (up to `max_batch` requests
or `max_wait_ms` of linger, whichever first), and dispatches each batch
through `repro_torch.batch.cp_als_batched` on one device (the CUDA card
unless the caller passes ``device="cpu"``) — so concurrent requests that
land in the same (shape class, nnz band) bucket share one batched MTTKRP,
one autotune decision, and one ALS loop.
"""
from __future__ import annotations

from .service import DecomposeService, ServeStats

__all__ = ["DecomposeService", "ServeStats"]
