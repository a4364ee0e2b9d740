"""Lock-removal emulation (paper §IV-C, Fig. 6), in PyTorch (counterpart of
`repro.core.lockfree`).

On UPMEM, PRISM removes the locks guarding the shared per-DPU output buffer:
when two of the 16 tasklets write the same output row in the same cycle, one
update is lost.  The paper shows CP-ALS absorbs this imprecision.  The
port's scatters lose nothing, so this module emulates the lost updates:
nonzeros are grouped into waves of `n_tasklets` entries; within a wave, if
two entries target the same output row, only the last writer survives.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["N_TASKLETS", "wave_collision_mask"]

N_TASKLETS = 16  # the paper's tasklet count


def wave_collision_mask(out_rows: torch.Tensor, nnz_per_task: torch.Tensor, *,
                        n_tasklets: int = N_TASKLETS) -> torch.Tensor:
    """out_rows: (T, P) int32 chunk-local output row per nonzero;
    nnz_per_task: (T,).  Returns (T, P) f32 mask — 0 where an update is lost.

    UPMEM tasklets each take a contiguous block of P/G nonzeros, so at
    "time" t the G simultaneous writers are entries {j·P/G + t}.  An entry
    is lost iff a higher-numbered tasklet writes the same row in the same
    wave (last-writer-wins race).  Memory: a (T, P/G, G, G) bool
    comparison, T·P·G bytes."""
    t, p = out_rows.shape
    g = n_tasklets
    pp = p + (-p) % g
    rows = F.pad(out_rows, (0, pp - p), value=-1)
    slot = torch.arange(pp, dtype=out_rows.dtype, device=out_rows.device)[None, :]
    rows = torch.where(slot < nnz_per_task[:, None], rows, -1 - slot)  # uniquify pads
    waves = rows.reshape(t, g, pp // g).transpose(1, 2)                # (T, W, G)
    same = waves[..., :, None] == waves[..., None, :]                   # (T, W, G, G)
    later = torch.ones((g, g), dtype=torch.bool, device=out_rows.device).triu(1)
    lost = (same & later).any(dim=3)                                    # later dup exists
    return (~lost.transpose(1, 2).reshape(t, pp)[:, :p]).to(torch.float32)
