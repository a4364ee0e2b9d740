"""Elastic scaling: resume a run on another number of ranks (counterpart of
`repro.launch.elastic`).

Checkpoints are host (numpy) snapshots.  On restart the mesh is rebuilt
from the ranks that are alive, and every array is placed on this rank's
device in a like-tree of the current run's structure.  The like-tree is
made of meta tensors (`LM.init(nn.SHAPES)`, `init_opt_shapes`): the
checkpoint carries the data, so nothing is drawn or allocated twice.  The
deterministic data pipeline (seed, step, shard) makes batch boundaries
reproducible across the change, so no data server has to survive it.
"""
from __future__ import annotations

import torch

from ..checkpoint import latest_step, restore_checkpoint
from ..models import LM
from ..models.nn import SHAPES
from ..models.transformer import later
from ..optim import AdamWConfig
from .mesh import make_local_mesh
from .steps import init_opt_shapes

__all__ = ["elastic_restore"]


def elastic_restore(lm: LM, ckpt_dir: str, opt_cfg: AdamWConfig, n_model: int = 1,
                    device: str | torch.device | None = None):
    """Rebuild the mesh from the live ranks (`make_local_mesh`; `device`
    None → the CUDA card over NCCL, "cpu" → gloo) and restore the latest
    committed `{"params", "opt"}` checkpoint on every rank.  Returns (mesh,
    params, opt_state, step), or None when there is no checkpoint.  A model
    axis of more than one rank raises: that is the tensor-parallel slice."""
    if n_model > 1:
        raise later("multi-card")
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    mesh = make_local_mesh(n_model=n_model, device=device)
    params, _ = lm.init(SHAPES)
    like = {"params": params, "opt": init_opt_shapes(params, opt_cfg)}
    state = restore_checkpoint(ckpt_dir, step, like, device=device)
    return mesh, state["params"], state["opt"], step
