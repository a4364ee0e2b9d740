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
from ..optim import AdamWConfig
from .mesh import make_local_mesh
from .shardings import init_shapes
from .steps import init_opt_shapes, state_shardings

__all__ = ["elastic_restore"]


def elastic_restore(lm: LM, ckpt_dir: str, opt_cfg: AdamWConfig, n_model: int = 1,
                    device: str | torch.device | None = None):
    """Rebuild the mesh from the live ranks (`make_local_mesh(n_model=...)`;
    `device` None → the CUDA card over NCCL, "cpu" → gloo), recompute the
    shardings against it and restore the latest committed `{"params",
    "opt"}` checkpoint, written from any earlier mesh, as every rank's
    blocks.  Returns (mesh, params, opt_state, step), or None when there is
    no checkpoint."""
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    mesh = make_local_mesh(n_model=n_model, device=device)
    structs, _ = init_shapes(lm)
    like = {"params": structs, "opt": init_opt_shapes(structs, opt_cfg)}
    state = restore_checkpoint(ckpt_dir, step, like, device=device,
                               shardings=state_shardings(lm, mesh, opt_cfg), mesh=mesh)
    return mesh, state["params"], state["opt"], step
