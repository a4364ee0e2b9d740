"""Device meshes over `torch.distributed` (counterpart of `make_local_mesh`
and `mesh_axes` in `repro.launch.mesh`).

The reference's mesh spans the devices of one JAX process; here each mesh
member is one rank of a process group, one card per rank (or one CPU
process over gloo).  A caller that launched several ranks
(`python -m torch.distributed.run`) initialises the default group itself;
a lone process gets a one-rank group on an in-process store, so it needs
no network and no `MASTER_ADDR`, and still gets a real (1, 1) mesh, as
the reference gets a one-device mesh.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["make_local_mesh", "mesh_axes", "world_rank", "world_size"]

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def world_size() -> int:
    """Ranks of the initialised default process group, or 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    """This process's rank in the default process group, or 0 without one."""
    return dist.get_rank() if dist.is_initialized() else 0


def make_local_mesh(n_data: int | None = None, n_model: int = 1, *,
                    device: str | torch.device | None = None):
    """A `DeviceMesh` of shape (n_data, n_model) named ("data", "model")
    over the ranks of the default process group (None n_data: every rank
    over `n_model`).  `device` None means the CUDA card (NCCL); "cpu"
    means gloo.  Without a default group, one is initialised for this
    process alone."""
    dev = resolve_device(device)
    if dev.type not in _BACKENDS:
        raise ValueError(f"no process-group backend for device {dev}")
    if not dist.is_initialized():
        # A one-rank group on an in-process store: `init_device_mesh` on an
        # uninitialised group would rendezvous through `env://` instead.
        dist.init_process_group(_BACKENDS[dev.type], store=dist.HashStore(),
                                rank=0, world_size=1)
    n = dist.get_world_size()
    n_data = n_data or max(n // n_model, 1)
    if n_data * n_model != n:
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs {n_data * n_model} ranks; "
                         f"the process group has {n}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, (n_data, n_model), mesh_dim_names=("data", "model"))


def mesh_axes(mesh) -> dict:
    """{axis name: size} of a named mesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape, strict=True))
