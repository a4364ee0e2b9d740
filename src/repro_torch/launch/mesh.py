"""Device meshes over `torch.distributed` (counterpart of `make_local_mesh`
and `mesh_axes` in `repro.launch.mesh`).

The reference's mesh spans the devices of one JAX process; here each mesh
member is one rank of a process group, one card per rank (or one CPU
process over gloo).  This module makes the default group when the caller
has not: under `python -m torch.distributed.run` each rank joins the
launcher's group (`join_launched_group`); a lone process gets a one-rank
group on an in-process store, so it needs no network and no `MASTER_ADDR`,
and still gets a real (1, 1) mesh, as the reference gets a one-device mesh.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["dp_axes", "join_launched_group", "make_local_mesh", "mesh_axes", "world_rank",
           "world_size"]

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def world_size() -> int:
    """Ranks of the initialised default process group, or 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    """This process's rank in the default process group, or 0 without one."""
    return dist.get_rank() if dist.is_initialized() else 0


def _backend(dev: torch.device) -> str:
    if dev.type not in _BACKENDS:
        raise ValueError(f"no process-group backend for device {dev}")
    return _BACKENDS[dev.type]


def join_launched_group(device: str | torch.device | None = None) -> bool:
    """Under `torch.distributed.run` (WORLD_SIZE > 1 in the environment)
    and without a default group, join the launcher's group through
    `env://`: NCCL on this rank's card (`resolve_device`: the card
    LOCAL_RANK names), gloo with a "cpu" device.  Returns whether it
    joined; a lone process or an existing group is left as it is."""
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    dev = resolve_device(device)
    backend = _backend(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://")
    return True


def make_local_mesh(n_data: int | None = None, n_model: int = 1, *,
                    device: str | torch.device | None = None):
    """A `DeviceMesh` of shape (n_data, n_model) named ("data", "model")
    over the ranks of the default process group (None n_data: every rank
    over `n_model`).  `device` None means the CUDA card (NCCL); "cpu"
    means gloo.  Without a default group, the launcher's is joined under
    `torch.distributed.run`, and one is initialised for this process alone
    otherwise."""
    dev = resolve_device(device)
    backend = _backend(dev)
    if not dist.is_initialized() and not join_launched_group(dev):
        # A one-rank group on an in-process store: `init_device_mesh` on an
        # uninitialised group would rendezvous through `env://` instead.
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
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


def dp_axes(mesh) -> tuple[str, ...]:
    """Batch-parallel axes: pod (if present) + data."""
    names = mesh.mesh_dim_names
    return tuple(a for a in ("pod", "data") if a in names)
