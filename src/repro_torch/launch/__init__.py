"""Process groups and device meshes for the port's multi-rank path."""
from .mesh import (dp_axes, join_launched_group, make_local_mesh, mesh_axes, world_rank,
                   world_size)

__all__ = ["dp_axes", "join_launched_group", "make_local_mesh", "mesh_axes", "world_rank",
           "world_size"]
