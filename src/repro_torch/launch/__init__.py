"""Process groups and device meshes for the port's multi-rank path."""
from .mesh import make_local_mesh, mesh_axes, world_rank, world_size

__all__ = ["make_local_mesh", "mesh_axes", "world_rank", "world_size"]
