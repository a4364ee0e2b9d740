"""Logical-axis → mesh placement (counterpart of `repro.launch.shardings`).

Params carry logical axis names from init ("embed", "heads", "ffn",
"vocab", "expert", "expert_ffn", "inner"); this module resolves them
against a mesh with the reference's rule: each mesh axis goes to the first
dim that names it and divides by its size, and a dim that does not divide
falls back to replication (whisper's vocabulary of 51,865 leaves its
unembed replicated on a model axis of 16).

A resolved spec is a per-dim tuple, as a `PartitionSpec` is: a mesh axis
name, a tuple of names, or None.  Every function here resolves against a
`DeviceMesh` or against a mapping of axis sizes ({"data": 16, "model":
16}), so the production (16, 16) and (2, 16, 16) meshes resolve without
256 ranks.  The port keeps layers unstacked: a layer's specs are the
reference's stacked ones with the leading repeat axis dropped, and a
decode cache's likewise.

`shard_tree` cuts this rank's block of every leaf of a whole tree,
`gather_tree` puts the whole tree back together on every rank (both over
the mesh's process groups); checkpoints, weight carry-over and the tests
use them.
"""
from __future__ import annotations

import math
from typing import Mapping

import torch

from .mesh import mesh_axes

__all__ = ["LOGICAL_RULES", "param_shardings", "opt_shardings", "batch_shardings",
           "cache_shardings", "init_shapes", "shard_tree", "gather_tree", "block_slices",
           "block_shape", "block_count", "replication", "sharded_axes", "whole_shapes",
           "leaves_with_paths", "map_with_specs", "mesh_sizes"]

LOGICAL_RULES = {
    "embed": "data",        # FSDP
    "heads": "model",       # TP
    "ffn": "model",
    "vocab": "model",
    "expert": "model",      # EP (the paper's rank-axis analogue)
    "expert_ffn": "data",   # FSDP inside the MoE body
    "inner": "model",       # mamba/xlstm inner dim
}


def mesh_sizes(mesh) -> dict:
    """{axis: size} of a DeviceMesh or of a mapping of sizes."""
    return dict(mesh) if isinstance(mesh, Mapping) else mesh_axes(mesh)


_sizes = mesh_sizes


def _axis_size(mesh, axis) -> int:
    sizes = _sizes(mesh)
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def _resolve(mesh, shape, logical_axes) -> tuple:
    spec, used = [], set()
    for dim, ax in zip(shape, logical_axes, strict=True):
        mesh_ax = LOGICAL_RULES.get(ax) if ax is not None else None
        if (mesh_ax is not None and mesh_ax not in used
                and dim % _axis_size(mesh, mesh_ax) == 0):
            spec.append(mesh_ax)
            used.add(mesh_ax)
        else:
            spec.append(None)
    return tuple(spec)


def _is_axes(x) -> bool:
    """Whether x is a spec: a tuple of axis names, tuples of them, or None."""
    return isinstance(x, tuple) and all(
        a is None or isinstance(a, str)
        or (isinstance(a, tuple) and all(isinstance(n, str) for n in a)) for a in x)


def _map2(fn, tree, other):
    """fn(leaf, other's entry at its place) over `tree`'s dicts and lists;
    `other`'s leaves may be axis tuples."""
    if isinstance(tree, dict):
        return {k: _map2(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_axes(tree):
        return type(tree)(_map2(fn, v, o) for v, o in zip(tree, other, strict=True))
    return fn(tree, other)


def leaves_with_paths(tree, path=()):
    """(path, leaf) pairs, paths of dict keys and list indices from the
    root, in `nn.tree_leaves`' order (dict keys sorted); an axis tuple is
    a leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)) and not _is_axes(tree):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, path + (i,))
    else:
        yield path, tree


def _map_paths(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_paths(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def param_shardings(mesh, param_structs, spec_tree):
    """The resolved spec of every param (spec_tree's leaves are tuples of
    logical axis names, one per dim)."""
    def leaf(struct, axes):
        assert len(axes) == struct.dim(), (tuple(struct.shape), axes)
        return _resolve(mesh, tuple(struct.shape), axes)
    return _map2(leaf, param_structs, spec_tree)


def opt_shardings(mesh, opt_structs, param_sh):
    """Optimizer state mirrors the param shardings; 8-bit `q`/`s` leaves
    take the param's axis dim by dim where their own dim still divides, and
    the step counter is replicated."""
    flat_p = dict(leaves_with_paths(param_sh))

    def leaf(path, struct):
        inner = path[1:]  # ("m", <param path...>) or ("m", ..., "q"/"s")
        shape = tuple(struct.shape)
        if inner and inner[-1] in ("q", "s"):
            psh = flat_p.get(inner[:-1])
            spec = [None] * len(shape)
            if psh is not None:
                for i, dim in enumerate(shape):
                    ax = psh[i] if i < len(psh) else None
                    if ax is not None and dim % _axis_size(mesh, ax) == 0:
                        spec[i] = ax
            return tuple(spec)
        sh = flat_p.get(inner)
        if sh is not None and len(sh) == len(shape):
            return sh
        return (None,) * len(shape)
    return _map_paths(leaf, opt_structs)


def _dp(sizes) -> tuple:
    """The batch-parallel axes, pod (if present) and data."""
    return tuple(a for a in ("pod", "data") if a in sizes)


def _entry(axes: tuple):
    """A spec entry as `PartitionSpec` keeps it: one axis by its name."""
    return axes[0] if len(axes) == 1 else axes


def batch_shardings(mesh, batch_structs):
    """Rows over the batch-parallel axes where they divide."""
    sizes = _sizes(mesh)
    dp = _dp(sizes)

    def leaf(path, struct):
        spec = [None] * struct.dim()
        if struct.dim() and struct.shape[0] % _axis_size(mesh, dp) == 0:
            spec[0] = _entry(dp)
        return tuple(spec)
    return _map_paths(leaf, batch_structs)


def cache_shardings(mesh, cache_structs, *, long_context: bool = False):
    """The reference's decode-cache placement for the port's per-layer
    caches (B, ...): KV rows over the batch-parallel axes and the sequence
    over `model` (over `data` and `model` for the batch-1 long-context
    shape); cross keys and values likewise; recurrent states their inner
    dim over `model`.  (The port's head-parallel decode holds its KV heads
    instead: the same bytes a rank, see `models.attention.head_plan`.)"""
    sizes = _sizes(mesh)
    dp = _dp(sizes)

    def leaf(path, struct):
        names = [k for k in path if isinstance(k, str)]
        shape = tuple(struct.shape)
        spec = [None] * len(shape)
        batch_ok = len(shape) > 0 and shape[0] % _axis_size(mesh, dp) == 0
        if "kv" in names and names[-1] in ("k", "v", "pos"):
            if batch_ok and not long_context:
                spec[0] = _entry(dp)
            seq_axes = ("data", "model") if long_context else ("model",)
            if shape[1] % _axis_size(mesh, seq_axes) == 0:
                spec[1] = seq_axes if long_context else "model"
        elif names[-1] in ("xk", "xv"):
            if batch_ok:
                spec[0] = _entry(dp)
            if shape[1] % sizes.get("model", 1) == 0:
                spec[1] = "model"
        else:
            if batch_ok:
                spec[0] = _entry(dp)
            if len(shape) > 1 and shape[1] % sizes.get("model", 1) == 0:
                spec[1] = "model"
        return tuple(spec)
    return _map_paths(leaf, cache_structs)


def init_shapes(lm):
    """(param meta tensors, logical spec tree) without allocating."""
    from ..models.nn import SHAPES
    return lm.init(SHAPES)


# ---------------------------------------------------------------------------
# Blocks of a mesh's ranks
# ---------------------------------------------------------------------------

def sharded_axes(spec) -> tuple[str, ...]:
    """The mesh axes a resolved spec shards over."""
    out = []
    for ax in spec:
        out += list(ax) if isinstance(ax, tuple) else ([] if ax is None else [ax])
    return tuple(out)


def block_count(mesh, spec) -> int:
    """How many blocks `spec` cuts a leaf into."""
    return math.prod(_axis_size(mesh, a) for a in sharded_axes(spec))


def block_shape(shape, spec, mesh) -> tuple:
    """The shape of a rank's block of a leaf of `shape`."""
    return tuple(d // _axis_size(mesh, ax) for d, ax in zip(shape, spec, strict=True))


def whole_shapes(tree, specs, mesh):
    """Meta tensors of the whole leaves whose blocks `tree` holds."""
    def leaf(a, spec):
        shape = tuple(d * _axis_size(mesh, ax) for d, ax in zip(a.shape, spec, strict=True))
        return torch.empty(shape, dtype=a.dtype, device="meta")
    return _map2(leaf, tree, specs)


def map_with_specs(fn, tree, specs):
    """fn(path, leaf, spec) over a tree and its spec tree."""
    flat = dict(leaves_with_paths(specs))
    return _map_paths(lambda path, a: fn(path, a, flat[path]), tree)


def replication(mesh, spec) -> int:
    """How many ranks hold each block of a leaf placed by `spec`."""
    used = set(sharded_axes(spec))
    return math.prod(n for a, n in _sizes(mesh).items() if a not in used)


def _coord(mesh, axes) -> int:
    """This rank's index along `axes` (row-major over a tuple of axes)."""
    sizes = _sizes(mesh)
    idx = 0
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        idx = idx * sizes[a] + mesh.get_local_rank(a)
    return idx


def block_slices(mesh, shape, spec) -> tuple[slice, ...]:
    """The slices of a leaf of `shape` that this rank holds under `spec`."""
    out = []
    for dim, ax in zip(shape, spec, strict=True):
        if ax is None:
            out.append(slice(None))
            continue
        n = _axis_size(mesh, ax)
        step = dim // n
        i = _coord(mesh, ax)
        out.append(slice(i * step, (i + 1) * step))
    return tuple(out)


def shard_tree(tree, specs, mesh):
    """This rank's block of every leaf of a whole tree (None specs: the
    leaf as it is), each a contiguous copy so that the whole can be freed."""
    def leaf(a, spec):
        if spec is None or not sharded_axes(spec):
            return a
        return a[block_slices(mesh, tuple(a.shape), spec)].clone()
    return _map2(leaf, tree, specs)


def gather_tree(tree, specs, mesh):
    """The whole of every leaf on every rank: each block all-gathered over
    the axes its spec shards (no autograd)."""
    from ..models import comm

    def leaf(a, spec):
        if spec is None:
            return a
        for d, ax in enumerate(spec):
            for name in reversed(ax if isinstance(ax, tuple) else (ax,) if ax else ()):
                a = comm.gather_block(a, d, mesh.get_group(name))
        return a
    return _map2(leaf, tree, specs)
