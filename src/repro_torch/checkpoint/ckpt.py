"""Checkpoint and restore (counterpart of `repro.checkpoint.ckpt`), in the
reference's format on disk.

Layout: `<dir>/step_<N:08d>/arrays.npz` (keys `a0`, `a1`, ... over the
tree's leaves in JAX's order: dict keys sorted, lists in order) and
`meta.json`, with a `COMMITTED` marker written last: a checkpoint whose
writer died half way is never restored.  A tree of plain dicts written by
either package therefore restores in the other.  `AsyncCheckpointer`
writes on a background thread while training goes on.

Restore is elastic: the arrays are read on the host and placed on the
device the caller names, in the structure and dtypes of a like-tree (meta
tensors will do), so a run can resume on another number of ranks
(`repro_torch.launch.elastic`).  Under a group of more than one rank only
rank 0 writes.  On a mesh (`shardings` and `mesh` given: the tree's
resolved specs) the file holds the host layout, the whole arrays, as the
reference's does: each leaf is gathered over the ranks, one at a time, and
rank 0 writes; a restore cuts every rank's block from the whole arrays.
"""
from __future__ import annotations

import json
import os
import threading

import numpy as np
import torch

from ..device import resolve_device
from ..launch.mesh import world_rank
from ..models.nn import tree_leaves, tree_map, tree_unflatten

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "AsyncCheckpointer"]

_COMMIT = "COMMITTED"


def _step_dir(path: str, step: int) -> str:
    return os.path.join(path, f"step_{step:08d}")


def _host(a) -> np.ndarray:
    """A host copy of a leaf (a copy on the CPU too: the caller may change
    the tensor at once)."""
    if isinstance(a, torch.Tensor):
        # repro-lint: disable=host-sync -- a checkpoint is a host copy: the one deliberate readout
        return a.detach().to("cpu", copy=True).numpy()
    return np.array(a)


def _treedef(tree) -> str:
    """The tree's structure, leaves shown as `*` (meta.json's record; a
    restore reads only the arrays)."""
    return str(tree_map(lambda a: None if a is None else "*", tree))


def _write(path: str, step: int, leaves: list[np.ndarray], treedef: str) -> str:
    d = _step_dir(path, step)
    os.makedirs(d, exist_ok=True)
    np.savez(os.path.join(d, "arrays.npz"), **{f"a{i}": a for i, a in enumerate(leaves)})
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump({"step": step, "n_leaves": len(leaves), "treedef": treedef}, f)
    with open(os.path.join(d, _COMMIT), "w") as f:
        f.write("ok")
    return d


def _host_leaves(tree, shardings, mesh) -> list[np.ndarray] | None:
    """The whole leaves as host arrays on rank 0 (None on the others),
    each leaf gathered over the mesh in turn when `shardings` is given."""
    if shardings is None:
        return [_host(a) for a in tree_leaves(tree)] if world_rank() == 0 else None
    from ..launch.shardings import gather_tree, leaves_with_paths
    specs = [s for _, s in leaves_with_paths(shardings)]
    out = []
    for a, spec in zip(tree_leaves(tree), specs, strict=True):
        whole = gather_tree(a, spec, mesh)
        if world_rank() == 0:
            out.append(_host(whole))
        del whole
    return out if world_rank() == 0 else None


def save_checkpoint(path: str, step: int, tree, *, shardings=None, mesh=None) -> str:
    """Write `tree` (tensors or numpy arrays) as step `step`; returns its
    directory.  Only rank 0 of a group writes; with `shardings` (the
    tree's specs on `mesh`) every rank takes part in gathering the whole
    leaves first."""
    leaves = _host_leaves(tree, shardings, mesh)
    if leaves is None:
        return _step_dir(path, step)
    return _write(path, step, leaves, _treedef(tree))


def latest_step(path: str) -> int | None:
    """The highest committed step under `path`, or None."""
    if not os.path.isdir(path):
        return None
    steps = [int(name.split("_")[1]) for name in os.listdir(path)
             if name.startswith("step_") and os.path.exists(os.path.join(path, name, _COMMIT))]
    return max(steps) if steps else None


def restore_checkpoint(path: str, step: int, like_tree, device: str | torch.device | None = None,
                       *, shardings=None, mesh=None):
    """Step `step` in the structure of `like_tree`, every leaf on `device`
    (None → the CUDA card) with the like-tree's dtype and shape; a leaf of
    another dtype or shape, a count of leaves that differs, or an
    uncommitted step raises.  With `shardings` (specs of the whole tree on
    `mesh`) each leaf is this rank's block of the whole array."""
    device = resolve_device(device)
    d = _step_dir(path, step)
    if not os.path.exists(os.path.join(d, _COMMIT)):
        raise FileNotFoundError(f"uncommitted checkpoint {d}")
    like = tree_leaves(like_tree)
    if shardings is not None:
        from ..launch.shardings import block_slices, leaves_with_paths
        specs = [s for _, s in leaves_with_paths(shardings)]
    out = []
    with np.load(os.path.join(d, "arrays.npz")) as data:
        if len(data.files) != len(like):
            raise ValueError(f"{d} holds {len(data.files)} arrays; the tree has {len(like)} leaves")
        for i, want in enumerate(like):
            a = data[f"a{i}"]
            t = torch.from_numpy(a)
            if t.dtype != want.dtype or tuple(t.shape) != tuple(want.shape):
                raise ValueError(f"{d} leaf {i}: {t.dtype} {tuple(t.shape)}, the tree wants "
                                 f"{want.dtype} {tuple(want.shape)}")
            if shardings is not None:
                t = t[block_slices(mesh, tuple(t.shape), specs[i])].clone()
            out.append(t.to(device).contiguous())
    return tree_unflatten(like_tree, out)


class AsyncCheckpointer:
    """Saves on a background thread (last write wins).  `save` copies the
    tree to host arrays first, so training may change it at once."""

    def __init__(self, path: str):
        self.path = path
        self._thread: threading.Thread | None = None

    def save(self, step: int, tree, *, shardings=None, mesh=None) -> None:
        """`shardings` and `mesh` as `save_checkpoint`'s: the gather runs
        before this returns, the write in the background."""
        leaves = _host_leaves(tree, shardings, mesh)  # the snapshot, before the thread
        if leaves is None:
            return
        self.wait()
        self._thread = threading.Thread(target=_write,
                                        args=(self.path, step, leaves, _treedef(tree)))
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
