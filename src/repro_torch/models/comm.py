"""Collectives over one axis of a mesh, with autograd (what GSPMD and the
reference's `shard_map` bodies insert, written out).

Gradients follow one convention throughout the LM stack: a block that a
rank holds alone (a slice of the sequence, of the heads, of the vocabulary)
carries its own gradient; a tensor replicated over the axis carries on
each rank a *share* of its gradient, the shares summing to the whole.  So
every collective's backward is its exact transpose:

  all_gather ↔ reduce_scatter, all_reduce ↔ all_reduce,

and a slice of a replicated tensor needs no collective at all (its
backward pads the block with zeros).  The loss, replicated over `model`,
is differentiated with a seed of 1/n_model, and a leaf replicated over an
axis has its gradient shares summed over that axis after the backward
(`launch.steps.make_train_step`).

Each collective is recorded, while `record()` is open, as {op, bytes,
group} in HLO's spelling (`roofline.collectives.collective_bytes` turns
the log into wire bytes).  A group of one rank is no collective: every
function returns its input.  A `DryGroup` stands for a group of ranks
that do not exist: its collectives move nothing, give results of the
right shape (meta tensors in, meta tensors out) and are recorded, which
is how `launch.dryrun` reads the port's collective schedule at production
mesh sizes.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

__all__ = ["all_gather", "reduce_scatter", "all_reduce", "all_reduce_max", "gather_block",
           "sum_", "record", "LOG", "DryGroup"]

#: The collectives run while `record()` is open ({op, bytes, group} each).
LOG: list[dict] | None = None


@contextlib.contextmanager
def record():
    """Logs every collective run inside the block into the list it yields."""
    global LOG
    prev, LOG = LOG, []
    try:
        yield LOG
    finally:
        LOG = prev


class DryGroup:
    """A process group of `size` ranks that is never joined."""

    def __init__(self, size: int):
        self.size = size


def _size(group) -> int:
    if group is None:
        return 1
    return group.size if isinstance(group, DryGroup) else dist.get_world_size(group)


def _log(op: str, t: torch.Tensor, group) -> None:
    if LOG is not None:
        LOG.append({"op": op, "bytes": t.numel() * t.element_size(), "group": _size(group)})


def gather_block(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' blocks of x concatenated along `dim`, in rank order."""
    n = _size(group)
    if n == 1:
        return x
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((n * xm.shape[0], *xm.shape[1:]))
    if not isinstance(group, DryGroup):
        dist.all_gather_into_tensor(out, xm, group=group)
    _log("all-gather", out, group)
    return out.movedim(0, dim).contiguous()


def _scatter_block(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over the ranks of x, this rank's block of `dim`."""
    n = _size(group)
    xm = x.movedim(dim, 0).contiguous()
    if xm.shape[0] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n} ranks")
    out = xm.new_empty((xm.shape[0] // n, *xm.shape[1:]))
    if not isinstance(group, DryGroup):
        dist.reduce_scatter_tensor(out, xm, group=group)
    _log("reduce-scatter", out, group)
    return out.movedim(0, dim).contiguous()


def sum_(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over the group's ranks in place (no autograd); returns x."""
    if _size(group) > 1:
        if not isinstance(group, DryGroup):
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        _log("all-reduce", x, group)
    return x


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    return sum_(x.contiguous().clone(), group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return gather_block(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter_block(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _scatter_block(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return gather_block(g, ctx.dim, ctx.group), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Blocks along `dim` → the whole on every rank (backward: reduce-scatter)."""
    return x if _size(group) == 1 else _AllGather.apply(x, dim, group)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Partial sums → this rank's block of the sum along `dim` (backward:
    all-gather)."""
    return x if _size(group) == 1 else _ReduceScatter.apply(x, dim, group)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Partial sums → the sum on every rank (backward: all-reduce)."""
    return x if _size(group) == 1 else _AllReduce.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum over the ranks (no gradient)."""
    if _size(group) == 1:
        return x
    out = x.detach().contiguous().clone()
    if not isinstance(group, DryGroup):
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    _log("all-reduce", out, group)
    return out
