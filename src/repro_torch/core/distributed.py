"""Distributed spMTTKRP over a (data, model) mesh of `torch.distributed`
ranks (paper §IV-B; counterpart of `repro.core.distributed`).

The reference maps the paper's partitioning hierarchy onto `shard_map`
axes; here the same mapping runs SPMD, one rank per mesh member:

  * rank partitioning       → factor matrices split on the R axis over the
                              `model` axis: this rank takes its R/n_model
                              contiguous columns, and the kernel needs no
                              collective.  The tensor (tasks) is replicated
                              across `model` and stays resident across
                              CP-ALS iterations.
  * dimension-size + nonzero partitioning
                            → the task axis split over `data`: each rank
                              holds one contiguous block of the
                              `shard_chunked` tasks and computes its
                              chunk-local partials; the paper's host-side sum
                              becomes an `all_reduce` over `data` ("psum",
                              paper-faithful) or a reduce-scatter of row
                              blocks ("psum_scatter", (g-1)/g of the bytes).

The reference returns a global array; the port's counterpart is the full
(I_mode, R) result on every rank, gathered over `model` for the columns
and, after a reduce-scatter, over `data` for the row blocks.

One deliberate deviation: the reference's shard body runs the plain
chunked op; on a CUDA rank the body runs that op's counterpart, the
hand-written float kernel (`kernels.ops.mttkrp_kernel_op`), and on the
CPU the plain `mttkrp_chunked`.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .chunking import ChunkedTensor
from .mttkrp import mttkrp_chunked

__all__ = ["DistributedMTTKRP", "distributed_mttkrp_fn", "shard_chunked"]

REDUCTIONS = ("psum", "psum_scatter")
_FIELDS = ("task_chunk", "coords_rel", "values", "nnz_per_task")


def shard_chunked(ct: ChunkedTensor, n_data: int) -> ChunkedTensor:
    """Pad the task axis so it splits evenly over the data axis."""
    return ct.pad_tasks(n_data)


def _pad_dim(d: int, mult: int) -> int:
    return -(-d // mult) * mult


def _renamed(new: str, old: str):
    """`torch.distributed.<new>`, or `<old>` on a torch from before the
    rename (reduce_scatter_tensor and all_gather_into_tensor became
    reduce_scatter_single and all_gather_single)."""
    return getattr(dist, new, None) or getattr(dist, old)


class _Axis:
    """One mesh axis as this rank sees it: size, own coordinate, group."""

    def __init__(self, mesh, name: str):
        if name not in mesh.mesh_dim_names:
            raise ValueError(f"mesh has no axis {name!r}; axes: {mesh.mesh_dim_names}")
        self.size = mesh.size(mesh.mesh_dim_names.index(name))
        self.index = mesh.get_local_rank(name)
        self.group = mesh.get_group(name)


def _record(log, op: str, out: torch.Tensor, axis: _Axis) -> None:
    if log is not None:
        log.append({"op": op, "bytes": out.numel() * out.element_size(), "group": axis.size})


def distributed_mttkrp_fn(
    mesh,
    *,
    mode: int,
    chunk_shape: tuple[int, ...],
    out_dim: int,
    data_axis: str = "data",
    model_axis: str = "model",
    reduce: str = "psum_scatter",
    log: list | None = None,
):
    """Build one rank's distributed MTTKRP body.

    fn(factors, task_chunk, coords_rel, values, nnz_per_task=None) takes
    this rank's shards — factors (I_m, R/n_model) f32 contiguous (its
    columns), and its task block: task_chunk (T/n_data, N), coords_rel
    (T/n_data, P, N), values (T/n_data, P), nnz_per_task (T/n_data,) —
    and returns its block of the output: all _pad_dim(out_dim, n_data)
    rows for "psum", one row block of them for "psum_scatter", in its
    columns.  The second value names the mesh axes that split the rows
    and columns (the reference's out PartitionSpec).  Each collective is
    appended to `log` as {op, bytes (of its result), group (size)}.
    """
    if reduce not in REDUCTIONS:
        raise ValueError(f"reduce must be one of {REDUCTIONS}; got {reduce!r}")
    data = _Axis(mesh, data_axis)
    rows = _pad_dim(out_dim, data.size)

    def body(factors, task_chunk, coords_rel, values, nnz_per_task=None):
        # Both ops return all `rows` rows, also past the chunk-padded count
        # (42 rows in chunks of 6 over 4 data ranks want 44): the kernel op
        # pads the requested rows, not the tensor's, to whole chunks.
        if task_chunk.is_cuda:
            from ..kernels import ops as kops  # the kernels package imports core
            local = kops.mttkrp_kernel_op(factors, task_chunk, coords_rel, values, mode=mode,
                                          chunk_shape=chunk_shape, out_dim=rows,
                                          nnz_per_task=nnz_per_task)
        else:
            local = mttkrp_chunked(factors, task_chunk, coords_rel, values, mode=mode,
                                   chunk_shape=chunk_shape, out_dim=rows)
        if reduce == "psum":
            dist.all_reduce(local, group=data.group)
            _record(log, "all-reduce", local, data)
            return local
        # Each data rank ends up owning a contiguous row block: the bytes
        # on the wire drop from 2·(g-1)/g·|out| (all-reduce) to (g-1)/g·|out|.
        block = local.new_empty((rows // data.size, local.shape[1]))
        reduce_scatter = _renamed("reduce_scatter_single", "reduce_scatter_tensor")
        reduce_scatter(block, local, group=data.group)
        _record(log, "reduce-scatter", block, data)
        return block

    out_layout = (data_axis, model_axis) if reduce == "psum_scatter" else (None, model_axis)
    return body, out_layout


def _task_block(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Tasks [lo, hi) of `x`, with zero padding tasks past its end (those of
    `shard_chunked`), without padding the rest of the tensor."""
    part = x[lo:min(hi, x.shape[0])]
    short = hi - lo - part.shape[0]
    if short == 0:
        return part
    return torch.cat([part, part.new_zeros((short, *x.shape[1:]))])


class DistributedMTTKRP:
    """Places this rank's task block and column range once, then serves
    per-mode MTTKRP calls (CP-ALS engine compatible): `self(factors, mode)`
    takes the full (I_m, R) factors and returns the full (I_mode, R) result
    on every rank.

    `arrays` — the chunked tensor's arrays already resident on this rank's
    device (`chunked_device_arrays`, e.g. from a PlanCache): the task block
    is cut from them instead of moved from the host again.  `log` holds
    every collective run so far ({op, bytes, group};
    `repro_torch.roofline.collective_bytes` reads it)."""

    def __init__(self, mesh, ct: ChunkedTensor, rank: int,
                 data_axis: str = "data", model_axis: str = "model",
                 reduce: str = "psum_scatter", *, arrays: dict | None = None):
        if reduce not in REDUCTIONS:
            raise ValueError(f"reduce must be one of {REDUCTIONS}; got {reduce!r}")
        self.mesh = mesh
        self.data_axis, self.model_axis, self.reduce = data_axis, model_axis, reduce
        self.data, self.model = _Axis(mesh, data_axis), _Axis(mesh, model_axis)
        if rank % self.model.size:
            raise ValueError(f"rank {rank} does not split over {self.model.size} "
                             f"`{model_axis}` ranks")
        self.ct, self.rank = ct, rank
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if mesh.device_type == "cuda" else torch.device(mesh.device_type))
        width = rank // self.model.size
        self.columns = slice(self.model.index * width, (self.model.index + 1) * width)
        n_tasks = -(-ct.num_tasks // self.data.size)
        lo = self.data.index * n_tasks
        src = arrays if arrays is not None else {
            k: torch.from_numpy(getattr(ct, k)) for k in _FIELDS}
        self.arrays = {k: _task_block(src[k], lo, lo + n_tasks).to(self.device)
                       for k in _FIELDS}
        self.log: list[dict] = []
        self._fns: dict = {}

    def __call__(self, factors, mode: int) -> torch.Tensor:
        out_dim = self.ct.tensor_shape[mode]
        if mode not in self._fns:
            self._fns[mode] = distributed_mttkrp_fn(
                self.mesh, mode=mode, chunk_shape=self.ct.chunk_shape, out_dim=out_dim,
                data_axis=self.data_axis, model_axis=self.model_axis, reduce=self.reduce,
                log=self.log)[0]
        # The float kernel refuses strided factors: the column slice is
        # made contiguous (a no-op at one `model` rank).
        local = [f.to(self.device)[:, self.columns].contiguous() for f in factors]
        a = self.arrays
        out = self._fns[mode](local, a["task_chunk"], a["coords_rel"], a["values"],
                              a["nnz_per_task"])
        if self.reduce == "psum_scatter":
            out = self._gather(out, self.data)
        rows, width = out.shape
        # (n_model·rows, width) stacked blocks → (rows, R): a view at one
        # `model` rank, one copy otherwise.
        out = self._gather(out, self.model).view(self.model.size, rows, width)
        return out.permute(1, 0, 2).reshape(rows, self.rank)[:out_dim]

    def _gather(self, x: torch.Tensor, axis: _Axis) -> torch.Tensor:
        """Rows of `x` from every rank of `axis`, stacked in axis order."""
        out = x.new_empty((axis.size * x.shape[0], *x.shape[1:]))
        _renamed("all_gather_single", "all_gather_into_tensor")(out, x, group=axis.group)
        _record(self.log, "all-gather", out, axis)
        return out
