"""Train and serve step builders and the greedy generation loop
(counterpart of `repro.launch.steps`)."""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..data.pipeline import host_shard_slice
from ..models import LM, MeshCtx
from ..models.nn import tree_leaves, tree_map, tree_unflatten
from ..optim import AdamWConfig, adamw_init, adamw_update
from .mesh import dp_axes, mesh_axes

__all__ = ["make_ctx", "make_train_step", "make_prefill_step", "make_decode_step",
           "init_opt_shapes", "generate"]


def make_ctx(mesh, *, seq_sharded: bool = True) -> MeshCtx:
    return MeshCtx(mesh=mesh, dp=dp_axes(mesh), tp="model", seq_sharded=seq_sharded)


def _data_axis(ctx: MeshCtx):
    """(group, size, this rank's coordinate) of the mesh's data axis; no
    group without a mesh or on one data rank."""
    n = 1 if ctx.mesh is None else mesh_axes(ctx.mesh).get("data", 1)
    if n == 1:
        return None, 1, 0
    return ctx.mesh.get_group("data"), n, ctx.mesh.get_local_rank("data")


def _mean_over(group, n: int, tensors) -> None:
    """Each tensor summed over the group's ranks, then divided by n, in place."""
    for t in tensors:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        t.div_(n)


def make_train_step(lm: LM, ctx: MeshCtx, opt_cfg: AdamWConfig, *, grad_accum: int = 1):
    """Full step: forward, backward, AdamW.  `train_step(params, opt_state,
    batch)` takes the global batch; on a (n_data, 1) mesh each rank runs
    its `host_shard_slice` of it and the gradients and the loss are
    averaged over the data ranks before the update.  With `grad_accum` > 1
    the rank's rows run as that many microbatches in turn, their float32
    gradients summed and divided by `grad_accum`, the loss their mean.
    Returns `(params, opt_state, loss)`, params and state updated in place
    (`adamw_update`) and the loss a 0-d tensor on the params' device; the
    step never waits on the host."""
    group, n_data, coord = _data_axis(ctx)

    def train_step(params, opt_state, batch):
        rows = next(iter(batch.values())).shape[0]
        if rows % (n_data * grad_accum):
            raise ValueError(f"a batch of {rows} rows does not split into {n_data} data ranks "
                             f"× {grad_accum} microbatches")
        shard = host_shard_slice(rows, n_data, coord)
        micro = (shard.stop - shard.start) // grad_accum
        tracked = tree_map(lambda a: a.detach().requires_grad_(), params)
        leaves = tree_leaves(tracked)
        gsum, losses = None, []
        for k in range(grad_accum):
            start = shard.start + k * micro
            mb = {key: a[start:start + micro] for key, a in batch.items()}
            loss = lm.loss(tracked, ctx, mb)
            grads = torch.autograd.grad(loss, leaves)
            losses.append(loss.detach())
            if gsum is None:
                gsum = [g.float() for g in grads]
            else:
                for acc, g in zip(gsum, grads, strict=True):
                    acc.add_(g)
            del grads
        if grad_accum > 1:
            for g in gsum:
                g.div_(grad_accum)
        loss = losses[0] if grad_accum == 1 else torch.stack(losses).mean()
        if group is not None:
            _mean_over(group, n_data, [*gsum, loss])
        params, opt_state = adamw_update(tree_unflatten(params, gsum), opt_state, params,
                                         opt_cfg)
        return params, opt_state, loss

    return train_step


def make_prefill_step(lm: LM, ctx: MeshCtx):
    def prefill_step(params, batch):
        return lm.prefill(params, ctx, batch)
    return prefill_step


def make_decode_step(lm: LM, ctx: MeshCtx):
    def decode_step(params, token, cache, pos):
        return lm.decode_step(params, ctx, token, cache, pos)
    return decode_step


def init_opt_shapes(param_structs, opt_cfg: AdamWConfig) -> dict:
    """The optimizer state's tree, shapes and dtypes as meta tensors, for
    params (or their meta structs, `LM.init(nn.SHAPES)`): allocates nothing."""
    return adamw_init(tree_map(lambda a: torch.empty_like(a, device="meta"), param_structs),
                      opt_cfg)


@torch.no_grad()
def generate(lm: LM, params, ctx, prompts: torch.Tensor, gen: int,
             max_len: int | None = None) -> torch.Tensor:
    """Prefill by teacher-forced decode of the prompt (B, S), then `gen`
    greedy tokens (the first maximum), on the device of `prompts`, against
    a float32 cache.  Returns (B, gen) int32 on that device; the loop never
    waits on the host."""
    b, s = prompts.shape
    max_len = max_len or (s + gen + 8)
    cache = lm.init_cache(b, max_len=max_len, dtype=torch.float32, device=prompts.device)
    step = make_decode_step(lm, ctx)
    tok = prompts[:, :1]
    out = []
    for t in range(s + gen - 1):
        logits, cache = step(params, tok, cache, t)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        if t + 1 < s:
            tok = prompts[:, t + 1:t + 2]  # teacher forcing over the prompt
        else:
            tok = nxt
            out.append(nxt)
    return torch.cat(out, dim=1)
