"""Train and serve step builders and the greedy generation loop
(counterpart of `repro.launch.steps`)."""
from __future__ import annotations

import torch

from ..data.pipeline import host_shard_slice
from ..models import LM, MeshCtx, comm
from ..models.nn import tree_leaves, tree_map, tree_unflatten
from ..optim import AdamWConfig, adamw_init, adamw_update
from .mesh import dp_axes
from .shardings import (init_shapes, leaves_with_paths, opt_shardings, param_shardings,
                        sharded_axes)

__all__ = ["make_ctx", "make_grad_step", "make_train_step", "make_prefill_step",
           "make_decode_step", "init_opt_shapes", "generate", "param_specs", "state_shardings"]


def make_ctx(mesh, *, seq_sharded: bool = True) -> MeshCtx:
    return MeshCtx(mesh=mesh, dp=dp_axes(mesh), tp="model", seq_sharded=seq_sharded)


def _data_axis(ctx: MeshCtx):
    """(group, size, this rank's coordinate) of the mesh's data axis; no
    group without a mesh or on one data rank."""
    n = ctx.size("data")
    if n == 1:
        return None, 1, 0
    return ctx.group("data"), n, ctx.coord("data")


def _sum_over(group, tensors) -> None:
    """Each tensor (float32) summed over the group's ranks in place, in one
    collective: the tensors flattened into one buffer."""
    if group is None or not tensors:
        return
    flat = comm.sum_(torch.cat([t.reshape(-1) for t in tensors]), group)
    for t, part in zip(tensors, torch.split(flat, [t.numel() for t in tensors]), strict=True):
        t.copy_(part.view_as(t))


def param_specs(lm: LM, ctx: MeshCtx):
    """The resolved specs of lm's params on ctx's mesh (None without one)."""
    if ctx.mesh is None:
        return None
    return param_shardings(ctx.mesh, *init_shapes(lm))


def state_shardings(lm: LM, mesh, opt_cfg: AdamWConfig) -> dict:
    """The resolved specs of a `{"params", "opt"}` training state on `mesh`
    (for `save_checkpoint` and `restore_checkpoint`)."""
    structs, specs = init_shapes(lm)
    p_sh = param_shardings(mesh, structs, specs)
    return {"params": p_sh,
            "opt": opt_shardings(mesh, init_opt_shapes(structs, opt_cfg), p_sh)}


def make_grad_step(lm: LM, ctx: MeshCtx, *, grad_accum: int = 1):
    """`grad_step(params, batch) -> (loss, grads)` of the global batch: on a
    (n_data, n_model) mesh the params are the rank's blocks
    (`launch.shardings`).  As the reference's step, the batch is cut into
    `grad_accum` microbatches of consecutive rows, run in turn, their
    float32 gradients summed and divided by `grad_accum` and the loss
    their mean; each data rank runs its `host_shard_slice` of each
    microbatch (the reference's batch sharding of it), and the model ranks
    of a data rank run those rows together.

    The loss, replicated over `model`, is differentiated with a seed of
    1/n_model (`models.comm`: each rank's gradient of a replicated tensor
    is its share); a leaf's gradient is then summed over each axis the
    leaf is not split over (the norms, the router and the biases applied
    to split rows, every leaf over `data` that FSDP does not shard: a
    sharded one was summed by the reduce-scatter that is its gather's
    backward) and divided by n_data.  Returns the loss (a 0-d tensor, the
    mean over the data ranks) and the float32 gradients of the rank's
    blocks in the params' structure; nothing waits on the host."""
    group, n_data, coord = _data_axis(ctx)
    specs = param_specs(lm, ctx)
    flat_specs = None if specs is None else [s for _, s in leaves_with_paths(specs)]
    n_model = ctx.size(ctx.tp)

    def grad_step(params, batch):
        rows = next(iter(batch.values())).shape[0]
        if rows % (n_data * grad_accum):
            raise ValueError(f"a batch of {rows} rows does not split into {n_data} data ranks "
                             f"× {grad_accum} microbatches")
        per = rows // grad_accum
        mine = host_shard_slice(per, n_data, coord)
        tracked = tree_map(lambda a: a.detach().requires_grad_(), params)
        leaves = tree_leaves(tracked)
        gsum, losses = None, []
        for k in range(grad_accum):
            start, stop = k * per + mine.start, k * per + mine.stop
            mb = {key: a[start:stop] for key, a in batch.items()}
            loss = lm.loss(tracked, ctx, mb)
            seed = None if n_model == 1 else torch.full_like(loss, 1.0 / n_model)
            grads = torch.autograd.grad(loss, leaves, grad_outputs=seed)
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
        if flat_specs is None:
            _sum_over(group, [*gsum, loss])
        else:
            for axis in (ctx.tp, "data"):
                _sum_over(ctx.group(axis), [g for g, s in zip(gsum, flat_specs, strict=True)
                                            if axis not in sharded_axes(s)])
            _sum_over(group, [loss])
        if group is not None:
            for t in (*gsum, loss):
                t.div_(n_data)
        return loss, tree_unflatten(params, gsum)

    return grad_step


def make_train_step(lm: LM, ctx: MeshCtx, opt_cfg: AdamWConfig, *, grad_accum: int = 1):
    """Full step: forward, backward (`make_grad_step`), AdamW.
    `train_step(params, opt_state, batch)` takes the global batch; on a
    mesh the params and state are the rank's blocks, and `adamw_update`
    gets their specs.  Returns `(params, opt_state, loss)`, params and
    state updated in place and the loss a 0-d tensor on the params'
    device, the mean over the data ranks; the step never waits on the
    host."""
    grad_step = make_grad_step(lm, ctx, grad_accum=grad_accum)
    specs = param_specs(lm, ctx)
    on_mesh = {} if specs is None else {"specs": specs, "mesh": ctx.mesh}

    def train_step(params, opt_state, batch):
        loss, grads = grad_step(params, batch)
        params, opt_state = adamw_update(grads, opt_state, params, opt_cfg, **on_mesh)
        return params, opt_state, loss

    return train_step


def _rows(ctx: MeshCtx, n: int) -> slice:
    """This data rank's rows of a global batch of n (all of them where n
    does not split over the data ranks)."""
    _, n_data, coord = _data_axis(ctx)
    return host_shard_slice(n, n_data, coord) if n % n_data == 0 else slice(0, n)


def _whole_rows(ctx: MeshCtx, x: torch.Tensor, n: int) -> torch.Tensor:
    """The data ranks' rows put back together (x as it is if every rank ran all n)."""
    group, n_data, _ = _data_axis(ctx)
    return comm.gather_block(x, 0, group) if n % n_data == 0 else x


def make_prefill_step(lm: LM, ctx: MeshCtx):
    """`prefill_step(params, batch)` of the global batch: each data rank
    prefills its rows; the logits (B, 1, V) are every row's."""
    def prefill_step(params, batch):
        n = next(iter(batch.values())).shape[0]
        rows = _rows(ctx, n)
        logits = lm.prefill(params, ctx, {k: a[rows] for k, a in batch.items()})
        return _whole_rows(ctx, logits, n)
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
    waits on the host.  On a mesh each data rank decodes its rows, the
    model ranks together against their parts of the cache (the KV heads
    of their query heads), and every rank returns all rows' tokens."""
    n, s = prompts.shape
    rows = _rows(ctx, n)
    prompts = prompts[rows]
    b = prompts.shape[0]
    max_len = max_len or (s + gen + 8)
    cache = lm.init_cache(b, max_len=max_len, dtype=torch.float32, device=prompts.device,
                          ctx=ctx)
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
    return _whole_rows(ctx, torch.cat(out, dim=1), n)
