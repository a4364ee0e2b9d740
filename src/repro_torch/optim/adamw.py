"""AdamW with float32 or 8-bit moments (counterpart of `repro.optim.adamw`).

The 8-bit layout is the reference's: int8 blockwise absmax along the last
axis only, 256-element blocks, one float32 scale per block, so the int8
buffer keeps the parameter's shape (padded only in the last dimension).  A
row of the reference's stacked `(reps, ...)` state is therefore the port's
per-layer state as it is (`repro_torch.interop.opt_state_from_reference`).

The update copies the reference's arithmetic op for op (a Python constant
is applied as jnp applies it, rounded to float32 by the op), and works in
place: the step counter is a 0-d int32 tensor on the params' device, the
bias corrections are computed there from it, and nothing is read back to
the host.

On a mesh (`specs` and `mesh` given: the params' resolved specs, as
`launch.shardings.param_shardings` gives them) each rank updates its
blocks.  The gradient norm counts every element once (each block's sum of
squares over the ranks that hold it), the 8-bit step's RMS bound is taken
over the whole leaf, and the 8-bit state is the whole leaf's: its blocks of
256 lie along the last axis, so where a rank's block of that axis is not
a multiple of 256 (it straddles the global blocks) the rank gathers the
rows of its moment along that axis, dequantizes and requantizes them with
the global blocks' scales, and keeps its block of `q` and `s` as
`opt_shardings` places them.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..models import comm
from ..models.nn import tree_leaves, tree_map

__all__ = ["AdamWConfig", "adamw_init", "adamw_update"]

_BLOCK = 256


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    use_8bit: bool = False


def _q8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 blockwise absmax quantization along the last axis.  Returns
    (q (*lead, padded_last) int8, scales (*lead, n_blocks) float32)."""
    if x.dim() == 0:
        x = x[None]
    *lead, last = x.shape
    pad = (-last) % _BLOCK
    blocks = F.pad(x, (0, pad)).reshape(*lead, -1, _BLOCK)
    scale = torch.clamp_min(blocks.abs().amax(dim=-1) / 127.0, 1e-12).float()
    q = torch.clamp(torch.round(blocks / scale[..., None]), -127, 127)
    return q.to(torch.int8).reshape(*lead, last + pad), scale


def _dq8(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    if len(shape) == 0:
        shape = (1,)
    *lead, last = shape
    blocks = q.reshape(*lead, -1, _BLOCK).float() * scale[..., None]
    return blocks.reshape(*lead, -1)[..., :last].reshape(shape)


def _zeros8(p: torch.Tensor) -> dict:
    """`_q8` of zeros, made directly: q all 0, every scale the 1e-12 floor."""
    *lead, last = p.shape if p.dim() else (1,)
    n_blocks = -(-last // _BLOCK)
    return {"q": torch.zeros((*lead, n_blocks * _BLOCK), dtype=torch.int8, device=p.device),
            "s": torch.full((*lead, n_blocks), 1e-12, dtype=torch.float32, device=p.device)}


def adamw_init(params, cfg: AdamWConfig, *, specs=None, mesh=None) -> dict:
    """Zero moments (float32, or 8-bit `{"q", "s"}` pairs) and a 0-d int32
    step counter, on the params' device (meta params give meta state:
    the counterpart of `jax.eval_shape` over this).  With `specs` and
    `mesh`, `params` are a rank's blocks and the state is the rank's block
    of the whole params' state."""
    if specs is not None:
        from ..launch import shardings as sh
        device = tree_leaves(params)[0].device
        whole = sh.whole_shapes(params, specs, mesh)
        o_meta = adamw_init(whole, cfg)
        o_specs = sh.opt_shardings(mesh, o_meta, specs)

        def local(path, a, spec):
            shape = sh.block_shape(tuple(a.shape), spec, mesh)
            if path[-1] == "s":
                return torch.full(shape, 1e-12, dtype=a.dtype, device=device)
            return torch.zeros(shape, dtype=a.dtype, device=device)
        return sh.map_with_specs(local, o_meta, o_specs)
    if cfg.use_8bit:
        def zero(p):
            return _zeros8(p)
    else:
        def zero(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zero, params), "v": tree_map(zero, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _zip(p, *trees):
    """(param, the other trees' entries at its place) for every param, in
    `tree_leaves`' order; an 8-bit moment's `{"q", "s"}` stands at a leaf."""
    if isinstance(p, dict):
        for k in sorted(p):
            yield from _zip(p[k], *(t[k] for t in trees))
    elif isinstance(p, (list, tuple)):
        for i, v in enumerate(p):
            yield from _zip(v, *(t[i] for t in trees))
    else:
        yield (p, *trees)


def _global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads)))


class _Mesh:
    """What the update needs of a mesh: each axis's group and size, and the
    specs of the params in `_zip`'s order."""

    def __init__(self, mesh, specs):
        from ..launch import shardings as sh
        self.mesh, self.sh = mesh, sh
        self.sizes = sh.mesh_sizes(mesh)
        self.specs = [s for _, s in sh.leaves_with_paths(specs)]

    def group(self, axis):
        return self.mesh.get_group(axis) if self.sizes.get(axis, 1) > 1 else None

    def sum_over(self, t: torch.Tensor, axes) -> torch.Tensor:
        for a in axes:
            t = comm.all_reduce(t, self.group(a))
        return t

    def norm(self, grads) -> torch.Tensor:
        """Each block's sum of squares over the ranks that hold it."""
        tot = sum(torch.sum(torch.square(g.float())) / self.sh.replication(self.sizes, sp)
                  for g, sp in zip(tree_leaves(grads), self.specs, strict=True))
        return torch.sqrt(self.sum_over(tot, tuple(self.sizes)))

    def straddles(self, n: int, spec) -> bool:
        """Whether a rank's block of n entries of the last axis cuts across
        256-blocks."""
        ax = spec[-1] if spec else None
        return ax is not None and self.sizes[ax] > 1 and n % _BLOCK != 0

    def dq8(self, q: torch.Tensor, s: torch.Tensor, n: int, spec) -> torch.Tensor:
        """The moment of rows of the rank's block of a param (n entries a
        row) from the rows of its 8-bit state that the rank holds."""
        if not self.straddles(n, spec):
            return _dq8(q, s, (q.shape[0], n))
        ax = spec[-1]
        g = self.group(ax)
        nb = -(-n * self.sizes[ax] // _BLOCK)
        if q.shape[-1] != nb * _BLOCK:  # the rank holds its block of q: gather it
            q = comm.gather_block(q, 1, g)
        if s.shape[-1] != nb:
            s = comm.gather_block(s, 1, g)
        whole = _dq8(q, s, (q.shape[0], n * self.sizes[ax]))
        r = self.mesh.get_local_rank(ax)
        return whole[:, r * n:(r + 1) * n].contiguous()

    def q8(self, new: torch.Tensor, q: torch.Tensor, s: torch.Tensor, spec) -> None:
        """The rank's block of the 8-bit state of the whole rows, into q and s."""
        if not self.straddles(new.shape[-1], spec):
            _store8(new, q, s)
            return
        ax = spec[-1]
        wq, ws = _q8(comm.gather_block(new, 1, self.group(ax)))
        r = self.mesh.get_local_rank(ax)
        for dst, t in ((q, wq), (s, ws)):
            k = dst.shape[-1]
            dst.copy_(t if k == t.shape[-1] else t[:, r * k:(r + 1) * k])


def _store8(new: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> None:
    nq, ns = _q8(new)
    q.copy_(nq)
    s.copy_(ns)


#: Entries of a leaf updated at once: row blocks of this size bound the
#: update's float32 temporaries (a (256000, 8192) embedding's moments
#: would otherwise take several copies of the leaf at once).
_CHUNK = 1 << 24


def _rows(t: torch.Tensor, written: bool = True) -> torch.Tensor:
    """A leaf as (rows, last axis) (a 0-d leaf as (1, 1)): a view of it
    when the update writes it."""
    if written and not t.is_contiguous():
        raise ValueError("adamw_update updates contiguous params and state in place")
    return t.reshape(-1, t.shape[-1]) if t.dim() else t.reshape(1, 1)


def _apply(p: torch.Tensor, u: torch.Tensor, cfg: AdamWConfig) -> None:
    """p -= lr·(u + wd·p), in float32, back in p's dtype."""
    pf = p.float()
    u.add_(pf * cfg.weight_decay).mul_(cfg.lr)
    if p.dtype == torch.float32:
        p.sub_(u)
    else:
        p.copy_(pf - u)


@torch.no_grad()
def adamw_update(grads, state: dict, params, cfg: AdamWConfig, *, specs=None, mesh=None):
    """One AdamW step.  Updates `params` and `state` in place and returns
    them, `(params, state)`: the same tensors (at full width a second copy
    of the params would not fit beside the moments).  Pass copies to keep
    the old values.  A leaf is updated in blocks of rows (`_CHUNK`
    entries); with 8-bit moments its step `u` is kept whole until the RMS
    bound, which needs all of it.  With `specs` and `mesh`, each rank's
    blocks (see the module's docstring)."""
    on = None if specs is None or mesh is None else _Mesh(mesh, specs)
    step = state["step"].add_(1)
    gnorm = _global_norm(grads) if on is None else on.norm(grads)
    clip = torch.full((), cfg.grad_clip, dtype=torch.float32, device=gnorm.device)
    scale = torch.clamp_max(clip / torch.clamp_min(gnorm, 1e-12), 1.0)
    t = step.float()
    bc1 = 1.0 - torch.pow(cfg.b1, t)
    bc2 = 1.0 - torch.pow(cfg.b2, t)

    for i, (p, g, m_st, v_st) in enumerate(_zip(params, grads, state["m"], state["v"])):
        spec = None if on is None else on.specs[i]
        prows, grows = _rows(p), _rows(g, written=False)
        n_rows, n = prows.shape
        per = max(1, _CHUNK // n)
        if cfg.use_8bit:
            m8 = (_rows(m_st["q"]), _rows(m_st["s"]))
            v8 = (_rows(v_st["q"]), _rows(v_st["s"]))
            u_all = torch.empty(prows.shape, dtype=torch.float32, device=p.device)
            sumsq = torch.zeros((), dtype=torch.float32, device=p.device)
        else:
            mrows, vrows = _rows(m_st), _rows(v_st)
        for r0 in range(0, n_rows, per):
            sl = slice(r0, r0 + per)
            gc = grows[sl].float() * scale
            if cfg.use_8bit:
                m, v = ((_dq8(q[sl], s[sl], (q[sl].shape[0], n)) if on is None
                         else on.dq8(q[sl], s[sl], n, spec)) for q, s in (m8, v8))
            else:
                m, v = mrows[sl], vrows[sl]
            m.mul_(cfg.b1).add_(gc.mul(1 - cfg.b1))
            v.mul_(cfg.b2).add_(gc.mul(1 - cfg.b2).mul_(gc))
            del gc
            u = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
            if not cfg.use_8bit:
                _apply(prows[sl], u, cfg)
                continue
            # int8 v underestimates small entries (block absmax quant), which
            # explodes m/√v: bound the step as the reference does.
            u.clamp_(-4.0, 4.0)
            u_all[sl] = u
            sumsq = sumsq + torch.sum(u * u)
            for (q, s), new in ((m8, m), (v8, v)):
                if on is None:
                    _store8(new, q[sl], s[sl])
                else:
                    on.q8(new, q[sl], s[sl], spec)
        if cfg.use_8bit:
            if on is None:
                ms = sumsq / p.numel()
            else:
                ms = on.sum_over(sumsq, on.sh.sharded_axes(spec)) / (
                    p.numel() * on.sh.block_count(on.sizes, spec))
            u_all.div_(torch.clamp_min(torch.sqrt(ms), 1.0))
            for r0 in range(0, n_rows, per):
                _apply(prows[r0:r0 + per], u_all[r0:r0 + per], cfg)
    return params, state
