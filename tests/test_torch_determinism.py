"""The port's train step in the form whose CUDA backward gives the same
bits on every run, against the JAX package's on the CPU.

Three lookups used to add their gradients with atomics on the card: the
embedding (`w[tokens]`), the mLSTM's stabiliser (`torch.cummax`, whose
backward is a `scatter_add`) and the MoE's gather of each token's k rows
(`xt[rows]`).  They are now `F.embedding` (its CUDA backward sums a row's
repeats in a fixed order) and `xlstm._cummax` (an `associative_scan` of
`torch.maximum`).  The cases:

- `_cummax`: its values equal `torch.cummax`'s; its gradient against
  `jax.grad` of `jax.lax.cummax`, which differentiates through the same
  odd/even scan of `lax.max` and so splits a tie in half at each pair:
  within 1e-6 of the largest |entry|, on seeded inputs with and without
  ties.  The mLSTM chunk's gradients on inputs whose stabiliser ties
  everywhere (forget gates 1, equal input gates), within 1e-5 of each
  leaf's largest |entry| (float32 sums in another order).
- The embedding's and the MoE gather's gradients against the reference's,
  one backward each, on lookups that repeat rows: within 1e-6 (the
  embedding: sums of a few float32 terms) and 1e-5 (the MoE: the gradients
  of tests/test_torch_lm_modules.py's MoE backward) of each leaf's largest
  |entry|.
- No float accumulation into repeated indices in one train step of any
  family (a dispatch-mode census of the ops: `index_put_` with
  accumulate, `scatter_add`, `scatter_reduce`, `index_add_`, `put_`): on
  the card each such op adds with atomics, in an order that varies from
  run to run.
- Four train steps of each trained family (dense, MoE, SSM, hybrid,
  enc-dec, VLM) at its smoke config, as `chip_smoke.py`'s phase 4t runs
  them (lr 1e-4, grad_accum 2) but at float32 compute and moments, from
  the reference's params and state: each of the four losses within
  TRAJECTORY_REL relative of the reference's.  Every reference call that
  reaches the JAX MoE is jitted.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _lm_families import _batch, _jb, _np, _pair, _rctx, _t, _tb
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as rconfigs
from repro.launch import steps as rsteps
from repro.models import LM as RLM
from repro.models import moe as rmoe
from repro.models import xlstm as rxl
from repro.optim import AdamWConfig as RAdamWConfig
from repro.optim import adamw_init as radamw_init
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import SyntheticBatches
from repro_torch.interop import lm_params_from_reference, opt_state_from_reference
from repro_torch.launch import steps
from repro_torch.models import LM, MeshCtx, moe, nn, xlstm
from repro_torch.optim import AdamWConfig, adamw_init

CUMMAX_REL = 1e-6      # of the largest |gradient entry|
EMBED_REL = 1e-6
MOE_REL = 1e-5
CHUNK_REL = 1e-5
# Four steps at lr 1e-4 from the same state, float32: the losses within
# 1e-5 relative (measured: at most 1.9e-7).  Adam's first steps are nearly
# sign(g)·lr, so an entry whose gradient is as small as the two sides'
# rounding differences moves the other way; at lr 1e-4 that moves the loss
# far less than this.
TRAJECTORY_REL = 1e-5
TRAIN_LR, TRAIN_ACCUM, TRAIN_STEPS = 1e-4, 2, 4
CTX = MeshCtx(mesh=None)
TRAINED = ["gemma3_4b", "qwen3_moe_30b_a3b", "xlstm_350m", "jamba_1_5_large_398b",
           "whisper_medium", "internvl2_1b"]


def _hold(got, want, rel, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


# ---------------------------------------------------------------------------
# cummax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 7, 16, 37, 256])
@pytest.mark.parametrize("ties", [False, True])
def test_cummax_gradient_matches_reference(n, ties):
    """Values equal to torch.cummax's; the gradient jax.grad's, ties split
    as the reference splits them."""
    rng = np.random.default_rng(n + 1000 * ties)
    a = (rng.integers(0, 3, (2, 3, n)) if ties else rng.standard_normal((2, 3, n)))
    a = a.astype(np.float32)
    w = rng.standard_normal((2, 3, n)).astype(np.float32)
    want = jax.jit(jax.grad(lambda x: jnp.sum(jnp.asarray(w) * jax.lax.cummax(x, axis=2))))(
        jnp.asarray(a))
    ta = _t(a).requires_grad_()
    y = xlstm._cummax(ta, 2)
    assert torch.equal(y, torch.cummax(_t(a), 2).values)
    got, = torch.autograd.grad((y * _t(w)).sum(), ta)
    _hold(got, want, CUMMAX_REL, f"n={n} ties={ties}")


def test_mlstm_chunk_gradient_with_a_tied_stabiliser():
    """Forget gates 1 (log 0) and equal input gates: the stabiliser's
    running max ties at every step of the chunk."""
    rng = np.random.default_rng(3)
    b, l, h, dh = 2, 16, 2, 8
    qkv = [rng.standard_normal((b, l, h, dh)).astype(np.float32) for _ in range(3)]
    log_i = np.full((b, l, h), 0.25, np.float32)
    log_f = np.zeros((b, l, h), np.float32)
    carry = [rng.standard_normal(s).astype(np.float32) * 0.1
             for s in ((b, h, dh, dh), (b, h, dh), (b, h))]
    xs = [*qkv, log_i, log_f]

    def rloss(xs_):
        return jnp.sum(rxl._mlstm_chunk(tuple(map(jnp.asarray, carry)), tuple(xs_))[1] ** 2)
    want = jax.jit(jax.grad(rloss))([jnp.asarray(x) for x in xs])
    txs = [_t(x).requires_grad_() for x in xs]
    _, y = xlstm._mlstm_chunk(tuple(map(_t, carry)), tuple(txs))
    got = torch.autograd.grad((y ** 2).sum(), txs)
    for name, g, w in zip(("q", "k", "v", "log_i", "log_f"), got, want, strict=True):
        _hold(g, w, CHUNK_REL, name)


# ---------------------------------------------------------------------------
# the embedding and the MoE gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma3_4b", "xlstm_350m"])
def test_embedding_gradient_matches_reference(arch):
    """Tokens drawn from 7 ids, so that every row repeats; gemma scales
    by sqrt(d_model), xlstm does not."""
    rlm, rparams, lm, params = _pair(arch)
    tokens = np.random.default_rng(0).integers(0, 7, (4, 33)).astype(np.int32)
    u = np.random.default_rng(1).standard_normal((4, 33, lm.cfg.d_model)).astype(np.float32)
    w0 = rparams["embed"]["w"]
    want = jax.jit(jax.grad(lambda w: jnp.sum(jnp.asarray(u) * rlm._embed(
        {"embed": {"w": w}}, jnp.asarray(tokens)))))(w0)
    w = params["embed"]["w"].clone().requires_grad_()
    got, = torch.autograd.grad((_t(u) * lm._embed({"embed": {"w": w}}, CTX, _t(tokens))).sum(),
                               w)
    _hold(got, want, EMBED_REL, "embed")


@pytest.mark.parametrize("top_k", [2, 8])
def test_moe_gather_gradient_matches_reference(top_k, trivial_mesh):
    """Many tokens, k rows each, through the gather: the gradients of the
    input and of every weight against jax.grad."""
    kw = dict(d_model=32, d_ff=16, n_experts=8, top_k=top_k, n_shared_experts=0)
    rcfg, cfg = rmoe.MoEConfig(**kw), moe.MoEConfig(**kw)
    rp, _ = rmoe.moe_init(jax.random.key(top_k), rcfg)
    x = np.random.default_rng(top_k).standard_normal((3, 40, 32)).astype(np.float32)
    rg = jax.jit(jax.grad(lambda p_, x_: jnp.sum(rmoe.moe_apply(
        p_, rcfg, x_, mesh=trivial_mesh, seq_sharded=False) ** 2), argnums=(0, 1)))(
            rp, jnp.asarray(x))
    p = nn.tree_map(lambda a: _t(a).requires_grad_(), jax.tree.map(np.asarray, rp))
    tx = _t(x).requires_grad_()
    grads = torch.autograd.grad(torch.sum(moe.moe_apply(p, cfg, tx) ** 2),
                                [tx, *nn.tree_leaves(p)])
    for g, w in zip(grads, [rg[1], *jax.tree.leaves(rg[0])], strict=True):
        _hold(g, w, MOE_REL, "moe")


# ---------------------------------------------------------------------------
# no float atomics in a train step
# ---------------------------------------------------------------------------

def _repeats(index: torch.Tensor, dim: int | None = None) -> bool:
    """Whether `index` holds a value twice (along `dim`, for each place of
    the other dims)."""
    if dim is None:
        return index.unique().numel() < index.numel()
    return bool((index.sort(dim=dim).values.diff(dim=dim) == 0).any())


class _Census(TorchDispatchMode):
    """Records each float accumulation into repeated indices."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        self_ = args[0] if args else None
        if isinstance(self_, torch.Tensor) and self_.is_floating_point():
            hit = False
            if name in ("index_put", "index_put_", "_index_put_impl_"):
                acc = args[3] if len(args) > 3 else kwargs.get("accumulate", False)
                idx = [i for i in args[1] if i is not None]
                if acc and idx and idx[0].dtype != torch.bool:
                    keys = torch.stack(torch.broadcast_tensors(*idx)).flatten(1).T
                    hit = keys.unique(dim=0).shape[0] < keys.shape[0]
            elif name in ("scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_"):
                hit = _repeats(args[2], args[1] % args[2].dim())
            elif name in ("index_add", "index_add_"):
                hit = _repeats(args[2])
            elif name == "put_":
                hit = (args[3] if len(args) > 3 else kwargs.get("accumulate", False)) \
                    and _repeats(args[1])
            if hit:
                self.found.append(f"{func} on {tuple(self_.shape)}")
        return func(*args, **kwargs)


@pytest.mark.parametrize("arch", [*TRAINED, "llama4_scout_17b_a16e"])
def test_train_step_adds_no_float_atomics(arch):
    """One train step (grad_accum 2) of the smoke config: no op that the
    card would run with float atomics over repeated indices."""
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    lm = LM(cfg)
    params, _ = lm.init(torch.Generator("cpu").manual_seed(0))
    opt_cfg = AdamWConfig(lr=TRAIN_LR)
    step = steps.make_train_step(lm, CTX, opt_cfg, grad_accum=TRAIN_ACCUM)
    batch = _tb(_batch(cfg, 4, 32))
    opt = adamw_init(params, opt_cfg)
    census = _Census()
    with census:
        step(params, opt, batch)
    assert int(opt["step"]) == 1
    assert not census.found, census.found


def test_census_sees_the_atomic_lookups():
    """The census is not blind: indexing a table by repeated rows, and
    torch.cummax, are what it reports."""
    w = torch.randn(5, 3, requires_grad=True)
    a = torch.tensor([[0.0, 2.0, 1.0, 2.0]], requires_grad=True)
    census = _Census()
    with census:
        w[torch.tensor([1, 1, 2])].sum().backward()
        torch.cummax(a, 1).values.sum().backward()
    assert len(census.found) == 2, census.found


# ---------------------------------------------------------------------------
# four train steps against the reference
# ---------------------------------------------------------------------------

def _trajectories(rlm, rparams, lm, params, batch, n_steps=TRAIN_STEPS):
    """The losses of `n_steps` train steps of both packages (lr 1e-4,
    grad_accum 2, float32 moments) from the reference's params and state,
    on one batch: (reference's, port's)."""
    ropt_cfg, opt_cfg = RAdamWConfig(lr=TRAIN_LR), AdamWConfig(lr=TRAIN_LR)
    ropt = radamw_init(rparams, ropt_cfg)
    opt = opt_state_from_reference(ropt, lm.cfg, device="cpu")
    rstep = jax.jit(rsteps.make_train_step(rlm, _rctx(), ropt_cfg, grad_accum=TRAIN_ACCUM))
    step = steps.make_train_step(lm, CTX, opt_cfg, grad_accum=TRAIN_ACCUM)
    want, got = [], []
    for _ in range(n_steps):
        rparams, ropt, rloss = rstep(rparams, ropt, _jb(batch))
        params, opt, loss = step(params, opt, _tb(batch))
        want.append(float(rloss))
        got.append(float(loss))
    return want, got


@pytest.mark.parametrize("arch", TRAINED)
def test_four_train_steps_match_reference(arch):
    """Float32 compute and moments, one batch of 4 × 32."""
    rlm, rparams, lm, params = _pair(arch)
    want, got = _trajectories(rlm, rparams, lm, params, _batch(lm.cfg, 4, 32))
    gap = max(abs(a - b) / abs(b) for a, b in zip(got, want, strict=True))
    assert all(np.isfinite(got)) and gap <= TRAJECTORY_REL, (got, want, gap)


if __name__ == "__main__":
    # The published widths, the depth cut:
    #   python tests/test_torch_determinism.py ARCH N_LAYERS [COMPUTE_DTYPE]
    # trains phase 4t's batch (SyntheticBatches seed 0, 4 × 256) four steps
    # in both packages on the CPU from the reference's jax.random.key(0) init
    # and prints both packages' losses.
    import sys

    arch, n_layers = sys.argv[1], int(sys.argv[2])
    dtype = sys.argv[3] if len(sys.argv) > 3 else "bfloat16"
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers, compute_dtype=dtype)
    rlm = RLM(dataclasses.replace(rconfigs.get_config(arch), n_layers=n_layers,
                                  compute_dtype=dtype))
    rparams = rlm.init(jax.random.key(0))[0]
    want, got = _trajectories(rlm, rparams, LM(cfg), lm_params_from_reference(
        rparams, cfg, device="cpu"), SyntheticBatches(cfg, 256, 4).batch(0))
    print(f"{arch} at {n_layers} layers, {dtype} compute: reference {want}; port {got}")
