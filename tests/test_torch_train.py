"""The port's LM training path (`repro_torch.optim`, `checkpoint`,
`launch.steps.make_train_step`, `launch.elastic`) against the JAX package's
on the CPU, at the smoke sizes, both on the same seeded inputs; weights and
optimizer state carried across by `interop`.

Tolerances:
- AdamW, float32 moments: params and moments within 1e-6 (atol) + 1e-5
  (rtol) of the reference's after each step (the frameworks round
  the same ops; the sums of the global norm and `mean(u²)` run in another
  order).  8-bit moments: each step starts from the reference's state;
  params as above, scales within 1e-6 relative, and the int8 `q` buffers
  equal but for entries at most 1 apart, at most 0.1% of them: a value
  that lands on a rounding tie after a float32 sum taken in another order
  rounds the other way.
- Gradients at float32 compute: every leaf within 1e-4 of its largest
  |entry| of `jax.value_and_grad`'s (measured: at most 2.6e-5), the loss
  within 1e-6 relative.  At bfloat16 compute: the whole gradient within
  2^-3 of its norm and every leaf at cosine ≥ 0.99 with the reference's
  (measured: 0.064 and 0.995 on gemma3-4b's smoke config), the loss within
  2^-7 relative: the reference's compiled step rounds bfloat16 fewer times
  than eager torch (the same bound as the logits', tests/test_torch_lm.py).
- Params after 2 train steps: at most 0.1% of entries more than 1e-5 apart
  (measured: 0.03%), none more than 4·lr.  Adam's first steps are nearly
  sign(g)·lr, so an entry whose gradient is as small as the rounding
  differences may move by up to 2·lr per step on either side.
- Checkpoints: every array equal, bit for bit.
- CP compression: the approximation and the error buffer within 1e-5 of
  the gradient's largest |entry|, `q` within 1e-4 relative up to the sign
  of each column (QR's sign convention is the library's).

It mirrors the seed tests of the code it ports: tests/test_optim_data.py
(the optimizer and the compression), test_arch_smoke.py
(`test_smoke_train_step_decreases_loss`), test_elastic.py and
test_distributed.py (`test_train_step_runs_sharded_and_checkpoint_roundtrip`),
with data-parallel gloo ranks in place of the reference's (4, 2) mesh.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import checkpoint as rckpt
from repro import configs as rconfigs
from repro.launch import steps as rsteps
from repro.models import LM as RLM
from repro.models import MeshCtx as RCtx
from repro.optim import AdamWConfig as RAdamWConfig
from repro.optim import adamw_init as radamw_init
from repro.optim import adamw_update as radamw_update
from repro.optim.cp_compress import compress_grad as rcompress_grad
from repro.optim.cp_compress import cp_compress_state as rcp_compress_state
from repro_torch import checkpoint, configs
from repro_torch.data import SyntheticTokens
from repro_torch.interop import (cp_state_from_reference, lm_params_from_reference,
                                 opt_state_from_reference)
from repro_torch.launch import elastic, steps
from repro_torch.models import LM, MeshCtx, nn
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update, compress_grad,
                               cp_compress_state, cp_compressed_mean)
from repro_torch.optim import cp_compress

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
CTX = MeshCtx(mesh=None)
RCTX = RCtx(mesh=None)
DENSE = ["gemma3_4b", "qwen3_14b", "minitron_4b", "command_r_35b"]
OPT_ATOL, OPT_RTOL = 1e-6, 1e-5
Q8_SHARE = 1e-3
GRAD_REL = 1e-4
BF16_GRAD_REL, BF16_COS, BF16_LOSS = 2.0 ** -3, 0.99, 2.0 ** -7
PARAM_ATOL, PARAM_SHARE = 1e-5, 1e-3
CP_TOL = 1e-5
LR = 1e-3
TIMEOUT = 300


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(t) -> np.ndarray:
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _tokens(vocab, b=4, s=16, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _toy(seed=0) -> dict:
    """test_optim_data.py's toy tree, plus a vector whose length is not a
    multiple of the 256-element block."""
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(64, 1024)).astype(np.float32),
            "b": rng.normal(size=(1024,)).astype(np.float32),
            "c": rng.normal(size=(300,)).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def _reference_params(arch):
    return RLM(rconfigs.get_smoke_config(arch)).init(jax.random.key(0))[0]


def _pair(arch, compute_dtype="float32"):
    """(reference LM, its params, port LM, the same params on the CPU)."""
    rcfg = dataclasses.replace(rconfigs.get_smoke_config(arch), compute_dtype=compute_dtype)
    cfg = dataclasses.replace(configs.get_smoke_config(arch), compute_dtype=compute_dtype)
    rparams = _reference_params(arch)
    return RLM(rcfg), rparams, LM(cfg), lm_params_from_reference(rparams, cfg, device=CPU)


def _leaves_np(tree) -> list:
    return [_np(a) for a in nn.tree_leaves(tree)]


def _hold_q8(got, want):
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert got.dtype == np.int8 and got.shape == want.shape
    assert d.max() <= 1 and np.mean(d != 0) <= Q8_SHARE, (d.max(), np.mean(d != 0))


def _hold_state(got: dict, want: dict, use_8bit: bool):
    """The port's AdamW state against the reference's, carried into the
    port's structure."""
    for kind in ("m", "v"):
        for g, w in zip(_leaves_np(got[kind]), _leaves_np(want[kind]), strict=True):
            if g.dtype == np.int8:
                _hold_q8(g, w)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-6 if use_8bit else OPT_RTOL,
                                           atol=0 if use_8bit else OPT_ATOL)
    assert got["step"].dtype == torch.int32 and got["step"].shape == ()
    assert int(got["step"]) == int(want["step"])


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_8bit", [False, True], ids=["f32", "8bit"])
@pytest.mark.parametrize("tree", ["toy", "lm"])
def test_adamw_matches_reference(tree, use_8bit):
    """Steps on random gradients (5 on the toy tree, 3 on the LM's params,
    a smoke gemma3-4b's); at 8 bits each step starts from the
    reference's state (carried by `opt_state_from_reference` on the LM,
    whose stacked 8-bit moments unstack row by row)."""
    rng = np.random.default_rng(1)
    rcfg, cfg = (RAdamWConfig(lr=5e-2, use_8bit=use_8bit),
                 AdamWConfig(lr=5e-2, use_8bit=use_8bit))
    if tree == "toy":
        rparams = {k: jnp.asarray(v) for k, v in _toy().items()}
        lm_cfg = None
    else:
        _, rparams, lm, _ = _pair("gemma3_4b")
        lm_cfg = lm.cfg

    def port(tree_, fn=_t):
        return (lm_params_from_reference(tree_, lm_cfg, device=CPU) if lm_cfg
                else {k: fn(v) for k, v in tree_.items()})

    def port_state(st):
        if lm_cfg:
            return opt_state_from_reference(st, lm_cfg, device=CPU)
        return {"m": jax.tree.map(_t, st["m"]), "v": jax.tree.map(_t, st["v"]),
                "step": _t(np.int32(st["step"]))}

    ropt = radamw_init(rparams, rcfg)
    params, opt = port(rparams), port_state(ropt)
    update = jax.jit(radamw_update, static_argnums=3)
    for _ in range(3 if lm_cfg else 5):
        rgrads = jax.tree.map(lambda a: jnp.asarray(
            rng.normal(size=a.shape).astype(np.float32)), rparams)
        if use_8bit:
            params, opt = port(rparams), port_state(ropt)
        rparams, ropt = update(rgrads, ropt, rparams, rcfg)
        params, opt = adamw_update(port(rgrads), opt, params, cfg)
        for g, w in zip(_leaves_np(params), _leaves_np(port(rparams)), strict=True):
            np.testing.assert_allclose(g, w, rtol=OPT_RTOL, atol=OPT_ATOL)
        _hold_state(opt, port_state(ropt), use_8bit)


@pytest.mark.parametrize("use_8bit", [False, True], ids=["f32", "8bit"])
def test_adamw_reduces_quadratic_loss(use_8bit):
    cfg = AdamWConfig(lr=5e-2, weight_decay=0.0, grad_clip=1e9, use_8bit=use_8bit)
    params = {k: _t(v) for k, v in _toy().items()}
    opt = adamw_init(params, cfg)

    def loss(p):
        return sum(torch.sum(a ** 2) for a in nn.tree_leaves(p))
    l0 = float(loss(params))
    for _ in range(30):
        grads = {k: 2 * a for k, a in params.items()}
        params, opt = adamw_update(grads, opt, params, cfg)
    assert float(loss(params)) < 0.5 * l0


def test_8bit_states_really_int8():
    cfg = AdamWConfig(use_8bit=True)
    params = {k: _t(v) for k, v in _toy().items()}
    opt = adamw_init(params, cfg)
    params, opt = adamw_update(nn.tree_map(torch.ones_like, params), opt, params, cfg)
    assert opt["m"]["w"]["q"].dtype == torch.int8 and opt["v"]["w"]["q"].dtype == torch.int8
    # q keeps the param's shape, padded only in the last dimension
    assert opt["m"]["w"]["q"].shape == (64, 1024) and opt["m"]["c"]["q"].shape == (512,)
    assert opt["m"]["c"]["s"].shape == (2,)


def test_adamw_updates_in_place():
    cfg = AdamWConfig()
    params = {k: _t(v) for k, v in _toy().items()}
    opt = adamw_init(params, cfg)
    w, m, step = params["w"], opt["m"]["w"], opt["step"]
    new_params, new_opt = adamw_update(nn.tree_map(torch.ones_like, params), opt, params, cfg)
    assert new_params["w"] is w and new_opt["m"]["w"] is m and new_opt["step"] is step
    assert int(step) == 1 and float(m.abs().max()) > 0


@pytest.mark.parametrize("use_8bit", [False, True], ids=["f32", "8bit"])
def test_init_opt_shapes_allocates_nothing(use_8bit):
    """Meta state with the tree, shapes and dtypes of `adamw_init`'s, for
    gemma3-4b's published widths."""
    cfg = AdamWConfig(use_8bit=use_8bit)
    lm = LM(configs.get_smoke_config("gemma3_4b"))
    real = adamw_init(lm.init(torch.Generator(CPU).manual_seed(0))[0], cfg)
    meta = steps.init_opt_shapes(lm.init(nn.SHAPES)[0], cfg)

    def sig(t):
        return nn.tree_map(lambda a: (tuple(a.shape), a.dtype), t)
    assert sig(meta) == sig(real)
    assert all(a.device.type == "meta" for a in nn.tree_leaves(meta))
    full = steps.init_opt_shapes(LM(configs.get_config("gemma3-4b")).init(nn.SHAPES)[0], cfg)
    assert sum(a.numel() for a in nn.tree_leaves(full["m"])) >= 3_879_925_248


# ---------------------------------------------------------------------------
# CP compression
# ---------------------------------------------------------------------------

def _hold_q_up_to_signs(got, want):
    got, want = _np(got), np.asarray(want)
    signs = np.sign(np.sum(got * want, axis=0))
    np.testing.assert_allclose(got * signs, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("shape", [(128, 64), (16, 8, 24)])
def test_compress_grad_matches_reference(shape):
    """Three sweeps from the same g, err and q (a 3-D gradient is
    compressed as (rows, rest), as `_as2d` views it)."""
    rng = np.random.default_rng(0)
    cols = int(np.prod(shape[1:]))
    rst = {"err": jnp.asarray(rng.normal(size=shape).astype(np.float32) * 0.1),
           "q": jnp.asarray(rng.normal(size=(cols, 8)).astype(np.float32))}
    st = cp_state_from_reference(rst, device=CPU)
    for _ in range(3):
        g = rng.normal(size=shape).astype(np.float32)
        want, rst = rcompress_grad(jnp.asarray(g), rst, axis_name=None)
        got, st = compress_grad(_t(g), st)
        scale = float(np.abs(g).max())
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=CP_TOL * scale)
        np.testing.assert_allclose(_np(st["err"]), np.asarray(rst["err"]), rtol=0,
                                   atol=CP_TOL * scale)
        _hold_q_up_to_signs(st["q"], rst["q"])
        st = cp_state_from_reference(rst, device=CPU)  # the next sweep from the same q


def test_cp_compression_exact_on_lowrank_grad():
    rng = np.random.default_rng(0)
    g = _t(rng.normal(size=(128, 4)).astype(np.float32) @ rng.normal(size=(64, 4)).astype(
        np.float32).T)  # exactly rank 4
    state = {"err": torch.zeros_like(g),
             "q": torch.randn((64, 8), generator=torch.Generator().manual_seed(0))}
    for _ in range(3):
        cg, state = compress_grad(g, state)
    assert float(torch.linalg.norm(cg - g) / torch.linalg.norm(g)) < 1e-3


def test_cp_compression_error_feedback_converges():
    rng = np.random.default_rng(0)
    target = _t(rng.normal(size=(128, 64)).astype(np.float32))
    w = torch.zeros_like(target)
    state = {"err": torch.zeros_like(w),
             "q": torch.randn((64, 8), generator=torch.Generator().manual_seed(0))}
    rels = []
    for _ in range(150):
        cg, state = compress_grad(w - target, state)
        w = w - cg
        rels.append(float(torch.linalg.norm(w - target) / torch.linalg.norm(target)))
    assert rels[-1] < 0.10 and rels[-1] < rels[10]


def test_cp_compress_state_matches_reference():
    """The reference's tree, shapes and dtypes (None below MIN_SIZE or for a
    vector); the initial q is seeded from the path's crc32, so it is the
    same in every process."""
    params = {"w": np.zeros((512, 256), np.float32), "b": np.zeros((512,), np.float32),
              "t": [np.zeros((4, 128, 256), np.float32), np.zeros((8, 8), np.float32)]}
    want = rcp_compress_state(jax.tree.map(jnp.asarray, params), rank=4)
    got = cp_compress_state(nn.tree_map(_t, params), rank=4)
    assert nn.tree_map(lambda a: None if a is None else tuple(a.shape), got) == jax.tree.map(
        lambda a: None if a is None else tuple(a.shape), want, is_leaf=lambda x: x is None)
    assert got["b"] is None and got["t"][1] is None and got["t"][0]["q"].shape == (32768, 4)
    again = cp_compress_state(nn.tree_map(_t, params), rank=4)
    assert torch.equal(got["w"]["q"], again["w"]["q"])
    assert not torch.equal(got["w"]["q"][:256], got["t"][0]["q"][:256])
    assert cp_compress.MIN_SIZE == 1 << 16


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_grads(arch, compute_dtype):
    rlm, rparams, _, _ = _pair(arch, compute_dtype)
    toks = jnp.asarray(_tokens(rlm.cfg.vocab))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: rlm.loss(p, RCTX, {"tokens": toks})))(rparams)
    return float(loss), grads


def _step_grads(monkeypatch, lm, params, grad_accum, opt_cfg=None):
    """The gradients and loss one port train step hands to AdamW."""
    seen = []

    def record(grads, state, params_, cfg):
        seen.append(nn.tree_map(lambda a: a.clone(), grads))
        return adamw_update(grads, state, params_, cfg)
    monkeypatch.setattr(steps, "adamw_update", record)
    opt_cfg = opt_cfg or AdamWConfig(lr=LR)
    step = steps.make_train_step(lm, CTX, opt_cfg, grad_accum=grad_accum)
    _, _, loss = step(params, adamw_init(params, opt_cfg),
                      {"tokens": _t(_tokens(lm.cfg.vocab))})
    return seen[0], loss


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("arch", ["gemma3_4b", "minitron_4b"])
def test_train_step_matches_reference(arch, grad_accum, monkeypatch):
    """Float32 compute: the first step's gradients against
    `jax.value_and_grad` of the whole batch, then params after 2 steps of
    both train steps."""
    rlm, rparams, lm, params = _pair(arch)
    want_loss, rgrads = _reference_grads(arch, "float32")
    grads, loss = _step_grads(monkeypatch, lm, nn.tree_map(torch.clone, params), grad_accum)
    assert loss.shape == () and loss.dtype == torch.float32
    assert abs(float(loss) - want_loss) <= 1e-6 * want_loss
    want = nn.tree_leaves(lm_params_from_reference(rgrads, lm.cfg, device=CPU))
    for g, w in zip(nn.tree_leaves(grads), want, strict=True):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert float((g - w).abs().max()) <= GRAD_REL * float(w.abs().max())
    monkeypatch.undo()

    ropt_cfg, opt_cfg = RAdamWConfig(lr=LR), AdamWConfig(lr=LR)
    ropt = radamw_init(rparams, ropt_cfg)
    opt = opt_state_from_reference(ropt, lm.cfg, device=CPU)
    rstep = jax.jit(rsteps.make_train_step(rlm, RCTX, ropt_cfg, grad_accum=grad_accum))
    step = steps.make_train_step(lm, CTX, opt_cfg, grad_accum=grad_accum)
    toks = _tokens(lm.cfg.vocab)
    for _ in range(2):
        rparams, ropt, rloss = rstep(rparams, ropt, {"tokens": jnp.asarray(toks)})
        params, opt, loss = step(params, opt, {"tokens": _t(toks)})
        assert abs(float(loss) - float(rloss)) <= 1e-6 * float(rloss)
    want = lm_params_from_reference(rparams, lm.cfg, device=CPU)
    d = torch.cat([(a - b).abs().flatten() for a, b in zip(
        nn.tree_leaves(params), nn.tree_leaves(want), strict=True)])
    assert float((d > PARAM_ATOL).float().mean()) <= PARAM_SHARE
    assert float(d.max()) <= 4 * LR
    assert int(opt["step"]) == 2


@pytest.mark.parametrize("arch", ["gemma3_4b", "minitron_4b"])
def test_train_step_bfloat16_matches_reference(arch, monkeypatch):
    _, _, lm, params = _pair(arch, "bfloat16")
    want_loss, rgrads = _reference_grads(arch, "bfloat16")
    grads, loss = _step_grads(monkeypatch, lm, params, 1)
    assert abs(float(loss) - want_loss) <= BF16_LOSS * want_loss
    got = nn.tree_leaves(grads)
    want = nn.tree_leaves(lm_params_from_reference(rgrads, lm.cfg, device=CPU))
    flat_g, flat_w = torch.cat([g.flatten() for g in got]), torch.cat([w.flatten() for w in want])
    assert float((flat_g - flat_w).norm() / flat_w.norm()) <= BF16_GRAD_REL
    for g, w in zip(got, want, strict=True):
        assert float(torch.nn.functional.cosine_similarity(g.flatten(), w.flatten(), dim=0)) \
            >= BF16_COS


def test_remat_gives_the_same_gradients(monkeypatch):
    """Each pattern repeat under torch.utils.checkpoint recomputes the same
    forward: the gradients are the same bit for bit."""
    _, _, lm, params = _pair("gemma3_4b")
    on, _ = _step_grads(monkeypatch, lm, nn.tree_map(torch.clone, params), 1)
    calls = []
    monkeypatch.setattr("repro_torch.models.transformer.checkpoint",
                        lambda fn, *a, **k: calls.append(1) or fn(*a))
    off_lm = LM(dataclasses.replace(lm.cfg, remat=False))
    off, _ = _step_grads(monkeypatch, off_lm, nn.tree_map(torch.clone, params), 1)
    assert not calls  # remat=False never checkpoints
    assert lm.cfg.remat
    for a, b in zip(nn.tree_leaves(on), nn.tree_leaves(off), strict=True):
        assert torch.equal(a, b)
    # two repeats of the (local, global) pattern: checkpointed twice
    monkeypatch.setattr("repro_torch.models.transformer.checkpoint",
                        lambda fn, *a, **k: calls.append(1) or fn(*a))
    _step_grads(monkeypatch, lm, nn.tree_map(torch.clone, params), 1)
    assert len(calls) == 2
    with torch.no_grad():
        lm.loss(params, CTX, {"tokens": _t(_tokens(lm.cfg.vocab))})
    assert len(calls) == 2  # the forward alone is never checkpointed


@pytest.mark.parametrize("arch", DENSE)
def test_smoke_train_step_decreases_loss(arch):
    lm = LM(configs.get_smoke_config(arch))
    params, _ = lm.init(torch.Generator(CPU).manual_seed(0))
    opt_cfg = AdamWConfig(lr=5e-3)
    opt = adamw_init(params, opt_cfg)
    step = steps.make_train_step(lm, CTX, opt_cfg)
    batch = {"tokens": _t(SyntheticTokens(lm.cfg.vocab, 32, 2).batch(0))}
    losses = []
    for _ in range(4):
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_train_step_refuses_a_batch_that_does_not_split():
    lm = LM(configs.get_smoke_config("qwen3_14b"))
    params, _ = lm.init(torch.Generator(CPU).manual_seed(0))
    step = steps.make_train_step(lm, CTX, AdamWConfig(), grad_accum=2)
    with pytest.raises(ValueError, match="microbatches"):
        step(params, adamw_init(params, AdamWConfig()), {"tokens": torch.ones((3, 8),
                                                                             dtype=torch.int32)})


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_state(use_8bit):
    rcfg = RAdamWConfig(use_8bit=use_8bit)
    rparams = {k: jnp.asarray(v) for k, v in _toy().items()}
    ropt = radamw_init(rparams, rcfg)
    rparams, ropt = jax.jit(radamw_update, static_argnums=3)(
        jax.tree.map(jnp.ones_like, rparams), ropt, rparams, rcfg)
    return {"params": rparams, "opt": ropt}


def _toy_state(use_8bit=False):
    """A plain dict tree, params and AdamW state after one update, in both
    packages' forms (the same values; the port's a fresh copy)."""
    rtree = _reference_state(use_8bit)
    return rtree, jax.tree.map(_t, rtree)


def test_checkpoint_roundtrip_and_latest(tmp_path):
    _, tree = _toy_state(use_8bit=True)
    assert checkpoint.latest_step(str(tmp_path)) is None
    for s in (3, 12):
        d = checkpoint.save_checkpoint(str(tmp_path), s, tree)
        assert sorted(os.listdir(d)) == ["COMMITTED", "arrays.npz", "meta.json"]
    assert checkpoint.latest_step(str(tmp_path)) == 12
    like = nn.tree_map(lambda a: torch.empty_like(a, device="meta"), tree)
    got = checkpoint.restore_checkpoint(str(tmp_path), 12, like, device=CPU)
    for a, b in zip(nn.tree_leaves(got), nn.tree_leaves(tree), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    meta = json.loads((tmp_path / "step_00000012" / "meta.json").read_text())
    assert meta["step"] == 12 and meta["n_leaves"] == len(nn.tree_leaves(tree))


def test_uncommitted_step_is_never_restored(tmp_path):
    _, tree = _toy_state()
    checkpoint.save_checkpoint(str(tmp_path), 1, tree)
    d = checkpoint.save_checkpoint(str(tmp_path), 2, tree)
    os.remove(os.path.join(d, "COMMITTED"))  # the writer died before the marker
    assert checkpoint.latest_step(str(tmp_path)) == 1
    with pytest.raises(FileNotFoundError, match="uncommitted"):
        checkpoint.restore_checkpoint(str(tmp_path), 2, tree, device=CPU)


def test_restore_refuses_another_dtype_or_shape(tmp_path):
    _, tree = _toy_state()
    checkpoint.save_checkpoint(str(tmp_path), 1, tree)
    for edit in (lambda t: t.double(), lambda t: t[:1]):
        bad = dict(tree, params=dict(tree["params"], w=edit(tree["params"]["w"])))
        with pytest.raises(ValueError, match="the tree wants"):
            checkpoint.restore_checkpoint(str(tmp_path), 1, bad, device=CPU)


@pytest.mark.parametrize("use_8bit", [False, True], ids=["f32", "8bit"])
def test_checkpoints_cross_between_packages(tmp_path, use_8bit):
    """A dict tree written by `repro.checkpoint` restores in the port, and
    one written by the port restores in `repro.checkpoint`, every array
    equal."""
    rtree, tree = _toy_state(use_8bit)
    rckpt.save_checkpoint(str(tmp_path / "ref"), 5, rtree)
    got = checkpoint.restore_checkpoint(str(tmp_path / "ref"), 5, tree, device=CPU)
    checkpoint.save_checkpoint(str(tmp_path / "port"), 6, tree)
    back = rckpt.restore_checkpoint(str(tmp_path / "port"), rckpt.latest_step(
        str(tmp_path / "port")), rtree)
    for a, b, c in zip(nn.tree_leaves(got), jax.tree.leaves(rtree), jax.tree.leaves(back),
                       strict=True):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert np.asarray(c).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(c), np.asarray(b))


def test_async_checkpointer_snapshots_before_writing(tmp_path):
    _, tree = _toy_state()
    ck = checkpoint.AsyncCheckpointer(str(tmp_path))
    want = tree["params"]["w"].clone()
    ck.save(1, tree)
    tree["params"]["w"].add_(1.0)  # training goes on while the thread writes
    ck.wait()
    got = checkpoint.restore_checkpoint(str(tmp_path), 1, tree, device=CPU)
    assert torch.equal(got["params"]["w"], want)


# ---------------------------------------------------------------------------
# Two gloo ranks: the compressed mean, data-parallel training, elastic resume
# ---------------------------------------------------------------------------

ELASTIC_ARCH = "qwen3_14b"
ELASTIC_BATCH, ELASTIC_SEQ = 4, 32

_RANK_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    rank, init, out, ckpt = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method="file://" + init, rank=rank, world_size=2)
    from repro_torch import configs
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import make_local_mesh
    from repro_torch.launch.steps import make_ctx, make_train_step, param_specs, state_shardings
    from repro_torch.models import LM
    from repro_torch.optim import AdamWConfig, adamw_init, cp_compress_state, cp_compressed_mean
    res = {}
    # the compressed mean: each rank its own gradients, one state
    rng = np.random.default_rng(10 + rank)
    grads = {"w": rng.normal(size=(512, 256)).astype(np.float32),
             "b": rng.normal(size=(512,)).astype(np.float32)}
    grads = {k: torch.from_numpy(v) for k, v in grads.items()}
    state = cp_compress_state(grads, rank=4)
    out_g, out_s = cp_compressed_mean(grads, state, dist.group.WORLD)
    res["cp"] = {k: v.tolist() for k, v in out_g.items()}
    # data-parallel training, 2 steps, then a checkpoint
    mesh = make_local_mesh(device="cpu")
    cfg = configs.get_smoke_config(%(arch)r)
    lm = LM(cfg)
    params, _ = lm.init(torch.Generator("cpu").manual_seed(0), mesh=mesh)  # FSDP blocks
    opt_cfg = AdamWConfig(lr=1e-3)
    ctx = make_ctx(mesh, seq_sharded=False)
    opt = adamw_init(params, opt_cfg, specs=param_specs(lm, ctx), mesh=mesh)
    step = make_train_step(lm, ctx, opt_cfg)
    batch = {"tokens": torch.from_numpy(SyntheticTokens(cfg.vocab, %(seq)d, %(batch)d).batch(0))}
    res["losses"] = []
    for _ in range(2):
        params, opt, loss = step(params, opt, batch)
        res["losses"].append(float(loss))
    save_checkpoint(ckpt, 2, {"params": params, "opt": opt},
                    shardings=state_shardings(lm, mesh, opt_cfg), mesh=mesh)
    res["mesh"] = list(mesh.shape)
    dist.barrier()
    json.dump(res, open(out + "." + str(rank) + ".json", "w"))
    dist.destroy_process_group()
""") % dict(arch=ELASTIC_ARCH, seq=ELASTIC_SEQ, batch=ELASTIC_BATCH)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train2")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_WORKER, str(r), str(tmp / "init"), str(tmp / "out"),
         str(tmp / "ckpt")], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"a spawned rank did not finish within {TIMEOUT} s")
    for p, (_, err) in zip(procs, outs, strict=True):
        assert p.returncode == 0, err[-4000:]
    return [json.loads((tmp / f"out.{r}.json").read_text()) for r in range(2)], tmp / "ckpt"


def test_cp_compressed_mean_over_two_ranks(two_ranks):
    """Each rank's result is the one-process compression of the mean
    gradient (the factors are linear in g; the error buffers start at 0),
    and the uncompressed vector is the plain mean."""
    results, _ = two_ranks
    grads = []
    for r in range(2):  # the ranks' draws
        rng = np.random.default_rng(10 + r)
        grads.append({"w": rng.normal(size=(512, 256)).astype(np.float32),
                      "b": rng.normal(size=(512,)).astype(np.float32)})
    mean_w = _t((grads[0]["w"] + grads[1]["w"]) / 2)
    want, _ = compress_grad(mean_w, cp_compress_state({"w": mean_w}, rank=4)["w"])
    for res in results:
        got = np.array(res["cp"]["w"], np.float32)
        np.testing.assert_allclose(got, want.numpy(), rtol=0,
                                   atol=CP_TOL * float(mean_w.abs().max()))
        np.testing.assert_allclose(np.array(res["cp"]["b"], np.float32),
                                   (grads[0]["b"] + grads[1]["b"]) / 2,
                                   rtol=1e-6, atol=1e-6)
    assert results[0]["cp"] == results[1]["cp"]


def test_elastic_resume_from_two_ranks_to_one(two_ranks):
    """Two data-parallel ranks train 2 steps and checkpoint; their losses
    are those of one process that runs the same two halves of the batch as
    microbatches (the gradients summed and halved either way); then
    `elastic_restore` on one rank resumes, and the loss keeps falling."""
    results, ckpt = two_ranks
    assert results[0]["losses"] == results[1]["losses"] and results[0]["mesh"] == [2, 1]
    lm = LM(configs.get_smoke_config(ELASTIC_ARCH))
    opt_cfg = AdamWConfig(lr=1e-3)
    params, _ = lm.init(torch.Generator(CPU).manual_seed(0))
    opt = adamw_init(params, opt_cfg)
    step = steps.make_train_step(lm, CTX, opt_cfg, grad_accum=2)
    batch = {"tokens": _t(SyntheticTokens(lm.cfg.vocab, ELASTIC_SEQ, ELASTIC_BATCH).batch(0))}
    one = []
    for _ in range(2):
        params, opt, loss = step(params, opt, batch)
        one.append(float(loss))
    np.testing.assert_allclose(results[0]["losses"], one, rtol=1e-6)

    assert not dist.is_initialized()
    try:
        mesh, rparams, ropt, start = elastic.elastic_restore(lm, str(ckpt), opt_cfg, device="cpu")
        assert start == 2 and dict(zip(mesh.mesh_dim_names, mesh.shape)) == {"data": 1,
                                                                               "model": 1}
        assert int(ropt["step"]) == 2 and ropt["step"].dtype == torch.int32
        ctx = steps.make_ctx(mesh, seq_sharded=False)
        _, _, loss = steps.make_train_step(lm, ctx, opt_cfg)(rparams, ropt, batch)
    finally:
        dist.destroy_process_group()
    loss2 = results[0]["losses"][-1]
    assert np.isfinite(loss2) and np.isfinite(float(loss))
    assert float(loss) < loss2 + 0.05


def test_elastic_restore_without_a_checkpoint_and_on_a_model_axis(tmp_path):
    """No checkpoint: None, and no group is made.  A model axis of two
    ranks asks for two: one process that has a checkpoint refuses to make
    a (1, 2) mesh of itself alone (the multi-rank resume, onto a model
    axis of two from a (4, 2) mesh, is tests/test_torch_tp.py's)."""
    lm = LM(configs.get_smoke_config(ELASTIC_ARCH))
    assert elastic.elastic_restore(lm, str(tmp_path), AdamWConfig(), device="cpu") is None
    assert elastic.elastic_restore(lm, str(tmp_path), AdamWConfig(), n_model=2,
                                   device="cpu") is None
    assert not dist.is_initialized()
    params, _ = lm.init(torch.Generator("cpu").manual_seed(0))
    checkpoint.save_checkpoint(str(tmp_path), 1, {"params": params,
                                                  "opt": adamw_init(params, AdamWConfig())})
    try:
        with pytest.raises(ValueError, match="mesh needs 2 ranks"):
            elastic.elastic_restore(lm, str(tmp_path), AdamWConfig(), n_model=2, device="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()