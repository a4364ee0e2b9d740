"""The cases of tests/test_torch_lm_moe.py, test_torch_lm_ssm.py and
test_torch_lm_encdec.py: the port's MoE, SSM, hybrid, enc-dec and VLM LM
families (qwen3-moe-30b-a3b, llama4-scout-17b-a16e; xlstm-350m,
jamba-1.5-large-398b; whisper-medium, internvl2-1b) against the JAX
package's on the CPU, at their smoke configs, both on the same seeded
inputs (`_batch`: tokens, and `SyntheticBatches`' frames or image embeds
for the enc-dec and VLM archs), the weights carried across by
`interop.lm_params_from_reference`.  Each file imports the cases it runs
and gives them its archs through an `arch` fixture (three files, so that
`--dist loadfile` runs them apart).  Decode runs against a cache whose
cross-attention keys and values (enc-dec only) are seeded draws put into
both packages' caches alike (`_fill_cross`): the reference's `init_cache`
leaves them zeros, which would hide the cross-attention.
The reference runs on tests/conftest.py's trivial (1, 1) mesh (its MoE
needs one), compiled with `jax.jit`, and each arch's reference params are
drawn once per module.

Tolerances, as tests/test_torch_lm.py's for the dense family: float32
logits within 1e-5 of Σ|terms| of the final product (LOGIT_REL), the loss
within 1e-5 relative, `generate`'s tokens equal; bfloat16 logits within
2^-3 of the largest |logit| at each step (BF16_REL) and the loss within
1e-2 relative, loose on purpose: the reference's compiled stack fuses
bfloat16 steps and rounds fewer times than the port, which rounds as eager
jnp does, and a flipped rounding spreads through the layers and the cache.
A flipped rounding may also flip an MoE top-k choice, which moves that
token's output by far more than a rounding; the test bounds such flips by
bounding the logits.  The train step (AdamW, float32 moments): the loss
within 1e-5 relative, and after the step at most 0.1% of parameter
entries more than 1e-5 from the reference's, none more than 4·lr (Adam's
first step is nearly sign(g)·lr, tests/test_torch_train.py).

It mirrors the seed tests these families run on every PR:
tests/test_arch_smoke.py's forward loss, train step and decode step for
the six archs, and test_system.py's generation end to end.
"""
import dataclasses
import functools
import gc
import re
import runpy
import weakref
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.launch import steps as rsteps
from repro.launch.mesh import make_mesh_compat
from repro.models import LM as RLM
from repro.models import MeshCtx as RCtx
from repro.optim import AdamWConfig as RAdamWConfig
from repro.optim import adamw_init as radamw_init
from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.examples import serve_lm
from repro_torch.interop import lm_params_from_reference, opt_state_from_reference
from repro_torch.launch import steps
from repro_torch.models import LM, MeshCtx, nn
from repro_torch.models import transformer as tr
from repro_torch.optim import AdamWConfig

CPU = torch.device("cpu")
LOGIT_REL = 1e-5       # of Σ|terms|, float32
BF16_REL = 2.0 ** -3   # of max |logit|, bfloat16
LOSS_REL = {"float32": 1e-5, "bfloat16": 1e-2}
PARAM_ATOL, PARAM_SHARE = 1e-5, 1e-3
LR = 1e-3
CTX = MeshCtx(mesh=None)
ENC_LEN = 12           # the decode tests' cross cache: encoder keys and values
FAMILIES = {"qwen3_moe_30b_a3b": "moe", "llama4_scout_17b_a16e": "moe", "xlstm_350m": "ssm",
            "jamba_1_5_large_398b": "hybrid", "whisper_medium": "audio", "internvl2_1b": "vlm"}


@functools.lru_cache(maxsize=None)
def _rctx():
    return RCtx(mesh=make_mesh_compat((1, 1), ("data", "model")), dp=("data",), tp="model",
                seq_sharded=False)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        jnp.asarray(t).astype(jnp.float32))


def _tokens(vocab, b, s, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _batch(cfg, b, s, seed=0) -> dict:
    """The arch's inputs as numpy arrays: `_tokens` (B, S) for a
    decoder-only arch; `SyntheticBatches`' step 0 (seq_len S) for an
    enc-dec or VLM one (frames (B, S, D) and S // dec_ratio tokens, at
    least 16; or image embeds (B, n_image_tokens, D) and S - n_image_tokens
    tokens, at least 16)."""
    if cfg.encoder_decoder or cfg.n_image_tokens:
        return pipeline.SyntheticBatches(cfg, s, b, seed).batch(0)
    return {"tokens": _tokens(cfg.vocab, b, s, seed)}


def _jb(batch) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch) -> dict:
    return {k: _t(v) for k, v in batch.items()}


def _fill_cross(rcache, cache, segs, seed=0):
    """Seeded draws (float32, scale 0.5) into every cross-attending layer's
    `xk`/`xv`, in the reference's stacked cache and the port's per-layer
    one alike (repeat r of slot j is layer r·len(pattern) + j).  Returns
    the reference's cache."""
    rng = np.random.default_rng(seed)
    rcache = [dict(seg) for seg in rcache]
    for rseg, seg, (pat, reps) in zip(rcache, cache, segs, strict=True):
        for j in range(len(pat)):
            slot = dict(rseg[f"b{j}"])
            for key in ("xk", "xv"):
                if key not in slot:
                    continue
                a = (rng.standard_normal(slot[key].shape) * 0.5).astype(np.float32)
                slot[key] = jnp.asarray(a).astype(slot[key].dtype)
                for r in range(reps):
                    seg[r * len(pat) + j][key].copy_(_t(a[r]))
            rseg[f"b{j}"] = slot
    return rcache


@functools.lru_cache(maxsize=None)
def _reference_params(arch):
    return RLM(rconfigs.get_smoke_config(arch)).init(jax.random.key(0))[0]


def _pair(arch, compute_dtype="float32"):
    """(reference LM, its params, port LM, the same params), smoke config."""
    rcfg = dataclasses.replace(rconfigs.get_smoke_config(arch), compute_dtype=compute_dtype)
    cfg = dataclasses.replace(configs.get_smoke_config(arch), compute_dtype=compute_dtype)
    rparams = _reference_params(arch)
    return RLM(rcfg), rparams, LM(cfg), lm_params_from_reference(rparams, cfg, device=CPU)


def _hidden_seen(lm) -> list:
    """Record every hidden state the port's `_logits` is given."""
    seen, logits = [], lm._logits

    def record(p, x, *ctx):
        seen.append(_np(x))
        return logits(p, x, *ctx)
    lm._logits = record
    return seen


def _hold(got, want, h, rlm, rparams, compute_dtype, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want)
    if compute_dtype == "float32":
        w = np.asarray(rparams["embed"]["w"]).T if rlm.cfg.tie_embeddings \
            else np.asarray(rparams["unembed"]["w"])
        tol = LOGIT_REL * (np.abs(h.astype(np.float64)) @ np.abs(w.astype(np.float64)))
    else:
        tol = BF16_REL * np.abs(want).max()
    assert np.all(err <= tol), f"{what}: max error {err.max():.3e}"


def _shapes(tree):
    return nn.tree_map(lambda a: (tuple(a.shape), a.dtype), tree)


# ---------------------------------------------------------------------------
# builds, inits and the carried weights
# ---------------------------------------------------------------------------

def test_lm_builds_full_and_smoke(arch):
    for get in (configs.get_config, configs.get_smoke_config):
        assert LM(get(arch)).cfg.family == FAMILIES[arch]


def test_init_matches_reference_shapes(arch):
    """The port's own init has the reference's tree, shapes and dtypes, and
    a finite loss."""
    _, rparams, lm, params = _pair(arch)
    mine, _ = lm.init(torch.Generator(CPU).manual_seed(0))
    assert _shapes(mine) == _shapes(params)
    assert nn.param_count(mine) == sum(a.size for a in jax.tree.leaves(rparams))
    assert np.isfinite(float(lm.loss(mine, CTX, _tb(_batch(lm.cfg, 2, 9)))))


def test_full_width_init_matches_reference(arch):
    """The published config on the meta device (`nn.SHAPES`, nothing
    allocated): the reference's top-level leaves, per layer (the encoder's
    too) the reference's shapes (`jax.eval_shape`), every leaf in its param
    dtype (jamba's bfloat16), the same parameter count."""
    cfg = configs.get_config(arch)
    mine, _ = LM(cfg).init(nn.SHAPES)
    rlm = RLM(rconfigs.get_config(arch))
    rshapes = jax.eval_shape(lambda: rlm.init(jax.random.key(0))[0])
    assert all(a.device.type == "meta" and a.dtype == cfg.pdtype for a in nn.tree_leaves(mine))
    assert nn.param_count(mine) == sum(a.size for a in jax.tree.leaves(rshapes))
    assert sorted(mine) == sorted(rshapes)
    stacks = [("layers", rlm.segs)] + ([("enc_layers", rlm.enc_segs)] if cfg.encoder_decoder
                                       else [])
    for key, segs in stacks:
        for seg_p, rseg, (pat, reps) in zip(mine[key], rshapes[key], segs, strict=True):
            for r in range(reps):
                for j in range(len(pat)):
                    got = nn.tree_map(lambda a: tuple(a.shape), seg_p[r * len(pat) + j])
                    assert got == jax.tree.map(lambda a: tuple(a.shape[1:]), rseg[f"b{j}"])
    for key in mine.keys() - {k for k, _ in stacks}:
        assert nn.tree_map(lambda a: tuple(a.shape), mine[key]) == jax.tree.map(
            lambda a: tuple(a.shape), rshapes[key])


def test_interop_carries_the_new_leaves():
    """The stacked (reps, E, D, F) expert weights, Mamba's a_log and the
    sLSTM's (4, H, dh, dh) r: repeat r of slot j is layer r·len(pattern) + j."""
    for arch, path in [("qwen3_moe_30b_a3b", ("moe", "wg")),
                       ("jamba_1_5_large_398b", ("mamba", "a_log")),
                       ("jamba_1_5_large_398b", ("moe", "wd")),
                       ("xlstm_350m", ("slstm", "r"))]:
        rlm, rparams, lm, params = _pair(arch)
        for (pat, reps), seg, rseg in zip(rlm.segs, params["layers"], rparams["layers"],
                                          strict=True):
            for r in range(reps):
                for j, spec in enumerate(pat):
                    if path[0] in (spec.mixer, spec.mlp):
                        got = seg[r * len(pat) + j][path[0]][path[1]]
                        want = np.asarray(rseg[f"b{j}"][path[0]][path[1]][r])
                        assert got.dtype == torch.float32 and got.shape == want.shape
                        np.testing.assert_array_equal(got.numpy(), want)


def test_init_casts_each_leaf_as_it_is_drawn(monkeypatch):
    """A bfloat16 config gets bfloat16 leaves with the float32 config's tree
    and shapes, and no float32 draw outlives the next draw: the init never
    holds a float32 copy of the model."""
    cfg32 = configs.get_smoke_config("jamba_1_5_large_398b")
    cfg16 = dataclasses.replace(cfg32, param_dtype="bfloat16")
    p32, _ = LM(cfg32).init(torch.Generator(CPU).manual_seed(0))
    drawn, alive = [], []
    randn = torch.randn

    def tracked(*a, **k):
        t = randn(*a, **k)
        alive.append(sum(r() is not None for r in drawn))
        drawn.append(weakref.ref(t))
        return t
    monkeypatch.setattr(torch, "randn", tracked)
    gc.disable()
    try:
        p16, _ = LM(cfg16).init(torch.Generator(CPU).manual_seed(0))
    finally:
        gc.enable()
    assert len(drawn) > 30 and max(alive) == 0
    assert all(a.dtype == torch.bfloat16 for a in nn.tree_leaves(p16))
    assert nn.tree_map(lambda a: tuple(a.shape), p16) == nn.tree_map(lambda a: tuple(a.shape), p32)
    # the same draws, rounded: the bfloat16 leaves are the float32 ones cast
    for a, b in zip(nn.tree_leaves(p16), nn.tree_leaves(p32), strict=True):
        assert torch.equal(a, b.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_model_matches_reference(arch, compute_dtype):
    """prefill, loss and 8 teacher-forced decode steps (against a cross cache
    of ENC_LEN seeded keys and values, enc-dec only)."""
    rlm, rparams, lm, params = _pair(arch, compute_dtype)
    batch = _batch(lm.cfg, 2, 40)
    toks = batch["tokens"]
    seen = _hidden_seen(lm)
    want = jax.jit(rsteps.make_prefill_step(rlm, _rctx()))(rparams, _jb(batch))
    got = steps.make_prefill_step(lm, CTX)(params, _tb(batch))
    _hold(got, want, seen[-1], rlm, rparams, compute_dtype, "prefill")
    want_loss = float(jax.jit(lambda p, b: rlm.loss(p, _rctx(), b))(rparams, _jb(batch)))
    got_loss = float(lm.loss(params, CTX, _tb(batch)))
    assert abs(got_loss - want_loss) <= LOSS_REL[compute_dtype] * want_loss
    rstep = jax.jit(rsteps.make_decode_step(rlm, _rctx()))
    rcache = rlm.init_cache(2, max_len=24, enc_len=ENC_LEN, dtype=jnp.float32)
    cache = lm.init_cache(2, max_len=24, dtype=torch.float32, enc_len=ENC_LEN, device=CPU)
    rcache = _fill_cross(rcache, cache, lm.segs)
    for t in range(8):
        want, rcache = rstep(rparams, jnp.asarray(toks[:, t:t + 1]), rcache, jnp.int32(t))
        got, cache = lm.decode_step(params, CTX, _t(toks[:, t:t + 1]), cache, t)
        _hold(got, want, seen[-1][:, 0], rlm, rparams, compute_dtype, f"decode step {t}")


def test_generate_matches_reference(arch):
    rlm, rparams, lm, params = _pair(arch)
    prompts = pipeline.SyntheticTokens(lm.cfg.vocab, 10, 2).batch(0)
    want = np.asarray(rsteps.generate(rlm, rparams, _rctx(), jnp.asarray(prompts), 6))
    got = steps.generate(lm, params, CTX, _t(prompts), 6)
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_caches_hold_float32_states_on_the_device():
    """`init_cache` puts the recurrent mixers' float32 states (and
    attention's ring) on the device it is given, whatever the cache dtype."""
    for arch in ("xlstm_350m", "jamba_1_5_large_398b"):
        lm = LM(configs.get_smoke_config(arch))
        cache = lm.init_cache(2, max_len=16, dtype=torch.bfloat16, device="meta")
        for layer in (c for seg in cache for c in seg):
            for kind, state in layer.items():
                for name, a in state.items():
                    assert a.device.type == "meta"
                    if kind != "kv" and name != "conv":
                        assert a.dtype == torch.float32, (kind, name)


def test_train_step_matches_reference(arch):
    """One step of both train steps (float32 compute and moments) from the
    same params and state, then three more of the port's lower the loss
    (tests/test_arch_smoke.py::test_smoke_train_step_decreases_loss)."""
    rlm, rparams, lm, params = _pair(arch)
    ropt_cfg, opt_cfg = RAdamWConfig(lr=LR), AdamWConfig(lr=LR)
    ropt = radamw_init(rparams, ropt_cfg)
    opt = opt_state_from_reference(ropt, lm.cfg, device=CPU)
    batch = _batch(lm.cfg, 4, 16)
    rstep = jax.jit(rsteps.make_train_step(rlm, _rctx(), ropt_cfg))
    step = steps.make_train_step(lm, CTX, opt_cfg)
    rparams, ropt, rloss = rstep(rparams, ropt, _jb(batch))
    params, opt, loss = step(params, opt, _tb(batch))
    assert abs(float(loss) - float(rloss)) <= LOSS_REL["float32"] * float(rloss)
    want = lm_params_from_reference(rparams, lm.cfg, device=CPU)
    d = torch.cat([(a - b).abs().flatten() for a, b in zip(
        nn.tree_leaves(params), nn.tree_leaves(want), strict=True)])
    assert float((d > PARAM_ATOL).float().mean()) <= PARAM_SHARE and float(d.max()) <= 4 * LR
    losses = [float(loss)]
    for _ in range(3):
        params, opt, loss = step(params, opt, _tb(batch))
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


# ---------------------------------------------------------------------------
# the example and the mixers
# ---------------------------------------------------------------------------

def test_serve_lm_example_matches_reference(arch, monkeypatch, capsys):
    """`serve_lm --arch` for the new families against examples/serve_lm.py,
    both at float32 on the reference's weights: the same tokens."""
    def f32(get):
        return lambda name: dataclasses.replace(get(name), compute_dtype="float32")
    monkeypatch.setattr(rconfigs, "get_smoke_config", f32(rconfigs.get_smoke_config))
    monkeypatch.setattr(serve_lm, "get_smoke_config", f32(configs.get_smoke_config))
    carried = []
    init = RLM.init

    def record(self, key):
        carried.append(init(self, key))
        return carried[-1]
    monkeypatch.setattr(RLM, "init", record)
    monkeypatch.setattr(LM, "init", lambda self, generator: (
        lm_params_from_reference(carried[0][0], self.cfg, device=generator.device), None))
    argv = ["--arch", arch.replace("_", "-"), "--batch", "2", "--prompt-len", "12", "--gen", "4"]
    example = Path(__file__).resolve().parents[1] / "examples" / "serve_lm.py"
    monkeypatch.setattr("sys.argv", [str(example), *argv])
    runpy.run_path(str(example), run_name="__main__")
    want = capsys.readouterr().out
    assert serve_lm.main([*argv, "--device", "cpu"]) == 0
    got = capsys.readouterr().out

    def parts(out):
        head, body = out.split("\n", 1)
        return re.sub(r"in [\d.]+s \([\d.]+ tok/s\)", "", head), body
    assert parts(got) == parts(want)
    assert "-> (2, 4)" in got


def test_unknown_mixer_raises():
    cfg = configs.get_smoke_config("qwen3_14b")
    with pytest.raises(ValueError):
        tr.block_init(torch.Generator(CPU).manual_seed(0), cfg, tr.LayerSpec(mixer="rwkv"))
