"""The port's LM serving path (`repro_torch.models`, `configs`, `data`,
`launch.steps`, `examples.serve_lm`) against the JAX package's on the CPU,
at the smoke sizes, both on the same seeded inputs, the weights carried
across by `interop.lm_params_from_reference`; the reference runs with
`MeshCtx(mesh=None)`.

Tolerances, float32: the nn pieces within 1e-6 and attention within 1e-5
(the two frameworks sum in other orders); whole-model logits within 1e-5
of Σ|terms| of the final product (|h| @ |W|, h the final normed hidden
state) and `generate`'s tokens equal.  bfloat16: one block's outputs bit
for bit the reference's but for at most 1% of them, none more than two
bfloat16 steps (2^-6 relative) away, against the eager reference: every
elementwise step rounds as eager jnp rounds it (the activations are
written out so; 0.04% differ, measured); the whole model's logits within
2^-3 of the largest |logit| at each step.  That bound is loose on purpose:
the reference's stack is a compiled `lax.scan`, in which XLA fuses
elementwise bfloat16 steps and rounds fewer times than eager jnp (and than
the port, which rounds as eager jnp does), and the frameworks' float32
sums differ in order; a flipped rounding spreads through the layers and
the cache.
Measured on 3 prompts × 13 steps: up to 5.7% of the largest |logit| on
gemma3-4b's smoke config, 1.9% on the others (0.13 absolute on
qwen3-14b's untied logits, which reach 6, where one bfloat16 step is
0.031).  The float32 checks are the sharp ones.

It mirrors the seed tests of the stack it ports: tests/test_models.py
(attention: blocked against naive, decode against prefill), test_arch_smoke.py
(forward loss and decode step per arch, the published configs),
test_system.py (generation end to end) and test_optim_data.py (the data
pipeline).
"""
import dataclasses
import functools
import re
import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.data import pipeline as rpipe
from repro.launch import steps as rsteps
from repro.models import LM as RLM
from repro.models import MeshCtx as RCtx
from repro.models import attention as ram
from repro.models import nn as rnn
from repro.models import transformer as rtr
from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.examples import serve_lm
from repro_torch.interop import lm_params_from_reference
from repro_torch.launch import steps
from repro_torch.models import LM, LayerSpec, MeshCtx
from repro_torch.models import attention as am
from repro_torch.models import nn
from repro_torch.models import transformer as tr

CPU = torch.device("cpu")
DENSE = ["gemma3_4b", "qwen3_14b", "minitron_4b", "command_r_35b"]
NN_TOL = 1e-6
ATTN_TOL = 1e-5
LOGIT_REL = 1e-5       # of Σ|terms|, float32
BF16_REL = 2.0 ** -3   # of max |logit|, bfloat16, the whole model
BF16_STEPS = 2.0 ** -6  # relative, bfloat16, one block: two bfloat16 steps
BF16_FLIPS = 0.01      # the share of a block's bfloat16 outputs that may differ at all
CTX = MeshCtx(mesh=None)
RCTX = RCtx(mesh=None)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _tokens(vocab, b, s, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _reference_params(arch):
    """The reference's smoke-config params (its init does not depend on the
    compute dtype)."""
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


def _abs_terms(rlm, rparams, h) -> np.ndarray:
    cfg = rlm.cfg
    w = np.asarray(rparams["embed"]["w"]).T if cfg.tie_embeddings \
        else np.asarray(rparams["unembed"]["w"])
    return np.abs(h.astype(np.float64)) @ np.abs(w.astype(np.float64))


def _hold(got, want, terms, compute_dtype, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want)
    tol = (LOGIT_REL * terms if compute_dtype == "float32"
           else BF16_REL * np.abs(want).max())
    assert np.all(err <= tol), f"{what}: max error {err.max():.3e}"


def _hold_block(got, want, dtype):
    got, want = _np(got), _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
        return
    assert np.mean(got != want) <= BF16_FLIPS
    np.testing.assert_allclose(got, want, rtol=BF16_STEPS, atol=0)


# ---------------------------------------------------------------------------
# nn
# ---------------------------------------------------------------------------

def _nn_case(name, rng):
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    g = (rng.standard_normal(16) * 0.3).astype(np.float32)
    w = (rng.standard_normal((16, 24)) * 0.25).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    pos = np.arange(3, 8)
    return {
        "rmsnorm": (lambda: rnn.rmsnorm({"g": g}, x), lambda: nn.rmsnorm({"g": _t(g)}, _t(x))),
        "layernorm": (lambda: rnn.layernorm({"g": g}, x),
                      lambda: nn.layernorm({"g": _t(g)}, _t(x))),
        "apply_rope": (lambda: rnn.apply_rope(x, jnp.asarray(pos), theta=1e6),
                       lambda: nn.apply_rope(_t(x), _t(pos), theta=1e6)),
        "softcap": (lambda: rnn.softcap(x * 40, 30.0), lambda: nn.softcap(_t(x) * 40, 30.0)),
        "linear": (lambda: rnn.linear({"w": w, "b": b}, x),
                   lambda: nn.linear({"w": _t(w), "b": _t(b)}, _t(x))),
    }[name]


@pytest.mark.parametrize("name", ["rmsnorm", "layernorm", "apply_rope", "softcap", "linear"])
def test_nn_matches_reference(name):
    want, got = _nn_case(name, np.random.default_rng(0))
    np.testing.assert_allclose(_np(got()), _np(want()), rtol=NN_TOL, atol=NN_TOL)


def test_activations_round_as_the_reference():
    """GeGLU's gelu (the tanh approximation) and SwiGLU's silu, bit for bit
    in bfloat16 and within 1e-6 in float32."""
    x = np.random.default_rng(1).standard_normal(4096).astype(np.float32) * 3
    for dtype, jdtype, tol in [(torch.bfloat16, jnp.bfloat16, 0.0), (torch.float32, jnp.float32,
                                                                       NN_TOL)]:
        for mine, ref in [(nn.gelu, jax.nn.gelu), (nn.silu, jax.nn.silu)]:
            got = _np(mine(_t(x).to(dtype)))
            want = np.asarray(ref(jnp.asarray(x).astype(jdtype)).astype(jnp.float32))
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _attn_cfgs(variant, **kw):
    base = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, q_block=8, kv_block=16,
                causal=variant != "bidir", window=6 if variant == "window" else None,
                chunk=8 if variant == "chunk" else None, qk_norm=True, softcap=20.0)
    base.update(kw)
    return ram.AttnConfig(**base), am.AttnConfig(**base)


def _attn_params(rcfg):
    rp, _ = ram.attn_init(jax.random.key(3), rcfg)
    return rp, nn.tree_map(_t, jax.tree.map(np.asarray, rp))


@pytest.mark.parametrize("variant", ["full", "window", "chunk", "bidir"])
def test_attention_matches_reference(variant):
    rcfg, cfg = _attn_cfgs(variant)
    rp, p = _attn_params(rcfg)
    x = np.random.default_rng(4).standard_normal((2, 37, 32)).astype(np.float32) * 0.5
    want, (wk, wv) = ram.attention(rp, rcfg, jnp.asarray(x))
    got, (k, v) = am.attention(p, cfg, _t(x))
    for a, b in [(got, want), (k, wk), (v, wv)]:
        np.testing.assert_allclose(_np(a), _np(b), rtol=ATTN_TOL, atol=ATTN_TOL)


@pytest.mark.parametrize("variant", ["full", "window", "chunk"])
def test_attn_decode_matches_reference(variant):
    """Step by step against the reference's decode; the window's ring (6
    slots) and the chunk's (8) wrap within the 17 steps."""
    rcfg, cfg = _attn_cfgs(variant)
    rp, p = _attn_params(rcfg)
    b, s = 2, 17
    x = np.random.default_rng(5).standard_normal((b, s, 32)).astype(np.float32) * 0.5
    rcache = ram.init_kv_cache(rcfg, b, max_len=32, dtype=jnp.float32)
    cache = am.init_kv_cache(cfg, b, max_len=32, dtype=torch.float32, device=CPU)
    outs = []
    for t in range(s):
        want, rcache = ram.attn_decode(rp, rcfg, jnp.asarray(x[:, t:t + 1]), rcache,
                                       jnp.int32(t))
        got, cache = am.attn_decode(p, cfg, _t(x[:, t:t + 1]), cache, t)
        np.testing.assert_allclose(_np(got), _np(want), rtol=ATTN_TOL, atol=ATTN_TOL)
        outs.append(got)
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(rcache["pos"]))
    np.testing.assert_allclose(_np(cache["k"]), _np(rcache["k"]), rtol=ATTN_TOL, atol=ATTN_TOL)
    # and against the port's own prefill (tests/test_models.py's check)
    full, _ = am.attention(p, cfg, _t(x))
    np.testing.assert_allclose(_np(torch.cat(outs, 1)), _np(full), rtol=2e-3, atol=2e-3)


def test_attn_cross_decode_matches_reference():
    rcfg, cfg = _attn_cfgs("bidir")
    rp, p = _attn_params(rcfg)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 1, 32)).astype(np.float32)
    ek, ev = (rng.standard_normal((2, 9, 2, 8)).astype(np.float32) for _ in range(2))
    want = ram.attn_cross_decode(rp, rcfg, x, ek, ev, jnp.int32(0))
    got = am.attn_cross_decode(p, cfg, _t(x), _t(ek), _t(ev))
    np.testing.assert_allclose(_np(got), _np(want), rtol=ATTN_TOL, atol=ATTN_TOL)


def test_cache_len_matches_reference():
    for variant in ["full", "window", "chunk"]:
        rcfg, cfg = _attn_cfgs(variant)
        for max_len in (4, 7, 32):
            assert am.cache_len(cfg, max_len) == ram.cache_len(rcfg, max_len)


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["local", "global"])
def test_block_apply_and_decode_match_reference(kind, dtype):
    rcfg = rconfigs.get_smoke_config("gemma3_4b")
    cfg = configs.get_smoke_config("gemma3_4b")
    rspec = rtr.LayerSpec(attn_kind=kind)
    spec = LayerSpec(attn_kind=kind)
    rp, _ = rtr.block_init(jax.random.key(7), rcfg, rspec)
    p = nn.tree_map(_t, jax.tree.map(np.asarray, rp))
    b, s = 2, 18
    x = np.random.default_rng(8).standard_normal((b, s, cfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(dtype), _t(x).to(getattr(torch, dtype))
    want = rtr.block_apply(rp, rcfg, rspec, RCTX, jx, positions=jnp.arange(s))
    got = tr.block_apply(p, cfg, spec, CTX, tx, positions=torch.arange(s))
    _hold_block(got, want, dtype)
    rcache = rtr.init_block_cache(rcfg, rspec, b, 32, dtype=jnp.float32)
    cache = tr.init_block_cache(cfg, spec, b, 32, torch.float32, device=CPU)
    for t in range(s):
        want, rcache = rtr.block_decode(rp, rcfg, rspec, RCTX, jx[:, t:t + 1], rcache,
                                        jnp.int32(t))
        got, cache = tr.block_decode(p, cfg, spec, CTX, tx[:, t:t + 1], cache, t)
        _hold_block(got, want, dtype)


def _plain(obj):
    """A config as plain data, its LayerSpecs as dicts."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_plain(o) for o in obj)
    return obj


@pytest.mark.parametrize("arch", rconfigs.ARCHS)
def test_configs_and_layouts_match_reference(arch):
    """Every field of both configs, the segment layout and each layer's
    attention config."""
    assert configs.ARCHS == rconfigs.ARCHS and configs.ALIASES == rconfigs.ALIASES
    for get, rget in [(configs.get_config, rconfigs.get_config),
                      (configs.get_smoke_config, rconfigs.get_smoke_config)]:
        cfg, rcfg = get(arch.replace("_", "-")), rget(arch)
        assert _plain(cfg) == _plain(rcfg)
        assert _plain(tr.segment_layout(cfg.n_layers, cfg.pattern)) == \
            _plain(rtr.segment_layout(rcfg.n_layers, rcfg.pattern))
        for spec, rspec in zip(cfg.pattern, rcfg.pattern, strict=True):
            assert _plain(tr._attn_cfg(cfg, spec)) == _plain(rtr._attn_cfg(rcfg, rspec))
        assert _plain(tr._cross_cfg(cfg)) == _plain(rtr._cross_cfg(rcfg))
    assert cfg.cdtype == torch.bfloat16 and cfg.pdtype == getattr(torch, rcfg.param_dtype)


def test_gemma3_4b_segments():
    cfg = configs.get_config("gemma3-4b")
    local, glob = LayerSpec(attn_kind="local"), LayerSpec(attn_kind="global")
    assert tr.segment_layout(cfg.n_layers, cfg.pattern) == [
        ((local,) * 5 + (glob,), 5), ((local,) * 4, 1)]


def test_params_unstacked_in_layer_order():
    """Repeat r of pattern slot j is the port's layer r·len(pattern) + j."""
    rlm, rparams, lm, params = _pair("gemma3_4b")
    (pat, reps), = rlm.segs
    assert reps == 2 and len(params["layers"][0]) == 4
    for r in range(reps):
        for j in range(len(pat)):
            np.testing.assert_array_equal(
                params["layers"][0][r * len(pat) + j]["attn"]["wq"]["w"].numpy(),
                np.asarray(rparams["layers"][0][f"b{j}"]["attn"]["wq"]["w"][r]))


@pytest.mark.parametrize("arch", DENSE)
def test_init_matches_reference_shapes(arch):
    """The port's own init has the reference's tree, shapes and dtypes."""
    rlm, rparams, lm, params = _pair(arch)
    mine, _ = lm.init(torch.Generator(CPU).manual_seed(0))
    shapes = nn.tree_map(lambda a: (tuple(a.shape), a.dtype), mine)
    assert shapes == nn.tree_map(lambda a: (tuple(a.shape), a.dtype), params)
    assert nn.param_count(mine) == rnn.param_count(rparams)
    assert np.isfinite(float(lm.loss(mine, CTX, {"tokens": _t(_tokens(lm.cfg.vocab, 2, 9))})))


@pytest.mark.parametrize("arch", DENSE)
def test_full_width_init_matches_reference(arch, monkeypatch):
    """The published config's tree, shapes and parameter count (gemma3-4b:
    3,879,925,248), with the draws on the meta device: nothing allocated."""
    monkeypatch.setattr(torch, "randn", lambda shape, generator, device, dtype=None: torch.empty(
        shape, dtype=dtype, device="meta"))
    mine, _ = LM(configs.get_config(arch)).init(torch.Generator(CPU))
    rlm = RLM(rconfigs.get_config(arch))
    rshapes = jax.eval_shape(lambda: rlm.init(jax.random.key(0))[0])
    assert nn.param_count(mine) == rnn.param_count(rshapes)
    segs = rlm.segs
    for seg_p, rseg, (pat, reps) in zip(mine["layers"], rshapes["layers"], segs, strict=True):
        for r in range(reps):
            for j in range(len(pat)):
                got = nn.tree_map(lambda a: tuple(a.shape), seg_p[r * len(pat) + j])
                assert got == jax.tree.map(lambda a: tuple(a.shape[1:]), rseg[f"b{j}"])


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_model_matches_reference(arch, compute_dtype):
    """prefill, loss and 8 teacher-forced decode steps."""
    rlm, rparams, lm, params = _pair(arch, compute_dtype)
    toks = _tokens(lm.cfg.vocab, 2, 40)
    seen = _hidden_seen(lm)
    want = rsteps.make_prefill_step(rlm, RCTX)(rparams, {"tokens": jnp.asarray(toks)})
    got = steps.make_prefill_step(lm, CTX)(params, {"tokens": _t(toks)})
    _hold(got, want, _abs_terms(rlm, rparams, seen[-1]), compute_dtype, "prefill")
    want_loss = float(rlm.loss(rparams, RCTX, {"tokens": jnp.asarray(toks)}))
    got_loss = float(lm.loss(params, CTX, {"tokens": _t(toks)}))
    assert abs(got_loss - want_loss) <= (1e-5 if compute_dtype == "float32" else 1e-2) * want_loss
    rstep = jax.jit(rsteps.make_decode_step(rlm, RCTX))
    rcache = rlm.init_cache(2, max_len=24, dtype=jnp.float32)
    cache = lm.init_cache(2, max_len=24, dtype=torch.float32, device=CPU)
    for t in range(8):
        want, rcache = rstep(rparams, jnp.asarray(toks[:, t:t + 1]), rcache, jnp.int32(t))
        got, cache = lm.decode_step(params, CTX, _t(toks[:, t:t + 1]), cache, t)
        _hold(got, want, _abs_terms(rlm, rparams, seen[-1][:, 0]), compute_dtype,
              f"decode step {t}")


@pytest.mark.parametrize("arch", DENSE)
def test_generate_matches_reference(arch):
    rlm, rparams, lm, params = _pair(arch)
    prompts = pipeline.SyntheticTokens(lm.cfg.vocab, 10, 2).batch(0)
    want = np.asarray(rsteps.generate(rlm, rparams, RCTX, jnp.asarray(prompts), 6))
    got = steps.generate(lm, params, CTX, _t(prompts), 6)
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_decode_wraps_the_ring_against_prefill():
    """The smoke gemma's window is 16: 40 teacher-forced steps wrap its
    local layers' rings twice; the last step's logits against prefill's."""
    _, _, lm, params = _pair("gemma3_4b")
    toks = _t(_tokens(lm.cfg.vocab, 2, 40))
    cache = lm.init_cache(2, max_len=48, dtype=torch.float32, device=CPU)
    assert cache[0][0]["kv"]["k"].shape[1] == 16 and cache[0][1]["kv"]["k"].shape[1] == 48
    for t in range(40):
        logits, cache = lm.decode_step(params, CTX, toks[:, t:t + 1], cache, t)
    want = lm.prefill(params, CTX, {"tokens": toks})[:, 0]
    np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=0,
                               atol=1e-4 * float(want.abs().max()))


# ---------------------------------------------------------------------------
# data, the example, the mesh
# ---------------------------------------------------------------------------

def test_synthetic_tokens_byte_identical():
    for vocab, s, b, seed in [(100, 32, 8, 1), (512, 24, 4, 0), (262144, 40, 3, 7)]:
        mine, ref = pipeline.SyntheticTokens(vocab, s, b, seed), rpipe.SyntheticTokens(
            vocab, s, b, seed)
        for step, shard in [(0, None), (3, pipeline.host_shard_slice(b, 2, 1))]:
            got, want = mine.batch(step, shard), ref.batch(step, shard)
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert pipeline.host_shard_slice(8, 4, 3) == rpipe.host_shard_slice(8, 4, 3)


@pytest.mark.parametrize("arch", ["gemma3_4b", "whisper_medium", "internvl2_1b"])
def test_synthetic_batches_byte_identical(arch):
    got = pipeline.SyntheticBatches(configs.get_smoke_config(arch), 32, 4, seed=2).batch(1)
    want = rpipe.SyntheticBatches(rconfigs.get_smoke_config(arch), 32, 4, seed=2).batch(1)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes()


def test_serve_lm_example_matches_reference(monkeypatch, capsys):
    """Both examples at float32 on the reference's weights: the same tokens
    and the same printed shape."""
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
    argv = ["--arch", "gemma3-4b", "--batch", "3", "--prompt-len", "20", "--gen", "5"]
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
    assert "-> (3, 5)" in got


def test_serve_lm_without_a_card_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert serve_lm.main(["--gen", "2"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_mesh_of_more_ranks_raises():
    """The residual's layouts on a model axis of two ranks (a dry mesh:
    collectives of the right shape that move nothing): `resid` keeps this
    rank's rows, `full` gathers them back, and a partial product lands by
    reduce-scatter (all-reduce when the rows are not split); a length the
    axis does not divide stays whole.  Without a mesh, or on a model axis
    of one rank, every method is the identity."""
    from repro_torch.launch.dryrun import DryMesh
    x = torch.ones((2, 6, 4))
    assert MeshCtx(mesh=None).resid(x) is x and MeshCtx(mesh=None).full(x) is x
    one = MeshCtx(mesh=DryMesh({"data": 2, "model": 1}))
    assert one.resid(x) is x and one.land(x, True) is x and one.for_seq(6).seq_sharded is False
    ctx = MeshCtx(mesh=DryMesh({"data": 1, "model": 2}))
    assert ctx.size("model") == 2 and ctx.coord("model") == 0
    split = ctx.for_seq(6)
    assert split.seq_sharded and tuple(split.resid(x).shape) == (2, 3, 4)
    assert torch.equal(split.resid(x), x[:, :3])
    assert tuple(split.full(split.resid(x)).shape) == (2, 6, 4)
    assert tuple(split.land(x, True).shape) == (2, 3, 4)
    whole = ctx.for_seq(5)
    assert not whole.seq_sharded and whole.resid(x) is x
    assert tuple(whole.land(x, True).shape) == (2, 6, 4)
    with pytest.raises(ValueError, match="does not split"):
        split.land(torch.ones((2, 5, 4)), True)