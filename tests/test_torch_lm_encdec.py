"""The port's enc-dec and VLM families against the JAX package's on the
CPU: whisper-medium (an encoder stack over stub frame embeddings, decoder
blocks that cross-attend to it) and internvl2-1b (`img_proj` of stub
patch embeddings before the text; the loss over the text tail), at their
smoke configs.  The whole-model cases and their tolerances are
tests/_lm_families.py's, run here for these two archs on `SyntheticBatches`'
inputs; decode runs against a cross cache of seeded keys and values, and
`generate` with an empty one (enc_len 0), as the reference runs it.

The module cases: a cross-attending block (prefill over an encoder output,
decode against a cross cache) at float32 within 1e-5 and at bfloat16 as
tests/test_torch_lm.py holds a block (≤ 1% of outputs differ, none by more
than two bfloat16 steps); `attention(kv_x=...)` with 13 queries against 37
keys (`kv_block` 16: a padded last block); `attn_cross_decode` over an
empty encoder (enc_len 0); the audio-frontend branch without an encoder;
`interop` carrying `enc_layers`, `enc_norm` and `img_proj`; the cross
cache's shapes; a whisper checkpoint restored by `elastic_restore`.  They
mirror tests/test_arch_smoke.py (loss, train step, decode step with a
cross cache) and tests/test_system.py's generation for these archs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from _lm_families import (  # noqa: F401 -- collected here
    CPU,
    CTX,
    LOSS_REL,
    _hidden_seen,
    _hold,
    _np,
    _pair,
    _rctx,
    _t,
    test_full_width_init_matches_reference,
    test_generate_matches_reference,
    test_init_matches_reference_shapes,
    test_lm_builds_full_and_smoke,
    test_model_matches_reference,
    test_serve_lm_example_matches_reference,
    test_train_step_matches_reference,
)

from repro import configs as rconfigs
from repro.models import LM as RLM
from repro.models import attention as ram
from repro.models import transformer as rtr
from repro_torch import configs
from repro_torch.checkpoint import save_checkpoint
from repro_torch.data import SyntheticBatches
from repro_torch.interop import lm_params_from_reference
from repro_torch.launch import elastic, steps
from repro_torch.models import LM, LayerSpec, nn
from repro_torch.models import attention as am
from repro_torch.models import transformer as tr
from repro_torch.optim import AdamWConfig, adamw_init

WHISPER = "whisper_medium"
BLOCK_TOL = 1e-5       # float32, one block or one attention call
BF16_STEPS = 2.0 ** -6  # relative, bfloat16, one block: two bfloat16 steps
BF16_FLIPS = 0.01      # the share of a block's bfloat16 outputs that may differ at all


@pytest.fixture(params=[WHISPER, "internvl2_1b"])
def arch(request):
    return request.param


def _hold_block(got, want, dtype):
    got, want = _np(got), _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=BLOCK_TOL, atol=BLOCK_TOL)
        return
    assert np.mean(got != want) <= BF16_FLIPS
    np.testing.assert_allclose(got, want, rtol=BF16_STEPS, atol=0)


# ---------------------------------------------------------------------------
# attention at the lengths cross-attention gives it
# ---------------------------------------------------------------------------

def _cross_attn_cfgs(**kw):
    base = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, q_block=8, kv_block=16,
                causal=False, rope=False, bias=True)
    base.update(kw)
    return ram.AttnConfig(**base), am.AttnConfig(**base)


def _attn_params(rcfg):
    rp, _ = ram.attn_init(jax.random.key(3), rcfg)
    return rp, nn.tree_map(_t, jax.tree.map(np.asarray, rp))


def test_attention_over_an_encoder_of_another_length():
    """13 queries against 37 encoder keys: two query blocks of 8 (three
    padded rows), three key blocks of 16 (eleven padded keys)."""
    rcfg, cfg = _cross_attn_cfgs()
    rp, p = _attn_params(rcfg)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 13, 32)).astype(np.float32) * 0.5
    enc = rng.standard_normal((2, 37, 32)).astype(np.float32) * 0.5
    want, (wk, wv) = ram.attention(rp, rcfg, jnp.asarray(x), kv_x=jnp.asarray(enc),
                                   kv_positions=jnp.arange(37))
    got, (k, v) = am.attention(p, cfg, _t(x), kv_x=_t(enc), kv_positions=torch.arange(37))
    assert got.shape == (2, 13, 32) and k.shape == (2, 37, 2, 8)
    for a, b in [(got, want), (k, wk), (v, wv)]:
        np.testing.assert_allclose(_np(a), _np(b), rtol=BLOCK_TOL, atol=BLOCK_TOL)


@pytest.mark.parametrize("enc_len", [0, 5])
def test_attn_cross_decode_over_an_encoder_of_any_length(enc_len):
    """enc_len 0: the softmax and its product run over an empty key axis,
    and the output is the output projection's bias, as in the reference."""
    rcfg, cfg = _cross_attn_cfgs()
    rp, p = _attn_params(rcfg)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 1, 32)).astype(np.float32)
    ek, ev = (rng.standard_normal((2, enc_len, 2, 8)).astype(np.float32) for _ in range(2))
    want = ram.attn_cross_decode(rp, rcfg, x, ek, ev, jnp.int32(0))
    got = am.attn_cross_decode(p, cfg, _t(x), _t(ek), _t(ev))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(_np(got), _np(want), rtol=BLOCK_TOL, atol=BLOCK_TOL)
    if enc_len == 0:
        np.testing.assert_array_equal(_np(got), np.broadcast_to(_np(p["wo"]["b"]), got.shape))


# ---------------------------------------------------------------------------
# the cross-attending block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_block_apply_and_decode_match_reference(dtype):
    """Whisper's decoder block: prefill of 7 positions over an encoder
    output of 11, then 7 decode steps against a cross cache of 11 seeded
    keys and values, each against the eager reference."""
    rcfg = rconfigs.get_smoke_config(WHISPER)
    cfg = configs.get_smoke_config(WHISPER)
    rspec, spec = rtr.LayerSpec(cross_attn=True), LayerSpec(cross_attn=True)
    rp, _ = rtr.block_init(jax.random.key(7), rcfg, rspec)
    p = nn.tree_map(_t, jax.tree.map(np.asarray, rp))
    assert sorted(p) == ["attn", "ln1", "ln2", "lnx", "mlp", "xattn"]
    mine, _ = tr.block_init(torch.Generator(CPU).manual_seed(0), cfg, spec)
    assert nn.tree_map(lambda a: tuple(a.shape), mine) == nn.tree_map(lambda a: tuple(a.shape), p)
    b, s, e = 2, 7, 11
    rng = np.random.default_rng(8)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((b, e, cfg.d_model)).astype(np.float32)
    tdt = getattr(torch, dtype)
    jx, tx = jnp.asarray(x).astype(dtype), _t(x).to(tdt)
    want = rtr.block_apply(rp, rcfg, rspec, _rctx(), jx, positions=jnp.arange(s),
                           enc_out=jnp.asarray(enc).astype(dtype))
    got = tr.block_apply(p, cfg, spec, CTX, tx, positions=torch.arange(s),
                         enc_out=_t(enc).to(tdt))
    _hold_block(got, want, dtype)
    rcache = dict(rtr.init_block_cache(rcfg, rspec, b, 16, e, dtype=jnp.float32))
    cache = tr.init_block_cache(cfg, spec, b, 16, torch.float32, enc_len=e, device=CPU)
    for key in ("xk", "xv"):
        a = (rng.standard_normal(rcache[key].shape) * 0.5).astype(np.float32)
        rcache[key] = jnp.asarray(a)
        cache[key].copy_(_t(a))
    for t in range(s):
        want, rcache = rtr.block_decode(rp, rcfg, rspec, _rctx(), jx[:, t:t + 1], rcache,
                                        jnp.int32(t))
        got, cache = tr.block_decode(p, cfg, spec, CTX, tx[:, t:t + 1], cache, t)
        _hold_block(got, want, dtype)


def test_cross_cache_matches_reference():
    """`init_cache(enc_len=...)`: every decoder layer's `xk`/`xv` zeros of
    (B, enc_len, n_kv_heads, head_dim) in the cache dtype, on the device
    given, as the reference's (unstacked); none for internvl."""
    for arch, enc_len in [(WHISPER, 0), (WHISPER, 9), ("internvl2_1b", 9)]:
        rlm = RLM(rconfigs.get_smoke_config(arch))
        lm = LM(configs.get_smoke_config(arch))
        rcache = rlm.init_cache(3, max_len=16, enc_len=enc_len, dtype=jnp.bfloat16)
        cache = lm.init_cache(3, max_len=16, dtype=torch.bfloat16, enc_len=enc_len,
                              device="meta")
        for rseg, seg, (pat, reps) in zip(rcache, cache, lm.segs, strict=True):
            for r in range(reps):
                for j in range(len(pat)):
                    layer, rlayer = seg[r * len(pat) + j], rseg[f"b{j}"]
                    assert sorted(layer) == sorted(rlayer)
                    for key in ("xk", "xv"):
                        if key in layer:
                            assert tuple(layer[key].shape) == rlayer[key].shape[1:]
                            assert layer[key].dtype == torch.bfloat16
                            assert layer[key].device.type == "meta"
        assert all("xk" in layer for seg in cache for layer in seg) == (arch == WHISPER)


# ---------------------------------------------------------------------------
# the branches and the carried weights
# ---------------------------------------------------------------------------

def test_audio_frontend_without_an_encoder_matches_reference():
    """`audio_frontend` with `encoder_decoder=False`: the frames are the
    decoder's input (no config uses it; the reference has it).  prefill and
    loss at float32."""
    rcfg = dataclasses.replace(rconfigs.get_smoke_config(WHISPER), encoder_decoder=False,
                               compute_dtype="float32")
    cfg = dataclasses.replace(configs.get_smoke_config(WHISPER), encoder_decoder=False,
                              compute_dtype="float32")
    rlm, lm = RLM(rcfg), LM(cfg)
    assert not hasattr(lm, "enc_segs") and not any(s.cross_attn for pat, _ in lm.segs
                                                   for s in pat)
    rparams = rlm.init(jax.random.key(1))[0]
    params = lm_params_from_reference(rparams, cfg, device=CPU)
    assert "enc_layers" not in params
    rng = np.random.default_rng(9)
    batch = {"frames": (rng.standard_normal((2, 12, cfg.d_model)) * 0.02).astype(np.float32),
             "tokens": rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)}
    seen = _hidden_seen(lm)
    want = rlm.prefill(rparams, _rctx(), {k: jnp.asarray(v) for k, v in batch.items()})
    got = lm.prefill(params, CTX, {k: _t(v) for k, v in batch.items()})
    _hold(got, want, seen[-1], rlm, rparams, "float32", "prefill")
    want_loss = float(rlm.loss(rparams, _rctx(), {k: jnp.asarray(v) for k, v in batch.items()}))
    got_loss = float(lm.loss(params, CTX, {k: _t(v) for k, v in batch.items()}))
    assert abs(got_loss - want_loss) <= LOSS_REL["float32"] * want_loss


def test_interop_carries_encoder_and_image_leaves():
    """Repeat r of the encoder's one slot is encoder layer r; `enc_norm`
    and `img_proj` pass through; the decoder's layers hold `lnx`/`xattn`."""
    rlm, rparams, lm, params = _pair(WHISPER)
    assert list(params) == list(rparams)
    (pat, reps), = rlm.enc_segs
    assert len(pat) == 1 and len(params["enc_layers"][0]) == reps == lm.cfg.n_enc_layers
    for r in range(reps):
        for path in (("attn", "wq", "w"), ("mlp", "w1"), ("ln1", "g")):
            got = params["enc_layers"][0][r]
            want = rparams["enc_layers"][0]["b0"]
            for k in path:
                got, want = got[k], want[k]
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want)[r])
        np.testing.assert_array_equal(params["layers"][0][r]["xattn"]["wk"]["w"].numpy(),
                                      np.asarray(rparams["layers"][0]["b0"]["xattn"]["wk"]["w"])[r])
    np.testing.assert_array_equal(params["enc_norm"]["g"].numpy(), np.asarray(rparams["enc_norm"]["g"]))
    _, rparams, _, params = _pair("internvl2_1b")
    assert "enc_layers" not in params
    np.testing.assert_array_equal(params["img_proj"]["w"].numpy(),
                                  np.asarray(rparams["img_proj"]["w"]))


def test_whisper_checkpoint_round_trip(tmp_path):
    """A whisper smoke state after one train step, saved, then restored by
    `elastic_restore` into `LM.init(nn.SHAPES)`'s like-tree: bit for bit,
    and one step from it gives the live run's next loss."""
    cfg = dataclasses.replace(configs.get_smoke_config(WHISPER), compute_dtype="float32")
    lm = LM(cfg)
    opt_cfg = AdamWConfig(lr=1e-3)
    params, _ = lm.init(torch.Generator(CPU).manual_seed(0))
    opt = adamw_init(params, opt_cfg)
    batch = {k: _t(v) for k, v in SyntheticBatches(cfg, 16, 4).batch(0).items()}
    step = steps.make_train_step(lm, CTX, opt_cfg, grad_accum=2)
    params, opt, _ = step(params, opt, batch)
    state = {"params": params, "opt": opt}
    save_checkpoint(str(tmp_path), 1, state)
    snapshot = nn.tree_map(torch.clone, state)
    _, _, live = step(params, opt, batch)
    assert not dist.is_initialized()
    try:
        _, rparams, ropt, start = elastic.elastic_restore(lm, str(tmp_path), opt_cfg, device="cpu")
    finally:
        dist.destroy_process_group()
    assert start == 1
    got, want = nn.tree_leaves({"params": rparams, "opt": ropt}), nn.tree_leaves(snapshot)
    assert len(got) == len(want) and all(
        a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want, strict=True))
    assert "enc_layers" in rparams
    _, _, loss = step(rparams, ropt, batch)
    assert float(loss) == float(live)


def test_generate_runs_against_an_empty_cross_cache():
    """`generate` makes its cache with enc_len 0, as the reference's does:
    whisper's decoder cross-attends over no keys (every layer's `xk` is
    empty); test_generate_matches_reference holds its tokens to the
    reference's."""
    _, _, lm, params = _pair(WHISPER)
    made = []
    init_cache = lm.init_cache

    def record(*a, **k):
        made.append(init_cache(*a, **k))
        return made[-1]
    lm.init_cache = record
    toks = steps.generate(lm, params, CTX, torch.zeros((2, 3), dtype=torch.int32), 2)
    assert toks.shape == (2, 2)
    assert all(layer["xk"].shape[1] == 0 for seg in made[0] for layer in seg)
