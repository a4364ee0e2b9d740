"""The port's MoE, Mamba and xLSTM modules (`repro_torch.models.moe`,
`ssm`, `xlstm`) against the JAX package's on the CPU, at small widths, both
on the same seeded inputs and weights (the reference's init, carried
across as numpy).  The reference's MoE runs on tests/conftest.py's
trivial (1, 1) mesh.  The reference runs under `jax.jit` (its eager
`shard_map` takes seconds a call), but for Mamba, which runs eagerly: XLA
fuses the compiled scan's bfloat16 steps and rounds them fewer times.

Tolerances:
- float32: every output within 1e-5 (LOGIT_REL) of Σ|terms| of the
  module's final product (|a| @ |W|, a the activation the output
  projection is given, the port's own; for MoE the gate-weighted sum over
  the token's experts, in float64); decode states within 1e-5 of their
  largest entry.  Measured: at most 3e-6 absolute on outputs of size 1–9.
- bfloat16: bit for bit against the reference, but for at most 1%
  of the outputs (BF16_FLIPS), none more than two bfloat16 steps
  (BF16_STEPS, 2^-6 relative) away: every elementwise step rounds as
  jnp rounds it (`nn.silu`, `nn.softplus`, `nn.log_sigmoid` are written out
  op by op) and the products round their float32 sums once; a sum taken
  in another order may round the other way.  Measured: bit for bit.

It also ports the seed tests of these modules (tests/test_models.py:78-137):
MoE against a dense loop over the experts, Mamba decode against apply, the
chunkwise mLSTM against the step recurrence, sLSTM decode against apply,
at the seed tests' tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as rmoe
from repro.models import ssm as rssm
from repro.models import xlstm as rxl
from repro_torch.models import moe, nn, ssm, xlstm

LOGIT_REL = 1e-5       # of Σ|terms|, float32
STATE_REL = 1e-5       # of the largest |entry| of a state, float32
BF16_STEPS = 2.0 ** -6  # relative: two bfloat16 steps
BF16_FLIPS = 0.01      # the share of bfloat16 outputs that may differ at all
DTYPES = ["float32", "bfloat16"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _carry(rp) -> dict:
    return nn.tree_map(_t, jax.tree.map(np.asarray, rp))


def _inputs(dtype, x):
    return jnp.asarray(x).astype(dtype), _t(x).to(getattr(torch, dtype))


def _hold(got, want, dtype, terms=None, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    if dtype == "float32":
        err = np.abs(got - want)
        assert np.all(err <= LOGIT_REL * terms), f"{what}: max error {err.max():.3e}"
        return
    assert np.mean(got != want) <= BF16_FLIPS, what
    np.testing.assert_allclose(got, want, rtol=BF16_STEPS, atol=0, err_msg=what)


def _hold_state(got: dict, want: dict, what=""):
    for key in want:
        w = _np(want[key])
        np.testing.assert_allclose(_np(got[key]), w, rtol=0,
                                   atol=STATE_REL * max(np.abs(w).max(), 1.0),
                                   err_msg=f"{what} {key}")


def _terms(fn, p, key, width):
    """Σ|terms| of the final product `a @ p[key]`: the port's `a`, got by
    running `fn` with p[key] the identity, against |p[key]|."""
    eye = dict(p, **{key: torch.eye(width, dtype=p[key].dtype)})
    a = _np(fn(eye))
    return np.abs(a.astype(np.float64)) @ np.abs(_np(p[key]).astype(np.float64))


# ---------------------------------------------------------------------------
# activations and the scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["silu", "gelu", "softplus", "log_sigmoid"])
def test_activations_round_as_the_reference(name):
    """Bit for bit in bfloat16, within 1e-6 in float32, against eager jax.nn."""
    x = np.random.default_rng(1).standard_normal(4096).astype(np.float32) * 6
    mine, ref = getattr(nn, name), getattr(jax.nn, name)
    for dtype, tol in [("bfloat16", 0.0), ("float32", 1e-6)]:
        jx, tx = _inputs(dtype, x)
        np.testing.assert_allclose(_np(mine(tx)), _np(ref(jx)), rtol=tol, atol=tol)


def test_softplus_gradient_is_the_sigmoid():
    x = torch.tensor([-30.0, -2.0, 0.0, 1e-3, 3.0, 40.0], requires_grad=True)
    g, = torch.autograd.grad(nn.softplus(x).sum(), x)
    torch.testing.assert_close(g, torch.sigmoid(x.detach()), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13, 16])
def test_associative_scan_matches_reference(n):
    """Mamba's (a, b) combine over n steps: the same pairs as
    `jax.lax.associative_scan`, so the same float32 values."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 3, 4)).astype(np.float32)
    b = rng.standard_normal((2, n, 3, 4)).astype(np.float32)

    def combine(left, right):
        return (left[0] * right[0], left[1] * right[0] + right[1])
    want = jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    got = ssm.associative_scan(ssm._combine, [_t(a), _t(b)], dim=1)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_cfgs(top_k, shared, **kw):
    base = dict(d_model=32, d_ff=16, n_experts=8, top_k=top_k, n_shared_experts=shared)
    base.update(kw)
    return rmoe.MoEConfig(**base), moe.MoEConfig(**base)


def _moe_dense(p, cfg, x):
    """The layer as a float64 loop over tokens and their experts, routed as
    `lax.top_k` routes (ties to the lower id), and Σ|terms| of each output."""
    p = {k: _np(v).astype(np.float64) for k, v in p.items()}
    xt = x.reshape(-1, cfg.d_model).astype(np.float64)
    logits = xt @ p["router"]
    out, terms = np.zeros_like(xt), np.zeros_like(xt)

    def silu(v):
        return v / (1 + np.exp(-v))
    for t in range(len(xt)):
        eids = np.argsort(-logits[t], kind="stable")[:cfg.top_k]
        gates = np.exp(logits[t, eids] - logits[t, eids].max())
        gates /= gates.sum()
        for e, g in zip(eids, gates, strict=True):
            h = silu(xt[t] @ p["wg"][e]) * (xt[t] @ p["wu"][e])
            out[t] += g * (h @ p["wd"][e])
            terms[t] += g * (np.abs(h) @ np.abs(p["wd"][e]))
        if cfg.n_shared_experts:
            h = silu(xt[t] @ p["shared_wg"]) * (xt[t] @ p["shared_wu"])
            out[t] += h @ p["shared_wd"]
            terms[t] += np.abs(h) @ np.abs(p["shared_wd"])
    return out.reshape(x.shape), terms.reshape(x.shape)


@pytest.mark.parametrize("top_k", [1, 2, 8])
@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_matches_reference(dtype, shared, top_k, trivial_mesh):
    rcfg, cfg = _moe_cfgs(top_k, shared)
    rp, _ = rmoe.moe_init(jax.random.key(top_k + 10 * shared), rcfg)
    p = _carry(rp)
    x = np.random.default_rng(top_k).standard_normal((2, 9, 32)).astype(np.float32)
    jx, tx = _inputs(dtype, x)
    want = jax.jit(lambda p_, x_: rmoe.moe_apply(p_, rcfg, x_, mesh=trivial_mesh,
                                                 dp_axes=("data",), seq_sharded=False))(rp, jx)
    got = moe.moe_apply(p, cfg, tx)
    assert got.dtype == tx.dtype
    _hold(got, want, dtype, _moe_dense(p, cfg, x)[1], f"moe k={top_k} shared={shared}")


def test_moe_init_matches_reference_tree():
    """Names, shapes and scales; shared_wg and shared_wu start equal, as
    the reference's (one key for both)."""
    rcfg, cfg = _moe_cfgs(2, 2, d_model=128, d_ff=64, n_experts=16)
    rp, rs = rmoe.moe_init(jax.random.key(0), rcfg)
    p, s = moe.moe_init(torch.Generator().manual_seed(0), cfg)
    assert nn.tree_map(lambda a: tuple(a.shape), p) == jax.tree.map(lambda a: tuple(a.shape), rp)
    assert s == rs
    assert torch.equal(p["shared_wg"], p["shared_wu"])
    np.testing.assert_array_equal(np.asarray(rp["shared_wg"]), np.asarray(rp["shared_wu"]))
    for k in p:  # the same scale: standard deviations within 10% (≥ 2048 draws each)
        assert abs(float(p[k].std()) / float(np.std(rp[k])) - 1) < 0.1, k


def test_moe_ties_go_to_the_lower_expert():
    """Equal router logits: lax.top_k keeps the lower ids, and so does the port."""
    rcfg, cfg = _moe_cfgs(2, 0, n_experts=4)
    p = _carry(rmoe.moe_init(jax.random.key(0), rcfg)[0])
    p["router"] = torch.zeros_like(p["router"])  # every logit 0
    x = torch.ones((1, 3, 32))
    gates, eids = moe._route(cfg, x.reshape(3, 32), p["router"])
    assert eids.tolist() == [[0, 1]] * 3
    assert torch.equal(gates, torch.full((3, 2), 0.5))
    _, reids = jax.lax.top_k(jnp.zeros((3, 4)), 2)
    assert np.asarray(reids).tolist() == eids.tolist()


def test_moe_matches_dense_loop():
    """tests/test_models.py::test_moe_matches_dense_loop, in the port."""
    rcfg, cfg = _moe_cfgs(2, 0, d_model=16, d_ff=8, n_experts=4)
    p = _carry(rmoe.moe_init(jax.random.key(0), rcfg)[0])
    x = np.random.default_rng(1).standard_normal((2, 8, 16)).astype(np.float32) * 0.5
    want, _ = _moe_dense(p, cfg, x)
    np.testing.assert_allclose(_np(moe.moe_apply(p, cfg, _t(x))), want, rtol=1e-4, atol=1e-5)


def test_moe_backward_matches_reference(trivial_mesh):
    """The gradients through the sorted gather, the experts' products and the
    ordered add back, against jax.grad, float32, within 1e-5 of each
    leaf's largest |entry|."""
    rcfg, cfg = _moe_cfgs(2, 1)
    rp, _ = rmoe.moe_init(jax.random.key(5), rcfg)
    x = np.random.default_rng(5).standard_normal((2, 9, 32)).astype(np.float32)
    rg = jax.jit(jax.grad(lambda p_, x_: jnp.sum(rmoe.moe_apply(
        p_, rcfg, x_, mesh=trivial_mesh, seq_sharded=False) ** 2), argnums=(0, 1)))(
            rp, jnp.asarray(x))
    p = nn.tree_map(lambda a: a.requires_grad_(), _carry(rp))
    tx = _t(x).requires_grad_()
    leaves = [tx, *nn.tree_leaves(p)]
    grads = torch.autograd.grad(torch.sum(moe.moe_apply(p, cfg, tx) ** 2), leaves)
    for g, w in zip(grads, [rg[1], *jax.tree.leaves(rg[0])], strict=True):
        w = _np(w)
        np.testing.assert_allclose(_np(g), w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_moe_on_a_model_axis_of_more_ranks_raises():
    """On a model axis of two ranks (a dry mesh of meta tensors) a rank
    holds 4 of the 8 experts and gives its output in the layout of its
    input (its rows of the sequence, or the whole rows); experts that do
    not divide over the axis raise, as the reference asserts.  The
    two-rank arithmetic, capacity drops included, is held to the
    reference's (2, 4) mesh in tests/test_torch_tp.py."""
    from repro_torch.launch.dryrun import DryMesh
    rcfg, cfg = _moe_cfgs(2, 1)
    mesh = DryMesh({"data": 1, "model": 2})
    p = {k: torch.empty(((v.shape[0] // 2,) + tuple(v.shape[1:])) if k in ("wg", "wu", "wd")
                        else tuple(v.shape), device="meta")
         for k, v in rmoe.moe_init(jax.random.key(0), rcfg)[0].items()}
    for seq_sharded in (True, False):
        out = moe.moe_apply(p, cfg, torch.empty((1, 2, 32), device="meta"), mesh=mesh,
                            seq_sharded=seq_sharded)
        assert tuple(out.shape) == (1, 2, 32) and out.is_meta
    _, odd = _moe_cfgs(2, 0, n_experts=3)
    with pytest.raises(ValueError, match="must divide"):
        moe.moe_apply(p, odd, torch.empty((1, 2, 32), device="meta"), mesh=mesh)


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

def _mamba(seed=0, **kw):
    base = dict(d_model=16, d_state=4, scan_chunk=8)
    base.update(kw)
    rcfg, cfg = rssm.MambaConfig(**base), ssm.MambaConfig(**base)
    rp, _ = rssm.mamba_init(jax.random.key(seed), rcfg)
    return rcfg, rp, cfg, _carry(rp)


@pytest.mark.parametrize("s", [8, 21])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_apply_matches_reference(dtype, s):
    """One chunk (8), and three chunks whose last is padded (21)."""
    rcfg, rp, cfg, p = _mamba()
    x = np.random.default_rng(s).standard_normal((2, s, 16)).astype(np.float32) * 0.5
    jx, tx = _inputs(dtype, x)
    want, (wh, wconv) = rssm.mamba_apply(rp, rcfg, jx, return_state=True)
    got, (h, conv) = ssm.mamba_apply(p, cfg, tx, return_state=True)
    terms = _terms(lambda q: ssm.mamba_apply(q, cfg, tx), p, "out_proj", cfg.d_inner)
    _hold(got, want, dtype, terms, "mamba_apply")
    _hold_state({"h": h, "conv": conv}, {"h": wh, "conv": wconv}, "mamba_apply")


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_decode_matches_reference(dtype):
    rcfg, rp, cfg, p = _mamba(1)
    x = np.random.default_rng(2).standard_normal((2, 11, 16)).astype(np.float32) * 0.5
    jx, tx = _inputs(dtype, x)
    rcache = rssm.init_mamba_cache(rcfg, 2, jnp.float32)
    cache = ssm.init_mamba_cache(cfg, 2, torch.float32, device=torch.device("cpu"))
    for t in range(11):
        want, rcache = rssm.mamba_decode(rp, rcfg, jx[:, t:t + 1], rcache)
        got, cache = ssm.mamba_decode(p, cfg, tx[:, t:t + 1], cache)
        terms = _terms(lambda q: ssm.mamba_decode(q, cfg, tx[:, t:t + 1], dict(cache))[0], p,
                       "out_proj", cfg.d_inner)
        _hold(got, want, dtype, terms, f"mamba_decode step {t}")
        _hold_state(cache, rcache, f"mamba_decode step {t}")
        assert cache["h"].dtype == torch.float32 and cache["conv"].dtype == torch.float32


def test_mamba_decode_matches_apply():
    """tests/test_models.py::test_mamba_decode_matches_apply, in the port."""
    _, _, cfg, p = _mamba()
    x = _t(np.random.default_rng(1).standard_normal((2, 21, 16)).astype(np.float32) * 0.5)
    full = ssm.mamba_apply(p, cfg, x)
    cache = ssm.init_mamba_cache(cfg, 2, torch.float32, device=torch.device("cpu"))
    outs = []
    for t in range(21):
        o, cache = ssm.mamba_decode(p, cfg, x[:, t:t + 1], cache)
        outs.append(o)
    np.testing.assert_allclose(_np(full), _np(torch.cat(outs, 1)), rtol=1e-4, atol=1e-5)


def test_mamba_remat_gives_the_same_gradients(monkeypatch):
    """Each chunk under torch.utils.checkpoint: the same gradients, bit for bit."""
    _, _, cfg, p = _mamba()
    x = _t(np.random.default_rng(3).standard_normal((2, 21, 16)).astype(np.float32))

    def grads(remat):
        q = nn.tree_map(lambda a: a.clone().requires_grad_(), p)
        out = ssm.mamba_apply(q, cfg, x, remat=remat)
        return torch.autograd.grad(out.square().sum(), nn.tree_leaves(q))
    calls = []
    checkpoint = ssm.checkpoint
    monkeypatch.setattr(ssm, "checkpoint", lambda *a, **k: calls.append(1) or checkpoint(*a, **k))
    for a, b in zip(grads(True), grads(False), strict=True):
        assert torch.equal(a, b)
    assert len(calls) == 3  # one per chunk


# ---------------------------------------------------------------------------
# xLSTM
# ---------------------------------------------------------------------------

def _mlstm(chunk=8):
    base = dict(d_model=32, n_heads=2, chunk=chunk)
    rcfg, cfg = rxl.MLSTMConfig(**base), xlstm.MLSTMConfig(**base)
    rp, _ = rxl.mlstm_init(jax.random.key(0), rcfg)
    return rcfg, rp, cfg, _carry(rp)


def _slstm():
    rcfg, cfg = rxl.SLSTMConfig(16, 2), xlstm.SLSTMConfig(16, 2)
    rp, _ = rxl.slstm_init(jax.random.key(0), rcfg)
    return rcfg, rp, cfg, _carry(rp)


CPU = torch.device("cpu")


@pytest.mark.parametrize("s", [8, 37])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mlstm_apply_matches_reference(dtype, s):
    """One chunk (8), and five chunks of 8 whose last is padded (37)."""
    rcfg, rp, cfg, p = _mlstm()
    x = np.random.default_rng(s).standard_normal((2, s, 32)).astype(np.float32) * 0.5
    jx, tx = _inputs(dtype, x)
    want, wst = jax.jit(lambda p_, x_: rxl.mlstm_apply(p_, rcfg, x_, return_state=True))(rp, jx)
    got, st = xlstm.mlstm_apply(p, cfg, tx, return_state=True)
    terms = _terms(lambda q: xlstm.mlstm_apply(q, cfg, tx), p, "down", cfg.d_inner)
    _hold(got, want, dtype, terms, "mlstm_apply")
    _hold_state(st, wst, "mlstm_apply")


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlstm_decode_matches_reference(dtype):
    rcfg, rp, cfg, p = _mlstm()
    x = np.random.default_rng(4).standard_normal((2, 10, 32)).astype(np.float32) * 0.5
    jx, tx = _inputs(dtype, x)
    rcache, cache = rxl.init_mlstm_cache(rcfg, 2), xlstm.init_mlstm_cache(cfg, 2, device=CPU)
    rdecode = jax.jit(lambda p_, x_, c_: rxl.mlstm_decode(p_, rcfg, x_, c_))
    for t in range(10):
        want, rcache = rdecode(rp, jx[:, t:t + 1], rcache)
        got, cache = xlstm.mlstm_decode(p, cfg, tx[:, t:t + 1], cache)
        terms = _terms(lambda q: xlstm.mlstm_decode(q, cfg, tx[:, t:t + 1], cache)[0], p,
                       "down", cfg.d_inner)
        _hold(got, want, dtype, terms, f"mlstm_decode step {t}")
        _hold_state(cache, rcache, f"mlstm_decode step {t}")


def test_mlstm_chunkwise_matches_stepscan():
    """tests/test_models.py::test_mlstm_chunkwise_matches_stepscan, in the
    port: the chunkwise form (chunk 8 < S = 37, padded) against the
    one-step recurrence `_mlstm_step` over the same q, k, v and gates, and
    against token-by-token decode."""
    _, _, cfg, p = _mlstm()
    x = _t(np.random.default_rng(1).standard_normal((2, 37, 32)).astype(np.float32) * 0.5)
    out_c, st_c = xlstm.mlstm_apply(p, cfg, x, return_state=True)
    q, k, v, log_i, log_f, _ = xlstm._mlstm_qkvif(p, cfg, x)
    cache = xlstm.init_mlstm_cache(cfg, 2, device=CPU)
    carry, ys = (cache["c"], cache["n"], cache["m"]), []
    for t in range(37):
        carry, y = xlstm._mlstm_step(carry, (q[:, t], k[:, t], v[:, t], log_i[:, t],
                                             log_f[:, t]))
        ys.append(y)
    _, y_c = xlstm._mlstm_chunk((cache["c"], cache["n"], cache["m"]),
                                (q, k, v, log_i, log_f))  # one chunk of all 37
    np.testing.assert_allclose(_np(y_c), _np(torch.stack(ys, 1)), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(_np(st_c["c"]), _np(carry[0]), rtol=1e-3, atol=1e-3)
    outs = []
    for t in range(37):
        o, cache = xlstm.mlstm_decode(p, cfg, x[:, t:t + 1], cache)
        outs.append(o)
    np.testing.assert_allclose(_np(out_c), _np(torch.cat(outs, 1)), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(_np(st_c["c"]), _np(cache["c"]), rtol=1e-3, atol=1e-3)


def test_mlstm_backward_is_finite():
    """The -inf mask is taken before the exp: no NaN in any gradient."""
    _, _, cfg, p = _mlstm()
    p = nn.tree_map(lambda a: a.requires_grad_(), p)
    x = _t(np.random.default_rng(2).standard_normal((2, 21, 32)).astype(np.float32))
    grads = torch.autograd.grad(xlstm.mlstm_apply(p, cfg, x).square().sum(), nn.tree_leaves(p))
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("dtype", DTYPES)
def test_slstm_matches_reference(dtype):
    """apply over 13 steps, then decode step by step from its state."""
    rcfg, rp, cfg, p = _slstm()
    x = np.random.default_rng(6).standard_normal((2, 13, 16)).astype(np.float32) * 0.5
    jx, tx = _inputs(dtype, x)
    want, wst = jax.jit(lambda p_, x_: rxl.slstm_apply(p_, rcfg, x_, return_state=True))(rp, jx)
    rdecode = jax.jit(lambda p_, x_, c_: rxl.slstm_decode(p_, rcfg, x_, c_))
    got, st = xlstm.slstm_apply(p, cfg, tx, return_state=True)
    terms = _terms(lambda q: xlstm.slstm_apply(q, cfg, tx), p, "out", cfg.d_model)
    _hold(got, want, dtype, terms, "slstm_apply")
    _hold_state(st, wst, "slstm_apply")
    assert st["h"].shape == (2, 16) and st["c"].shape == (2, 2, 8)
    for t in range(4):
        xt = np.random.default_rng(t).standard_normal((2, 1, 16)).astype(np.float32)
        jxt, txt = _inputs(dtype, xt)
        want, wst = rdecode(rp, jxt, wst)
        got, st = xlstm.slstm_decode(p, cfg, txt, st)
        terms = _terms(lambda q: xlstm.slstm_decode(q, cfg, txt, st)[0], p, "out", cfg.d_model)
        _hold(got, want, dtype, terms, f"slstm_decode step {t}")
        _hold_state(st, wst, f"slstm_decode step {t}")


def test_slstm_decode_matches_apply():
    """tests/test_models.py::test_slstm_decode_matches_apply, in the port."""
    _, _, cfg, p = _slstm()
    x = _t(np.random.default_rng(1).standard_normal((2, 13, 16)).astype(np.float32) * 0.5)
    full = xlstm.slstm_apply(p, cfg, x)
    cache = xlstm.init_slstm_cache(cfg, 2, device=CPU)
    outs = []
    for t in range(13):
        o, cache = xlstm.slstm_decode(p, cfg, x[:, t:t + 1], cache)
        outs.append(o)
    np.testing.assert_allclose(_np(full), _np(torch.cat(outs, 1)), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("which", ["mlstm", "slstm"])
def test_xlstm_inits_match_reference_tree(which):
    rcfg, rp, cfg, _ = _mlstm() if which == "mlstm" else _slstm()
    init = getattr(xlstm, f"{which}_init")
    p, s = init(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    assert s == getattr(rxl, f"{which}_init")(jax.random.key(0), rcfg)[1]
    assert nn.tree_map(lambda a: (tuple(a.shape), a.dtype), p) == jax.tree.map(
        lambda a: (tuple(a.shape), torch.bfloat16), rp)
    for k in ("fb", "gn", "b"):  # the constants are the reference's
        if k in p:
            np.testing.assert_array_equal(_np(p[k]), _np(rp[k]))
