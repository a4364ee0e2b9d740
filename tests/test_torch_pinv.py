"""The pseudo-inverse CP-ALS takes of its Gram Hadamard products: the plain
version (`kernels/ref.py::gram_pinv_ref`, torch's SVD with jnp's cutoff)
and the warp tier's host replay (`kernels/gram_pinv.py::jacobi_replay`,
the CUDA kernel's float64 arithmetic in its order) against
`jnp.linalg.pinv` on the CPU, non-finite entries included (a NaN, or a
±Inf off the diagonal, makes a member NaN; ±Inf only on the diagonal
makes it zeros; cp_als and cp_als_batched carry that through as the JAX
package does), the tiers `plan_pinv` picks, and the dispatch
of `core/cpals.py::_pinv`, which sends CPU tensors to the plain version and
never to the CUDA kernel (`kernels/gram_pinv.py`; its tests on the card are
in tests/test_torch_kernel_gpu.py).

Tolerance: the plain version and jnp both take a float32 SVD, which round
differently; the inverse magnifies that by κ, the condition number over the
kept directions.  Entries are held to max(1e-6, κ·2^-20) of the largest
entry: the flat 1e-6 where V is well conditioned, eight float32 roundings
(2^-23) magnified by κ where it is not (measured: 1.3e-6 at R = 10, κ ≈ 19;
1.0e-5 at R = 64, κ ≈ 190).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch as rt
from repro.batch import cp_als_batched as ref_cp_als_batched
from repro_torch.core.cpals import _pinv
from repro_torch.kernels import _build, gram_pinv, tiles
from repro_torch.kernels import ref as pref

F32_EPS = float(np.finfo(np.float32).eps)


def gram_stack(rank: int, n: int, seed: int, rows: int = 200, n_modes: int = 2, edit=None):
    """(n, R, R) float32 Hadamard products of the Grams of `n_modes` seeded
    uniform factors, as CP-ALS forms V; `edit(f)` alters every factor."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        v = np.ones((rank, rank), np.float32)
        for _m in range(n_modes):
            f = rng.uniform(0, 1, (rows, rank)).astype(np.float32)
            if edit is not None:
                edit(f)
            v = v * (f.T @ f)
        out.append(v)
    return np.stack(out)


def kept_kappa(v: np.ndarray) -> float:
    """Largest, over the stack, of λ_max / λ_min over the directions jnp's
    cutoff keeps (float64 eigenvalues)."""
    lam = np.abs(np.linalg.eigvalsh(v.astype(np.float64)))
    top = lam.max(axis=-1, keepdims=True)
    kept = np.where(lam > 10 * v.shape[-1] * F32_EPS * top, lam, np.inf)
    return float((top[..., 0] / kept.min(axis=-1)).max())


@pytest.mark.parametrize("rank", [3, 10, 64])
def test_plain_matches_jnp_pinv(rank):
    v = gram_stack(rank, 4, seed=rank)
    want = np.asarray(jnp.linalg.pinv(jnp.asarray(v)))
    got = pref.gram_pinv_ref(torch.from_numpy(v)).numpy()
    tol = max(1e-6, kept_kappa(v) * 2.0 ** -20)
    err = np.abs(got - want).max(axis=(1, 2)) / np.abs(want).max(axis=(1, 2))
    assert float(err.max()) <= tol, (err, tol)


def _zero_column(f):
    f[:, 3] = 0.0


def _equal_columns(f):
    f[:, 6] = f[:, 5]


@pytest.mark.parametrize("edit", [_zero_column, _equal_columns], ids=["zero-column", "equal-columns"])
def test_rank_deficient_stacks_drop_the_directions_jnp_drops(edit):
    """V·pinv(V) projects onto the kept directions: the same projector, of
    the same rank, as jnp's, and one direction fewer than R."""
    v = gram_stack(10, 3, seed=7, edit=edit)
    want = np.asarray(jnp.linalg.pinv(jnp.asarray(v))).astype(np.float64)
    got = pref.gram_pinv_ref(torch.from_numpy(v)).numpy().astype(np.float64)
    v64 = v.astype(np.float64)
    p_got, p_want = v64 @ got, v64 @ want
    rank_got = np.rint(np.trace(p_got, axis1=1, axis2=2))
    rank_want = np.rint(np.trace(p_want, axis1=1, axis2=2))
    assert rank_got.tolist() == rank_want.tolist() == [9.0] * 3
    assert float(np.abs(p_got - p_want).max()) <= 1e-4
    tol = max(1e-6, kept_kappa(v) * 2.0 ** -20)
    err = np.abs(got - want).max(axis=(1, 2)) / np.abs(want).max(axis=(1, 2))
    assert float(err.max()) <= tol, (err, tol)


def test_pinv_on_cpu_never_touches_the_kernel(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the CUDA kernel was reached from a CPU tensor")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "call", refuse)
    before = gram_pinv.launches
    v = torch.from_numpy(gram_stack(5, 8, seed=1))
    for x in (v, v[0]):
        assert torch.equal(_pinv(x), torch.linalg.pinv(x, rtol=10 * 5 * F32_EPS))
    assert gram_pinv.launches == before


def test_work_area_placement():
    """The tiers on the H100's opt-in budget: the warp tier up to R = 32;
    the block tier in shared memory while A, V
    and the per-index values fit (R ≤ 120); a global scratch buffer past it."""
    assert gram_pinv.work_bytes(10) == 8 * (2 * 100 + 10)
    assert gram_pinv.work_bytes(5) == 8 * (2 * 25 + 6)
    for rank in (1, 2, 5, 10, 31, 32):
        assert gram_pinv.plan_pinv(rank, tiles.SMEM_BUDGET) == gram_pinv.PinvLaunch("warp")
    for rank in (33, 64, 120):
        plan = gram_pinv.plan_pinv(rank, tiles.SMEM_BUDGET)
        assert plan == gram_pinv.PinvLaunch("shared", smem_bytes=gram_pinv.work_bytes(rank))
    for rank in (121, 160):
        plan = gram_pinv.plan_pinv(rank, tiles.SMEM_BUDGET)
        assert plan == gram_pinv.PinvLaunch("global", scratch_bytes=gram_pinv.work_bytes(rank))


def test_plan_forces_a_tier():
    """`tier=` reaches the first design at any R; the warp tier stops at 32."""
    assert gram_pinv.plan_pinv(10, tiles.SMEM_BUDGET, "shared") == gram_pinv.PinvLaunch(
        "shared", smem_bytes=gram_pinv.work_bytes(10))
    assert gram_pinv.plan_pinv(10, tiles.SMEM_BUDGET, "global") == gram_pinv.PinvLaunch(
        "global", scratch_bytes=gram_pinv.work_bytes(10))
    with pytest.raises(ValueError, match="R ≤ 32"):
        gram_pinv.plan_pinv(33, tiles.SMEM_BUDGET, "warp")
    with pytest.raises(ValueError, match="unknown tier"):
        gram_pinv.plan_pinv(10, tiles.SMEM_BUDGET, "registers")


@pytest.mark.parametrize("width", range(2, 34, 2))
def test_round_robin_meets_every_pair_once(width):
    """The warp tier's ordering: pairs (2j, 2j+1), then the fixed move
    between rounds; W-1 rounds meet every pair of columns once and bring
    every column home."""
    layout = list(range(width))
    met = []
    for _ in range(width - 1):
        met += [frozenset(layout[2 * j:2 * j + 2]) for j in range(width // 2)]
        layout = [layout[gram_pinv.round_robin_source(c, width)] for c in range(width)]
    assert len(met) == len(set(met)) == width * (width - 1) // 2
    assert layout == list(range(width))


def _all_zero(rank: int) -> np.ndarray:
    return np.zeros((2, rank, rank), np.float32)


REPLAY_STACKS = {
    **{f"rank-{r}": (lambda r=r: gram_stack(r, 4, seed=r, rows=max(50, 3 * r)))
       for r in (1, 2, 5, 10, 31, 32)},
    "zero-column": lambda: gram_stack(10, 3, seed=7, edit=_zero_column),
    "equal-columns": lambda: gram_stack(10, 3, seed=7, edit=_equal_columns),
    "all-zero": lambda: _all_zero(10),
}


@pytest.mark.parametrize("stack", list(REPLAY_STACKS))
def test_jacobi_replay_matches_jnp_pinv(stack):
    """The warp tier's arithmetic, replayed on the host, against
    `jnp.linalg.pinv` at the file's tolerance: bitwise symmetric, the same
    directions cut, converged well before the sweep limit; the all-zero
    matrix gives zeros."""
    v = REPLAY_STACKS[stack]()
    rank = v.shape[-1]
    rp = gram_pinv.jacobi_replay(v)
    assert rp.out.dtype == np.float32 and rp.out.shape == v.shape
    assert np.array_equal(rp.out, rp.out.transpose(0, 2, 1))
    width = rank + rank % 2
    assert (rp.rounds < gram_pinv.MAX_SWEEPS * (width - 1)).all(), rp.rounds
    if stack == "all-zero":
        assert not rp.out.any() and not rp.rotations.any()
        return
    want = np.asarray(jnp.linalg.pinv(jnp.asarray(v)))
    tol = max(1e-6, kept_kappa(v) * 2.0 ** -20)
    err = np.abs(rp.out - want).max(axis=(1, 2)) / np.abs(want).max(axis=(1, 2))
    assert float(err.max()) <= tol, (err, tol)
    v64 = v.astype(np.float64)
    kept = np.rint(np.trace(v64 @ rp.out.astype(np.float64), axis1=1, axis2=2))
    kept_jnp = np.rint(np.trace(v64 @ want.astype(np.float64), axis1=1, axis2=2))
    assert kept.tolist() == kept_jnp.tolist()
    if stack in ("zero-column", "equal-columns"):
        assert kept.tolist() == [9.0] * 3


def test_jacobi_replay_counts():
    """Rounds, rotations and checked pairs: a diagonal matrix rotates
    nothing and stops after one quiet sweep; no pair holding the padded
    column is checked; a matrix past a warp is refused."""
    diag = np.diag(np.arange(1, 6, dtype=np.float32))[None]
    rp = gram_pinv.jacobi_replay(diag)
    assert rp.rotations.tolist() == [0] and rp.rounds.tolist() == [5]  # W-1 quiet rounds
    assert rp.checks.tolist() == [5 * 2]  # 2 real pairs per round at R = 5, W = 6
    np.testing.assert_array_equal(rp.out[0], np.diag(1 / np.arange(1, 6, dtype=np.float64))
                                  .astype(np.float32))
    with pytest.raises(ValueError, match="R ≤ 32"):
        gram_pinv.jacobi_replay(np.eye(33, dtype=np.float32)[None])


#: Symmetric placements of non-finite entries in a 10×10 V: each entry set
#: at (i, j) and (j, i).  jnp's pinv answers NaN for a NaN anywhere or a ±Inf
#: off the diagonal, zeros for ±Inf only on the diagonal.
NONFINITE = {
    "nan-off-diagonal": ([(3, 4, np.nan)], "nan"),
    "nan-diagonal": ([(2, 2, np.nan)], "nan"),
    "inf-off-diagonal": ([(3, 4, np.inf)], "nan"),
    "neg-inf-off-diagonal": ([(3, 4, -np.inf)], "nan"),
    "inf-diagonal": ([(2, 2, np.inf)], "zeros"),
    "inf-two-diagonal": ([(2, 2, np.inf), (5, 5, np.inf)], "zeros"),
    "neg-inf-diagonal": ([(2, 2, -np.inf)], "zeros"),
    "inf-diagonal-and-off": ([(2, 2, np.inf), (2, 5, np.inf)], "nan"),
}


def nonfinite_stack(placement: str) -> np.ndarray:
    """(3, 10, 10): the SPD V = a·aᵀ (seed 0) three times over, the middle
    member with `placement`'s entries set symmetrically."""
    a = np.random.default_rng(0).standard_normal((10, 10)).astype(np.float32)
    v = np.stack([a @ a.T, a @ a.T + np.eye(10, dtype=np.float32), 2 * (a @ a.T)])
    for i, j, x in NONFINITE[placement][0]:
        v[1, i, j] = v[1, j, i] = x
    return v


@pytest.mark.parametrize("single", [False, True], ids=["stack", "single"])
@pytest.mark.parametrize("how", ["plain", "replay"])
@pytest.mark.parametrize("placement", list(NONFINITE))
def test_nonfinite_members_follow_jnp_pinv(placement, how, single):
    """Member by member jnp's answer: the bad member all NaN or all zeros,
    the others finite and within the file's tolerance; one (R, R) matrix
    alone gives the bad member's answer.  The replay runs no round on it."""
    v = nonfinite_stack(placement)
    if single:
        v = v[1]
    with np.errstate(invalid="ignore"):
        want = np.asarray(jnp.linalg.pinv(jnp.asarray(v)))
    if how == "plain":
        got = pref.gram_pinv_ref(torch.from_numpy(v)).numpy()
    else:
        rp = gram_pinv.jacobi_replay(v)
        got = rp.out
        assert int(np.asarray(rp.rounds).reshape(-1)[0 if single else 1]) == 0
    assert got.shape == v.shape and got.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    bad = got if single else got[1]
    expect = NONFINITE[placement][1]
    assert np.isnan(bad).all() if expect == "nan" else not bad.any()
    if single:
        return
    good = [0, 2]
    tol = max(1e-6, kept_kappa(v[good]) * 2.0 ** -20)
    err = (np.abs(got[good] - want[good]).max(axis=(1, 2))
           / np.abs(want[good]).max(axis=(1, 2)))
    assert float(err.max()) <= tol, (err, tol)


def test_nonfinite_replay_is_the_plain_mask():
    """The replay reads the upper triangle: a NaN below the diagonal only
    is not seen, as in the kernel; the plain version sees it, as jnp does."""
    v = nonfinite_stack("inf-diagonal")[0].copy()
    v[6, 1] = np.nan
    assert not np.isnan(gram_pinv.jacobi_replay(v).out).any()
    assert np.isnan(pref.gram_pinv_ref(torch.from_numpy(v)).numpy()).all()


def _with_nan(mod, seed: int, nan: bool):
    """A tiny seeded tensor of `mod` (the JAX package or the port), one of
    its values NaN when `nan`."""
    st = mod.random_tensor((12, 10, 8), 60, seed=seed)
    values = st.values.copy()
    if nan:
        values[5] = np.nan
    return mod.SparseTensor(st.coords, values, st.shape)


def _nan_pattern_equal(got, want):
    assert np.array_equal(np.isnan(np.asarray(got.fit_history)),
                          np.isnan(np.asarray(want.fit_history)))
    for f, g in zip(got.factors, want.factors, strict=True):
        np.testing.assert_array_equal(np.isnan(f.numpy()), np.isnan(np.asarray(g)))


@pytest.mark.parametrize("engine", ["ref", "chunked"])
def test_cp_als_with_a_nan_value_follows_the_reference(engine):
    """One NaN value spreads to every factor and fit in the reference; the
    port gives the same pattern and raises nothing."""
    want = repro.core.cp_als(_with_nan(repro.core, 0, True), 4, n_iters=3, engine=engine, seed=0)
    got = rt.cp_als(_with_nan(rt, 0, True), 4, n_iters=3, engine=engine, seed=0, device="cpu")
    assert np.isnan(want.fit_history).all()
    _nan_pattern_equal(got, want)


def test_cp_als_batched_with_a_nan_member_follows_the_reference():
    """The NaN member of a bucket comes out as the reference's (all NaN);
    the other members are bit for bit the same as in the batch without it,
    and within the batch tests' κ rule of the reference's."""
    want = ref_cp_als_batched([_with_nan(repro.core, s, s == 1) for s in range(3)], 4, n_iters=3)
    got = rt.cp_als_batched([_with_nan(rt, s, s == 1) for s in range(3)], 4, n_iters=3,
                            device="cpu")
    clean = rt.cp_als_batched([_with_nan(rt, s, False) for s in range(3)], 4, n_iters=3,
                              device="cpu")
    for g, w in zip(got, want, strict=True):
        _nan_pattern_equal(g, w)
    assert np.isnan(got[1].fit_history).all()
    for i in (0, 2):
        assert got[i].fit_history == clean[i].fit_history
        for f, c, w in zip(got[i].factors, clean[i].factors, want[i].factors, strict=True):
            assert torch.equal(f, c)
            fs = [np.asarray(x, np.float64) for x in want[i].factors]
            kappa = max(np.linalg.cond(np.prod([x.T @ x for k, x in enumerate(fs) if k != m],
                                               axis=0)) for m in range(3))
            assert float(np.abs(f.numpy() - np.asarray(w)).max()) <= max(1e-5, kappa * 2.0 ** -17)
