"""The pseudo-inverse CP-ALS takes of its Gram Hadamard products: the plain
version (`kernels/ref.py::gram_pinv_ref`, torch's SVD with jnp's cutoff)
against `jnp.linalg.pinv` on the CPU, and the dispatch of
`core/cpals.py::_pinv`, which sends CPU tensors to the plain version and
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
    monkeypatch.setattr(gram_pinv, "_entry", refuse)
    before = gram_pinv.launches
    v = torch.from_numpy(gram_stack(5, 8, seed=1))
    for x in (v, v[0]):
        assert torch.equal(_pinv(x), torch.linalg.pinv(x, rtol=10 * 5 * F32_EPS))
    assert gram_pinv.launches == before


def test_work_area_placement():
    """Shared memory while A, V and the per-index values fit the H100's
    opt-in budget (R ≤ 120), a global scratch buffer past it."""
    assert gram_pinv.work_bytes(10) == 8 * (2 * 100 + 10)
    assert gram_pinv.work_bytes(5) == 8 * (2 * 25 + 6)
    for rank in (1, 10, 64, 120):
        plan = gram_pinv.plan_pinv(rank, tiles.SMEM_BUDGET)
        assert plan == gram_pinv.PinvLaunch(gram_pinv.work_bytes(rank))
    for rank in (121, 160):
        plan = gram_pinv.plan_pinv(rank, tiles.SMEM_BUDGET)
        assert plan == gram_pinv.PinvLaunch(0, gram_pinv.work_bytes(rank))
