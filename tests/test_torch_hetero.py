"""The port's heterogeneous execution (paper §IV-D, `repro_torch.core.hetero`
and the `hetero` backend) against the JAX package on the CPU.

The split and the densified blocks are numpy and held byte for byte.
`mttkrp_hetero` is held per mode within 1e-5 relative (Frobenius norm): its
dense path is an einsum on both sides, and its sparse path the float
kernel's plain version here against the reference's `mttkrp_chunked`, so
only the order of the float32 sums may differ.  Fits are held per
iteration at 1e-6, as in tests/test_torch_cpals.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import chunk_tensor, cp_als, random_tensor
from repro.core import hetero as rhet
from repro_torch.core import hetero as phet
from repro_torch.engine import PlanCache
from repro_torch.kernels import mttkrp_kernel
from repro_torch.kernels import ops as kops

REL_TOL = 1e-5
FIT_ATOL = 1e-6
FRACTIONS = [None, 0.0, 0.5, 1.0]
# (shape, nnz, distribution, chunk_shape, capacity): tests/test_cpals.py's
# hetero setting, a powerlaw tensor with split chunks, a 4-mode one, and a
# dense cube where the cost model sends every task down the dense path.
CASES = {
    "test_cpals": ((30, 24, 36), 800, "uniform", (8, 8, 8), 64),
    "powerlaw_split": ((40, 30, 50), 1500, "powerlaw", (16, 8, 16), 32),
    "four_modes": ((12, 10, 14, 9), 900, "uniform", (4, 5, 7, 3), 48),
    "dense_cube": ((12, 12, 12), 1500, "uniform", (4, 4, 4), 64),
}


def _chunked(name):
    shape, nnz, dist, cs, cap = CASES[name]
    st = random_tensor(shape, nnz, distribution=dist, seed=2)
    pst = rt.random_tensor(shape, nnz, distribution=dist, seed=2)
    return st, pst, chunk_tensor(st, cs, cap), rt.chunk_tensor(pst, cs, cap)


def _assert_split_equal(got, want):
    for f in ("dense_idx", "sparse_idx"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), f
    assert got.threshold == want.threshold
    assert got.dense_fraction == want.dense_fraction


@pytest.mark.parametrize("fraction", FRACTIONS, ids=lambda f: f"fraction={f}")
@pytest.mark.parametrize("name", sorted(CASES))
def test_split_and_densify_identical(name, fraction):
    _, _, ct, pct = _chunked(name)
    want = rhet.split_tasks(ct, 5, dense_fraction=fraction)
    got = rt.split_tasks(pct, 5, dense_fraction=fraction)
    _assert_split_equal(got, want)
    for idx in (want.dense_idx, want.sparse_idx):
        assert rt.densify_tasks(pct, idx).tobytes() == rhet.densify_tasks(ct, idx).tobytes()


@pytest.mark.parametrize("fraction", FRACTIONS, ids=lambda f: f"fraction={f}")
def test_split_over_max_dense_volume_is_all_sparse(fraction):
    """A chunk whose dense form exceeds MAX_DENSE_VOLUME never goes dense,
    whatever `dense_fraction` asks (NELL-2's 256 KiB plan: 391 M cells)."""
    shape, cs = (300, 200, 150), (150, 200, 150)  # 4.5 M cells per chunk
    assert np.prod(cs) > phet.MAX_DENSE_VOLUME == rhet.MAX_DENSE_VOLUME
    st, pst = random_tensor(shape, 500, seed=1), rt.random_tensor(shape, 500, seed=1)
    ct, pct = chunk_tensor(st, cs, 128), rt.chunk_tensor(pst, cs, 128)
    got = rt.split_tasks(pct, 10, dense_fraction=fraction)
    _assert_split_equal(got, rhet.split_tasks(ct, 10, dense_fraction=fraction))
    assert got.dense_idx.size == 0 and got.sparse_idx.size == pct.num_tasks
    assert got.threshold == float("inf")


def test_cost_model_costs_match_reference():
    for cs, rank, cap in [((8, 8, 8), 5, 64), ((23, 23, 23), 5, 12167), ((4, 5, 7, 3), 10, 9)]:
        assert phet.dense_path_cost(cs, rank) == rhet.dense_path_cost(cs, rank)
        assert phet.sparse_path_cost(cap, cs, rank) == rhet.sparse_path_cost(cap, cs, rank)


@pytest.mark.parametrize("fraction", FRACTIONS, ids=lambda f: f"fraction={f}")
@pytest.mark.parametrize("name", sorted(CASES))
def test_mttkrp_hetero_matches_reference(name, fraction):
    st, pst, ct, pct = _chunked(name)
    split = rhet.split_tasks(ct, 5, dense_fraction=fraction)
    psplit = rt.split_tasks(pct, 5, dense_fraction=fraction)
    dense_blocks = jnp.asarray(rhet.densify_tasks(ct, split.dense_idx))
    arrays = rt.hetero_device_arrays(pct, psplit, rt.chunked_device_arrays(pct, "cpu"))
    rng = np.random.default_rng(7)
    fs = [rng.uniform(-1, 1, (d, 5)).astype(np.float32) for d in st.shape]
    for mode in range(st.ndim):
        want = np.asarray(rhet.mttkrp_hetero(tuple(jnp.asarray(f) for f in fs), ct, split,
                                             dense_blocks, mode=mode, out_dim=st.shape[mode]))
        got = rt.mttkrp_hetero([torch.from_numpy(f) for f in fs], arrays, mode=mode,
                               chunk_shape=pct.chunk_shape, out_dim=st.shape[mode]).numpy()
        assert got.shape == want.shape
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= REL_TOL, (name, fraction, mode, rel)


def test_hetero_arrays_are_built_once_and_reuse_the_resident_tensors():
    """Every task sparse: the sparse path is the resident chunked arrays
    themselves, no copy; a split takes its tasks' rows, once."""
    _, _, _, pct = _chunked("test_cpals")
    dev = rt.chunked_device_arrays(pct, "cpu")
    all_sparse = rt.hetero_device_arrays(pct, rt.split_tasks(pct, 5, dense_fraction=0.0), dev)
    assert all_sparse["sparse"] is dev and all_sparse["dense"] is None
    half = rt.split_tasks(pct, 5, dense_fraction=0.5)
    arrays = rt.hetero_device_arrays(pct, half, dev)
    idx = half.sparse_idx
    for k, v in arrays["sparse"].items():
        assert v.numpy().tobytes() == dev[k].numpy()[idx].tobytes(), k
    assert arrays["dense"]["blocks"].shape == (half.dense_idx.size, *pct.chunk_shape)
    assert arrays["dense"]["task_chunk"].numpy().tobytes() == pct.task_chunk[
        half.dense_idx].tobytes()
    all_dense = rt.hetero_device_arrays(pct, rt.split_tasks(pct, 5, dense_fraction=1.0), dev)
    assert all_dense["sparse"] is None


@pytest.mark.parametrize("fraction", [0.0, 0.5, 1.0], ids=lambda f: f"fraction={f}")
def test_sparse_path_goes_through_the_kernel_op(monkeypatch, fraction):
    """The sparse tasks take `kernels.ops.mttkrp_kernel_op` (the float
    kernel's wrapper, its plain version on the CPU), once per mode call with
    their own `nnz_per_task` (the resident one, in task order, when every
    task is sparse), and never the plain `mttkrp_chunked`; with every task
    dense it is not called.  No kernel launches on the CPU."""
    calls = []
    real = kops.mttkrp_kernel_op

    def counting(*args, **kwargs):
        calls.append(kwargs["nnz_per_task"])
        return real(*args, **kwargs)

    def forbidden(*args, **kwargs):
        raise AssertionError("hetero must not take the plain mttkrp_chunked")

    monkeypatch.setattr(kops, "mttkrp_kernel_op", counting)
    monkeypatch.setattr(rt.core.mttkrp, "mttkrp_chunked", forbidden)
    _, pst, _, pct = _chunked("test_cpals")
    eng = rt.build_engine(pst, "hetero", 5, device="cpu", chunk_shape=pct.chunk_shape,
                          capacity=pct.capacity, dense_fraction=fraction, plans=PlanCache())
    factors = rt.init_factors(pst.shape, 5, device="cpu")
    before = mttkrp_kernel.launches
    for mode in range(3):
        eng(factors, mode)
    split = rt.split_tasks(pct, 5, dense_fraction=fraction)
    assert len(calls) == (3 if split.sparse_idx.size else 0)
    want = pct.nnz_per_task if split.dense_idx.size == 0 else pct.nnz_per_task[split.sparse_idx]
    for nnz in calls:
        assert nnz.numpy().tobytes() == want.tobytes()
    assert mttkrp_kernel.launches == before


@pytest.mark.parametrize("fraction", [None, 0.5], ids=lambda f: f"fraction={f}")
def test_hetero_cpals_fit_matches_reference(fraction):
    """tests/test_cpals.py:39-49's setting: rank 5, 3 iterations, seed 3,
    chunk (8, 8, 8), capacity 64 (there with dense_fraction=0.5)."""
    st, pst = random_tensor((30, 24, 36), 800, seed=2), rt.random_tensor((30, 24, 36), 800, seed=2)
    kw = dict(chunk_shape=(8, 8, 8), capacity=64, dense_fraction=fraction)
    want = cp_als(st, 5, n_iters=3, engine="hetero", seed=3, **kw)
    got = rt.cp_als(pst, 5, n_iters=3, engine="hetero", seed=3, device="cpu", **kw)
    assert got.engine == "hetero" and got.quant_error is None
    np.testing.assert_allclose(got.fit_history, want.fit_history, rtol=0, atol=FIT_ATOL)
    np.testing.assert_allclose(got.diff_history, want.diff_history, rtol=0, atol=FIT_ATOL)
    ref = rt.cp_als(pst, 5, n_iters=3, engine="ref", seed=3, device="cpu")
    np.testing.assert_allclose(got.fit_history, ref.fit_history, rtol=0, atol=FIT_ATOL)


def test_hetero_backend_spec_matches_reference():
    from repro.engine import registered_backends as ref_backends
    got, want = rt.registered_backends(), ref_backends()
    for name in ("alto", "csf", "hetero"):
        g, w = got[name], want[name]
        assert (g.needs_chunking, g.supports_fixed_point, g.lossless, g.presets) == (
            w.needs_chunking, w.supports_fixed_point, w.lossless, w.presets), name
