"""The `alto`, `csf` and `hetero` backends on the card against their CPU
results, and hetero's use of the float CUDA kernel.

Run on a machine with an NVIDIA GPU and nvcc:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_formats_gpu.py

Elsewhere every test skips (the card is looked for inside a fixture).  The
CPU results are what tests/test_torch_formats.py and test_torch_hetero.py
hold to the JAX package.  Card and CPU form each product in the same order
and differ only in the order of their float32 sums (atomic `index_add_` on
the card), so each entry is held to 1e-4 of the sum of the absolute values
of its terms, the tolerance of tests/test_torch_kernel_gpu.py.
"""
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch.engine import PlanCache
from repro_torch.kernels import _build, mttkrp_kernel

pytestmark = pytest.mark.gpu

LBNL_SHAPE = (1605, 4198, 1631, 4209, 868131)
# (shape, nnz, distribution, chunk_shape, capacity)
TENSORS = {
    "3d": ((40, 30, 50), 1500, "uniform", (16, 8, 16), 64),
    "4d_powerlaw": ((20, 12, 20, 12), 900, "powerlaw", (8, 4, 8, 4), 32),
    "lbnl_68_bits": (LBNL_SHAPE, 3000, "powerlaw", (1605, 4198, 1631, 4209, 3392), 256),
    "dense_cube": ((12, 12, 12), 1500, "uniform", (4, 4, 4), 64),
}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernel)")
    return torch.device("cuda")


def _engines(name, backend, device, **kwargs):
    shape, nnz, dist, cs, cap = TENSORS[name]
    st = rt.random_tensor(shape, nnz, distribution=dist, seed=3)
    kw = dict(chunk_shape=cs, capacity=cap, **kwargs) if backend == "hetero" else {}
    return st, [rt.build_engine(st, backend, 6, device=d, plans=PlanCache(),
                                formats=rt.FormatCache(), **kw) for d in ("cpu", device)]


def _factors(shape, device, seed=1):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.uniform(-1, 1, (d, 6)).astype(np.float32)).to(device)
            for d in shape]


@pytest.mark.parametrize("name", sorted(TENSORS))
@pytest.mark.parametrize(("backend", "kwargs"), [
    ("alto", {}), ("csf", {}), ("hetero", {}), ("hetero", {"dense_fraction": 0.5})],
    ids=["alto", "csf", "hetero", "hetero-half"])
def test_backend_on_card_matches_cpu(cuda, name, backend, kwargs):
    st, (on_cpu, on_card) = _engines(name, backend, cuda, **kwargs)
    cpu_f, card_f = _factors(st.shape, "cpu"), _factors(st.shape, cuda)
    coords, abs_values = torch.from_numpy(st.coords), torch.from_numpy(np.abs(st.values))
    for mode in range(st.ndim):
        got = on_card(card_f, mode)
        assert got.is_cuda and tuple(got.shape) == (st.shape[mode], 6)
        want = on_cpu(cpu_f, mode)
        abs_terms = rt.mttkrp_coo([f.abs() for f in cpu_f], coords, abs_values, mode=mode,
                                  out_dim=st.shape[mode])
        torch.cuda.synchronize()
        err = (got.cpu() - want).abs()
        tol = 1e-4 * abs_terms + 1e-6
        assert bool((err <= tol).all()), (name, backend, mode, float(err.max()))


@pytest.mark.parametrize(("fraction", "sparse_launches"), [(None, 0), (0.5, 1), (0.0, 1)],
                         ids=["cost-model-all-dense", "half", "all-sparse"])
def test_hetero_launches_the_float_kernel_once_per_mode_with_sparse_tasks(
        cuda, fraction, sparse_launches):
    """On the dense cube the cost model sends every task dense: no launch.
    With any sparse task, one float-kernel launch per mode call."""
    st, (_, on_card) = _engines("dense_cube", "hetero", cuda, dense_fraction=fraction)
    shape, _, _, cs, cap = TENSORS["dense_cube"]
    split = rt.split_tasks(rt.chunk_tensor(st, cs, cap), 6, dense_fraction=fraction)
    assert (split.sparse_idx.size > 0) == bool(sparse_launches)
    factors = _factors(shape, cuda)
    before = mttkrp_kernel.launches
    for mode in range(3):
        on_card(factors, mode)
    torch.cuda.synchronize()
    assert mttkrp_kernel.launches - before == 3 * sparse_launches


def test_hetero_kernel_build_failure_raises(cuda, monkeypatch):
    """A kernel that cannot be built raises out of the hetero engine; nothing
    falls back to the plain chunked op."""
    st, (_, on_card) = _engines("3d", "hetero", cuda, dense_fraction=0.5)

    def broken(name):
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu")

    monkeypatch.setattr(_build, "load", broken)
    before = mttkrp_kernel.launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        on_card(_factors(st.shape, cuda), 0)
    assert mttkrp_kernel.launches == before


@pytest.mark.parametrize("engine", ["alto", "csf", "hetero"])
def test_cpals_on_card_follows_cpu(cuda, engine):
    """cp_als without `device=` runs on the card and follows the CPU run
    within the CPU tests' 1e-6."""
    st = rt.table1_tensor("nell2")
    on_card = rt.cp_als(st, 10, 3, engine=engine)
    on_cpu = rt.cp_als(st, 10, 3, engine=engine, device="cpu")
    assert on_card.factors[0].is_cuda
    np.testing.assert_allclose(on_card.fit_history, on_cpu.fit_history, rtol=0, atol=1e-6)
    np.testing.assert_allclose(on_card.diff_history, on_cpu.diff_history, rtol=0, atol=1e-6)
