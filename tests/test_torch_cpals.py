"""The port's CP-ALS and engine layer against the JAX package on the CPU.

`fit_history` and `diff_history` are held per iteration at an absolute
1e-6.  Both sides compute the residual ||X||² - 2<X, X̂> + ||X̂||² in float32,
which carries about ||X||²·eps ≈ 1e-3 of absolute error on these tensors,
about 3e-8 of fit; the factors themselves agree to float32 summation order.
"""
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import chunk_tensor, cp_als, decide_partition, table1_tensor
from repro.core.cpals import init_factors
from repro_torch.engine import default_plan_cache
from repro_torch.kernels import mttkrp_kernel

FIT_ATOL = 1e-6
TENSORS = ["nell2", "lbnl"]
N_ITERS = 3


@pytest.fixture(scope="module")
def reference_runs():
    """JAX cp_als, once per (tensor, engine)."""
    return {(name, eng): cp_als(table1_tensor(name), 10, N_ITERS, engine=eng)
            for name in TENSORS for eng in ("ref", "chunked")}


@pytest.mark.parametrize("name", TENSORS)
@pytest.mark.parametrize(("engine", "ref_engine"),
                         [("ref", "ref"), ("chunked", "chunked"), ("kernel", "chunked")])
def test_fit_history_matches_reference(reference_runs, name, engine, ref_engine):
    want = reference_runs[(name, ref_engine)]
    got = rt.cp_als(rt.table1_tensor(name), 10, N_ITERS, engine=engine, device="cpu")
    assert got.engine == engine
    assert len(got.fit_history) == len(got.iter_times) == N_ITERS
    np.testing.assert_allclose(got.fit_history, want.fit_history, rtol=0, atol=FIT_ATOL)
    np.testing.assert_allclose(got.diff_history, want.diff_history, rtol=0, atol=FIT_ATOL)
    for g, w in zip(got.factors, want.factors, strict=True):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3, atol=1e-4)


def test_example_driver_path_on_cpu():
    """The kernel engine built as examples/decompose_tensor.py builds it
    (256 KiB plan), driven through cp_als, against the reference's chunked
    engine on the same plan."""
    st = rt.table1_tensor("nell2")
    plan = rt.decide_partition(st, 10, mem_bytes=256 * 1024, rank_axis=10)
    eng = rt.build_engine(st, "kernel", 10, chunk_shape=plan.chunk_shape,
                          capacity=plan.capacity, device="cpu")
    got = rt.cp_als(st, 10, n_iters=2, engine=eng)
    rst = table1_tensor("nell2")
    rplan = decide_partition(rst, 10, mem_bytes=256 * 1024, rank_axis=10)
    want = cp_als(rst, 10, n_iters=2, engine="chunked", chunk_shape=rplan.chunk_shape,
                  capacity=rplan.capacity)
    assert plan.chunk_shape == rplan.chunk_shape
    np.testing.assert_allclose(got.fit_history, want.fit_history, rtol=0, atol=FIT_ATOL)


def test_init_factors_byte_identical():
    got = rt.init_factors((7, 5, 3), 4, seed=3, device="cpu")
    for g, w in zip(got, init_factors((7, 5, 3), 4, seed=3), strict=True):
        assert g.dtype == torch.float32
        assert g.numpy().tobytes() == np.asarray(w).tobytes()


def test_init_factors_byte_identical_across_draw_slices():
    """Factors longer than the draw's scratch, and a mode that starts in the
    middle of a slice of the stream, draw the reference's bits."""
    from repro_torch.core import cpals as port_cpals

    shape = (port_cpals._DRAW_SLICE // 4 + 3, 70_001, 5)
    got = rt.init_factors(shape, 4, seed=2**40 + 3, device="cpu")
    for g, w in zip(got, init_factors(shape, 4, seed=2**40 + 3), strict=True):
        assert g.shape == w.shape and g.numpy().tobytes() == np.asarray(w).tobytes()


def test_pinv_cutoff_matches_jax():
    """A singular value between torch's default cutoff and jnp's is dropped,
    as jnp.linalg.pinv drops it."""
    import jax.numpy as jnp

    from repro_torch.core.cpals import _pinv
    u, _ = np.linalg.qr(np.random.default_rng(0).normal(size=(4, 4)))
    s = np.array([1.0, 0.5, 0.25, 2e-6])  # 4·eps ≈ 4.8e-7 < 2e-6 < 40·eps ≈ 4.8e-6
    v = (u * s) @ u.T
    got = _pinv(torch.tensor(v, dtype=torch.float32)).numpy()
    want = np.asarray(jnp.linalg.pinv(jnp.asarray(v, dtype=jnp.float32)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.abs(got).max() < 10  # the tiny value was cut, not inverted


def test_interop_round_trips():
    rst = table1_tensor("lbnl")
    st = rt.tensor_from_reference(rst)
    assert st.shape == rst.shape
    assert st.coords.tobytes() == np.asarray(rst.coords).tobytes()
    assert st.values.tobytes() == np.asarray(rst.values).tobytes()
    rct = chunk_tensor(rst, (40, 105, 40, 105, 217), capacity=64)
    ct = rt.chunked_from_reference(rct)
    mine = rt.chunk_tensor(st, (40, 105, 40, 105, 217), capacity=64)
    for field in ("task_chunk", "coords_rel", "values", "nnz_per_task"):
        assert getattr(ct, field).tobytes() == getattr(mine, field).tobytes()
        assert getattr(ct, field).dtype == getattr(mine, field).dtype
    assert (ct.chunk_shape, ct.tensor_shape) == (mine.chunk_shape, mine.tensor_shape)
    ref_res = cp_als(rst, 4, 1, engine="ref", track_diff=False)
    factors, lam = rt.factors_from_reference(ref_res.factors, ref_res.lam, "cpu")
    for f, w in zip(factors, ref_res.factors, strict=True):
        assert f.dtype == torch.float32 and f.device.type == "cpu"
        assert f.numpy().tobytes() == np.asarray(w).tobytes()
    assert lam.numpy().tobytes() == np.asarray(ref_res.lam).tobytes()
    # the reference's factors give the port the reference's fit
    want = ref_res.fit_history[-1]
    got = rt.fit_value(st, factors, lam)
    assert abs(got - want) < FIT_ATOL


def test_no_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    st = rt.table1_tensor("nell2")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.cp_als(st, 4, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.build_engine(st, "kernel", 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.init_factors(st.shape, 4)


def test_build_engine_surface():
    st = rt.table1_tensor("nell2")
    # The tuning stack is ported: "auto" is the default method, and the
    # reference's tuning keywords are deprecated shims, as in the reference.
    eng = rt.build_engine(st, rank=4, device="cpu", tune=rt.TunePolicy(warmup=0, reps=1))
    assert eng.name.startswith("auto:") and eng.report.source == "measured"
    with pytest.raises(TypeError, match="tune= expects a TunePolicy"):
        rt.build_engine(st, "kernel", 4, device="cpu", tune=object())
    for bad in (dict(method="kernel", max_probes=2), dict(method="chunked", store=True)):
        with pytest.warns(DeprecationWarning, match="deprecated"):
            assert rt.build_engine(st, rank=4, device="cpu", **bad).name == bad["method"]
    with pytest.raises(ValueError, match="accuracy_budget only applies"), \
            pytest.warns(DeprecationWarning, match="accuracy_budget"):
        rt.cp_als(st, 4, 1, device="cpu", accuracy_budget=0.1)
    with pytest.raises(TypeError, match="did you mean 'capacity'"):
        rt.build_engine(st, "kernel", 4, device="cpu", capacty=8)
    with pytest.raises(ValueError, match="unknown engine"):
        rt.build_engine(st, "pallas", 4, device="cpu")
    with pytest.raises(ValueError, match="capacity must be >= 1"):
        rt.build_engine(st, "kernel", 4, device="cpu", capacity=0)
    assert {"ref", "chunked", "kernel"} <= set(rt.registered_backends())
    assert "`kernel`" in rt.backend_table()


def test_plan_cache_moves_chunked_arrays_once():
    st = rt.table1_tensor("nell2")
    cache = rt.PlanCache()
    kw = dict(chunk_shape=(302, 230, 720), capacity=4096, device="cpu", plans=cache)
    a = rt.build_engine(st, "kernel", 4, **kw)
    b = rt.build_engine(st, "chunked", 4, **kw)
    assert cache.stats.chunk_misses == 1 and cache.stats.device_misses == 1
    assert cache.stats.device_hits == 1
    factors = rt.init_factors(st.shape, 4, device="cpu")
    np.testing.assert_allclose(a(factors, 1).numpy(), b(factors, 1).numpy(), rtol=1e-5, atol=1e-5)
    # the default cache is what build_engine uses without plans=
    assert rt.build_engine(st, "ref", 4, device="cpu").context.plans is default_plan_cache


def test_prebuilt_engine_brings_its_device():
    st = rt.table1_tensor("lbnl")
    eng = rt.build_engine(st, "kernel", 4, device="cpu")
    before = mttkrp_kernel.launches
    res = rt.cp_als(st, 4, 1, engine=eng, track_diff=False)
    assert res.factors[0].device.type == "cpu"
    assert mttkrp_kernel.launches == before
    with pytest.raises(ValueError, match="runs on cpu"):
        rt.cp_als(st, 4, 1, engine=eng, device="meta")


@pytest.mark.parametrize("track_diff", [True, False])
@pytest.mark.parametrize("engine", ["ref", "fixed:int15-12"])
def test_norm_once_per_call(monkeypatch, engine, track_diff):
    """||X||² is computed once a call: on the device from the uploaded values
    when the call uploads the COO (with the difference, or for a lossy
    engine's factors-only fit), on the host with one `SparseTensor.norm` where
    it uploads none; every fit equals `fit_value` with the host norm on the
    same iteration's state."""
    from repro_torch.core import cpals as port_cpals
    st = rt.random_tensor((30, 24, 36), 700, seed=2)
    norms, fits = [], []
    real_norm, real_fit = rt.SparseTensor.norm, port_cpals.fit_value

    def counted_norm(self):
        norms.append(1)
        return real_norm(self)

    def recorded_fit(st, factors, lam, *args, **kwargs):
        fits.append(([f.clone() for f in factors], lam.clone(), args, dict(kwargs)))
        return real_fit(st, factors, lam, *args, **kwargs)

    monkeypatch.setattr(rt.SparseTensor, "norm", counted_norm)
    monkeypatch.setattr(port_cpals, "fit_value", recorded_fit)
    res = rt.cp_als(st, 4, 3, engine=engine, device="cpu", track_diff=track_diff,
                    chunk_shape=(8, 8, 8), capacity=64)
    on_host = engine == "ref" and not track_diff
    assert len(norms) == int(on_host)
    assert len(fits) == len(res.fit_history) == 3
    for got, (factors, lam, args, kwargs) in zip(res.fit_history, fits, strict=True):
        assert isinstance(kwargs.pop("norm_x2"), float if on_host else torch.Tensor)
        assert abs(got - real_fit(st, factors, lam, *args, **kwargs)) <= 1e-9
    monkeypatch.undo()
    factors, lam = res.factors, res.lam
    norm_x2 = st.norm() ** 2
    assert rt.fit_value(st, factors, lam, norm_x2=norm_x2) == rt.fit_value(st, factors, lam)
    device_norm = port_cpals._sum_squares(torch.from_numpy(st.values))
    assert device_norm.dtype == torch.float64 and device_norm.dim() == 0
    assert abs(float(device_norm) - norm_x2) <= 1e-12 * norm_x2
    assert abs(rt.fit_value(st, factors, lam, norm_x2=device_norm)
               - rt.fit_value(st, factors, lam)) <= 1e-9
