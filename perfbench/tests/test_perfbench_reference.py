"""The plain reference against the port's own plain (CPU) paths, on tiny tensors."""
import numpy as np
import pytest
import torch

from perfbench import check, reference, tensorgen
from perfbench.tests import _tiny  # noqa: F401  (puts the program on sys.path)


def _tensor(shape, nnz, dist, seed=3):
    from repro_torch.core.sptensor import SparseTensor
    c, v = tensorgen.generate(shape, nnz, distribution=dist, seed=seed, device="cpu")
    return c, v, SparseTensor(c.numpy(), v.numpy(), shape)


def test_init_factors_are_the_algorithms_draws():
    from repro_torch.core.cpals import init_factors
    ours = reference.init_factors((7, 5, 9), 4, 2**33 + 1)
    theirs = init_factors((7, 5, 9), 4, 2**33 + 1, device="cpu")
    for a, b in zip(ours, theirs, strict=True):
        assert np.array_equal(a, b.numpy())


@pytest.mark.parametrize(("shape", "dist"), [((60, 46, 144), "uniform"),
                                             ((40, 50, 30, 45, 900), "powerlaw")])
@pytest.mark.parametrize(("engine", "precision", "limit"), [
    ("ref", "float64", 1e-4),
    ("kernel", "float64", 1e-4),
    ("fixed:int15-12", "int15-12", 2e-2),
])
def test_reference_agrees_with_the_ports_cpu_path(shape, dist, engine, precision, limit):
    """float64 against the port's float32 COO and chunked paths: float32 rounding
    through five iterations; int15-12: the same integers from the quantised inputs,
    which round apart where float32 and float64 factors straddle a step."""
    import repro_torch as rt
    c, v, st = _tensor(shape, 5000, dist)
    plan = rt.decide_partition(st, 10, mem_bytes=256 * 1024, rank_axis=10)
    for seed in (1, 2**35 + 9):
        res = rt.cp_als(st, 10, n_iters=5, engine=engine, seed=seed, device="cpu",
                        **({} if engine == "ref" else dict(chunk_shape=plan.chunk_shape,
                                                           capacity=plan.capacity)))
        ref = reference.cp_als_ref(c, v, shape, 10, 5, seed, precision=precision)
        r = check.readings(res, ref)
        assert r["factor_gap"] < limit and r["lam_gap"] < limit, r


@pytest.mark.parametrize(("engine", "precision"), [("kernel", "float64"),
                                                   ("fixed:int15-12", "int15-12")])
def test_last_step_agrees_with_the_ports_cpu_path(engine, precision):
    """Recomputed from the port's own final state, the last step carries no earlier
    step's rounding: float32 against float64 in one step, and for int15-12 the
    same integers, since both sides quantise the same factors."""
    import repro_torch as rt
    shape = (40, 50, 30, 45, 900)
    c, v, st = _tensor(shape, 5000, "powerlaw")
    plan = rt.decide_partition(st, 10, mem_bytes=256 * 1024, rank_axis=10)
    res = rt.cp_als(st, 10, n_iters=5, engine=engine, seed=2**35 + 9, device="cpu",
                    chunk_shape=plan.chunk_shape, capacity=plan.capacity)
    step = reference.last_step_ref(c, v, shape, res.factors, res.lam, precision=precision)
    r = check.step_readings(res, step)
    assert set(r) == {"step_factor_gap", "step_lam_gap", "step_fit_gap", "step_diff_gap"} | (
        {"step_qerr_gap"} if precision != "float64" else set())
    assert max(r.values()) < 1e-4, r


@pytest.mark.parametrize("preset", ["int15-12", "int7"])
def test_fixed_spmttkrp_is_the_ports_integers(preset):
    """On the same float64 factors, the frozen Algorithm 2 gives the port's COO
    fixed-point output bit for bit."""
    from repro_torch.core.mttkrp import dequantize_output, mttkrp_coo_fixed
    from repro_torch.core.qformat import FIXED_PRESETS, value_qformat
    shape = (40, 50, 30, 45)
    c, v, st = _tensor(shape, 4000, "powerlaw")
    factors = [torch.from_numpy(f).double() * 2 - 1 for f in reference.init_factors(shape, 6, 5)]
    x = reference._Tensor(c, v, shape, preset, block=1000)
    qf, prec_shift = FIXED_PRESETS[preset]
    vq = value_qformat(st.values, storage_bits=16)
    assert vq.frac_bits == reference.value_frac_bits(st.values)
    qvalues = torch.from_numpy(vq.quantize_np(st.values))
    for mode in range(4):
        ours = x.mttkrp(factors, mode)
        qout = mttkrp_coo_fixed([qf.quantize(f.float()) for f in factors], c, qvalues,
                                mode=mode, out_dim=shape[mode], matrix_frac=qf.frac_bits,
                                value_frac=vq.frac_bits, prec_shift=prec_shift)
        theirs = dequantize_output(qout, qf.frac_bits, prec_shift)
        assert torch.equal(ours.float(), theirs)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -1.0 - 2**-12])
    assert reference._tf32(x).tolist() == [1.0, 1.0 + 2**-10, 1.0, 1.0 + 2**-9, -1.0]


def test_readings_flag_non_finite_results():
    c, v, _ = _tensor((20, 30, 40), 800, "uniform")
    ref = reference.cp_als_ref(c, v, (20, 30, 40), 4, 2, 1)
    bad = reference.cp_als_ref(c, v, (20, 30, 40), 4, 2, 1)
    bad.factors[0][0, 0] = float("nan")
    bad.fit_history[1] = float("nan")
    r = check.readings(bad, ref)
    assert r["factor_gap"] == float("inf") and r["fit_gap"] == float("inf")
    assert check.judge([r], {"factor_gap": 1.0}) == (False, r)
    assert check.judge([], {"factor_gap": 1.0})[0] is False
