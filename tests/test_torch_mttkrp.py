"""The port's float spMTTKRP against the JAX package on the CPU, over the
SWEEP of tests/test_kernels.py, every mode, at rtol = atol = 1e-5: the COO
and chunked ops, the kernel wrapper's CPU path (its plain version) against
the jnp oracle and the interpret-mode Pallas kernel, and the full kernel op
against the full Pallas op.  Same inputs on both sides, made with numpy."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import chunk_tensor, random_tensor
from repro.core.mttkrp import mttkrp_chunked, mttkrp_coo
from repro.kernels import mttkrp_pallas
from repro.kernels import ref as kref
from repro.kernels.mttkrp_kernel import mttkrp_pallas_local
from repro.kernels.ops import pad_factor
from repro_torch.kernels import mttkrp_kernel
from repro_torch.kernels import ref as pref

SWEEP = [
    # shape, nnz, chunk_shape, capacity, rank
    ((32, 32, 32), 400, (8, 8, 8), 16, 4),
    ((40, 30, 50), 600, (16, 8, 16), 32, 8),
    ((17, 23, 9), 200, (8, 8, 4), 16, 3),
    ((20, 12, 20, 12), 300, (8, 4, 8, 4), 32, 5),
    ((8, 8, 8, 8, 8), 200, (4, 4, 4, 4, 4), 16, 2),
]
TOL = dict(rtol=1e-5, atol=1e-5)


def _setup(shape, nnz, cs, cap, rank, seed=0):
    st = random_tensor(shape, nnz, seed=seed)
    rng = np.random.default_rng(seed + 1)
    factors = [rng.uniform(-1, 1, (d, rank)).astype(np.float32) for d in shape]
    ct = chunk_tensor(st, cs, capacity=cap)
    pdev = rt.chunked_device_arrays(rt.chunked_from_reference(ct), "cpu")
    jdev = dict(task_chunk=jnp.asarray(ct.task_chunk), coords_rel=jnp.asarray(ct.coords_rel),
                values=jnp.asarray(ct.values))
    return st, factors, ct, pdev, jdev


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@pytest.mark.parametrize(("shape", "nnz", "cs", "cap", "rank"), SWEEP)
def test_coo_and_chunked_match_reference(shape, nnz, cs, cap, rank):
    st, factors, ct, pdev, jdev = _setup(shape, nnz, cs, cap, rank)
    coords, values = torch.from_numpy(st.coords), torch.from_numpy(st.values)
    for mode in range(len(shape)):
        want = mttkrp_coo(_j(factors), jnp.asarray(st.coords), jnp.asarray(st.values),
                          mode=mode, out_dim=shape[mode])
        got = rt.mttkrp_coo(_t(factors), coords, values, mode=mode, out_dim=shape[mode])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        want = mttkrp_chunked(_j(factors), jdev["task_chunk"], jdev["coords_rel"],
                              jdev["values"], mode=mode, chunk_shape=ct.chunk_shape,
                              out_dim=shape[mode])
        got = rt.mttkrp_chunked(_t(factors), pdev["task_chunk"], pdev["coords_rel"],
                                pdev["values"], mode=mode, chunk_shape=ct.chunk_shape,
                                out_dim=shape[mode])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize(("shape", "nnz", "cs", "cap", "rank"), SWEEP)
def test_local_cpu_path_matches_oracle_and_pallas(shape, nnz, cs, cap, rank):
    _st, factors, ct, pdev, jdev = _setup(shape, nnz, cs, cap, rank)
    jpadded = tuple(pad_factor(f, cs[m]) for m, f in enumerate(_j(factors)))
    tpadded = [rt.pad_factor(f, cs[m]) for m, f in enumerate(_t(factors))]
    before = mttkrp_kernel.launches
    for mode in range(len(shape)):
        got = rt.mttkrp_local(tpadded, pdev["task_chunk"], pdev["coords_rel"], pdev["values"],
                              mode=mode, chunk_shape=ct.chunk_shape)
        oracle = kref.mttkrp_local_ref(jpadded, jdev["task_chunk"], jdev["coords_rel"],
                                       jdev["values"], mode=mode, chunk_shape=ct.chunk_shape)
        pallas = mttkrp_pallas_local(jpadded, jdev["task_chunk"], jdev["coords_rel"],
                                     jdev["values"], mode=mode, chunk_shape=ct.chunk_shape,
                                     interpret=True)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    assert mttkrp_kernel.launches == before  # the CPU path launches nothing


@pytest.mark.parametrize(("shape", "nnz", "cs", "cap", "rank"), SWEEP)
def test_kernel_op_matches_pallas_op(shape, nnz, cs, cap, rank):
    _st, factors, ct, pdev, jdev = _setup(shape, nnz, cs, cap, rank, seed=3)
    for mode in range(len(shape)):
        want = mttkrp_pallas(_j(factors), jdev["task_chunk"], jdev["coords_rel"],
                             jdev["values"], mode=mode, chunk_shape=ct.chunk_shape,
                             out_dim=shape[mode], interpret=True)
        got = rt.mttkrp_kernel_op(_t(factors), pdev["task_chunk"], pdev["coords_rel"],
                                  pdev["values"], mode=mode, chunk_shape=ct.chunk_shape,
                                  out_dim=shape[mode])
        assert got.shape == (shape[mode], rank)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gathers_clamp_and_scatters_drop_like_reference():
    """Out-of-range indices: gathers clamp to the last row and scatters drop
    the row, as jnp's defaults do, where torch's index ops would raise."""
    rng = np.random.default_rng(0)
    factor = rng.uniform(-1, 1, (10, 3)).astype(np.float32)
    offsets = np.array([0, 4, 8], np.int32)
    got = rt.gather_factor_blocks(torch.from_numpy(factor), torch.from_numpy(offsets), 4)
    from repro.core.mttkrp import gather_factor_blocks
    want = gather_factor_blocks(jnp.asarray(factor), jnp.asarray(offsets), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    local = rng.uniform(-1, 1, (3, 4, 3)).astype(np.float32)
    task_chunk = np.array([[0], [1], [2]], np.int32)
    got = pref.reduce_local(torch.from_numpy(local), torch.from_numpy(task_chunk),
                            mode=0, chunk_shape=(4,), out_dim=10)
    want = kref.reduce_local(jnp.asarray(local), jnp.asarray(task_chunk),
                             mode=0, chunk_shape=(4,), out_dim=10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    coords_rel = np.array([[[0, 1], [5, 1], [3, 2]]], np.int32)  # row 5 is past S = 4
    values = np.array([[1.0, 2.0, 3.0]], np.float32)
    two = [factor, rng.uniform(-1, 1, (10, 3)).astype(np.float32)]
    tc = np.zeros((1, 2), np.int32)
    got = rt.mttkrp_local(_t(two), torch.from_numpy(tc), torch.from_numpy(coords_rel),
                          torch.from_numpy(values), mode=0, chunk_shape=(4, 4))
    want = kref.mttkrp_local_ref(_j(two), jnp.asarray(tc), jnp.asarray(coords_rel),
                                 jnp.asarray(values), mode=0, chunk_shape=(4, 4))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_kernel_wrapper_refuses_other_devices():
    meta = torch.zeros((1, 2, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        rt.mttkrp_local([torch.zeros(2, 2)] * 2, torch.zeros(1, 2, dtype=torch.int32), meta,
                        torch.zeros(1, 2), mode=0, chunk_shape=(2, 2))
