"""The CUDA spMTTKRP kernel against its plain PyTorch version on the card.

Run on a machine with an NVIDIA GPU and nvcc:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernel_gpu.py

Elsewhere every test skips (the card is looked for inside a fixture, so
every pytest worker collects the same tests).  The kernel's per-nonzero
products are formed in the plain version's order; only the order of the
atomic sums differs, so each entry is held to 1e-4 of the sum of the
absolute values of its terms, which bounds the reordering error of a float32
sum of up to ~800 terms (2·(k-1)·2^-24 ≤ 1e-4) and is several times the
typical error well beyond that.
"""
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch.kernels import mttkrp_kernel
from repro_torch.kernels import ref as pref

pytestmark = pytest.mark.gpu

SWEEP = [
    # shape, nnz, chunk_shape, capacity, rank
    ((32, 32, 32), 400, (8, 8, 8), 16, 4),
    ((40, 30, 50), 600, (16, 8, 16), 32, 8),
    ((17, 23, 9), 200, (8, 8, 4), 16, 3),
    ((20, 12, 20, 12), 300, (8, 4, 8, 4), 32, 5),
    ((8, 8, 8, 8, 8), 200, (4, 4, 4, 4, 4), 16, 2),
    ((40, 30, 50), 600, (16, 8, 16), 32, 40),  # R > 32: lanes loop over r
]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernel)")
    return torch.device("cuda")


def _inputs(shape, nnz, cs, cap, rank, device, seed=0, distribution="uniform"):
    st = rt.random_tensor(shape, nnz, seed=seed, distribution=distribution)
    rng = np.random.default_rng(seed + 1)
    factors = [torch.from_numpy(rng.uniform(-1, 1, (d, rank)).astype(np.float32)).to(device)
               for d in shape]
    ct = rt.chunk_tensor(st, cs, cap)
    return factors, ct, rt.chunked_device_arrays(ct, device)


def _assert_sum_order_close(got, want, abs_terms):
    torch.cuda.synchronize()
    err = (got - want).abs()
    tol = 1e-4 * abs_terms + 1e-6
    assert bool((err <= tol).all()), f"max err {err.max().item()} (max tol {tol.max().item()})"


def _check_every_mode(factors, ct, dev):
    padded = [rt.pad_factor(f, ct.chunk_shape[m]) for m, f in enumerate(factors)]
    abs_padded = [f.abs() for f in padded]
    args = (dev["task_chunk"], dev["coords_rel"])
    for mode in range(ct.ndim):
        before = mttkrp_kernel.launches
        got = rt.mttkrp_local(padded, *args, dev["values"], mode=mode, chunk_shape=ct.chunk_shape)
        assert mttkrp_kernel.launches == before + 1
        assert got.is_cuda and got.shape == (ct.num_tasks, ct.chunk_shape[mode],
                                              factors[0].shape[1])
        want = pref.mttkrp_local_ref(padded, *args, dev["values"], mode=mode,
                                     chunk_shape=ct.chunk_shape)
        abs_terms = pref.mttkrp_local_ref(abs_padded, *args, dev["values"].abs(), mode=mode,
                                          chunk_shape=ct.chunk_shape)
        _assert_sum_order_close(got, want, abs_terms)

        out_dim = ct.tensor_shape[mode]
        got = rt.mttkrp_kernel_op(factors, *args, dev["values"], mode=mode,
                                  chunk_shape=ct.chunk_shape, out_dim=out_dim)
        want = rt.mttkrp_chunked(factors, *args, dev["values"], mode=mode,
                                 chunk_shape=ct.chunk_shape, out_dim=out_dim)
        abs_terms = rt.mttkrp_chunked([f.abs() for f in factors], *args, dev["values"].abs(),
                                      mode=mode, chunk_shape=ct.chunk_shape, out_dim=out_dim)
        _assert_sum_order_close(got, want, abs_terms)


@pytest.mark.parametrize(("shape", "nnz", "cs", "cap", "rank"), SWEEP)
def test_kernel_matches_plain_every_mode(cuda, shape, nnz, cs, cap, rank):
    _check_every_mode(*_inputs(shape, nnz, cs, cap, rank, cuda))


def test_kernel_one_task_many_nonzeros(cuda):
    """T = 1 with a large P: the grid tiles one task over many blocks."""
    factors, ct, dev = _inputs((300, 200, 400), 400_000, (300, 200, 400), None, 10, cuda)
    assert ct.num_tasks == 1 and ct.capacity == 400_000
    _check_every_mode(factors, ct, dev)


def test_kernel_split_powerlaw_chunks_five_modes(cuda):
    factors, ct, dev = _inputs((16, 42, 16, 42, 868), 30_000, (16, 42, 16, 42, 109), 512, 10,
                               cuda, distribution="powerlaw")
    assert ct.num_tasks > ct.grid[-1]  # hot chunks were split
    _check_every_mode(factors, ct, dev)


def test_kernel_wrapper_rejects_what_it_cannot_take(cuda):
    factors, ct, dev = _inputs((32, 32, 32), 400, (8, 8, 8), 16, 4, cuda)
    with pytest.raises(TypeError, match="float32"):
        rt.mttkrp_local([f.double() for f in factors], dev["task_chunk"], dev["coords_rel"],
                        dev["values"], mode=0, chunk_shape=ct.chunk_shape)
    with pytest.raises(TypeError, match="int32"):
        rt.mttkrp_local(factors, dev["task_chunk"].long(), dev["coords_rel"],
                        dev["values"], mode=0, chunk_shape=ct.chunk_shape)
    with pytest.raises(ValueError, match="is on"):
        rt.mttkrp_local(factors, dev["task_chunk"].cpu(), dev["coords_rel"],
                        dev["values"], mode=0, chunk_shape=ct.chunk_shape)
