"""The port's host-side numpy code against the reference: the same seeds
must give byte-identical arrays, dtypes included (random_tensor, TABLE1,
decide_partition, chunk_tensor, pad_tasks)."""
import dataclasses
from unittest import mock

import numpy as np
import pytest

import repro_torch.core.sptensor as pt_sptensor
from repro.core import chunking as ref_chunking
from repro.core import partition as ref_partition
from repro.core import sptensor as ref_sptensor
from repro_torch.core import chunking as pt_chunking
from repro_torch.core import partition as pt_partition


def assert_same_array(got, want):
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.tobytes() == want.tobytes()


def assert_same_tensor(got, want):
    assert got.shape == want.shape
    assert_same_array(got.coords, want.coords)
    assert_same_array(got.values, want.values)


def assert_same_chunked(got, want):
    for field in ("task_chunk", "coords_rel", "values", "nnz_per_task"):
        assert_same_array(getattr(got, field), getattr(want, field))
    assert got.chunk_shape == want.chunk_shape
    assert got.tensor_shape == want.tensor_shape


RANDOM_CASES = [
    # shape, nnz, distribution, seed
    ((32, 32, 32), 400, "uniform", 0),
    ((40, 30, 50), 600, "powerlaw", 1),
    ((8, 6, 10), 300, "uniform", 3),      # heavy collisions: several top-ups
    ((8, 6, 10), 300, "powerlaw", 3),
    ((20, 12, 20, 12), 300, "powerlaw", 5),
    ((3, 4), 1000, "uniform", 0),         # capped at the cell count
    ((5, 5), 0, "uniform", 0),
]


@pytest.mark.parametrize(("shape", "nnz", "dist", "seed"), RANDOM_CASES)
def test_random_tensor_byte_identical(shape, nnz, dist, seed):
    got = pt_sptensor.random_tensor(shape, nnz, distribution=dist, seed=seed)
    want = ref_sptensor.random_tensor(shape, nnz, distribution=dist, seed=seed)
    assert_same_tensor(got, want)


def test_random_tensor_exact_fill_topup_byte_identical():
    """A full powerlaw request stalls rejection sampling, so both versions
    reach the exact fill from the missing cells."""
    with mock.patch.object(np, "setdiff1d", wraps=np.setdiff1d) as spy:
        got = pt_sptensor.random_tensor((6, 6, 6), 216, distribution="powerlaw", seed=2)
        assert spy.call_count >= 1
        want = ref_sptensor.random_tensor((6, 6, 6), 216, distribution="powerlaw", seed=2)
    assert got.nnz == 216
    assert_same_tensor(got, want)


@pytest.mark.parametrize("dist", ["uniform", "powerlaw"])
def test_random_tensor_past_int64_cells_byte_identical(dist):
    """2**65 cells cannot ravel into int64 keys: the row-wise fallback."""
    shape = (2**21, 2**21, 2**21, 4)
    with mock.patch.object(np, "ravel_multi_index", wraps=np.ravel_multi_index) as spy:
        got = pt_sptensor.random_tensor(shape, 300, distribution=dist, seed=4)
        assert spy.call_count == 0
    want = ref_sptensor.random_tensor(shape, 300, distribution=dist, seed=4)
    assert_same_tensor(got, want)


@pytest.mark.parametrize("shape", [(7, 5, 9), (2**31 - 1, 2**31 - 1), (2**21, 2**21, 2**21, 4)])
def test_dedup_key_path_matches_rowwise_unique(shape):
    rng = np.random.default_rng(0)
    coords = np.stack([rng.integers(0, min(d, 6), 500) for d in shape], axis=1).astype(np.int32)
    values = rng.uniform(-1, 1, 500).astype(np.float32)
    got = pt_sptensor._dedup(coords, values, shape)
    want = ref_sptensor._dedup(coords, values)
    for g, w in zip(got, want, strict=True):
        assert_same_array(g, w)


@pytest.mark.parametrize("name", sorted(ref_sptensor.TABLE1))
def test_table1_tensor_byte_identical(name):
    assert pt_sptensor.TABLE1 == ref_sptensor.TABLE1
    assert_same_tensor(pt_sptensor.table1_tensor(name), ref_sptensor.table1_tensor(name))


@pytest.mark.parametrize("name", ["nell2", "lbnl", "delicious"])
@pytest.mark.parametrize("mem_bytes", [64 * 1024 * 1024, 256 * 1024])
def test_decide_partition_identical(name, mem_bytes):
    kw = dict(rank_axis=10) if mem_bytes == 256 * 1024 else {}
    got = pt_partition.decide_partition(pt_sptensor.table1_tensor(name), 10,
                                        mem_bytes=mem_bytes, **kw)
    want = ref_partition.decide_partition(ref_sptensor.table1_tensor(name), 10,
                                          mem_bytes=mem_bytes, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.mem_bytes_per_device == want.mem_bytes_per_device


CHUNK_CASES = [
    # shape, nnz, distribution, chunk_shape, capacity
    ((32, 32, 32), 400, "uniform", (8, 8, 8), 16),
    ((17, 23, 9), 200, "powerlaw", (8, 8, 4), 16),
    ((20, 12, 20, 12), 300, "powerlaw", (8, 4, 8, 4), None),
    ((8, 8, 8, 8, 8), 200, "uniform", (4, 4, 4, 4, 4), 5),
]


@pytest.mark.parametrize(("shape", "nnz", "dist", "cs", "cap"), CHUNK_CASES)
def test_chunk_tensor_and_pad_tasks_byte_identical(shape, nnz, dist, cs, cap):
    pst = pt_sptensor.random_tensor(shape, nnz, distribution=dist, seed=0)
    rst = ref_sptensor.random_tensor(shape, nnz, distribution=dist, seed=0)
    got = pt_chunking.chunk_tensor(pst, cs, cap)
    want = ref_chunking.chunk_tensor(rst, cs, cap)
    assert_same_chunked(got, want)
    for multiple in (1, 4, 7):
        assert_same_chunked(got.pad_tasks(multiple), want.pad_tasks(multiple))
    assert_same_array(got.coords_global(), want.coords_global())
    for mode in range(len(shape)):
        assert (pt_chunking.replication_stats(got, 10, mode)
                == ref_chunking.replication_stats(want, 10, mode))


def test_chunk_tensor_rejects_past_int32_extent():
    st = pt_sptensor.SparseTensor(np.zeros((1, 2), np.int32), np.ones(1, np.float32),
                                  (2**31, 2))
    with pytest.raises(ValueError, match="int32"):
        pt_chunking.chunk_tensor(st, (2**30 + 1, 2))
