"""The serving path on the card: the batched MTTKRP and `cp_als_batched`
against their CPU runs, a card fault raising out of `autotune_bucket`, the
tuning store keeping CPU and CUDA bucket decisions apart, and
`DecomposeService` on the card.

Run on a machine with an NVIDIA GPU:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_batch_gpu.py

Elsewhere every test skips (the card is looked for inside a fixture).
Tolerances: the batched MTTKRP within 1e-5 (relative and absolute) of the
CPU's; CP-ALS results member by member within max(1e-5, κ·2^-17) on
factors and λ/max(1, |λ|) and max(1e-6, κ·2^-20) on fits (κ: the largest
condition number of the Gram Hadamard product each ALS update inverts, as
`tests/test_torch_batch.py` states it).
"""
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch.batch import (
    BucketPlanCache,
    autotune_bucket,
    bucket_tensors,
    build_batched_kernel,
    pad_bucket,
)
from repro_torch.batch import kernels as bkernels

pytestmark = pytest.mark.gpu

RANK = 5


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _small(shape, nnz, seed):
    rng = np.random.default_rng(seed)
    coords = np.stack([rng.integers(0, d, size=nnz) for d in shape], axis=1).astype(np.int32)
    return rt.SparseTensor(coords, rng.uniform(-1, 1, size=nnz).astype(np.float32), shape)


def _load(n, seed=0):
    families = [((12, 10, 8), 40), ((16, 16, 16), 90), ((24, 24), 50)]
    return [_small(families[i % 3][0], families[i % 3][1] + i % 20, seed + i) for i in range(n)]


def _kappa(factors) -> float:
    fs = [np.asarray(f.cpu(), dtype=np.float64) for f in factors]
    worst = 1.0
    for mode in range(len(fs)):
        v = np.ones((fs[0].shape[1],) * 2)
        for k, f in enumerate(fs):
            if k != mode:
                v = v * (f.T @ f)
        worst = max(worst, float(np.linalg.cond(v)))
    return worst


def _hold(got, want):
    for a, b in zip(got, want, strict=True):
        kappa = _kappa(b.factors)
        ftol, fit_tol = max(1e-5, kappa * 2.0 ** -17), max(1e-6, kappa * 2.0 ** -20)
        for x, y in zip(a.factors, b.factors, strict=True):
            assert float((x.cpu() - y.cpu()).abs().max()) <= ftol
        lb = b.lam.cpu()
        assert float(((a.lam.cpu() - lb).abs() / lb.abs().clamp_min(1.0)).max()) <= ftol
        assert np.abs(np.subtract(a.fit_history, b.fit_history)).max() <= fit_tol


@pytest.mark.parametrize("name", ["ref", "alto"])
def test_batched_mttkrp_matches_cpu(cuda, name):
    (pb,) = [pad_bucket(b) for b in bucket_tensors(_load(60)[::3]).values()][:1]
    rng = np.random.default_rng(0)
    factors = [rng.uniform(-1, 1, size=(pb.size, d, RANK)).astype(np.float32) for d in pb.dims]
    on_card = build_batched_kernel(name, pb, cuda)
    on_cpu = build_batched_kernel(name, pb, "cpu")
    for mode in range(len(pb.dims)):
        got = on_card([torch.from_numpy(f).to(cuda) for f in factors], mode)
        want = on_cpu([torch.from_numpy(f) for f in factors], mode)
        assert got.device.type == "cuda"
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["ref", "alto"])
def test_cp_als_batched_matches_cpu(cuda, name):
    tensors = _load(90)
    policy = rt.TunePolicy(candidates=(name,))
    on_card = rt.cp_als_batched(tensors, RANK, 3, tune=policy, track_diff=True)
    on_cpu = rt.cp_als_batched(tensors, RANK, 3, tune=policy, track_diff=True, device="cpu")
    _hold(on_card, on_cpu)
    for r, t in zip(on_card, tensors, strict=True):
        assert r.engine == f"batched:{name}"
        assert [tuple(f.shape) for f in r.factors] == [(d, RANK) for d in t.shape]
        assert all(f.device.type == "cuda" for f in r.factors) and r.lam.device.type == "cuda"
        # a copy of the member's rows, not a view that keeps the bucket alive
        assert all(f.untyped_storage().nbytes() == f.numel() * 4 for f in r.factors)
        assert len(r.diff_history) == 3


def test_card_fault_raises_out_of_autotune_bucket(cuda, monkeypatch):
    (pb,) = [pad_bucket(b) for b in bucket_tensors(_load(4)[:1]).values()]

    def broken(pb, device):
        def engine(factors, mode):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")
        return engine

    monkeypatch.setitem(bkernels._BATCHED_FACTORIES, "alto", broken)
    with pytest.raises(torch.cuda.OutOfMemoryError, match="injected"):
        autotune_bucket(pb, RANK, device=cuda)
    # The same failure on the CPU disqualifies the candidate, as in the reference.
    _, rep = autotune_bucket(pb, RANK, device="cpu")
    assert "batched:alto" in rep.skipped and set(rep.winners.values()) == {"batched:ref"}


def test_store_keeps_cpu_and_card_decisions_apart(cuda, tmp_path):
    (pb,) = [pad_bucket(b) for b in bucket_tensors(_load(4)[:1]).values()]
    policy = rt.TunePolicy(store=rt.TuningStore(tmp_path / "s.json"))
    assert autotune_bucket(pb, RANK, policy, device="cpu")[1].source == "measured"
    cold = autotune_bucket(pb, RANK, policy, device=cuda)[1]
    assert cold.source == "measured" and cold.n_probes == 2 * len(pb.dims)
    warm = autotune_bucket(pb, RANK, rt.TunePolicy(store=rt.TuningStore(tmp_path / "s.json")),
                           device=cuda)[1]
    assert warm.source == "persisted" and warm.n_probes == 0
    plans = BucketPlanCache()
    autotune_bucket(pb, RANK, policy, device=cuda, plans=plans)
    assert autotune_bucket(pb, RANK, policy, device=cuda, plans=plans)[1].source == "cached"


def test_service_on_the_card(cuda, tmp_path):
    tensors = _load(24)
    svc = rt.DecomposeService(RANK, 3, max_batch=24, max_wait_ms=200.0,
                              tune=rt.TunePolicy(store=rt.TuningStore(tmp_path / "s.json")))
    try:
        assert svc.device.type == "cuda"
        futures = [svc.submit(t) for t in tensors]
        results = [f.result(timeout=300) for f in futures]
    finally:
        svc.close(timeout=120)
    stats = svc.stats()
    assert stats.n_completed == len(tensors) and stats.n_failed == 0
    assert all(f.device.type == "cuda" for r in results for f in r.factors)
    want = rt.cp_als_batched(tensors, RANK, 3,
                             tune=rt.TunePolicy(store=rt.TuningStore(tmp_path / "s.json")))
    _hold(results, want)
