"""The port's `DecomposeService` on the CPU: the nine cases of
`tests/test_serve.py` (coalescing, results under concurrency, warm
zero-probe dispatch, failure isolation, validation, latency stats), its
spans, and per-request results against the JAX package's service on the
same requests.

Every `Future.result()` and every `close()` has a timeout, so that a hung
worker fails one test instead of the suite.  Results are compared member by
member at the tolerances of `tests/test_torch_batch.py` (its `_hold`):
max(1e-5, κ·2^-17) on factors and λ/max(1, |λ|), max(1e-6, κ·2^-20) on
fits.
"""
import contextlib
import threading

import numpy as np
import pytest

from repro.core import SparseTensor as RSparseTensor
from repro.engine import TunePolicy as RTunePolicy
from repro.serve import DecomposeService as RDecomposeService
from repro_torch import DecomposeService, ServeStats, SparseTensor, TunePolicy
from repro_torch.obs import capture
from test_torch_batch import _hold

RANK = 4
WAIT_S = 120    # every Future.result()
CLOSE_S = 60    # every close()


def small(shape, nnz, seed=0):
    rng = np.random.default_rng(seed)
    coords = np.stack([rng.integers(0, d, size=nnz) for d in shape], axis=1).astype(np.int32)
    values = rng.uniform(-1, 1, size=nnz).astype(np.float32)
    return SparseTensor(coords, values, tuple(shape))


@contextlib.contextmanager
def service(cls=DecomposeService, **kwargs):
    """A service on the CPU, closed with a timeout and checked stopped."""
    if cls is DecomposeService:
        kwargs.setdefault("device", "cpu")
    svc = cls(RANK, **kwargs)
    try:
        yield svc
    finally:
        svc.close(timeout=CLOSE_S)
        assert not svc._worker.is_alive()


def test_submit_returns_correct_shapes_and_order():
    tensors = [small((10, 9, 8), 40 + i, seed=i) for i in range(6)]
    with service(n_iters=2, max_batch=4, max_wait_ms=20.0) as svc:
        futs = [svc.submit(t) for t in tensors]
        results = [f.result(timeout=WAIT_S) for f in futs]
    for t, r in zip(tensors, results, strict=True):
        assert [tuple(f.shape) for f in r.factors] == [(d, RANK) for d in t.shape]
        assert all(f.device.type == "cpu" for f in r.factors)
        assert len(r.fit_history) == 2


def test_coalescing_batches_requests():
    tensors = [small((8, 8, 8), 40, seed=i) for i in range(8)]
    with service(n_iters=1, max_batch=8, max_wait_ms=200.0) as svc:
        futs = [svc.submit(t) for t in tensors]
        [f.result(timeout=WAIT_S) for f in futs]
        stats = svc.stats()
    # 200ms linger with instant submissions: far fewer batches than requests
    assert stats.n_requests == 8 and stats.n_completed == 8
    assert stats.n_batches < 8 and stats.max_batch_seen > 1


def test_warm_store_means_zero_probes_across_services(tmp_path):
    store = str(tmp_path / "serve-store.json")
    tensors = [small((10, 9, 8), 40, seed=i) for i in range(3)]
    with service(n_iters=1, tune=TunePolicy(store=store), max_batch=4,
                 max_wait_ms=50.0) as svc:
        [svc.decompose(t, timeout=WAIT_S) for t in tensors]
        assert svc.stats().n_probes > 0  # cold: the bucket probed once
    with service(n_iters=1, tune=TunePolicy(store=store), max_batch=4,
                 max_wait_ms=50.0) as svc2:
        [svc2.decompose(t, timeout=WAIT_S) for t in tensors]
        stats = svc2.stats()
    assert stats.n_probes == 0
    assert stats.n_bucket_decisions.get("persisted", 0) >= 1
    assert set(stats.n_bucket_decisions) <= {"persisted", "cached"}


def test_concurrent_clients_all_complete():
    tensors = [small((10, 9, 8), 40 + i, seed=i) for i in range(12)]
    results = [None] * len(tensors)
    with service(n_iters=1, max_batch=6, max_wait_ms=20.0) as svc:
        def client(idxs):
            for i in idxs:
                results[i] = svc.decompose(tensors[i], timeout=WAIT_S)
        threads = [threading.Thread(target=client, args=(range(c, 12, 3),)) for c in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=WAIT_S)
        assert not any(th.is_alive() for th in threads)
    for t, r in zip(tensors, results, strict=True):
        assert r is not None
        assert [f.shape[0] for f in r.factors] == list(t.shape)


def test_batch_failure_fails_every_future_in_it():
    # A float64 member makes its whole coalesced batch invalid (mixed
    # dtypes): both futures must carry the TypeError, and the service must
    # keep serving afterwards.
    good = small((8, 8), 20, seed=1)
    rng = np.random.default_rng(2)
    coords = np.stack([rng.integers(0, 8, size=20) for _ in range(2)], axis=1).astype(np.int32)
    bad = SparseTensor(coords, rng.uniform(-1, 1, 20), (8, 8))  # f64 values
    with service(n_iters=1, max_batch=2, max_wait_ms=500.0) as svc:
        f1, f2 = svc.submit(good), svc.submit(bad)
        for fut in (f1, f2):
            with pytest.raises(TypeError, match="mixed value dtypes"):
                fut.result(timeout=WAIT_S)
        assert svc.stats().n_failed == 2
        res = svc.decompose(small((8, 8), 20, seed=3), timeout=WAIT_S)  # still alive
        assert tuple(res.factors[0].shape) == (8, RANK)


def test_closed_service_rejects_and_non_tensor_rejected():
    svc = DecomposeService(RANK, n_iters=1, max_wait_ms=1.0, device="cpu")
    with pytest.raises(TypeError, match="SparseTensor"):
        svc.submit("nope")
    svc.close(timeout=CLOSE_S)
    assert not svc._worker.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(small((4, 4), 5))
    svc.close(timeout=CLOSE_S)  # idempotent


def test_constructor_validation():
    with pytest.raises(ValueError, match="max_batch"):
        DecomposeService(RANK, max_batch=0, device="cpu")
    with pytest.raises(ValueError, match="max_wait_ms"):
        DecomposeService(RANK, max_wait_ms=-1.0, device="cpu")


def test_stats_reports_latency_percentiles():
    tensors = [small((6, 5, 4), 20, seed=i) for i in range(5)]
    with service(n_iters=1, max_batch=4, max_wait_ms=10.0) as svc:
        assert svc.stats().request_ms == {}  # empty before any dispatch
        futs = [svc.submit(t) for t in tensors]
        [f.result(timeout=WAIT_S) for f in futs]
        stats = svc.stats()
    for field in (stats.queue_wait_ms, stats.dispatch_ms, stats.request_ms):
        assert set(field) == {"p50", "p99"}
        assert 0 <= field["p50"] <= field["p99"]
    # Queue wait is part of the request, so p99 request dominates p50 wait,
    # and the service-side histograms agree with the raw counters.
    assert stats.request_ms["p99"] >= stats.queue_wait_ms["p50"]
    snap = svc.metrics.snapshot()
    assert snap["serve.request_seconds"]["count"] == len(tensors)
    assert snap["serve.queue_wait_seconds"]["count"] == len(tensors)
    assert snap["serve.dispatch_seconds"]["count"] == stats.n_batches


def test_stats_snapshot_does_not_alias_service_state():
    tensors = [small((6, 5, 4), 20, seed=i) for i in range(3)]
    with service(n_iters=1, max_batch=4, max_wait_ms=10.0) as svc:
        futs = [svc.submit(t) for t in tensors]
        [f.result(timeout=WAIT_S) for f in futs]
        before = svc.stats()
        assert isinstance(before, ServeStats) and before.n_bucket_decisions
        # Mutating every container on the snapshot must not leak back.
        before.n_bucket_decisions["measured"] = 10_000
        before.n_bucket_decisions["bogus"] = 1
        before.queue_wait_ms["p50"] = -1.0
        after = svc.stats()
    assert "bogus" not in after.n_bucket_decisions
    assert after.n_bucket_decisions.get("measured", 0) != 10_000
    assert after.queue_wait_ms["p50"] >= 0
    assert after.n_bucket_decisions is not before.n_bucket_decisions
    assert after.queue_wait_ms is not before.queue_wait_ms


def test_spans_link_requests_to_their_batch():
    tensors = [small((6, 5, 4), 20, seed=i) for i in range(4)]
    with capture() as spans, service(n_iters=1, max_batch=4, max_wait_ms=500.0) as svc:
        futs = [svc.submit(t) for t in tensors]
        [f.result(timeout=WAIT_S) for f in futs]
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    batch_ids = {s.span_id for s in by_name["serve.batch"]}
    requests = by_name["serve.request"]
    assert len(requests) == len(tensors) == len(by_name["serve.queue_wait"])
    assert all(r.attrs["batch_span"] in batch_ids for r in requests)
    assert {w.parent_id for w in by_name["serve.queue_wait"]} == {r.span_id for r in requests}
    # the bucket decision and the batched iterations nest under the batch
    assert {s.parent_id for s in by_name["cp_als_batched.bucket"]} <= batch_ids
    assert by_name["autotune.bucket"] and by_name["cp_als_batched.iter"]


def test_results_equal_reference_service():
    ours = [small((12, 10, 8), 40 + 3 * i, seed=20 + i) for i in range(6)]
    theirs = [RSparseTensor(t.coords, t.values, t.shape) for t in ours]
    kw = dict(n_iters=3, max_batch=6, max_wait_ms=2000.0)
    with service(tune=TunePolicy(candidates=("ref",)), **kw) as svc:
        got = [f.result(timeout=WAIT_S) for f in [svc.submit(t) for t in ours]]
    with service(RDecomposeService, tune=RTunePolicy(candidates=("ref",)), **kw) as rsvc:
        want = [f.result(timeout=WAIT_S) for f in [rsvc.submit(t) for t in theirs]]
    _hold(got, want)
    assert {a.engine for a in got} == {b.engine for b in want} == {"batched:ref"}
