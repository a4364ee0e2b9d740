"""The port's batched many-tensor CP-ALS (`repro_torch.batch`) against the
JAX package's `repro.batch`, on the CPU.

- Bucketing and padding: byte-identical arrays and the same errors.
- Batched MTTKRP (`ref`, `alto`) on one reference `PaddedBatch`: within
  1e-5 (relative and absolute) of the reference's in every mode.
- `cp_als_batched` member by member against the reference's and against
  the port's sequential `cp_als`.  Two float32 ALS runs that round
  differently drift apart by an amount that grows with κ, the condition
  number of the Gram Hadamard product each update inverts, so a flat 1e-5
  does not hold for every member of a large load.  Each member is held to
  max(1e-5, κ·2^-17) on factors and λ/max(1, |λ|), and max(1e-6, κ·2^-20)
  on fits per iteration (κ from the comparison target's factors, float64;
  the reasoning is in chip_smoke.py's docstring); well-conditioned members
  keep the flat 1e-5 and 1e-6.  Not bit for bit: the reference's own
  bit-exact batched-vs-sequential tests fail.
- Tuning decisions under one fake timing table patched into both
  packages' `_time_batched` seams: the same winners, probes, skips and
  sources.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.batch import BucketPlanCache as RBucketPlanCache
from repro.batch import PaddedBatch as RPaddedBatch
from repro.batch import autotune_bucket as ref_autotune_bucket
from repro.batch import bucket_tensors as ref_bucket_tensors
from repro.batch import build_batched_kernel as ref_build_batched_kernel
from repro.batch import cp_als_batched as ref_cp_als_batched
from repro.batch import nnz_band as ref_nnz_band
from repro.batch import pad_bucket as ref_pad_bucket
from repro.batch import shape_class as ref_shape_class
from repro.batch import tune as rtune
from repro.core import SparseTensor as RSparseTensor
from repro.engine import TunePolicy as RTunePolicy
from repro_torch.batch import (
    BucketPlanCache,
    autotune_bucket,
    batched_kernel_names,
    bucket_tensors,
    build_batched_kernel,
    cp_als_batched,
    nnz_band,
    pad_bucket,
    shape_class,
)
from repro_torch.batch import kernels as bkernels
from repro_torch.batch import tune as ttune
from repro_torch.batch.tune import _is_card_fault
from repro_torch.core.cpals import _pinv
from repro_torch.obs import capture

RANK = 4
N_ITERS = 3
REPO = Path(__file__).resolve().parents[1]
MTTKRP_TOL = dict(rtol=1e-5, atol=1e-5)


def _raw(shape, nnz, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    coords = np.stack([rng.integers(0, d, size=nnz) for d in shape], axis=1).astype(np.int32)
    return coords, rng.uniform(-1, 1, size=nnz).astype(dtype), tuple(shape)


def _both(raws):
    return [rt.SparseTensor(*r) for r in raws], [RSparseTensor(*r) for r in raws]


#: Mixed buckets: two 3-mode bands (one member exactly on the 64 boundary),
#: a 2-mode family, in an interleaved arrival order.
MIXED = ([_raw((12, 10, 8), 40 + 9 * i, 10 + i) for i in range(4)]
         + [_raw((24, 24), 50 + i, 30 + i) for i in range(3)]
         + [_raw((9, 7, 5), 64, 40)])
MIXED = [MIXED[i] for i in (0, 4, 1, 7, 5, 2, 6, 3)]


def _kappa(factors) -> float:
    """Largest condition number, over the modes, of the Hadamard product of
    the other modes' Grams (float64)."""
    fs = [np.asarray(f, dtype=np.float64) for f in factors]
    worst = 1.0
    for mode in range(len(fs)):
        v = np.ones((fs[0].shape[1],) * 2)
        for k, f in enumerate(fs):
            if k != mode:
                v = v * (f.T @ f)
        worst = max(worst, float(np.linalg.cond(v)))
    return worst


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _hold(got, want, *, diffs=False):
    """Member-wise tolerances of the module docstring."""
    for a, b in zip(got, want, strict=True):
        fb = [_np(f) for f in b.factors]
        kappa = _kappa(fb)
        ftol, fit_tol = max(1e-5, kappa * 2.0 ** -17), max(1e-6, kappa * 2.0 ** -20)
        assert [f.shape for f in fb] == [tuple(f.shape) for f in a.factors]
        for x, y in zip(a.factors, fb, strict=True):
            np.testing.assert_allclose(_np(x), y, rtol=0, atol=ftol)
        lb = _np(b.lam)
        assert np.max(np.abs(_np(a.lam) - lb) / np.maximum(np.abs(lb), 1.0)) <= ftol
        np.testing.assert_allclose(a.fit_history, b.fit_history, rtol=0, atol=fit_tol)
        if diffs:
            np.testing.assert_allclose(a.diff_history, b.diff_history, rtol=0, atol=ftol)


# ---------------------------------------------------------------------------
# bucketing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(12, 10, 8), (1, 2, 3), (24, 24), (16, 16, 16), (1000, 3, 65)])
def test_shape_class_matches_reference(shape):
    assert shape_class(shape) == ref_shape_class(shape)


@pytest.mark.parametrize("nnz", [0, 1, 2, 3, 63, 64, 65, 1023, 1024, 2 ** 20 + 1])
def test_nnz_band_matches_reference(nnz):
    assert nnz_band(nnz) == ref_nnz_band(nnz)


def test_bucketing_and_padding_byte_identical():
    ours, theirs = _both(MIXED)
    b_ours, b_theirs = bucket_tensors(ours), ref_bucket_tensors(theirs)
    assert list(b_ours) == list(b_theirs)
    assert len(b_ours) == 4  # (16,16,8) bands 5 and 6, (16,8,8) band 6, (32,32) band 5
    for key in b_ours:
        assert b_ours[key].indices == b_theirs[key].indices
        p, r = pad_bucket(b_ours[key]), ref_pad_bucket(b_theirs[key])
        assert (p.dims, p.band, p.shapes, p.nnz) == (r.dims, r.band, r.shapes, r.nnz)
        for name in ("coords", "values", "mask"):
            a, b = getattr(p, name), getattr(r, name)
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    assert bucket_tensors([]) == {} and cp_als_batched([], RANK, device="cpu") == []


def test_band_boundary_splits_buckets():
    ours, _ = _both([_raw((8, 8, 8), 63, 2), _raw((8, 8, 8), 64, 3)])
    assert sorted(band for _, band in bucket_tensors(ours)) == [5, 6]


@pytest.mark.parametrize("case", ["value_dtypes", "coord_dtypes", "non_tensor"])
def test_rejections_match_reference(case):
    a, b = _raw((8, 8), 10, 4), _raw((8, 8), 10, 5)
    if case == "value_dtypes":
        b = (b[0], b[1].astype(np.float64), b[2])
    elif case == "coord_dtypes":
        b = (b[0].astype(np.int64), b[1], b[2])
    ours, theirs = _both([a, b])
    if case == "non_tensor":
        ours[1] = theirs[1] = "nope"
    with pytest.raises(TypeError) as ref_err:
        ref_bucket_tensors(theirs)
    with pytest.raises(TypeError) as err:
        cp_als_batched(ours, RANK, device="cpu")
    assert str(err.value) == str(ref_err.value)


# ---------------------------------------------------------------------------
# batched MTTKRP
# ---------------------------------------------------------------------------

def _reference_batch(raws):
    (bucket,) = ref_bucket_tensors(_both(raws)[1]).values()
    return ref_pad_bucket(bucket)


BATCH3 = [_raw((12, 10, 8), 40 + 3 * i, 50 + i) for i in range(5)]
BATCH2 = [_raw((24, 24), 50 + i, 60 + i) for i in range(4)]


@pytest.mark.parametrize("name", ["ref", "alto"])
@pytest.mark.parametrize("raws", [BATCH3, BATCH2], ids=["3-mode", "2-mode"])
def test_batched_mttkrp_matches_reference(name, raws):
    rpb = _reference_batch(raws)
    pb = rt.padded_batch_from_reference(rpb)
    rng = np.random.default_rng(1)
    factors = [rng.uniform(-1, 1, size=(pb.size, d, RANK)).astype(np.float32) for d in pb.dims]
    ours = build_batched_kernel(name, pb, "cpu")
    theirs = ref_build_batched_kernel(name, rpb)
    for mode in range(len(pb.dims)):
        got = ours([torch.from_numpy(f) for f in factors], mode)
        want = np.asarray(theirs([jnp.asarray(f) for f in factors], mode))
        assert tuple(got.shape) == (pb.size, pb.dims[mode], RANK)
        np.testing.assert_allclose(got.numpy(), want, **MTTKRP_TOL)


def test_out_of_range_rows_follow_reference():
    """A coordinate past the padded dims: the gather clamps into the
    member's own rows and the scatter drops it, as in the reference."""
    rpb = _reference_batch(BATCH3)
    coords = rpb.coords.copy()
    coords[1, 0] = (15, 20, 7)  # mode 1 past its 16 rows
    coords[2, 3] = (16, 3, 2)   # mode 0 past its 16 rows
    rpb = RPaddedBatch(rpb.dims, rpb.band, coords, rpb.values, rpb.mask, rpb.shapes, rpb.nnz)
    pb = rt.padded_batch_from_reference(rpb)
    rng = np.random.default_rng(2)
    factors = [rng.uniform(-1, 1, size=(pb.size, d, RANK)).astype(np.float32) for d in pb.dims]
    ours = build_batched_kernel("ref", pb, "cpu")
    theirs = ref_build_batched_kernel("ref", rpb)
    for mode in range(3):
        got = ours([torch.from_numpy(f) for f in factors], mode).numpy()
        want = np.asarray(theirs([jnp.asarray(f) for f in factors], mode))
        np.testing.assert_allclose(got, want, **MTTKRP_TOL)


def test_kernel_registry():
    assert batched_kernel_names() == sorted(batched_kernel_names()) == ["alto", "ref"]
    pb = rt.padded_batch_from_reference(_reference_batch(BATCH2))
    with pytest.raises(ValueError, match=r"unknown batched kernel 'csf'; registered"):
        build_batched_kernel("csf", pb, "cpu")


def test_pinv_batched_equals_single_calls():
    """The cutoff is 10·R·eps of each matrix's largest singular value, never
    10·B·eps: a singular value at 1e-5 of the largest lies between the two
    (10·3·eps = 3.6e-6, 10·64·eps = 7.6e-5) and must survive in the stack."""
    rng = np.random.default_rng(3)
    q = np.linalg.qr(rng.standard_normal((64, 3, 3)))[0]
    s = np.array([1.0, 0.3, 1e-5])
    v = torch.from_numpy((q * s[None, None, :]) @ np.swapaxes(q, 1, 2)).to(torch.float32)
    stacked = _pinv(v)
    single = torch.stack([_pinv(m) for m in v])
    torch.testing.assert_close(stacked, single, rtol=1e-6, atol=0.0)
    assert float(stacked.abs().max()) > 1e4  # the 1e-5 direction was inverted, not cut
    batch_cutoff = torch.linalg.pinv(v, rtol=10 * 64 * torch.finfo(torch.float32).eps)
    assert float(batch_cutoff.abs().max()) < 1e2  # the B-sized cutoff would have cut it


# ---------------------------------------------------------------------------
# batched CP-ALS
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["ref", "alto"])
def runs(request):
    """Both packages' cp_als_batched over MIXED with one candidate, diffs on."""
    name = request.param
    ours, theirs = _both(MIXED)
    got = cp_als_batched(ours, RANK, N_ITERS, tune=rt.TunePolicy(candidates=(name,)),
                         track_diff=True, device="cpu")
    want = ref_cp_als_batched(theirs, RANK, N_ITERS, tune=RTunePolicy(candidates=(name,)),
                              track_diff=True)
    return name, ours, got, want


def test_cp_als_batched_matches_reference(runs):
    name, tensors, got, want = runs
    _hold(got, want, diffs=True)
    for t, a, b in zip(tensors, got, want, strict=True):
        assert a.engine == b.engine == f"batched:{name}"
        assert [tuple(f.shape) for f in a.factors] == [(d, RANK) for d in t.shape]  # input order
        assert len(a.fit_history) == len(a.diff_history) == N_ITERS
        assert a.quant_error is None and len(a.iter_times) == N_ITERS


def test_cp_als_batched_follows_port_sequential(runs):
    name, tensors, got, _ = runs
    seq = [rt.cp_als(t, RANK, N_ITERS, engine=name, track_diff=False, device="cpu")
           for t in tensors]
    _hold(got, seq)


def _serve_load(n, seed):
    """benchmarks/serve_bench.py's three families, drawn the same way."""
    rng = np.random.default_rng(seed)
    families = [((12, 10, 8), (40, 70)), ((16, 16, 16), (90, 120)), ((24, 24), (50, 60))]
    out = []
    for i in range(n):
        shape, (lo, hi) = families[i % 3]
        nnz = int(rng.integers(lo, hi))
        coords = np.stack([rng.integers(0, d, size=nnz) for d in shape], axis=1)
        out.append(rt.SparseTensor(coords.astype(np.int32),
                                   rng.uniform(-1, 1, size=nnz).astype(np.float32), shape))
    return [out[i] for i in rng.permutation(n)]


def test_kappa_rule_holds_across_a_serving_load():
    """300 tensors of serve_bench's load at its rank and iterations: every
    member of one batched call follows its sequential `ref` run."""
    tensors = _serve_load(300, seed=0)
    got = cp_als_batched(tensors, 5, 3, tune=rt.TunePolicy(candidates=("ref",)), device="cpu")
    _hold(got, [rt.cp_als(t, 5, 3, engine="ref", track_diff=False, device="cpu")
                for t in tensors])


def test_results_are_copies_and_share_the_bucket_report(runs):
    _, tensors, got, _ = runs
    for r in got:
        assert all(f.untyped_storage().nbytes() == f.numel() * 4 for f in r.factors)
        assert r.lam.untyped_storage().nbytes() == RANK * 4
    by_bucket = {}
    for (dims, band), bucket in bucket_tensors(tensors).items():
        reports = {id(got[i].tune_report) for i in bucket.indices}
        assert len(reports) == 1
        by_bucket[(dims, band)] = reports.pop()
    assert len(set(by_bucket.values())) == len(by_bucket)


def test_no_card_means_no_default_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    ours, _ = _both(BATCH2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cp_als_batched(ours, RANK)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.DecomposeService(RANK)


# ---------------------------------------------------------------------------
# one autotune decision per bucket
# ---------------------------------------------------------------------------

#: Seam timings (ms) per batched kernel and mode: `ref` wins modes 0 and 2.
TIMES_MS = {"ref": (1.0, 3.0, 2.0), "alto": (2.0, 1.5, 2.5)}


def _fake(engine, factors, mode, *, warmup, reps):
    name = "alto" if "_build_alto" in engine.__qualname__ else "ref"
    return TIMES_MS[name][mode] * 1e-3


@pytest.fixture
def seam(monkeypatch):
    monkeypatch.setattr(ttune, "_time_batched", _fake)
    monkeypatch.setattr(rtune, "_time_batched", _fake)


def _tune_both(tmp_path, **policy):
    rpb = _reference_batch(BATCH3)
    pb = rt.padded_batch_from_reference(rpb)
    ours = rt.TunePolicy(store=rt.TuningStore(tmp_path / "port.json"), **policy)
    theirs = RTunePolicy(store=str(tmp_path / "ref.json"), **policy)
    return pb, rpb, ours, theirs


def _decision(report):
    return (report.winners, report.n_probes, report.skipped, report.source,
            sorted(report.timings), report.candidates)


@pytest.mark.parametrize("policy", [{}, {"max_probes": 1}, {"candidates": ("batched:alto",)}],
                         ids=["default", "max_probes=1", "alto-only"])
def test_decisions_match_reference(seam, tmp_path, policy):
    pb, rpb, ours, theirs = _tune_both(tmp_path, **policy)
    _, rep = autotune_bucket(pb, RANK, ours, device="cpu")
    _, rrep = ref_autotune_bucket(rpb, RANK, theirs)
    assert _decision(rep) == _decision(rrep)
    assert rep.timings == rrep.timings


def test_sources_measured_cached_persisted(seam, tmp_path):
    pb, rpb, ours, theirs = _tune_both(tmp_path)
    plans, rplans = BucketPlanCache(), RBucketPlanCache()
    sequence = []
    for _ in range(2):
        sequence.append((_decision(autotune_bucket(pb, RANK, ours, plans=plans, device="cpu")[1]),
                         _decision(ref_autotune_bucket(rpb, RANK, theirs, plans=rplans)[1])))
    fresh = rt.TunePolicy(store=rt.TuningStore(tmp_path / "port.json"))
    sequence.append((_decision(autotune_bucket(pb, RANK, fresh, device="cpu")[1]),
                     _decision(ref_autotune_bucket(rpb, RANK, theirs)[1])))
    for ours_d, theirs_d in sequence:
        assert ours_d == theirs_d
    assert [d[3] for d, _ in sequence] == ["measured", "cached", "persisted"]
    assert [d[1] for d, _ in sequence] == [6, 0, 0]
    assert (plans.hits, plans.misses) == (rplans.hits, rplans.misses) == (1, 1)


def test_unwritable_store_degrades_to_per_process_tuning(seam, tmp_path):
    """A store whose directory cannot be made (its parent is a file): the
    OSError is suppressed in both packages and the decision still stands."""
    (tmp_path / "file").write_text("")
    pb, rpb, _, _ = _tune_both(tmp_path)
    path = str(tmp_path / "file" / "store.json")
    _, rep = autotune_bucket(pb, RANK, rt.TunePolicy(store=path), device="cpu")
    _, rrep = ref_autotune_bucket(rpb, RANK, RTunePolicy(store=path))
    assert _decision(rep) == _decision(rrep)
    assert rep.source == "measured" and rep.store_path == path


def test_tune_spans(seam, tmp_path):
    pb, _, ours, _ = _tune_both(tmp_path)
    with capture() as spans:
        _, rep = autotune_bucket(pb, RANK, ours, device="cpu")
        autotune_bucket(pb, RANK, rt.TunePolicy(store=ours.store), device="cpu")
    probes = [s for s in spans if s.name == "autotune.probe"]
    assert len(probes) == rep.n_probes == 6
    assert {(s.attrs["candidate"], s.attrs["mode"]) for s in probes} == {
        (c, m) for c in ("batched:alto", "batched:ref") for m in range(3)}
    assert [s.attrs["seconds"] for s in probes if s.attrs["candidate"] == "batched:ref"] == [
        t * 1e-3 for t in TIMES_MS["ref"]]
    decisions = [s for s in spans if s.name == "autotune.bucket"]
    assert [(d.attrs["source"], d.attrs["probes"]) for d in decisions] == [
        ("measured", 6), ("persisted", 0)]
    assert decisions[0].attrs["dims"] == list(pb.dims) and decisions[0].attrs["size"] == pb.size


def test_stored_entry_is_keyed_by_the_bucket(seam, tmp_path):
    pb, _, ours, _ = _tune_both(tmp_path)
    autotune_bucket(pb, RANK, ours, device="cpu")
    (entry,) = ours.store.entries()
    assert entry.key.shape == pb.dims and entry.key.nnz == 1 << pb.band
    assert entry.key.candidates == ("batched:alto", "batched:ref")
    assert dict(entry.key.device)["backend"] == "cpu"
    assert entry.format_stats is not None


def test_failing_candidate_is_skipped_on_the_cpu(tmp_path, monkeypatch):
    def broken(pb, device):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")

    monkeypatch.setitem(bkernels._BATCHED_FACTORIES, "alto", broken)
    pb = rt.padded_batch_from_reference(_reference_batch(BATCH2))
    _, rep = autotune_bucket(pb, RANK, device="cpu")
    assert rep.skipped == {"batched:alto": "OutOfMemoryError: CUDA out of memory (injected)"}
    assert set(rep.winners.values()) == {"batched:ref"}
    monkeypatch.setitem(bkernels._BATCHED_FACTORIES, "ref", broken)
    with pytest.raises(RuntimeError, match="every candidate failed"):
        autotune_bucket(pb, RANK, device="cpu")


@pytest.mark.parametrize("exc, device, fault", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), "cuda", True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"), "cuda", True),
    (ValueError("ALTO key needs 70 bits"), "cuda", False),
    (RuntimeError("CUDA error"), "cpu", False),
])
def test_card_faults_raise(exc, device, fault):
    assert _is_card_fault(exc, torch.device(device)) is fault


def test_accuracy_budget_rejected_like_reference():
    ours, theirs = _both(BATCH2[:1])
    with pytest.raises(ValueError) as ref_err:
        ref_cp_als_batched(theirs, RANK, tune=RTunePolicy(accuracy_budget=0.1))
    with pytest.raises(ValueError, match="accuracy_budget does not apply") as err:
        cp_als_batched(ours, RANK, tune=rt.TunePolicy(accuracy_budget=0.1), device="cpu")
    assert str(err.value) == str(ref_err.value)


def test_fresh_process_reports_zero_probes(tmp_path):
    """A cold tune here, then a fresh process on the same store: 0 probes."""
    store = str(tmp_path / "bucket-store.json")
    shape, seeds = (12, 10, 8), range(3)
    ours, _ = _both([_raw(shape, 40, s) for s in seeds])
    cold = cp_als_batched(ours, RANK, 1, tune=rt.TunePolicy(store=store), device="cpu")
    assert (cold[0].tune_report.n_probes, cold[0].tune_report.source) == (6, "measured")
    code = textwrap.dedent(f"""
        import numpy as np
        import repro_torch as rt
        ts = []
        for s in {list(seeds)!r}:
            rng = np.random.default_rng(s)
            coords = np.stack([rng.integers(0, d, size=40)
                               for d in {shape!r}], axis=1).astype(np.int32)
            vals = rng.uniform(-1, 1, size=40).astype(np.float32)
            ts.append(rt.SparseTensor(coords, vals, {shape!r}))
        res = rt.cp_als_batched(ts, {RANK}, n_iters=1, device="cpu",
                                tune=rt.TunePolicy(store={store!r}))
        print("PROBES", res[0].tune_report.n_probes, res[0].tune_report.source)
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300).stdout
    assert "PROBES 0 persisted" in out
