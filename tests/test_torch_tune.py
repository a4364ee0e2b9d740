"""The port's tuning stack against the JAX package on the CPU: `TunePolicy`
and its deprecated shims, the cost model, the tuning store in both
directions, and the store-calibrated prior.

The cost model is held at 1e-12 relative (the same float64 formulas in the
same order), with the port's `kernel` in the reference's `pallas` place and
the reference asked with `interpret=False`; the calibration at 1e-9 relative
(one least-squares solve on the same rows).
"""
import json
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import random_tensor, table1_tensor
from repro.engine import calibrate as rcal
from repro.engine import costmodel as rcost
from repro.engine import persist as rpersist
from repro.engine import tunepolicy as rtp
from repro.formats import FormatStats as RFormatStats
from repro_torch.engine import calibrate as tcal
from repro_torch.engine import costmodel as tcost
from repro_torch.engine import persist as tpersist
from repro_torch.engine import tunepolicy as ttp

REPO = Path(__file__).resolve().parents[1]
COST_RTOL = 1e-12
FIT_RTOL = 1e-9
NELL2 = ((12092, 9184, 28818), 76_879_419)
LBNL = ((1605, 4198, 1631, 4209, 868131), 1_698_825)
#: Every built-in candidate id of the port; `kernel` maps to `pallas`.
CANDIDATES = ["ref", "alto", "csf", "chunked", "kernel", "hetero", "distributed", "fixed",
              "fixed:int3", "fixed:int7", "fixed:int15-12", "user_backend"]


def _ref_name(name: str) -> str:
    return "pallas" if name == "kernel" else name


# ---------------------------------------------------------------------------
# TunePolicy
# ---------------------------------------------------------------------------

def test_policy_fields_and_defaults_equal_reference():
    import dataclasses
    got = [(f.name, f.default) for f in dataclasses.fields(rt.TunePolicy)]
    want = [(f.name, f.default) for f in dataclasses.fields(rtp.TunePolicy)]
    assert got == want
    assert ttp.TUNE_FIELDS == rtp.TUNE_FIELDS
    assert rt.TunePolicy(candidates=["chunked", "ref"]).candidates == ("chunked", "ref")
    with pytest.raises(AttributeError):
        rt.TunePolicy().warmup = 3


@pytest.mark.parametrize("kwargs", [
    dict(max_probes=0), dict(elide_margin=0.5), dict(accuracy_budget=0.0),
    dict(accuracy_budget=-1.0), dict(reps=0), dict(warmup=-1), dict(prior=42),
    dict(prior="analytic")], ids=str)
def test_policy_validation_errors_equal_reference(kwargs):
    with pytest.raises((ValueError, TypeError)) as want:
        rtp.TunePolicy(**kwargs)
    with pytest.raises(want.type) as got:
        rt.TunePolicy(**kwargs)
    assert str(got.value) == str(want.value)


def _resolve(cls, tune, legacy):
    unset = rtp.UNSET if cls is rtp.TunePolicy else ttp.UNSET
    full = {k: legacy.get(k, unset) for k in rtp.TUNE_FIELDS}
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        try:
            out = cls.resolve(tune, caller="f", **full)
        except TypeError as e:
            out = e
    return out, [(w.category, str(w.message)) for w in rec]


@pytest.mark.parametrize(("tune", "legacy"), [
    (None, {}),
    (None, dict(warmup=0, reps=1)),
    (None, dict(store=True, max_probes=2, accuracy_budget=0.1)),
    ("policy", {}),
    ("policy", dict(warmup=0)),
    ("dict", {}),
], ids=["none", "legacy", "legacy3", "policy", "mixed", "not_policy"])
def test_resolve_warnings_and_errors_equal_reference(tune, legacy):
    results = []
    for cls in (rtp.TunePolicy, rt.TunePolicy):
        t = {"policy": cls(reps=3), "dict": {"warmup": 0}, None: None}[tune]
        results.append(_resolve(cls, t, legacy))
    (want, want_warn), (got, got_warn) = results
    assert got_warn == want_warn
    assert len(got_warn) <= 1  # one DeprecationWarning per call at most
    if isinstance(want, Exception):
        assert type(got) is type(want) and str(got) == str(want)
    else:
        import dataclasses
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_split_and_nearest_kwarg_error_equal_reference():
    bags = [dict(warmup=3, store=True, mem_bytes=1024), dict(device="cpu")]
    for bag in bags:
        a, b = dict(bag), dict(bag)
        assert ttp.split_tune_kwargs(a) == rtp.split_tune_kwargs(b) and a == b
    valid = ["max_probes", "capacity", "chunk_shape"]
    for unknown in (["max_prob"], ["capacty", "zzz"]):
        assert (str(ttp.nearest_kwarg_error("f", unknown, valid))
                == str(rtp.nearest_kwarg_error("f", unknown, valid)))


@pytest.fixture(scope="module")
def small():
    return rt.random_tensor((8, 7, 6), nnz=60, seed=0)


def test_entrypoint_shims_warn_once_and_fold(small):
    """The nine keywords on build_engine and cp_als: one DeprecationWarning
    per call naming the caller, folded into the policy."""
    for call, caller in [
            (lambda: rt.build_engine(small, "auto", 4, device="cpu", warmup=0, reps=1), "build_engine"),
            (lambda: rt.cp_als(small, 4, 1, engine="auto", device="cpu", warmup=0, reps=1), "cp_als")]:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            out = call()
        deps = [w for w in rec if issubclass(w.category, DeprecationWarning)]
        assert len(deps) == 1 and caller in str(deps[0].message)
        assert "TunePolicy" in str(deps[0].message)
        report = out.report if caller == "build_engine" else out.tune_report
        assert (report.warmup, report.reps) == (0, 1)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        res = rt.cp_als(small, 4, 1, engine="auto", device="cpu",
                        tune=rt.TunePolicy(warmup=0, reps=1))
    assert res.tune_report.warmup == 0 and res.engine.startswith("auto:")


@pytest.mark.parametrize("case", ["mixed", "not_policy", "typo", "budget_explicit",
                                  "calibrated_no_store", "unknown_candidate"])
def test_entrypoint_errors_equal_reference(small, case):
    from repro.core import cp_als as ref_cp_als
    rst = random_tensor((8, 7, 6), nnz=60, seed=0)
    calls = {
        "mixed": (lambda cp, pol, st, **d: cp(st, 4, 1, engine="auto", tune=pol(), warmup=0, **d)),
        "not_policy": (lambda cp, pol, st, **d: cp(st, 4, 1, engine="auto", tune={"warmup": 0},
                                                    **d)),
        "typo": (lambda cp, pol, st, **d: cp(st, 4, 1, engine="auto", max_probe=2, **d)),
        "budget_explicit": (lambda cp, pol, st, **d: cp(st, 4, 1, engine="chunked",
                                                         tune=pol(accuracy_budget=0.2), **d)),
        "calibrated_no_store": (lambda cp, pol, st, **d: cp(st, 4, 1, engine="auto",
                                                             tune=pol(prior="calibrated"), **d)),
        "unknown_candidate": (lambda cp, pol, st, **d: cp(st, 4, 1, engine="auto",
                                                           tune=pol(candidates=("nope",)), **d)),
    }
    with pytest.raises(Exception) as want:
        calls[case](ref_cp_als, rtp.TunePolicy, rst)
    with pytest.raises(want.type) as got:
        calls[case](rt.cp_als, rt.TunePolicy, small, device="cpu")
    if case == "typo":  # the port's valid set adds device/plans/formats
        assert "did you mean 'max_probes'" in str(got.value)
    elif case == "unknown_candidate":
        assert "unknown engine 'nope'" in str(got.value)
    else:
        assert str(got.value) == str(want.value)
    if case == "budget_explicit":
        with pytest.raises(ValueError, match="accuracy_budget only applies"):
            rt.build_engine(small, "kernel", 4, device="cpu", tune=rt.TunePolicy(accuracy_budget=0.1))
        with pytest.raises(ValueError, match="accuracy_budget only applies"):
            rt.cp_als(small, 4, 1, engine=rt.build_engine(small, "ref", 4, device="cpu"),
                      tune=rt.TunePolicy(accuracy_budget=0.1))


# ---------------------------------------------------------------------------
# Cost model
# ---------------------------------------------------------------------------

def _stats_pair(case):
    """(port stats, reference stats) for one cost-model case."""
    if case in ("nell2_published", "lbnl_published"):
        shape, nnz = NELL2 if case == "nell2_published" else LBNL
        return (tcost.WorkloadStats(shape=shape, nnz=nnz),
                rcost.WorkloadStats(shape=shape, nnz=nnz))
    name, _ = case.rsplit("_", 1)
    st, rst = rt.table1_tensor(name), table1_tensor(name)
    fs, rfs = rt.FormatStats.from_tensor(st), RFormatStats.from_tensor(rst)
    assert fs.to_json() == rfs.to_json()
    return (tcost.WorkloadStats(shape=st.shape, nnz=st.nnz, format_stats=fs),
            rcost.WorkloadStats(shape=rst.shape, nnz=rst.nnz, format_stats=rfs))


COST_CASES = ["nell2_published", "lbnl_published", "nell2_measured", "lbnl_measured",
              "delicious_measured", "5d_large_measured"]


@pytest.mark.parametrize("case", COST_CASES)
def test_cost_model_equals_reference(case):
    stats, rstats = _stats_pair(case)
    priors = [(tcost.default_prior, rcost.default_prior),
              (tcost.CostModelPrior(bandwidth=3.1e12, chunk_padding=1.7, hetero_overhead=1.3,
                                    narrow_bandwidth=9e11, indexed_bandwidth=4e11,
                                    dispatch_overheads={"kernel": 2e-5, "csf": 3e-4}),
               rcost.CostModelPrior(bandwidth=3.1e12, chunk_padding=1.7, hetero_overhead=1.3,
                                    narrow_bandwidth=9e11, indexed_bandwidth=4e11,
                                    dispatch_overheads={"pallas": 2e-5, "csf": 3e-4}))]
    for rank in (1, 10):
        for mode in range(len(stats.shape)):
            for name in CANDIDATES:
                got = tcost.byte_terms(name, stats, rank, mode)
                want = rcost.byte_terms(_ref_name(name), rstats, rank, mode)
                np.testing.assert_allclose(got, want, rtol=COST_RTOL, atol=0)
                for nd in (1, 4):
                    got = tcost.device_byte_terms(name, stats, rank, mode, n_devices=nd)
                    want = rcost.device_byte_terms(_ref_name(name), rstats, rank, mode,
                                                   n_devices=nd)
                    np.testing.assert_allclose(got, want, rtol=COST_RTOL, atol=0)
                    for prior, rprior in priors:
                        got = prior.seconds(name, stats, rank, mode, n_devices=nd)
                        want = rprior.seconds(_ref_name(name), rstats, rank, mode,
                                              interpret=False, n_devices=nd)
                        assert got == pytest.approx(want, rel=COST_RTOL, abs=0)
        for prior, rprior in priors:
            for modes in (None, [0], [1, 2]):
                got = prior.order(stats, rank, list(CANDIDATES), modes)
                want = rprior.order(rstats, rank, [_ref_name(n) for n in CANDIDATES], modes,
                                    interpret=False)
                assert [_ref_name(n) for n in got] == want
    assert (tcost.prior_order(stats, 10, CANDIDATES[:6])
            == [n.replace("pallas", "kernel")
                for n in rcost.prior_order(rstats, 10, [_ref_name(n) for n in CANDIDATES[:6]],
                                           interpret=False)])


def test_cost_model_has_no_interpret_artifacts():
    import dataclasses
    assert "interpret_penalty" not in {f.name for f in dataclasses.fields(tcost.CostModelPrior)}
    with pytest.raises(TypeError):
        tcost.default_prior.seconds("kernel", tcost.WorkloadStats((4, 4), 4), 2, 0,
                                    interpret=True)
    # the byte model puts kernel with chunked: only a dispatch term parts them
    stats = tcost.WorkloadStats(*NELL2)
    assert (tcost.byte_terms("kernel", stats, 10, 0) == tcost.byte_terms("chunked", stats, 10, 0))


def test_analytic_order_at_nell2_size():
    """The analytic prior's order at NELL-2's published size (R = 10): the
    ranking the chip run holds against the measured one."""
    stats = tcost.WorkloadStats(*NELL2)
    order = tcost.prior_order(stats, 10, ["ref", "alto", "csf", "chunked", "kernel", "hetero"])
    assert order == ["alto", "csf", "chunked", "kernel", "ref", "hetero"]


# ---------------------------------------------------------------------------
# Tuning store
# ---------------------------------------------------------------------------

def _entry_args(shape, nnz):
    winners = {m: "alto" if m % 2 else "chunked" for m in range(len(shape))}
    timings = {"alto": {m: 1e-3 * (m + 1) for m in range(len(shape))},
               "chunked": {m: 2e-3 / (m + 1) for m in range(len(shape))}}
    errors = {"fixed:int7": {0: 0.0123}}
    fs = {"shape": list(shape), "nnz": nnz, "fiber_counts": [nnz] * len(shape),
          "key_bits": 20, "key_words": 1}
    return winners, timings, dict(overall="alto", warmup=1, reps=3, budget=0.05, errors=errors,
                                  format_stats=fs, save=True)


def _fill(store_cls, key_fn, path):
    store = store_cls(path)
    for i, (shape, nnz) in enumerate([((20, 16, 24), 400), ((40, 32, 12), 900)]):
        st = random_tensor(shape, nnz, seed=i)
        winners, timings, kw = _entry_args(shape, nnz)
        store.record(key_fn(st, i), winners, timings, **kw)
    return store


def _payload(path):
    return json.loads(Path(path).read_text())


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_store_loads_in_the_other_package(tmp_path, direction):
    path = tmp_path / "autotune.json"
    if direction == "reference_to_port":
        _fill(rpersist.TuningStore,
              lambda st, i: rpersist.WorkloadKey.from_tensor(st, 4, ["alto", "chunked"],
                                                             capacity=64 if i else None), path)
        reader_cls, writer = tpersist.TuningStore, "reference"
    else:
        _fill(tpersist.TuningStore,
              lambda st, i: tpersist.WorkloadKey.from_tensor(st, 4, ["alto", "chunked"],
                                                             capacity=64 if i else None,
                                                             device="cpu"), path)
        reader_cls, writer = rpersist.TuningStore, "port"
    written = _payload(path)
    assert written["version"] == 5 and len(written["entries"]) == 2
    reader = reader_cls(path)
    assert len(reader) == 2
    assert [e.to_json() for e in reader.entries()] == written["entries"]
    for e in reader.entries():
        assert reader.lookup(e.key) is e  # exact round trip of the key
        assert e.budget == 0.05 and e.errors == {"fixed:int7": {0: 0.0123}}
    # the reader writes schema v5 back, entry for entry
    reader.save()
    assert _payload(path) == written
    fp = dict(reader.entries()[0].key.device)
    assert ("jax" in fp) == (writer == "reference") and ("torch" in fp) == (writer == "port")


def test_entries_never_match_across_packages_or_devices(tmp_path, monkeypatch):
    st = random_tensor((20, 16, 24), 400, seed=1)
    cands = ["alto", "chunked", "ref"]
    ref_key = rpersist.WorkloadKey.from_tensor(st, 4, cands)
    cpu_key = tpersist.WorkloadKey.from_tensor(st, 4, cands, device="cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    cuda_fp = tpersist.device_fingerprint("cuda:0")
    assert cuda_fp["backend"] == "cuda" and cuda_fp["device_kind"] == "NVIDIA H100 80GB HBM3"
    assert set(cuda_fp) == {"backend", "device_count", "device_kind", "torch", "cuda"}
    cuda_key = tpersist.WorkloadKey.from_tensor(st, 4, cands, device="cuda:0")
    keys = [ref_key, cpu_key, cuda_key]
    assert len({k.device for k in keys}) == 3
    assert len({tpersist.device_fingerprint_id(dict(k.device)) for k in keys}) == 3
    path = tmp_path / "mixed.json"
    rstore = rpersist.TuningStore(path)
    rstore.record(ref_key, {0: "ref"}, {"ref": {0: 1.0}})
    tstore = tpersist.TuningStore(path)
    tstore.record(cpu_key, {0: "alto"}, {"alto": {0: 2.0}})
    tstore.record(cuda_key, {0: "chunked"}, {"chunked": {0: 3.0}})
    for store in (tpersist.TuningStore(path), rpersist.TuningStore(path)):
        assert len(store) == 3  # none supersedes another
        assert [store.lookup(k).winners[0] for k in keys] == ["ref", "alto", "chunked"]
        assert [len(store.observations(device=dict(k.device))) for k in keys] == [1, 1, 1]


def test_fingerprint_of_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpersist.device_fingerprint()
    fp = tpersist.device_fingerprint("cpu")
    assert fp["backend"] == "cpu" and fp["device_kind"] == "cpu" and fp["device_count"] == "1"


def _both_keys(shape, nnz, seed=1, cands=("alto", "chunked", "ref")):
    st = random_tensor(shape, nnz, seed=seed)
    return (tpersist.WorkloadKey.from_tensor(st, 4, cands, device="cpu"),
            rpersist.WorkloadKey.from_tensor(st, 4, cands))


def _shift(mod, key, nnz):
    import dataclasses
    return dataclasses.replace(key, nnz=nnz, density=nnz / np.prod(key.shape))


@pytest.mark.parametrize("nnz_tol", [0.1, 0.0])
def test_near_match_equals_reference(tmp_path, nnz_tol):
    keys = _both_keys((30, 24, 36), 1000)
    hits = []
    for mod, key in zip((tpersist, rpersist), keys, strict=True):
        store = mod.TuningStore(tmp_path / f"{mod.__name__}.json", nnz_tol=nnz_tol)
        store.record(key, {0: "alto"}, {"alto": {0: 1.0}})
        store.record(_shift(mod, key, 1500), {0: "ref"}, {"ref": {0: 1.0}})
        row = []
        for nnz in (1000, 1040, 1090, 1200, 1450, 1500):
            e = mod.TuningStore(store.path, nnz_tol=nnz_tol).lookup(_shift(mod, key, nnz))
            row.append(None if e is None else e.winners[0])
        # a near re-record supersedes its neighbour, only under a nonzero tolerance
        store.record(_shift(mod, key, 1050), {0: "csf"}, {"csf": {0: 1.0}})
        row.append(len(mod.TuningStore(store.path, nnz_tol=nnz_tol)))
        hits.append(row)
    assert hits[0] == hits[1]
    assert hits[0][:6] == (["alto", "alto", "alto", None, "ref", "ref"] if nnz_tol
                           else ["alto", None, None, None, None, "ref"])


def test_ttl_equals_reference(tmp_path, monkeypatch):
    keys = _both_keys((20, 16, 24), 400)
    seen = []
    for mod, key in zip((tpersist, rpersist), keys, strict=True):
        path = tmp_path / f"{mod.__name__}.json"
        mod.TuningStore(path).record(key, {0: "alto"}, {"alto": {0: 1.0}})
        row = []
        for ttl in (None, 3600.0, 0.0, -1.0):
            store = mod.TuningStore(path, ttl_s=ttl)
            store.entries()[0].created = time.time() - 7200
            row.append((store.lookup(key) is not None, len(store.observations()),
                        len(store.observations(include_expired=True))))
        monkeypatch.setenv("REPRO_AUTOTUNE_TTL", "10")
        env_store = mod.TuningStore(path)
        env_store.entries()[0].created = time.time() - 100
        row.append((env_store.ttl_s, env_store.lookup(key) is None))
        monkeypatch.delenv("REPRO_AUTOTUNE_TTL")
        seen.append(row)
    assert seen[0] == seen[1]
    assert seen[0][1][0] is False and seen[0][0][0] is True


def test_budget_coverage_equals_reference(tmp_path):
    grid = [None, 1e-3, 1e-2, 5e-2]
    for stored in grid:
        for requested in grid:
            assert (tpersist.budget_covers(stored, requested)
                    == rpersist.budget_covers(stored, requested))
    keys = _both_keys((20, 16, 24), 400)
    seen = []
    for mod, key in zip((tpersist, rpersist), keys, strict=True):
        store = mod.TuningStore(tmp_path / f"{mod.__name__}.json")
        store.record(key, {0: "fixed:int15-12"}, {"fixed:int15-12": {0: 1.0}}, budget=1e-2,
                     errors={"fixed:int15-12": {0: 1e-4}})
        seen.append([store.lookup(key, budget=b) is not None for b in grid])
    assert seen[0] == seen[1] == [False, False, True, True]


_WRITER = """
import sys, time
sys.path.insert(0, {src!r})
from repro_torch.engine.persist import TuningStore, WorkloadKey
real = TuningStore._read_disk
def slow(self):
    entries = real(self)
    time.sleep(0.05)
    return entries
TuningStore._read_disk = slow
store = TuningStore({path!r})
for i in range({n}):
    key = WorkloadKey(shape=(10 + {w} * 100 + i, 8, 6), nnz=50, density=0.1, ndim=3,
                      rank=4, candidates=("ref",), device=(("backend", "cpu"),))
    store.record(key, {{0: "ref"}}, {{"ref": {{0: 1.0}}}}, save=False)
    store.save()
"""


def test_flock_merge_of_two_writer_processes(tmp_path):
    """Two processes record into one store at once, each read→write window
    widened: the advisory lock serializes the cycles, so no entry is lost
    (the reference's racing-writers test, with processes)."""
    path = tmp_path / "autotune.json"
    n = 4
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _WRITER.format(
        src=str(REPO / "src"), path=str(path), n=n, w=w)], env=env) for w in range(2)]
    assert [p.wait(timeout=120) for p in procs] == [0, 0]
    for store_cls in (tpersist.TuningStore, rpersist.TuningStore):
        assert len(store_cls(path)) == 2 * n


def test_forget_and_resolve_store(tmp_path, monkeypatch):
    key, _ = _both_keys((20, 16, 24), 400)
    store = tpersist.TuningStore(tmp_path / "s.json")
    store.record(key, {0: "ref"}, {"ref": {0: 1.0}})
    assert store.forget(key) and not store.forget(key)
    assert len(tpersist.TuningStore(store.path)) == 0
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "env.json"))
    assert tpersist.resolve_store(True).path == str(tmp_path / "env.json")
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE")
    assert tpersist.TuningStore().path == os.path.join(
        os.path.expanduser("~"), ".cache", "repro", "autotune.json")
    assert tpersist.resolve_store(None) is None and tpersist.resolve_store(False) is None
    assert tpersist.resolve_store(store) is store
    assert tpersist.resolve_store(str(tmp_path / "p.json")).path == str(tmp_path / "p.json")


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------

CAL_CANDS = ["alto", "chunked", "csf", "hetero", "ref", "fixed:int7", "fixed:int3"]
CAL_WORKLOADS = [((30, 24, 36), 700), ((120, 80, 60), 9000), ((400, 300, 200), 60000),
                 ((50, 40, 30, 20), 5000), ((1000, 900, 800), 200000)]


def _synth(mod_persist, mod_cost, path, device, cands=CAL_CANDS, kernel_rows=False):
    """A store whose timings come from one ground-truth prior with a fixed
    multiplicative noise, keyed with `device`."""
    gt = mod_cost.CostModelPrior(bandwidth=8e11, chunk_padding=1.6, hetero_overhead=1.4,
                                 narrow_bandwidth=5e11, indexed_bandwidth=2e11,
                                 dispatch_overheads={"ref": 3e-5, "alto": 9e-5, "csf": 2e-4,
                                                     "chunked": 4e-5, "hetero": 6e-5,
                                                     "fixed": 5e-5})
    rng = np.random.default_rng(7)
    store = mod_persist.TuningStore(path)
    for shape, nnz in CAL_WORKLOADS:
        key = mod_persist.WorkloadKey(
            shape=shape, nnz=nnz, density=nnz / float(np.prod(shape)), ndim=len(shape), rank=8,
            candidates=tuple(sorted(cands)), device=tuple(sorted(device.items())))
        stats = mod_cost.WorkloadStats.from_key(key)
        names = list(cands) + (["kernel"] if kernel_rows else [])
        timings = {}
        for b in names:
            noise = 1.0 + 0.1 * rng.standard_normal(len(shape))
            timings[b] = {m: gt.seconds(b if b != "kernel" else "chunked", stats, 8, m)
                          * (0.3 if b == "kernel" else 1.0) * float(noise[m])
                          for m in range(len(shape))}
        winners = {m: min(timings, key=lambda b, m=m: timings[b][m]) for m in range(len(shape))}
        store.record(key, winners, timings)
    return store


def test_calibration_equals_reference(tmp_path):
    tdev, rdev = tpersist.device_fingerprint("cpu"), rpersist.device_fingerprint()
    tstore = _synth(tpersist, tcost, tmp_path / "t.json", tdev)
    rstore = _synth(rpersist, rcost, tmp_path / "r.json", rdev)
    got = tcal.CalibratedPrior.from_store(tstore, device=tdev, use_cache=False)
    want = rcal.CalibratedPrior.from_store(rstore, device=rdev, use_cache=False)
    g, w = got.calibration, want.calibration
    assert (g.n_observations, g.n_workloads, g.backends, g.fallbacks) == (
        w.n_observations, w.n_workloads, w.backends, w.fallbacks)
    assert g.fitted.keys() == w.fitted.keys()
    for k in w.fitted:
        assert g.fitted[k] == pytest.approx(w.fitted[k], rel=FIT_RTOL), k
    for a, b in [(g.mean_rel_err, w.mean_rel_err), (g.max_rel_err, w.max_rel_err),
                 (g.rmse_s, w.rmse_s), (got.suggested_margin, want.suggested_margin)]:
        assert a == pytest.approx(b, rel=FIT_RTOL)
    assert g.per_backend_rel_err == pytest.approx(w.per_backend_rel_err, rel=FIT_RTOL)
    assert got.used_fit == want.used_fit
    assert g.summary().splitlines()[0] == w.summary().splitlines()[0]
    for prior, rprior in [(got, want), (tcost.default_prior, rcost.default_prior)]:
        assert (tcal.ranking_accuracy(tstore, prior, device=tdev)
                == rcal.ranking_accuracy(rstore, rprior, device=rdev))
    # the same synthetic rows under another fingerprint are invisible
    assert tcal.ranking_accuracy(tstore, got, device=rdev) == (0, 0)
    with pytest.raises(tcal.CalibrationError):
        tcal.CalibratedPrior.from_store(tstore, device=rdev, use_cache=False)
    assert tcal.MIN_OBSERVATIONS == rcal.MIN_OBSERVATIONS
    # _nnls is the reference's
    a = np.random.default_rng(1).normal(size=(20, 6))
    b = np.random.default_rng(2).normal(size=20)
    np.testing.assert_allclose(tcal._nnls(a, b), rcal._nnls(a, b), rtol=FIT_RTOL)


def test_kernel_rows_enter_the_fit(tmp_path):
    """The port's `kernel` timings are real card timings and enter the fit,
    where the reference drops its interpret-mode `pallas` rows."""
    dev = tpersist.device_fingerprint("cpu")
    without = tcal.CalibratedPrior.from_store(
        _synth(tpersist, tcost, tmp_path / "a.json", dev), device=dev, use_cache=False)
    with_k = tcal.CalibratedPrior.from_store(
        _synth(tpersist, tcost, tmp_path / "b.json", dev, kernel_rows=True), device=dev,
        use_cache=False)
    assert "kernel" in with_k.calibration.backends and "kernel" not in without.calibration.backends
    n_modes = sum(len(s) for s, _ in CAL_WORKLOADS)
    assert with_k.calibration.n_observations == without.calibration.n_observations + n_modes
    assert with_k.calibration.fitted != without.calibration.fitted
    assert "dispatch[kernel]" in with_k.calibration.fitted or any(
        "dispatch[kernel]" in f for f in with_k.calibration.fallbacks)
    # batched rows stay out, as in the reference
    store = tpersist.TuningStore(tmp_path / "b.json")
    for e in store.entries():
        e.timings["batched"] = {0: 1.0}
    again = tcal.CalibratedPrior.from_store(store, device=dev, use_cache=False)
    assert "batched" not in again.calibration.backends


def test_format_stats_reuse_built_trees(monkeypatch):
    """FormatCache.format_stats takes a cached CSF tree's fiber count in
    place of recounting, with the same numbers as `FormatStats.from_tensor`
    and the reference's."""
    from repro_torch.formats import convert
    st = rt.table1_tensor("delicious")
    cache = rt.FormatCache()
    for m in range(st.ndim - 1):
        cache.csf(st, m)
    calls = []
    real = convert.fiber_count
    monkeypatch.setattr(convert, "fiber_count", lambda s, m: calls.append(m) or real(s, m))
    got = cache.format_stats(st)
    assert calls == [st.ndim - 1]  # only the mode without a tree is counted
    assert got.to_json() == rt.FormatStats.from_tensor(st).to_json()
    assert got.to_json() == RFormatStats.from_tensor(table1_tensor("delicious")).to_json()
    assert cache.format_stats(st) is got
