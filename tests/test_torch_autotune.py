"""The port's autotuner against the JAX package on the CPU.

Decisions: both packages' timing seam (`autotune._time_backend`) is
replaced by the same deterministic per-(candidate, mode) timings, so the
tuners see the same measurements; their winners, probe and elision counts,
skipped candidates, prior order, stored `overall` and anchored predictions
(1e-9 relative) must then be the reference's.  The builds stay real.

Error probes, `cp_als` through the tuner and the spans are held against the
reference on real CPU runs: errors within 1e-5, fit within 1e-6 (float) and
quant_error within 1e-5.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import cp_als as ref_cp_als
from repro.core import random_tensor, table1_tensor
from repro.engine import PlanCache as RPlanCache
from repro.engine import TunePolicy as RTunePolicy
from repro.engine import TuningStore as RTuningStore
from repro.engine import WorkloadKey as RWorkloadKey
from repro.engine import autotune as rauto
from repro.engine import build_engine as ref_build_engine
from repro.engine import costmodel as rcost
from repro.engine import device_fingerprint as ref_fingerprint
from repro.obs import capture as ref_capture
from repro_torch.engine import WorkloadKey, autotune, costmodel, device_fingerprint
from repro_torch.engine import registry as tregistry
from repro_torch.obs import capture
from repro_torch.obs import metrics as obs_metrics

KW = dict(chunk_shape=(8, 8, 8), capacity=64)
SHAPE, NNZ = (30, 24, 36), 700
PRED_RTOL = 1e-9
#: Seam timings (ms) per candidate and mode: every mode has a different
#: winner, and the fixed presets are fastest where the budget lets them in.
TIMES_MS = {
    "alto": (3.0, 5.0, 4.0), "chunked": (2.0, 6.0, 7.0), "csf": (4.0, 4.5, 4.4),
    "hetero": (5.0, 1.0, 6.0), "ref": (6.0, 7.0, 2.5), "kernel": (1.5, 1.5, 1.5),
    "fixed:int3": (0.5, 0.5, 0.5), "fixed:int7": (0.8, 0.8, 0.8),
    "fixed:int15-12": (0.9, 0.9, 0.9),
}


def _fake(name, engine, factors, mode, *, warmup, reps):
    return TIMES_MS[name][mode % 3] * 1e-3


@pytest.fixture
def seam(monkeypatch):
    monkeypatch.setattr(autotune, "_time_backend", _fake)
    monkeypatch.setattr(rauto, "_time_backend", _fake)


def _gt_store(path, store_cls, key_cls, device):
    """Twelve-plus observations for calibration: three workloads, timed by
    a ground-truth prior, keyed with `device`."""
    gt = rcost.CostModelPrior(bandwidth=5e9, chunk_padding=1.5, hetero_overhead=1.5,
                              dispatch_overheads={"ref": 2e-4, "alto": 1e-4, "csf": 3e-4,
                                                  "chunked": 5e-5, "hetero": 8e-5})
    store = store_cls(path)
    cands = ("alto", "chunked", "csf", "hetero", "ref")
    for shape, nnz in [((20, 16, 24), 400), ((40, 32, 12), 900), ((60, 50, 40), 3000)]:
        key = key_cls(shape=shape, nnz=nnz, density=nnz / float(np.prod(shape)), ndim=3,
                      rank=4, candidates=cands, device=tuple(sorted(device.items())))
        stats = rcost.WorkloadStats.from_key(key)
        timings = {b: {m: gt.seconds(b, stats, 4, m) for m in range(3)} for b in cands}
        store.record(key, {m: min(cands, key=lambda b, m=m: timings[b][m]) for m in range(3)},
                     timings)
    return store


def _tune_both(tmp_path, case):
    """The same tune in both packages; returns (port engine, reference
    engine, port store, reference store)."""
    st = rt.random_tensor(SHAPE, NNZ, seed=2)
    rst = random_tensor(SHAPE, NNZ, seed=2)
    pol, modes, stores = {}, None, (None, None)
    if case in ("modes", "warm", "stale", "calibrated"):
        stores = (rt.TuningStore(tmp_path / "port.json"), RTuningStore(tmp_path / "ref.json"))
    if case == "max_probes":
        pol = dict(max_probes=2)
    elif case == "elide":
        pol = dict(elide=True, elide_margin=1.5)
    elif case == "modes":
        modes = [1]
    elif case == "budget":
        pol = dict(accuracy_budget=0.05)
    elif case == "calibrated":
        stores = (_gt_store(tmp_path / "port.json", rt.TuningStore, WorkloadKey,
                            device_fingerprint("cpu")),
                  _gt_store(tmp_path / "ref.json", RTuningStore, RWorkloadKey, ref_fingerprint()))
        pol = dict(prior="calibrated")
    elif case == "stale":
        cands = ["alto", "chunked", "csf", "hetero", "ref"]
        for store, key in zip(stores, (WorkloadKey.from_tensor(st, 4, cands, device="cpu"),
                                       RWorkloadKey.from_tensor(rst, 4, cands)), strict=True):
            store.record(key, {0: "gone_backend", 1: "ref", 2: "ref"},
                         {"gone_backend": {0: 1.0}, "ref": {0: 2.0, 1: 2.0, 2: 2.0}})
    if case == "warm":  # the cold run that fills both stores
        rt.build_engine(st, "auto", 4, device="cpu", plans=rt.PlanCache(),
                        tune=rt.TunePolicy(store=stores[0]), **KW)
        ref_build_engine(rst, "auto", 4, plans=RPlanCache(),
                         tune=RTunePolicy(store=stores[1]), **KW)
    got = rt.build_engine(st, "auto", 4, device="cpu", plans=rt.PlanCache(),
                          formats=rt.FormatCache(), autotune_modes=modes,
                          tune=rt.TunePolicy(store=stores[0], **pol), **KW)
    want = ref_build_engine(rst, "auto", 4, plans=RPlanCache(), autotune_modes=modes,
                            tune=RTunePolicy(store=stores[1], **pol), **KW)
    return got, want, stores


def _assert_same_decision(got, want):
    g, w = got.report, want.report
    assert got.name == want.name
    assert g.winners == w.winners
    assert (g.n_probes, g.n_elided, g.source) == (w.n_probes, w.n_elided, w.source)
    assert set(g.skipped) == set(w.skipped)
    assert g.prior_order == w.prior_order
    assert (g.prior_name or "").split(" ")[0] == (w.prior_name or "").split(" ")[0]
    assert g.timings == w.timings
    assert g.candidates == w.candidates
    assert g.probe_breakdown() == w.probe_breakdown()
    assert g.chosen == w.chosen
    assert g.predicted.keys() == w.predicted.keys()
    for name, per in w.predicted.items():
        assert g.predicted[name].keys() == per.keys()
        for m, t in per.items():
            assert g.predicted[name][m] == pytest.approx(t, rel=PRED_RTOL)
    assert g.errors.keys() == w.errors.keys()


@pytest.mark.parametrize("case", ["default", "max_probes", "elide", "calibrated", "modes",
                                  "warm", "stale", "budget"])
def test_decisions_equal_reference(tmp_path, seam, case):
    got, want, (store, rstore) = _tune_both(tmp_path, case)
    _assert_same_decision(got, want)
    rep = got.report
    if case == "default":
        # on a CPU context `kernel` is the plain chunked op again: not probed
        assert rep.candidates == ["alto", "chunked", "csf", "hetero", "ref"]
        assert rep.n_probes == 15 and rep.winners == {0: "chunked", 1: "hetero", 2: "ref"}
    if case == "max_probes":
        assert all("pruned by cost-model prior" in why for why in rep.skipped.values())
    if case in ("elide", "calibrated"):
        assert rep.n_elided > 0 and rep.predicted
    if case == "calibrated":
        assert rep.prior_name == "calibrated"
    if case == "warm":
        assert (rep.source, rep.n_probes) == ("persisted", 0)
    if case == "stale":
        assert rep.source == "measured" and rep.n_probes > 0
    if case == "budget":
        assert [c for c in rep.candidates if ":" in c] == [
            "fixed:int3", "fixed:int7", "fixed:int15-12"]
        for name, per in want.report.errors.items():
            for m, e in per.items():
                assert got.report.errors[name][m] == pytest.approx(e, rel=0, abs=1e-5)
    if store is not None:
        entries = store.entries()
        rentries = rstore.entries()
        mine = [e for e in entries if e.key.shape == SHAPE]
        theirs = [e for e in rentries if e.key.shape == SHAPE]
        assert [(e.winners, e.overall, e.timings, e.budget) for e in mine] == [
            (e.winners, e.overall, e.timings, e.budget) for e in theirs]
        if case == "modes":
            assert mine[0].overall is not None and set(mine[0].winners) == {1}
    # every dispatched winner serves its mode with the reference's MTTKRP
    factors = rt.init_factors(SHAPE, 4, seed=3, device="cpu")
    coords = torch.from_numpy(rt.random_tensor(SHAPE, NNZ, seed=2).coords)
    values = torch.from_numpy(rt.random_tensor(SHAPE, NNZ, seed=2).values)
    for mode in range(3):
        want_out = rt.mttkrp_coo(factors, coords, values, mode=mode, out_dim=SHAPE[mode])
        tol = 1e-1 if ":" in rep.winners.get(mode, rep.chosen) else 1e-4
        np.testing.assert_allclose(got(factors, mode).numpy(), want_out.numpy(), rtol=tol,
                                   atol=tol)


def test_warm_hit_with_restricted_modes_serves_every_mode(tmp_path, seam):
    st = rt.random_tensor(SHAPE, NNZ, seed=6)
    store = rt.TuningStore(tmp_path / "s.json")
    rt.build_engine(st, "auto", 4, device="cpu", plans=rt.PlanCache(),
                    tune=rt.TunePolicy(store=store), **KW)
    warm = rt.build_engine(st, "auto", 4, device="cpu", plans=rt.PlanCache(),
                           autotune_modes=[0], tune=rt.TunePolicy(store=store), **KW)
    assert warm.report.source == "persisted"
    factors = rt.init_factors(SHAPE, 4, device="cpu")
    for mode in range(3):
        assert tuple(warm(factors, mode).shape) == (SHAPE[mode], 4)
    tuned = rt.build_engine(st, "auto", 4, device="cpu", plans=rt.PlanCache(),
                            tune=rt.TunePolicy(candidates=("ref",)), **KW)
    assert tuned.report.winners == {0: "ref", 1: "ref", 2: "ref"}
    with pytest.raises(ValueError, match="no backend for mode 5"):
        tuned(factors, 5)


def test_kernel_error_raises_other_failures_skip(monkeypatch, seam):
    """A candidate whose kernel cannot be built raises out of the tuner; any
    other failure is skipped and recorded, as in the reference."""
    def kernel_broken(ctx):
        raise rt.KernelError("nvcc failed on csrc/mttkrp.cu")

    def other_broken(ctx):
        raise RuntimeError("this backend is broken")

    monkeypatch.setitem(tregistry._REGISTRY, "broken_kernel",
                        tregistry.BackendSpec("broken_kernel", kernel_broken))
    monkeypatch.setitem(tregistry._REGISTRY, "broken_other",
                        tregistry.BackendSpec("broken_other", other_broken))
    monkeypatch.setitem(TIMES_MS, "broken_kernel", (1.0, 1.0, 1.0))
    monkeypatch.setitem(TIMES_MS, "broken_other", (1.0, 1.0, 1.0))
    st = rt.random_tensor(SHAPE, NNZ, seed=2)
    eng = rt.build_engine(st, "auto", 4, device="cpu", **KW,
                          tune=rt.TunePolicy(candidates=("ref", "broken_other")))
    assert "broken_other" in eng.report.skipped and eng.report.winners == {0: "ref", 1: "ref",
                                                                            2: "ref"}
    with pytest.raises(rt.KernelError, match="nvcc failed"):
        rt.build_engine(st, "auto", 4, device="cpu", **KW,
                        tune=rt.TunePolicy(candidates=("ref", "broken_kernel")))
    # a persisted winner that no longer builds for a kernel fault raises too
    key = WorkloadKey.from_tensor(st, 4, ["broken_kernel", "ref"], device="cpu")

    class Store(rt.TuningStore):
        def save(self):
            pass

    store = Store("unused.json")
    store._entries = []
    store.record(key, {0: "broken_kernel", 1: "ref", 2: "ref"}, {"ref": {0: 1.0}}, save=False)
    with pytest.raises(rt.KernelError):
        rt.build_engine(st, "auto", 4, device="cpu", **KW,
                        tune=rt.TunePolicy(candidates=("ref", "broken_kernel"), store=store))


@pytest.mark.parametrize("device,name,exc,fault", [
    ("cuda", "kernel", ValueError, True),
    ("cuda", "hetero", torch.cuda.OutOfMemoryError, True),
    ("cuda", "fixed:int7", TypeError, True),
    ("cuda", "ref", ValueError, False),
    ("cuda", "csf", RuntimeError, False),
    ("cuda", "unregistered", ValueError, False),
    ("cpu", "kernel", ValueError, False),
    ("cpu", "ref", rt.KernelError, True),
])
def test_kernel_candidate_failures_on_cuda_are_faults(device, name, exc, fault):
    """On a CUDA context any failure of a candidate that launches a
    hand-written kernel raises out of the tuner; a plain backend's failure,
    or a kernel backend's on the CPU (where it runs its plain version), is
    skipped as in the reference, and a KernelError raises everywhere."""
    ctx = type("Ctx", (), {"device": torch.device(device)})()
    assert autotune._is_fault(exc("x"), name, ctx) is fault


def test_kernel_candidate_on_cpu_only_when_asked(seam):
    st = rt.random_tensor(SHAPE, NNZ, seed=2)
    assert "kernel" in rt.eligible_backends(lossless_only=True)
    # One rank: every single-device lossless backend; `distributed` needs 2.
    assert rt.eligible_backends(lossless_only=True) == sorted(
        set(tregistry.registered_backends()) - {"fixed", "distributed"})
    assert rt.engine.preset_candidates() == ["fixed:int3", "fixed:int7", "fixed:int15-12"]
    eng = rt.build_engine(st, "auto", 4, device="cpu", **KW,
                          tune=rt.TunePolicy(candidates=("chunked", "kernel")))
    assert eng.report.winners == {0: "kernel", 1: "kernel", 2: "kernel"}


def test_error_probes_equal_reference():
    """The measured errors of the fixed presets on TABLE1 nell2, by the
    reference's exact-subset method, within 1e-5 of the reference's."""
    cands = ("fixed:int7", "fixed:int15-12")
    got = rt.build_engine(rt.table1_tensor("nell2"), "auto", 10, device="cpu",
                          tune=rt.TunePolicy(candidates=cands, accuracy_budget=10.0, warmup=0,
                                             reps=1)).report
    want = ref_build_engine(table1_tensor("nell2"), "auto", 10,
                            tune=RTunePolicy(candidates=cands, accuracy_budget=10.0, warmup=0,
                                             reps=1)).report
    assert got.errors.keys() == want.errors.keys() == set(cands)
    for name in cands:
        assert got.errors[name].keys() == want.errors[name].keys() == {0, 1, 2}
        for m, e in want.errors[name].items():
            assert got.errors[name][m] == pytest.approx(e, rel=0, abs=1e-5)
    # and a budget between the two presets rejects int7, as the reference does
    tight = rt.build_engine(rt.table1_tensor("nell2"), "auto", 10, device="cpu",
                            tune=rt.TunePolicy(candidates=cands, accuracy_budget=2e-2, warmup=0,
                                               reps=1)).report
    assert "over accuracy budget" in tight.skipped.get("fixed:int7", "")
    assert set(tight.winners.values()) == {"fixed:int15-12"}


@pytest.mark.parametrize("case", ["float", "lossy"])
def test_cp_als_through_the_tuner_equals_reference(case):
    cands = ("chunked",) if case == "float" else ("fixed:int15-12",)
    budget = None if case == "float" else 1.0
    got = rt.cp_als(rt.table1_tensor("nell2"), 10, 3, engine="auto", device="cpu",
                    tune=rt.TunePolicy(candidates=cands, accuracy_budget=budget))
    want = ref_cp_als(table1_tensor("nell2"), 10, 3, engine="auto",
                      tune=RTunePolicy(candidates=cands, accuracy_budget=budget))
    assert got.engine == want.engine == f"auto:{cands[0]}"
    assert got.tune_report.winners == want.tune_report.winners
    if case == "float":
        assert got.quant_error is None and want.quant_error is None
        np.testing.assert_allclose(got.fit_history, want.fit_history, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.diff_history, want.diff_history, rtol=0, atol=1e-6)
    else:
        assert got.quant_error == pytest.approx(want.quant_error, rel=0, abs=1e-5)
        assert got.quant_error == max(got.tune_report.errors["fixed:int15-12"].values())
        np.testing.assert_allclose(got.fit_history, want.fit_history, rtol=1e-3, atol=1e-5)


def test_quant_error_without_budget_measures_a_lossy_mode(monkeypatch):
    """A lossy candidate named without a budget records no errors: cp_als
    then measures the last mode a lossy winner serves, as the reference."""
    times = {"fixed:int15-12": (1.0, 1.0, 9.0), "ref": (5.0, 5.0, 1.0)}

    def fake(name, engine, factors, mode, *, warmup, reps):
        return times[name][mode] * 1e-3

    monkeypatch.setattr(autotune, "_time_backend", fake)
    monkeypatch.setattr(rauto, "_time_backend", fake)
    cands = ("fixed:int15-12", "ref")
    got = rt.cp_als(rt.table1_tensor("nell2"), 10, 2, engine="auto", device="cpu",
                    tune=rt.TunePolicy(candidates=cands))
    want = ref_cp_als(table1_tensor("nell2"), 10, 2, engine="auto",
                      tune=RTunePolicy(candidates=cands))
    assert got.tune_report.winners == want.tune_report.winners == {
        0: "fixed:int15-12", 1: "fixed:int15-12", 2: "ref"}
    assert got.tune_report.errors == {} and got.quant_error is not None
    assert got.quant_error == pytest.approx(want.quant_error, rel=0, abs=1e-5)


#: The port's spans inside `cp_als` that the reference does not emit.
PORT_ONLY_SPANS = ("cp_als.init", "cp_als.upload", "cp_als.norm", "cp_als.diff",
                   "cp_als.quant_error")


def _span_shape(spans):
    return [(s.name, tuple(sorted(s.attrs))) for s in spans]


def test_spans_equal_reference(seam):
    """Span names and attribute keys of a seam-timed tune plus cp_als, the
    port's own spans inside `cp_als` left out."""
    cands = ("alto", "chunked", "ref")
    with capture() as got:
        rt.cp_als(rt.random_tensor(SHAPE, NNZ, seed=2), 4, 2, engine="auto", device="cpu",
                  tune=rt.TunePolicy(candidates=cands), **KW)
    with ref_capture() as want:
        ref_cp_als(random_tensor(SHAPE, NNZ, seed=2), 4, 2, engine="auto",
                   tune=RTunePolicy(candidates=cands), **KW)
    assert not {s.name for s in want} & set(PORT_ONLY_SPANS)
    assert _span_shape([s for s in got if s.name not in PORT_ONLY_SPANS]) == _span_shape(want)
    names = {s.name for s in got}
    assert {"autotune.probe", "autotune.decision", "cp_als.decompose", "cp_als.iter",
            "cp_als.mode", "cp_als.fit"} <= names
    iters = [s for s in got if s.name == "cp_als.iter"]
    assert all(s.attrs["seconds"] <= s.duration for s in iters)
    # the port's tracer is its own: the reference's saw none of the port's spans
    assert not any(s.attrs.get("engine", "").startswith("auto:") and s in want for s in got)


@pytest.mark.parametrize("engine", ["ref", "fixed:int15-12"])
def test_cp_als_spans_nest(engine):
    """The whole call under `cp_als.decompose`: the factor draw, the uploads,
    ||X||² once on the device from the uploaded values, each iteration's fit
    and difference, and for a lossy engine the quantisation error."""
    n_iters = 3
    with capture() as got:
        res = rt.cp_als(rt.random_tensor(SHAPE, NNZ, seed=2), 4, n_iters, engine=engine,
                        device="cpu", **KW)
    (dec,) = [s for s in got if s.name == "cp_als.decompose"]
    by = {name: [s for s in got if s.name == name]
          for name in ("cp_als.iter", "cp_als.fit", *PORT_ONLY_SPANS)}
    lossy = engine.startswith("fixed")
    assert {k: len(v) for k, v in by.items()} == {
        "cp_als.iter": n_iters, "cp_als.fit": n_iters, "cp_als.init": 1, "cp_als.upload": 1,
        "cp_als.norm": 1, "cp_als.diff": n_iters, "cp_als.quant_error": int(lossy)}
    assert (res.quant_error is not None) == lossy
    for name, spans in by.items():
        for s in spans:
            assert dec.t_start <= s.t_start and s.t_start + s.duration <= dec.t_start + dec.duration
            assert s.parent_id == dec.span_id, name
    (init,), (upload,), (norm,) = by["cp_als.init"], by["cp_als.upload"], by["cp_als.norm"]
    assert init.t_start + init.duration <= upload.t_start
    assert upload.t_start + upload.duration <= norm.t_start
    assert norm.t_start + norm.duration <= by["cp_als.iter"][0].t_start
    assert norm.attrs["where"] == "device"
    if lossy:
        assert by["cp_als.quant_error"][0].t_start >= by["cp_als.diff"][-1].t_start


def _upload_bytes() -> tuple[int, int]:
    """The registry's (bytes, calls) of `cp_als`'s uploads."""
    reg = obs_metrics.default_registry
    return reg.counter("cp_als.upload_bytes").value, reg.counter("cp_als.uploads").value


@pytest.mark.parametrize("track_diff", [True, False])
def test_upload_bytes_count_what_the_call_copies(track_diff):
    """Float32 factors, int32 coordinates and float32 values; an exact engine
    without the difference needs no COO copy.  A fresh plan cache copies the
    COO on the call's first request (the `ref` engine's build would make that
    copy itself)."""
    rank, n_iters = 4, 2
    st = rt.random_tensor(SHAPE, NNZ, seed=2)
    nbytes, calls = _upload_bytes()
    with capture():
        rt.cp_als(st, rank, n_iters, engine="kernel", device="cpu", track_diff=track_diff,
                  plans=rt.PlanCache(), **KW)
    coo = NNZ * len(SHAPE) * 4 + NNZ * 4 if track_diff else 0
    assert st.nnz == NNZ
    assert _upload_bytes() == (nbytes + sum(SHAPE) * rank * 4 + coo, calls + 1)


def test_tracing_disabled_is_a_no_op():
    from repro_torch.obs import tracing
    assert not tracing.tracing_enabled()
    before = len(tracing.get_tracer())
    uploaded = _upload_bytes()
    rt.cp_als(rt.random_tensor(SHAPE, NNZ, seed=2), 4, 1, engine="ref", device="cpu")
    rt.cp_als(rt.random_tensor(SHAPE, NNZ, seed=2), 4, 1, engine="fixed:int15-12",
              device="cpu", **KW)
    assert len(tracing.get_tracer()) == before
    assert _upload_bytes() == uploaded
    sp = tracing.span("x", a=1)
    assert sp is tracing._NULL_SPAN and sp.set(b=2) is sp and sp.duration is None


def test_trace_export_round_trip(tmp_path, seam):
    from repro_torch.obs import export
    with capture() as spans:
        rt.build_engine(rt.random_tensor(SHAPE, NNZ, seed=2), "auto", 4, device="cpu",
                        tune=rt.TunePolicy(candidates=("alto", "ref")), **KW)
    path = export.write_jsonl(spans, tmp_path / "t.jsonl")
    meta, back = export.read_jsonl(path)
    export.validate_spans(back)
    assert [s.to_json() for s in back] == [s.to_json() for s in spans]
    from repro.obs import export as rexport
    rmeta, rback = rexport.read_jsonl(path)  # the reference reads the port's trace
    assert len(rback) == len(spans)
    summary = export.tune_decision_summary(back)
    assert summary["decisions"] == {"measured": 1} and summary["probes"] == {"measured": 6}
    assert "tune decisions: measured=1" in export.summarize_text(meta, back)
    chrome = export.to_chrome_trace(back, meta)
    assert len([e for e in chrome["traceEvents"] if e["ph"] == "X"]) == len(back)


def test_report_views_equal_reference(seam):
    st = rt.random_tensor(SHAPE, NNZ, seed=2)
    rst = random_tensor(SHAPE, NNZ, seed=2)
    pol = dict(candidates=("alto", "hetero", "ref"), elide=True)
    got = rt.autotune_engine(rt.EngineContext(st=st, rank=4, device="cpu", **KW),
                             tune=rt.TunePolicy(**pol))[1]
    from repro.engine import EngineContext as REngineContext
    want = rauto.autotune_engine(REngineContext(st=rst, rank=4, **KW),
                                 tune=RTunePolicy(**pol))[1]
    assert isinstance(got, rt.AutotuneReport)
    assert got.summary() == want.summary()
    assert got.probe_breakdown() == want.probe_breakdown()
    for k in ("chosen", "winners", "timings", "candidates", "skipped", "prior_order", "source"):
        assert getattr(got, k) == getattr(want, k), k


def test_default_prior_order_equals_reference_on_live_tensor(seam):
    """The live tensor's measured FormatStats feed the csf/alto models in
    both packages (same order)."""
    st = rt.table1_tensor("delicious")
    rst = table1_tensor("delicious")
    got = rt.build_engine(st, "auto", 10, device="cpu", tune=rt.TunePolicy(max_probes=1),
                          formats=rt.FormatCache())
    want = ref_build_engine(rst, "auto", 10, tune=RTunePolicy(max_probes=1))
    assert got.report.prior_order == want.report.prior_order
    stats = costmodel.WorkloadStats(shape=st.shape, nnz=st.nnz,
                                    format_stats=rt.FormatStats.from_tensor(st))
    assert got.report.prior_order == costmodel.prior_order(stats, 10, got.report.candidates)
    assert dataclasses.is_dataclass(got.report)
