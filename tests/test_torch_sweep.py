"""The port's offline sweep (`repro_torch.sweep`) and roofline model
(`repro_torch.roofline.model`) against the JAX package's, on the CPU.

The cases of tests/test_sweep.py, each run through the port: config
parsing and the TOML-subset parser on the shipped CI grid, the cell
fingerprint against a live tune, zero-probe resume, near-match stores,
the capacity axis, kill-and-restart, and the Pareto report.  Both
packages' sweeps run the CI grid under one deterministic timing seam and
must reach the same outcomes; the Pareto front, `roofline_terms` and
`model_flops` must equal the reference's on the same inputs.
"""
import dataclasses
import math
import os

import pytest

import repro_torch as rt
from repro.engine import TuningStore as RefStore
from repro.engine import autotune as ref_autotune
from repro.roofline import model as ref_model
from repro.sweep import load_config as ref_load_config
from repro.sweep import pareto_front as ref_pareto_front
from repro.sweep import run_sweep as ref_run_sweep
from repro_torch.engine import TuningStore, WorkloadKey
from repro_torch.engine import autotune as _autotune
from repro_torch.roofline import H100_SXM5, HWTarget, model_flops, roofline_terms
from repro_torch.sweep import (
    HOST_HW,
    SweepConfig,
    SweepConfigError,
    TensorBand,
    cell_key,
    load_config,
    pareto_front,
    pareto_report,
    run_sweep,
)
from repro_torch.sweep.config import _toml_subset_loads

ROOT = os.path.join(os.path.dirname(__file__), "..")
CI_GRID = os.path.join(ROOT, "benchmarks", "sweep_ci.toml")
CANDS = ("chunked", "ref")
CPU = "cpu"


def _band(**over):
    base = dict(name="u", shape=(12, 10, 8), nnz=(150, 200), distribution="uniform", seed=0)
    base.update(over)
    return TensorBand(**base)


def _config(**over):
    base = dict(name="t", tensors=(_band(),), ranks=(3,), candidates=CANDS,
                capacities=(None,), mem_bytes=64 * 1024, warmup=0, reps=1)
    base.update(over)
    return SweepConfig(**base)


def _fake(calls=None):
    """Deterministic per-(candidate, mode) probe seconds (tests/test_sweep.py's)."""
    def fake(name, engine, factors, mode, *, warmup, reps):
        if calls is not None:
            calls.append((name, mode))
        return 1e-3 * (1 + sum(map(ord, name)) % 7) + 2e-4 * mode
    return fake


@pytest.fixture
def calls(monkeypatch):
    seen = []
    monkeypatch.setattr(_autotune, "_time_backend", _fake(seen))
    return seen


def _store(tmp_path, name="sweep.json"):
    return TuningStore(tmp_path / name, nnz_tol=0.0)


# ---------------------------------------------------------------------------
# Config schema + TOML-subset parser
# ---------------------------------------------------------------------------

def test_config_validation_rejects_unusable_grids():
    with pytest.raises(SweepConfigError, match="no tensor bands"):
        _config(tensors=())
    with pytest.raises(SweepConfigError, match="ranks must be positive"):
        _config(ranks=(0,))
    with pytest.raises(SweepConfigError, match="bad candidate id"):
        _config(candidates=("pallas",))  # the reference's name; the port says `kernel`
    with pytest.raises(SweepConfigError, match="accuracy_budget"):
        _config(candidates=("ref", "fixed:int7"))
    with pytest.raises(SweepConfigError, match="capacity"):
        _config(capacities=(-3,))
    with pytest.raises(SweepConfigError, match="distribution"):
        _band(distribution="gaussian")
    with pytest.raises(SweepConfigError, match="nnz band must be positive"):
        _band(nnz=())
    assert _config(candidates=("kernel", "distributed")).candidates == ("kernel", "distributed")


def test_from_dict_maps_sentinels_and_scalars():
    cfg = SweepConfig.from_dict({"sweep": {
        "name": "d", "ranks": [4], "capacities": [0, 32], "candidates": ["ref"],
        "tensors": [{"name": "b", "shape": [8, 6, 4], "nnz": 50}]}})
    assert cfg.capacities == (None, 32)
    assert cfg.tensors[0].nnz == (50,)
    assert [c.label for c in cfg.cells()] == ["b/nnz=50/rank=4/cap=auto", "b/nnz=50/rank=4/cap=32"]


def test_toml_subset_parser_covers_the_schema():
    parsed = _toml_subset_loads(
        '# header comment\n[sweep]\nname = "g"  # trailing comment\nranks = [4, 8]\n'
        'accuracy_budget = 0.2\nflag = true\ncandidates = ["ref", "fixed:int7"]\n\n'
        '[[sweep.tensors]]\nname = "a"\nshape = [8, 6, 4]\nnnz = 50\n'
        '[[sweep.tensors]]\nname = "b # not a comment"\nshape = [10, 10, 10]\nnnz = [60, 70]\n')
    assert parsed["sweep"]["ranks"] == [4, 8] and parsed["sweep"]["flag"] is True
    assert [t["name"] for t in parsed["sweep"]["tensors"]] == ["a", "b # not a comment"]
    assert parsed["sweep"]["tensors"][1]["nnz"] == [60, 70]
    with pytest.raises(SweepConfigError, match="unsupported value"):
        _toml_subset_loads("x = 1979-05-27\n")
    with pytest.raises(SweepConfigError, match="key = value"):
        _toml_subset_loads("just words\n")


def test_ci_grid_gives_the_reference_cells():
    """`load_config`, `from_dict` and `_toml_subset_loads` all read the
    shipped CI grid into the reference's cells."""
    import tomllib
    cfg, ref = load_config(CI_GRID), ref_load_config(CI_GRID)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert [dataclasses.asdict(c) for c in cfg.cells()] == [
        dataclasses.asdict(c) for c in ref.cells()]
    assert len(cfg.cells()) == 6 and cfg.accuracy_budget == 0.2
    with open(CI_GRID, encoding="utf-8") as f:
        text = f.read()
    with open(CI_GRID, "rb") as f:
        assert _toml_subset_loads(text) == tomllib.load(f)
    assert SweepConfig.from_dict(_toml_subset_loads(text)) == cfg


# ---------------------------------------------------------------------------
# Fingerprint-native resumability
# ---------------------------------------------------------------------------

def test_cell_key_matches_live_autotune_fingerprint(tmp_path, calls):
    cfg = _config(capacities=(16,))
    cell = cfg.cells()[0]
    st = rt.random_tensor(cell.band.shape, cell.nnz, distribution=cell.band.distribution,
                          seed=cell.band.seed)
    live = WorkloadKey.from_tensor(st, cell.rank, cfg.candidates, capacity=cell.capacity,
                                   device=CPU)
    assert cell_key(cell, cfg, CPU) == live
    # ...and the key a real tune stores under.
    store = _store(tmp_path)
    rt.build_engine(st, "auto", cell.rank, device=CPU, capacity=cell.capacity,
                    mem_bytes=cfg.mem_bytes, tune=rt.TunePolicy(candidates=CANDS, store=store))
    assert [e.key for e in store.entries()] == [live]


def test_sweep_resumes_with_zero_probes(tmp_path, calls):
    cfg, store = _config(), _store(tmp_path)
    first = run_sweep(cfg, store, device=CPU)
    assert first.count("measured") == 2 and first.n_probes == len(calls) > 0
    calls.clear()
    second = run_sweep(cfg, store, device=CPU)
    assert calls == [] and second.n_probes == 0 and second.count("complete") == 2
    assert len(_store(tmp_path)) == 2
    assert [o.winners for o in second.outcomes] == [o.winners for o in first.outcomes]
    assert second.device == rt.engine.device_fingerprint_id(rt.engine.device_fingerprint(CPU))


def test_adjacent_nnz_band_cells_stay_distinct(tmp_path, calls):
    cfg, store = _config(tensors=(_band(nnz=(150, 160)),)), _store(tmp_path)
    assert run_sweep(cfg, store, device=CPU).count("measured") == 2 and len(store) == 2
    again = run_sweep(cfg, store, device=CPU)
    assert again.n_probes == 0 and again.count("complete") == 2


def test_sweep_rejects_near_match_store(tmp_path):
    with pytest.raises(ValueError, match="nnz_tol=0"):
        run_sweep(_config(), TuningStore(tmp_path / "s.json"), device=CPU)


def test_interrupted_sweep_restart_skips_completed_cells_and_matches_pareto(tmp_path, calls):
    cfg = _config(ranks=(3, 4))
    n_cells = len(cfg.cells())
    oneshot_store = _store(tmp_path, "oneshot.json")
    assert run_sweep(cfg, oneshot_store, device=CPU).count("measured") == n_cells
    probes_full = len(calls)
    calls.clear()
    store = _store(tmp_path, "interrupted.json")
    partial = run_sweep(cfg, store, max_cells=2, device=CPU)
    assert partial.count("measured") == 2 and partial.count("deferred") == n_cells - 2
    probes_before_kill = len(calls)
    calls.clear()
    resumed = run_sweep(cfg, store, device=CPU)
    assert resumed.count("complete") == 2 and resumed.count("measured") == n_cells - 2
    assert len(calls) == probes_full - probes_before_kill

    def front_view(s):
        return {(p["cell"], p["candidate"], p["time_s"], p["index_bytes"])
                for p in pareto_report(s, device=CPU)["front"]}
    assert front_view(store) == front_view(oneshot_store)


def test_no_resume_forgets_and_remeasures(tmp_path, calls):
    cfg, store = _config(tensors=(_band(nnz=(150,)),)), _store(tmp_path)
    run_sweep(cfg, store, device=CPU)
    calls.clear()
    redo = run_sweep(cfg, store, resume=False, device=CPU)
    assert redo.count("measured") == 1 and len(calls) > 0 and len(store) == 1


def test_capacity_axis_fingerprints_distinctly(tmp_path, calls):
    cfg = _config(tensors=(_band(nnz=(150,)),), capacities=(None, 16))
    store = _store(tmp_path)
    assert run_sweep(cfg, store, device=CPU).count("measured") == 2
    assert sorted((e.key.capacity for e in store.entries()),
                  key=lambda c: (c is not None, c)) == [None, 16]
    assert run_sweep(cfg, store, device=CPU).n_probes == 0


def test_failed_cell_does_not_take_down_the_grid(tmp_path, monkeypatch):
    def broken(name, engine, factors, mode, *, warmup, reps):
        raise RuntimeError("probe exploded")
    monkeypatch.setattr(_autotune, "_time_backend", broken)
    result = run_sweep(_config(), _store(tmp_path), device=CPU)
    assert result.count("failed") == 2
    assert all("every candidate failed" in o.error for o in result.outcomes)


def test_kernel_error_raises_out_of_the_sweep(tmp_path, monkeypatch):
    """A kernel that cannot build or launch breaks every cell: it raises
    instead of being recorded as one failed cell."""
    def broken(name, engine, factors, mode, *, warmup, reps):
        raise rt.KernelError("nvcc failed")
    monkeypatch.setattr(_autotune, "_time_backend", broken)
    with pytest.raises(rt.KernelError):
        run_sweep(_config(), _store(tmp_path), device=CPU)


def test_ci_grid_sweep_reaches_the_reference_outcomes(tmp_path, monkeypatch):
    """Both packages sweep the shipped CI grid (`fixed:int7` under its 0.2
    budget, measured for real) under one timing seam: the same cells,
    statuses, probes and winners, and the same resume."""
    monkeypatch.setattr(_autotune, "_time_backend", _fake())
    monkeypatch.setattr(ref_autotune, "_time_backend", _fake())
    cfg = load_config(CI_GRID)
    got = run_sweep(cfg, _store(tmp_path, "port.json"), device=CPU)
    want = ref_run_sweep(ref_load_config(CI_GRID), RefStore(tmp_path / "ref.json", nnz_tol=0.0))

    def view(result):
        return [(o.cell, o.status, o.n_probes, o.winners) for o in result.outcomes]
    assert view(got) == view(want)
    assert got.count("measured") == 6 and got.n_probes > 0
    again = run_sweep(cfg, _store(tmp_path, "port.json"), device=CPU)
    assert again.n_probes == 0 and again.count("complete") == 6


# ---------------------------------------------------------------------------
# Pareto report and roofline
# ---------------------------------------------------------------------------

def test_report_points_carry_all_required_axes(tmp_path, calls):
    store = _store(tmp_path)
    run_sweep(_config(), store, device=CPU)
    rep = pareto_report(store, hw=H100_SXM5, device=CPU)
    assert rep["hw"] == {"name": "nvidia-h100-80gb-hbm3", "peak_flops": 66.9e12,
                         "hbm_bw": 3.35e12}
    assert rep["n_entries"] == 2 and rep["n_points"] == 2 * len(CANDS) and rep["n_pareto"] >= 2
    for p in rep["points"]:
        assert p["time_s"] > 0 and p["rel_error"] == 0.0 and p["index_bytes"] > 0
        assert 0 < p["peak_fraction"] <= 1.0
        assert p["roofline_dominant"] in ("compute_s", "memory_s", "collective_s")
        assert isinstance(p["pareto"], bool)
    assert {p["cell"] for p in rep["front"]} == {p["cell"] for p in rep["points"]}
    host = pareto_report(store, device=CPU)  # the default target: the host estimate
    assert host["hw"]["name"] == HOST_HW.name == "cpu-host-estimate"


def test_pareto_front_marks_the_reference_dominance():
    mk = {"rel_error": 0.0, "index_bytes": 100.0}

    def points():
        return [
            {"cell": "a", "candidate": "x", "time_s": 1.0, **mk},
            {"cell": "a", "candidate": "y", "time_s": 2.0, **mk},
            {"cell": "a", "candidate": "z", "time_s": 2.0, "rel_error": 0.0, "index_bytes": 50.0},
            {"cell": "a", "candidate": "w", "time_s": 0.5, "rel_error": 0.1, "index_bytes": 100.0},
            {"cell": "b", "candidate": "y", "time_s": 2.0, **mk},
        ]
    got, want = points(), points()
    assert pareto_front(got) == ref_pareto_front(want)
    assert got == want
    assert [p["pareto"] for p in got] == [True, False, True, True, True]


@pytest.mark.parametrize("terms", [
    (197e12, 1e9, 1e6),       # compute-bound on the reference's target
    (1e12, 1e9, 500e9),       # collective-bound
    (1e9, 5e12, 0.0),         # memory-bound
    (0.0, 0.0, 0.0),          # empty
])
@pytest.mark.parametrize("target", ["h100", "host"])
def test_roofline_terms_equal_the_reference(terms, target):
    hw = H100_SXM5 if target == "h100" else HOST_HW
    ref_hw = ref_model.HWTarget(hw.name, hw.peak_flops, hw.hbm_bw, hw.link_bw)
    assert roofline_terms(*terms, hw=hw) == ref_model.roofline_terms(*terms, hw=ref_hw)
    if target == "h100":
        assert roofline_terms(*terms) == roofline_terms(*terms, hw=H100_SXM5)


def test_h100_target_and_model_flops():
    assert H100_SXM5 == HWTarget("nvidia-h100-80gb-hbm3", 66.9e12, 3.35e12, 450e9)
    # The data sheet's float32 rate: 132 SMs × 128 lanes × 2 × 1.98 GHz.
    assert math.isclose(H100_SXM5.peak_flops, 132 * 128 * 2 * 1.98e9, rel_tol=1e-3)
    for args in [(1e9, 1e6, "train"), (1e9, 1e6, "serve"), (3.5e6, 42.0, "train")]:
        assert model_flops(*args) == ref_model.model_flops(*args)
