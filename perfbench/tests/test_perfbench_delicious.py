"""The cells `delicious.kernel` and `nell2.fixed-int15-12`, their configuration and
the readers of the MTTKRP ops' global tier and output counter: on hand-made runs
and on tiny versions of the cells traced through `harness.run` on the CPU."""
import time

import numpy as np
import pytest
import torch

from perfbench import harness, manifest, tensorgen
from perfbench.tests import _tiny  # noqa: F401  (puts the program on sys.path)
from repro_torch.obs import metrics as obs_metrics

NEW_CELLS = ("delicious.kernel", "nell2.fixed-int15-12")
NEW_METRICS = ("mttkrp_global_ms", "mttkrp_global_roofline", "mttkrp_out_mb")
LAYER = "MTTKRP ops and kernels, kernels/ops.py and kernels/csrc/mttkrp*.cu"
#: The cells cut to a CPU's size: Delicious's four modes at about a thousandth.
TINY = {"delicious.kernel": ((53, 1726, 248, 144), 12_000),
        "nell2.fixed-int15-12": ((120, 92, 288), 20_000)}


def read(name, run):
    return manifest.reader(name)(run)


def _run(**kw):
    base = dict(config={"shape": [532924, 17262471, 2480308, 1443], "nnz": 140_126_181,
                        "rank": 10},
                traffic={}, device_name="NVIDIA H100 80GB HBM3", setup_s=90.0,
                engine_build_s=60.0, window=(0.0, 10.0),
                decomps=[(0.0, 4.0, 1), (4.0, 10.0, 1)], peak_bytes=40 * 2**30)
    base.update(kw)
    return harness.RunData(**base)


SPANS = [("perfbench.window", 0.0, 10.0),
         ("perfbench.decompose", 0.0, 4.0), ("perfbench.decompose", 4.0, 10.0),
         ("cp_als.iter", 1.0, 2.0), ("cp_als.iter", 5.0, 6.0)]
GLOBAL = "void prism::global_kernel<(anonymous namespace)::FloatPolicy>(int const*)"
EVENTS = [(GLOBAL, 1.1, 1.11), (GLOBAL, 1.2, 1.21), (GLOBAL, 1.3, 1.31),
          ("void prism::task_kernel<(anonymous namespace)::FloatPolicy, 4>(int)", 1.4, 1.5),
          (GLOBAL, 5.1, 5.11), (GLOBAL, 5.2, 5.21), (GLOBAL, 5.3, 5.31),
          # outside every iteration: another layer's
          (GLOBAL, 3.0, 3.5)]


def test_global_tier_readers():
    run = _run(spans=SPANS, device_events=EVENTS)
    assert read("mttkrp_global_ms", run) == pytest.approx(30.0)  # 3 x 10 ms an iteration
    one = (140_126_181 * 20 + (532924 + 17262471 + 2480308 + 1443) * 40) / 3.35e12
    assert read("mttkrp_global_roofline", run) == pytest.approx(3 * one / 0.030 * 100)
    # a launch that straddles an iteration's end counts to that end
    straddle = _run(spans=SPANS, device_events=[*EVENTS, (GLOBAL, 5.95, 6.05)])
    assert read("mttkrp_global_ms", straddle) == pytest.approx(55.0)


@pytest.mark.parametrize("case", ["untraced", "no global launch", "unknown card"])
def test_global_tier_readers_find_nothing(case):
    run = {"untraced": _run(),
           "no global launch": _run(spans=SPANS, device_events=EVENTS[3:4]),
           "unknown card": _run(spans=SPANS, device_events=EVENTS, device_name="cpu")}[case]
    assert read("mttkrp_global_roofline", run) is None
    if case != "unknown card":
        assert read("mttkrp_global_ms", run) is None


@pytest.fixture
def registry(monkeypatch):
    """A fresh registry in the program's place, read by the program and the reader."""
    fresh = obs_metrics.MetricsRegistry()
    monkeypatch.setattr(obs_metrics, "default_registry", fresh)
    return fresh


@pytest.mark.parametrize(("calls", "want"), [(8, 811.09132), (7, None), (9, None)])
def test_out_counter_reader(registry, calls, want):
    """N calls for each of the window's iteration spans, or no reading."""
    run = _run(spans=SPANS, device_events=[])
    assert read("mttkrp_out_mb", run) is None  # a program that counts nothing
    registry.counter("mttkrp.out_bytes").inc(2 * 811_091_320)
    registry.counter("mttkrp.calls").inc(calls)
    got = read("mttkrp_out_mb", run)
    assert got == (None if want is None else pytest.approx(want))
    assert read("mttkrp_out_mb", _run()) is None  # untraced


def test_manifest_holds_the_new_entries():
    m = manifest.load_manifest()
    assert manifest.check_manifest(m) == []
    config = next(c for c in m["configs"] if c["name"] == "frostt-delicious")
    assert config["reduced"] == [] and config["file"] == "perfbench/configs/frostt-delicious.json"
    cells = {w["name"]: w for w in m["workloads"]}
    assert (cells["delicious.kernel"]["config"], cells["delicious.kernel"]["traffic"]) == \
        ("frostt-delicious", "kernel")
    assert (cells["nell2.fixed-int15-12"]["config"], cells["nell2.fixed-int15-12"]["traffic"]) \
        == ("frostt-nell2", "fixed-int15-12")
    assert all(cells[c]["chips"] == 1 for c in NEW_CELLS)
    layer = {x["name"]: x for x in m["per_layer"]}
    for name in NEW_METRICS:
        assert layer[name]["layer"] == LAYER and layer[name]["moves"] == "iter_ms"
    assert layer["mttkrp_global_ms"]["workloads"] == ["delicious.kernel"]
    assert layer["mttkrp_global_roofline"]["workloads"] == ["delicious.kernel"]
    assert layer["mttkrp_out_mb"]["workloads"] == list(NEW_CELLS)
    for name in NEW_CELLS:
        cell = manifest.load_cell(m, name)
        assert {"iter_ms", "peak_mem_gib", "setup_s"} <= {x["name"] for x in cell.end_to_end}


def test_delicious_configuration_is_the_published_size():
    cell = manifest.load_cell(manifest.load_manifest(), "delicious.kernel")
    c = cell.config
    assert c["shape"] == [532_924, 17_262_471, 2_480_308, 1_443] and c["nnz"] == 140_126_181
    assert (c["distribution"], c["zipf_a"], c["rank"], c["precision"]) == \
        ("powerlaw", 1.3, 10, "float32")
    assert c["reduced"] == [] and c["source"] == "http://frostt.io/tensors/delicious/"
    assert {"dims", "values", "coordinates", "rank", "pattern"} <= set(c["assumed"])


def test_a_new_metric_naming_an_unknown_cell_is_refused():
    m = manifest.load_manifest()
    layer = next(x for x in m["per_layer"] if x["name"] == "mttkrp_out_mb")
    layer["workloads"] = [*layer["workloads"], "delicious.nothing"]
    assert any("unknown cells" in b for b in manifest.check_manifest(m))


def test_generate_at_a_scaled_four_mode_powerlaw_shape():
    """Delicious's dims and nonzeros over a thousand: distinct, lexicographic,
    exact, deterministic, and a hot row of a tenth or more in every mode."""
    shape, nnz = (533, 17_262, 2_480, 1_443), 140_126
    a = tensorgen.generate(shape, nnz, distribution="powerlaw", seed=2**32 + 5, device="cpu")
    b = tensorgen.generate(shape, nnz, distribution="powerlaw", seed=2**32 + 5, device="cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    coords = a[0].numpy()
    assert coords.shape == (nnz, 4) and (coords < np.array(shape)).all() and (coords >= 0).all()
    assert np.array_equal(np.unique(coords, axis=0), coords)
    for m in range(4):
        assert np.bincount(coords[:, m]).max() >= nnz // 10, m


@pytest.mark.parametrize("name", NEW_CELLS)
def test_traced_tiny_cell_reports_its_metrics(registry, name):
    cell = manifest.load_cell(manifest.load_manifest(), name)
    shape, nnz = TINY[name]
    cell.config = dict(cell.config, shape=list(shape), nnz=nnz)
    out = harness.run(cell, 2**31 + 17, 0.3, True, "cpu", time.perf_counter())
    assert out["correct"], out
    got = {k: v["value"] for k, v in out["metrics"].items()}
    import repro_torch as rt
    coords, values = tensorgen.generate(shape, nnz, distribution=cell.config["distribution"],
                                        seed=2**31 + 17, device="cpu")
    plan = rt.decide_partition(rt.SparseTensor(coords.numpy(), values.numpy(), shape), 10,
                               **cell.traffic["plan"])
    rows = [-(-d // s) * s for d, s in zip(shape, plan.chunk_shape, strict=True)]
    assert got["mttkrp_out_mb"] == pytest.approx(sum(rows) * 10 * 4 / 1e6, rel=1e-12)
    # no device trace on the CPU
    assert "mttkrp_global_ms" not in got and "mttkrp_global_roofline" not in got
