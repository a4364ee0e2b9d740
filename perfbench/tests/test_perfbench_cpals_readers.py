"""The readers of `cp_als`'s own spans and upload counter: on hand-made
runs, and on tiny cells traced through `harness.run` on the CPU."""
import time

import pytest

from perfbench import harness, manifest
from perfbench.tests._tiny import SIZES, tiny_cell
from repro_torch.obs import metrics as obs_metrics

SPAN_METRICS = ("init_ms", "upload_ms", "norm_ms", "diff_ms", "quant_error_ms")
METRICS = (*SPAN_METRICS, "upload_mb_per_call")


def _run(**kw):
    base = dict(config={"shape": [40, 50, 30], "nnz": 1000, "rank": 10}, traffic={},
                device_name="cpu", setup_s=1.0, engine_build_s=0.5, window=(0.0, 10.0),
                decomps=[(0.0, 4.0, 2), (4.0, 10.0, 2)], peak_bytes=None)
    base.update(kw)
    return harness.RunData(**base)


def read(name, run):
    return manifest.reader(name)(run)


#: Two calls of two iterations; one `cp_als.quant_error` falls outside the window.
SPANS = [("perfbench.window", 0.0, 10.0),
         ("perfbench.decompose", 0.0, 4.0), ("perfbench.decompose", 4.0, 10.0),
         ("cp_als.init", 0.0, 0.2), ("cp_als.upload", 0.2, 0.3),
         ("cp_als.norm", 1.0, 1.5), ("cp_als.diff", 1.6, 1.7),
         ("cp_als.norm", 2.0, 2.5), ("cp_als.diff", 2.6, 2.9),
         ("cp_als.quant_error", 3.0, 3.4),
         ("cp_als.init", 4.0, 4.4), ("cp_als.upload", 4.4, 4.7),
         ("cp_als.norm", 5.0, 6.0), ("cp_als.diff", 6.0, 6.2),
         ("cp_als.norm", 7.0, 8.0), ("cp_als.diff", 8.0, 8.2),
         ("cp_als.quant_error", 9.9, 10.5)]


def test_span_readers():
    run = _run(spans=SPANS, device_events=[])
    assert read("init_ms", run) == pytest.approx(300.0)
    assert read("upload_ms", run) == pytest.approx(200.0)
    assert read("norm_ms", run) == pytest.approx(750.0)
    assert read("diff_ms", run) == pytest.approx(200.0)
    assert read("quant_error_ms", run) == pytest.approx(400.0)
    float_run = [s for s in SPANS if s[0] != "cp_als.quant_error"]
    assert read("quant_error_ms", _run(spans=float_run, device_events=[])) is None


@pytest.fixture
def registry(monkeypatch):
    """A fresh registry in the program's place, read by the program and the reader."""
    fresh = obs_metrics.MetricsRegistry()
    monkeypatch.setattr(obs_metrics, "default_registry", fresh)
    return fresh


def _count(registry, nbytes, calls):
    registry.counter("cp_als.upload_bytes").inc(nbytes)
    registry.counter("cp_als.uploads").inc(calls)


def test_upload_counter_reader(registry):
    run = _run(spans=SPANS, device_events=[])
    assert read("upload_mb_per_call", run) is None  # a program that counts nothing
    _count(registry, 3_000_000, 2)
    assert read("upload_mb_per_call", run) == pytest.approx(1.5)


_UPLOAD = ("cp_als.upload", 4.4, 4.7)


@pytest.mark.parametrize("case", ["earlier call", "two earlier calls", "no span", "late span"])
def test_upload_counter_reader_refuses_what_is_not_one_window(registry, case):
    """Calls counted outside the window's spans (an earlier traced window, or
    set-up traced), a call with no upload span, or an upload span past the
    window's end, give None."""
    calls, spans = 2, SPANS
    if case.endswith("calls") or case.endswith("call"):
        calls += 2 if case.startswith("two") else 1
    elif case == "no span":
        spans = [s for s in SPANS if s != _UPLOAD]
    else:
        spans = [s if s != _UPLOAD else ("cp_als.upload", 10.0, 10.2) for s in SPANS]
    _count(registry, 4_500_000, calls)
    assert read("upload_mb_per_call", _run(spans=spans, device_events=[])) is None


def test_untraced_runs_give_none(registry):
    _count(registry, 3_000_000, 2)
    for name in METRICS:
        assert read(name, _run()) is None, name


@pytest.mark.parametrize("name", sorted(SIZES))
def test_traced_tiny_cell_reports_the_cpals_metrics(registry, name):
    cell = tiny_cell(name)
    out = harness.run(cell, 2**31 + 11, 0.3, True, "cpu", time.perf_counter())
    assert out["correct"], out
    got = {k: v["value"] for k, v in out["metrics"].items()}
    lossy = name.endswith("fixed-int15-12")
    want = set(METRICS) - (set() if lossy else {"quant_error_ms"})
    assert want <= set(got), got
    assert ("quant_error_ms" in got) == lossy
    shape, nnz = SIZES[name]
    rank = cell.config["rank"]
    assert got["upload_mb_per_call"] == pytest.approx(
        (sum(shape) * rank * 4 + nnz * len(shape) * 4 + nnz * 4) / 1e6, rel=1e-12)
    # the spans lie inside the harness's call and outside the iterations and fits
    named = (got["init_ms"] + got["upload_ms"] + cell.traffic["n_iters"] * got["diff_ms"]
             + got.get("quant_error_ms", 0.0))
    assert named <= got["decompose_self_ms"] * (1 + 1e-9)
    assert got["norm_ms"] <= got["fit_ms"]
