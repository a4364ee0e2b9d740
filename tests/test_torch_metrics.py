"""The port's `MetricsRegistry` and its obs CLI against the JAX package.

The metrics are pure Python in both packages, so the same observation
streams must give equal snapshots and percentiles: compared exactly (the
same float operations in the same order).  The CLI is driven on a trace
that the port writes, for its exit codes 0 (OK), 1 (invalid trace) and 2
(usage).
"""
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

import repro_torch as rt
from repro.obs import MetricsRegistry as RMetricsRegistry
from repro_torch.obs import (
    MetricsRegistry,
    capture,
    default_histogram_bounds,
    default_registry,
    write_jsonl,
)
from repro_torch.obs.__main__ import main as obs_cli

REPO = Path(__file__).resolve().parents[1]


def _streams():
    rng = np.random.default_rng(0)
    return {
        "lognormal": rng.lognormal(mean=-5.0, sigma=1.5, size=2000).tolist(),
        "constant": [0.0123] * 7,
        "sub_resolution": [1e-9, 5e-8, 2e-7, 0.0],
        "overflow": [0.5, 2.0, 5000.0, 1e6],
        "empty": [],
    }


def _feed(reg, name, samples, bounds=None):
    h = reg.histogram(name, bounds=bounds)
    for v in samples:
        h.observe(v)
    c = reg.counter(name + ".n")
    c.inc(len(samples))
    g = reg.gauge(name + ".last")
    g.set_value(samples[-1] if samples else 0.0)
    g.add(1.5)
    return h


@pytest.mark.parametrize("stream", sorted(_streams()))
@pytest.mark.parametrize("bounds", [None, (1.0, 10.0, 100.0)], ids=["default", "custom"])
def test_snapshot_equals_reference(stream, bounds):
    """Exact equality: the same Python arithmetic on the same stream."""
    samples = _streams()[stream]
    ours, theirs = MetricsRegistry(), RMetricsRegistry()
    _feed(ours, stream, samples, bounds)
    _feed(theirs, stream, samples, bounds)
    assert ours.snapshot() == theirs.snapshot()


@pytest.mark.parametrize("q", [0, 1, 25, 50, 90, 95, 99, 99.9, 100])
def test_percentiles_equal_reference(q):
    samples = _streams()["lognormal"]
    ours = _feed(MetricsRegistry(), "lat", samples)
    theirs = _feed(RMetricsRegistry(), "lat", samples)
    assert ours.percentile(q) == theirs.percentile(q)


def test_counter_gauge_basics():
    reg = MetricsRegistry()
    c = reg.counter("reqs")
    c.inc()
    c.inc(4)
    g = reg.gauge("depth")
    g.set_value(3)
    g.add(-1)
    snap = reg.snapshot()
    assert snap["reqs"] == {"type": "counter", "value": 5}
    assert snap["depth"] == {"type": "gauge", "value": 2.0}
    assert reg.counter("reqs") is c  # get-or-create
    with pytest.raises(TypeError, match="already registered as Counter"):
        reg.gauge("reqs")
    assert isinstance(default_registry, MetricsRegistry)


def test_bucket_geometry_and_bad_specs():
    b = default_histogram_bounds()
    assert len(b) == 73  # 9 decades × 8 + 1 edges
    assert b[0] == pytest.approx(1e-6) and b[-1] == pytest.approx(1e3)
    assert all(b[i + 1] / b[i] == pytest.approx(10 ** (1 / 8)) for i in range(len(b) - 1))
    for lo, hi, per in [(0.0, 1.0, 8), (1.0, 1.0, 8), (1e-3, 1.0, 0)]:
        with pytest.raises(ValueError, match="bad bounds spec"):
            default_histogram_bounds(lo, hi, per)
    with pytest.raises(ValueError, match="strictly increasing"):
        MetricsRegistry().histogram("h", bounds=(1.0, 1.0, 2.0))
    with pytest.raises(ValueError, match=r"\[0, 100\]"):
        MetricsRegistry().histogram("h").percentile(101)


def test_overflow_bucket_and_clamping():
    reg = MetricsRegistry()
    h = reg.histogram("big", bounds=(1.0, 10.0))
    h.observe(5000.0)
    assert h.percentile(99) == 5000.0
    assert reg.snapshot()["big"]["counts"] == [0, 0, 1]  # the overflow bucket
    one = reg.histogram("one")
    one.observe(0.0123)
    assert [one.percentile(q) for q in (0, 50, 100)] == pytest.approx([0.0123] * 3)
    assert reg.histogram("empty").percentile(99) == 0.0


def test_percentile_within_one_bucket_width():
    """Log-bucketed percentiles land within one bucket width — a factor of
    10^(1/8) for the default geometry — of the exact sample percentile."""
    samples = np.asarray(_streams()["lognormal"])
    h = _feed(MetricsRegistry(), "lat", samples.tolist())
    width = 10 ** (1 / 8)
    for q in (50, 95, 99):
        exact = float(np.percentile(samples, q))
        assert exact / width <= h.percentile(q) <= exact * width
    assert h.count == len(samples)
    assert h.total == pytest.approx(float(samples.sum()))


def test_thread_safety_under_contention():
    """More threads than cores and a short switch interval: no increment or
    observation is lost, and every snapshot taken meanwhile is a consistent
    cut (the histogram's count equals the sum of its bucket counts)."""
    reg = MetricsRegistry()
    c, h = reg.counter("n"), reg.histogram("v")
    torn = []

    def work():
        for i in range(500):
            c.inc()
            h.observe(1e-3 * (1 + i % 7))

    def watch():
        for _ in range(200):
            snap = reg.snapshot()["v"]
            if snap["count"] != sum(snap["counts"]):
                torn.append(snap)

    n_threads = 2 * (os.cpu_count() or 2) + 2
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        threads.append(threading.Thread(target=watch))
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert c.value == 500 * n_threads and h.count == 500 * n_threads
    assert not torn


@pytest.fixture
def port_trace(tmp_path):
    """A trace of the port's cp_als on the CPU, written by the port."""
    st = rt.random_tensor((6, 5, 4), 30, seed=1)
    with capture() as spans:
        rt.cp_als(st, 2, n_iters=2, device="cpu")
    assert {"cp_als.iter", "cp_als.mode"} <= {s.name for s in spans}
    return str(write_jsonl(spans, tmp_path / "t.jsonl"))


def test_cli_exit_codes(port_trace, tmp_path, capsys):
    assert obs_cli(["summarize", port_trace]) == 0
    assert "cp_als.iter" in capsys.readouterr().out
    out_json = str(tmp_path / "t.json")
    assert obs_cli(["export", port_trace, "-o", out_json]) == 0
    assert json.loads(Path(out_json).read_text())["traceEvents"]
    (tmp_path / "bad.jsonl").write_text("nope\n")
    assert obs_cli(["summarize", str(tmp_path / "bad.jsonl")]) == 1
    assert obs_cli(["summarize", str(tmp_path / "missing.jsonl")]) == 1
    for argv in ([], ["export", port_trace], ["frobnicate", port_trace]):
        with pytest.raises(SystemExit) as e:
            obs_cli(argv)
        assert e.value.code == 2


def test_cli_as_a_module(port_trace):
    """`python -m repro_torch.obs` in a process of its own (the exit codes
    are covered in process above)."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    ok = subprocess.run([sys.executable, "-m", "repro_torch.obs", "summarize", port_trace],
                        env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert ok.returncode == 0 and "cp_als.iter" in ok.stdout
