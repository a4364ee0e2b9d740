"""The trace reduction and the metric readers on a hand-made run."""
import pytest

from perfbench import devtrace, harness, manifest


def _run(**kw):
    base = dict(config={"shape": [12092, 9184, 28818], "nnz": 76_879_419, "rank": 10},
                traffic={}, device_name="NVIDIA H100 80GB HBM3", setup_s=30.0,
                engine_build_s=20.0, window=(0.0, 10.0),
                decomps=[(0.0, 4.0, 5), (4.0, 10.0, 5)], peak_bytes=3 * 2**30)
    base.update(kw)
    return harness.RunData(**base)


def read(name, run):
    return manifest.reader(name)(run)


def test_end_to_end_readers():
    run = _run()
    assert read("iter_ms", run) == pytest.approx(1000.0)
    assert read("decomp_p95_ms", run) == pytest.approx(6000.0)
    assert read("peak_mem_gib", run) == pytest.approx(3.0)
    assert read("setup_s", run) == 30.0 and read("engine_build_s", run) == 20.0
    assert read("peak_mem_gib", _run(peak_bytes=None)) is None


SPANS = [("perfbench.window", 0.0, 10.0),
         ("perfbench.decompose", 0.0, 4.0), ("perfbench.decompose", 4.0, 10.0),
         ("cp_als.iter", 0.5, 1.0), ("cp_als.fit", 1.0, 2.0),
         ("cp_als.iter", 4.5, 5.0), ("cp_als.fit", 5.0, 8.0)]
EVENTS = [("void prism::task_kernel<prism::(anonymous namespace)::FloatPolicy, 3>(int)", 0.5, 0.6),
          ("void at::native::indexFuncLargeIndex<float>(x)", 0.6, 0.7),
          ("Memcpy HtoD (Pageable -> Device)", 0.1, 0.4),
          ("void at::native::reduce_kernel<512>(y)", 4.5, 4.6)]


def test_trace_readers():
    run = _run(spans=SPANS, device_events=EVENTS)
    assert read("fit_ms", run) == pytest.approx(2000.0)
    # (4 - 0.5 - 1) + (6 - 0.5 - 3), over two calls
    assert read("decompose_self_ms", run) == pytest.approx(2500.0)
    assert read("mttkrp_ms", run) == pytest.approx(20.0)  # 0.2 s over 10 iterations
    bound_ms = 1.1034
    assert read("mttkrp_roofline", run) == pytest.approx(bound_ms / 20.0 * 100, rel=1e-3)
    assert read("iter_mfu", run) == pytest.approx(bound_ms / 1000.0 * 100, rel=1e-3)
    assert read("device_idle_frac", run) == pytest.approx(1 - 0.6 / 10)


def test_mttkrp_ms_counts_only_the_iterations():
    # quant_error's COO MTTKRP after the last iteration launches the same
    # index_add kernel; a kernel that straddles a span's end counts to that end
    events = EVENTS + [("void at::native::indexFuncLargeIndex<float>(x)", 8.5, 8.7),
                       ("void prism::task_kernel<prism::FloatPolicy, 5>(int)", 4.9, 5.2)]
    run = _run(spans=SPANS, device_events=events)
    assert read("mttkrp_ms", run) == pytest.approx(30.0)  # (0.2 + 0.1) s over 10 iterations
    assert read("mttkrp_ms", _run(spans=SPANS[:3], device_events=events)) is None


def test_trace_readers_find_nothing_in_an_untraced_run():
    run = _run()
    for name in ("fit_ms", "decompose_self_ms", "mttkrp_ms", "mttkrp_roofline", "iter_mfu",
                 "device_idle_frac"):
        assert read(name, run) is None


def test_busy_idle_and_top_ops():
    busy = devtrace.busy_intervals(EVENTS, 0.0, 10.0)
    assert busy == [(0.1, 0.4), (0.5, 0.7), (4.5, 4.6)]
    idle = dict(devtrace.idle_by_host_span(busy, 0.0, 10.0, SPANS))
    assert idle["cp_als.fit"] == pytest.approx(1.0 + 3.0)
    assert sum(idle.values()) == pytest.approx(10.0 - 0.6)
    top = devtrace.top_ops(EVENTS, 0.0, 10.0)
    assert top[0] == ("Memcpy HtoD (Pageable -> Device)", pytest.approx(0.3))
    assert ("void prism::task_kernel<prism::FloatPolicy, 3>", pytest.approx(0.1)) in top
