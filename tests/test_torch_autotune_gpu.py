"""The autotuner (`engine="auto"`) on the card: it dispatches to the
backends that launch the float CUDA kernel, a warm store skips the probes,
the device fingerprint keeps CPU and CUDA entries apart, and a kernel that
cannot be built or launched, or any other failure of a candidate that
launches a kernel, raises out of the tuner instead of being skipped as a
slow candidate.

Run on a machine with an NVIDIA GPU and nvcc:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_autotune_gpu.py

Elsewhere every test skips (the card is looked for inside a fixture).
"""
import pytest
import torch

import repro_torch as rt
from repro_torch.engine import EngineContext, PlanCache
from repro_torch.kernels import _build, mttkrp_fixed_kernel, mttkrp_kernel
from repro_torch.kernels import ops as kops

pytestmark = pytest.mark.gpu

RANK = 10
#: Large enough that the plain PyTorch chunked op is several times slower
#: than the kernel (13× at NELL-2's size on an H100).
MID = dict(shape=(6000, 5000, 9000), nnz=8_000_000)
FLOAT_KERNEL_BACKENDS = {"kernel", "hetero"}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def mid(cuda):
    st = rt.random_tensor(MID["shape"], MID["nnz"], seed=0)
    plan = rt.decide_partition(st, RANK, mem_bytes=256 * 1024, rank_axis=RANK)
    return st, dict(chunk_shape=plan.chunk_shape, capacity=plan.capacity)


def _store(tmp_path, name="autotune.json"):
    return rt.TuningStore(tmp_path / name)


def test_auto_dispatches_to_the_float_kernel(cuda, mid, tmp_path):
    st, chunking = mid
    eng = rt.build_engine(st, "auto", RANK, plans=PlanCache(), formats=rt.FormatCache(),
                          tune=rt.TunePolicy(store=_store(tmp_path)), **chunking)
    rep = eng.report
    assert rep.candidates == ["alto", "chunked", "csf", "hetero", "kernel", "ref"]
    assert rep.skipped == {} and rep.n_probes == 6 * st.ndim
    assert set(rep.winners.values()) <= FLOAT_KERNEL_BACKENDS, rep.summary()
    before, fixed_before = mttkrp_kernel.launches, mttkrp_fixed_kernel.launches
    res = rt.cp_als(st, RANK, 2, engine=eng)
    assert mttkrp_kernel.launches - before == 2 * st.ndim
    assert mttkrp_fixed_kernel.launches == fixed_before
    assert res.engine == eng.name and res.tune_report is rep
    assert res.factors[0].is_cuda


def test_cold_then_warm_on_a_temporary_store(cuda, mid, tmp_path):
    st, chunking = mid
    cands = ("kernel", "chunked", "ref")
    kw = dict(plans=PlanCache(), **chunking)
    cold = rt.build_engine(st, "auto", RANK, tune=rt.TunePolicy(candidates=cands,
                                                                store=_store(tmp_path)), **kw)
    assert cold.report.source == "measured" and cold.report.n_probes == 3 * st.ndim
    assert set(cold.report.winners.values()) == {"kernel"}
    warm = rt.build_engine(st, "auto", RANK, tune=rt.TunePolicy(candidates=cands,
                                                                store=_store(tmp_path)), **kw)
    assert (warm.report.source, warm.report.n_probes) == ("persisted", 0)
    assert warm.report.winners == cold.report.winners
    assert warm.report.timings == cold.report.timings
    factors = rt.init_factors(st.shape, RANK)
    before = mttkrp_kernel.launches
    for mode in range(st.ndim):
        torch.testing.assert_close(warm(factors, mode), cold(factors, mode), rtol=1e-4,
                                   atol=1e-4)
    assert mttkrp_kernel.launches - before == 2 * st.ndim


def test_cuda_fingerprint_keeps_cpu_and_cuda_entries_apart(cuda, tmp_path):
    st = rt.table1_tensor("nell2")
    store_path = tmp_path / "shared.json"
    pol = dict(candidates=("chunked", "ref"), store=str(store_path))
    on_cpu = rt.build_engine(st, "auto", RANK, device="cpu", tune=rt.TunePolicy(**pol))
    on_card = rt.build_engine(st, "auto", RANK, tune=rt.TunePolicy(**pol))
    assert on_cpu.report.source == on_card.report.source == "measured"
    entries = rt.TuningStore(store_path).entries()
    assert sorted(dict(e.key.device)["backend"] for e in entries) == ["cpu", "cuda"]
    kinds = {dict(e.key.device)["backend"]: dict(e.key.device)["device_kind"] for e in entries}
    assert kinds == {"cpu": "cpu", "cuda": torch.cuda.get_device_name(0)}
    for device in ("cpu", None):
        warm = rt.build_engine(st, "auto", RANK, device=device, tune=rt.TunePolicy(**pol))
        assert warm.report.source == "persisted"
    fp = rt.engine.device_fingerprint()
    assert fp["backend"] == "cuda" and fp["device_count"] == str(torch.cuda.device_count())
    assert fp["cuda"] == str(torch.version.cuda) and fp["torch"] == torch.__version__


def _break_build(monkeypatch, tmp_path):
    """nvcc that fails, into an empty build directory, nothing loaded."""
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_nvcc", lambda: "/bin/false")


def _break_launch(monkeypatch, tmp_path):
    """The MTTKRP kernels' C entries refuse every launch."""
    class Lib:
        @staticmethod
        def prism_cuda_error_string(rc):
            return b"refused for the test"

    symbol = _build._symbol

    def refusing(source, *args):
        if source in ("mttkrp", "mttkrp_fixed"):
            return Lib, lambda *_: 1
        return symbol(source, *args)

    monkeypatch.setattr(_build, "_symbol", refusing)


@pytest.mark.parametrize("fault", ["build", "launch"])
@pytest.mark.parametrize("candidates", [None, ("ref", "hetero"), ("ref", "fixed:int15-12")],
                         ids=["default", "hetero", "fixed"])
def test_kernel_failure_raises_out_of_auto(cuda, monkeypatch, tmp_path, fault, candidates):
    st = rt.random_tensor((40, 30, 50), 1500, seed=3)
    {"build": _break_build, "launch": _break_launch}[fault](monkeypatch, tmp_path)
    budget = 1.0 if candidates and "fixed:int15-12" in candidates else None
    before = mttkrp_kernel.launches
    with pytest.raises(rt.KernelError, match="nvcc failed" if fault == "build" else "refused"):
        rt.build_engine(st, "auto", 6, plans=PlanCache(), formats=rt.FormatCache(),
                        chunk_shape=(16, 8, 16), capacity=64, dense_fraction=0.5,
                        tune=rt.TunePolicy(candidates=candidates, accuracy_budget=budget))
    assert mttkrp_kernel.launches == before


def _refuse_in_wrapper(monkeypatch, tmp_path):
    """Both kernel wrappers refuse their arguments with a plain ValueError
    (not a KernelError), as their own argument checks would."""
    def refuse(*args, **kwargs):
        raise ValueError("refused by the wrapper for the test")

    monkeypatch.setattr(kops, "mttkrp_local", refuse)
    monkeypatch.setattr(kops, "mttkrp_fixed_local", refuse)


def _oom_on_resident_arrays(monkeypatch, tmp_path):
    """Building the resident chunked arrays runs out of device memory."""
    def oom(self):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (for the test)")

    monkeypatch.setattr(EngineContext, "device_arrays", oom)


@pytest.mark.parametrize("fault,exc,match", [
    ("wrapper", ValueError, "refused by the wrapper"),
    ("oom", torch.cuda.OutOfMemoryError, "out of memory"),
])
@pytest.mark.parametrize("candidates", [None, ("ref", "hetero"), ("ref", "fixed:int15-12")],
                         ids=["default", "hetero", "fixed"])
def test_any_kernel_candidate_failure_raises_out_of_auto(cuda, monkeypatch, tmp_path, fault, exc,
                                                         match, candidates):
    """On the card a candidate that launches a hand-written kernel is never
    skipped for a failure that is not a KernelError either: it would
    otherwise leave the plain backends to win."""
    st = rt.random_tensor((40, 30, 50), 1500, seed=3)
    {"wrapper": _refuse_in_wrapper, "oom": _oom_on_resident_arrays}[fault](monkeypatch, tmp_path)
    budget = 1.0 if candidates and "fixed:int15-12" in candidates else None
    with pytest.raises(exc, match=match):
        rt.build_engine(st, "auto", 6, plans=PlanCache(), formats=rt.FormatCache(),
                        chunk_shape=(16, 8, 16), capacity=64, dense_fraction=0.5,
                        tune=rt.TunePolicy(candidates=candidates, accuracy_budget=budget))


def test_warm_kernel_winner_that_fails_to_build_raises(cuda, monkeypatch, tmp_path):
    """A persisted kernel winner whose build fails raises out of
    build_engine instead of sending the workload back to the probes."""
    st = rt.random_tensor((40, 30, 50), 1500, seed=3)
    kw = dict(plans=PlanCache(), chunk_shape=(16, 8, 16), capacity=64)
    pol = rt.TunePolicy(candidates=("kernel",), store=_store(tmp_path))
    rt.build_engine(st, "auto", 6, tune=pol, **kw)
    _oom_on_resident_arrays(monkeypatch, tmp_path)
    with pytest.raises(torch.cuda.OutOfMemoryError, match="out of memory"):
        rt.build_engine(st, "auto", 6, tune=pol, **kw)


def test_warm_kernel_winner_with_a_broken_kernel_raises(cuda, monkeypatch, tmp_path):
    """A persisted kernel winner whose kernel no longer builds raises on its
    first call, never falling back to another backend."""
    st = rt.random_tensor((40, 30, 50), 1500, seed=3)
    kw = dict(plans=PlanCache(), chunk_shape=(16, 8, 16), capacity=64)
    pol = rt.TunePolicy(candidates=("kernel",), store=_store(tmp_path))
    rt.build_engine(st, "auto", 6, tune=pol, **kw)
    _break_build(monkeypatch, tmp_path)
    warm = rt.build_engine(st, "auto", 6, tune=pol, **kw)
    assert warm.report.source == "persisted"
    with pytest.raises(rt.KernelError, match="nvcc failed"):
        rt.cp_als(st, 6, 1, engine=warm)


def test_accuracy_budget_probes_the_fixed_kernel(cuda, mid):
    st, chunking = mid
    before = mttkrp_fixed_kernel.launches
    eng = rt.build_engine(st, "auto", RANK, plans=PlanCache(), **chunking,
                          tune=rt.TunePolicy(candidates=("kernel", "fixed:int7", "fixed:int15-12"),
                                             accuracy_budget=1e-2))
    assert mttkrp_fixed_kernel.launches > before
    assert "over accuracy budget" in eng.report.skipped["fixed:int7"]
    assert set(eng.report.errors) >= {"fixed:int7", "fixed:int15-12"}
