"""The port's benchmark harness, `repro_torch.bench`, against the JAX
harness, `benchmarks/`, on the CPU (`--device cpu`), at the suites' --fast
sizes: Table I's rows equal; the serving load byte-identical; Fig. 6's
fits and average absolute differences per (format, locks) on nell2 (float
within 1e-6, fixed point equal: the fixed-point MTTKRP is bit-exact, see
tests/test_torch_fixed.py); Fig. 7's row keys the JAX suite's plus the
port's documented ones, with a warm autotune of 0 probes; Figs. 8/9's
times positive; the CLI's exit codes (2 for an unknown or empty --only
name, 1 for a failed suite or no card, 0 otherwise) and the sweep CLI's
(0, then 3 under --require-warm).  Both harnesses write into `tmp_path`.
"""
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # the JAX harness is the top-level `benchmarks` package
    sys.path.insert(0, str(ROOT))

import benchmarks.common as jcommon  # noqa: E402
import benchmarks.fig6 as jfig6  # noqa: E402
import benchmarks.fig7 as jfig7  # noqa: E402
import benchmarks.serve_bench as jserve  # noqa: E402
import benchmarks.table1 as jtable1  # noqa: E402
from repro_torch.bench import common as tcommon  # noqa: E402
from repro_torch.bench import fig6 as tfig6  # noqa: E402
from repro_torch.bench import fig7 as tfig7  # noqa: E402
from repro_torch.bench import fig8_9 as tfig8_9  # noqa: E402
from repro_torch.bench import serve_bench as tserve  # noqa: E402
from repro_torch.bench import sweep as tsweep  # noqa: E402
from repro_torch.bench import table1 as ttable1  # noqa: E402
from repro_torch.bench.__main__ import main as bench_main  # noqa: E402
from repro_torch.engine import device_fingerprint, device_fingerprint_id  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture
def results(tmp_path, monkeypatch):
    monkeypatch.setattr(jcommon, "RESULTS_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(tcommon, "RESULTS_DIR", str(tmp_path / "torch"))
    return tmp_path


def test_table1_rows_equal_the_reference(results):
    assert ttable1.run() == jtable1.run()
    assert (results / "torch" / "torch_table1.json").is_file()
    assert (results / "jax" / "table1.json").is_file()


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_load_byte_identical(seed):
    got, want = tserve.synthetic_load(30, seed=seed), jserve.synthetic_load(30, seed=seed)
    assert len(got) == len(want) == 30
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape
        for a, b in ((g.coords, w.coords), (g.values, w.values)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_fig6_rows_follow_the_reference(results, monkeypatch):
    """nell2 at --fast: per (format, locks) the fit and average absolute
    difference (rounded as the JAX suite rounds them) match; the autotune
    rows carry the same keys."""
    monkeypatch.setattr(jfig6, "TENSORS", ["nell2"])
    monkeypatch.setattr(tfig6, "TENSORS", ["nell2"])
    got, want = tfig6.run(fast=True, device=CPU), jfig6.run(fast=True)
    assert [(r["tensor"], r["fmt"], r.get("locks")) for r in got] \
        == [(r["tensor"], r["fmt"], r.get("locks")) for r in want]
    for g, w in zip(got, want, strict=True):
        assert set(g) == set(w)
        if g["fmt"] == "autotune":
            continue
        if g["fmt"] == "float":
            assert abs(g["fit"] - w["fit"]) <= 1e-6
            assert abs(g["avg_abs_diff"] - w["avg_abs_diff"]) <= 1e-6
        else:
            assert (g["fit"], g["avg_abs_diff"]) == (w["fit"], w["avg_abs_diff"])
        assert g["time_per_iter_s"] > 0 and g["total_s"] > 0
    assert (results / "torch" / "torch_fig6.json").is_file()


def test_fig7_rows_carry_the_reference_keys(results, monkeypatch):
    """One tensor at --fast: every row has the JAX suite's keys plus
    `PORT_KEYS`; the warm `auto` build makes 0 probes; no peak fraction
    on the CPU; every engine the port times is there."""
    monkeypatch.setattr(jfig7, "prior_eval", lambda *a, **k: {})
    monkeypatch.setattr(tfig7, "FAST_TENSORS", ["nell2"])
    want = jfig7.run(fast=True)
    got = tfig7.run(fast=True, device=CPU)
    base = set(want[0])
    tuned = set(want[-1])
    assert want[-1]["engine"].startswith("auto")
    assert [r["engine"] for r in got[:-1]] == [label for label, _ in tfig7.ENGINES[:-1]]
    for r in got:
        keys = tuned if r["engine"].startswith("auto") else base
        assert set(r) == keys | set(tfig7.PORT_KEYS)
        assert r["peak_fraction"] is None and r["device"] == "cpu"
        assert r["time_all_modes_ms"] > 0 and len(r["time_per_mode_ms"]) == 3
        assert math.isclose(r["time_all_modes_ms"], sum(r["time_per_mode_ms"]))
    auto = got[-1]
    assert auto["engine"].startswith("auto") and auto["tune_warm_probes"] == 0
    assert auto["tune_probes"] > 0
    assert (results / "torch" / "torch_fig7.json").is_file()
    assert (results / "torch" / "torch_fig7_prior.json").is_file()


def test_fig7_bytes_bound():
    """The function's bytes: coordinates and values once, the other
    factors once, the output once."""
    from repro_torch import table1_tensor

    st = table1_tensor("nell2", nnz=8000)
    i0, i1, i2 = st.shape
    assert tfig7.mttkrp_bytes(st, 10, 0) == st.nnz * 16 + (i1 + i2) * 40 + i0 * 40
    assert tfig7.mttkrp_flops(st, 10) == st.nnz * 10 * 4


def test_fig8_9_times_are_positive(results):
    rows = tfig8_9.run(fast=True, device=CPU)
    assert [r["dense_fraction"] for r in rows] == tfig8_9.FRACTIONS
    assert all(r["time_ms"] > 0 and r["speedup_vs_alto"] > 0 for r in rows)
    assert (results / "torch" / "torch_fig8_9.json").is_file()


def test_serve_bench_parity_on_a_small_load():
    payload = tserve.run(6, store=None, max_batch=4, max_wait_ms=5.0, clients=2, device=CPU)
    assert payload["parity_ok"] and payload["parity_max_ratio"] <= 1.0
    assert [r["path"] for r in payload["rows"]] == ["sequential", "batched", "service"]
    assert all(r["throughput"] > 0 for r in payload["rows"])


def _fail(**_kw):
    raise RuntimeError("a failing suite")


@pytest.mark.parametrize(("only", "code"), [
    ("fig6,fig8", 2),   # "fig8" is a typo for "fig8_9"
    ("fig6,", 2),       # a stray trailing comma
    ("table1,fig8_9", 1),  # fig8_9 raises below
    ("table1", 0),
])
def test_cli_exit_codes(results, monkeypatch, capsys, only, code):
    monkeypatch.setattr(tfig8_9, "run", _fail)
    assert bench_main(["--fast", "--device", "cpu", "--only", only]) == code
    out, err = capsys.readouterr()
    if code == 2:
        assert "valid names" in err and "fig8_9" in err
        assert "repro_torch.bench.fig6" not in out  # nothing ran
    if code == 1:
        assert "fig8_9" in err and "a failing suite" in err
    if code == 0:
        assert "all benchmark suites passed: ['table1']" in out


def test_cli_without_a_card_exits_nonzero():
    """`python -m repro_torch.bench` never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.bench", "--fast", "--only", "table1"],
                         capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 1, (out.returncode, out.stderr[-2000:])
    assert "no CUDA device" in out.stderr
    assert "######## repro_torch.bench.table1" not in out.stdout


def test_sweep_cli_exits_0_then_3_under_require_warm(results, tmp_path, capsys):
    argv = ["--device", "cpu", "--config", str(ROOT / "benchmarks" / "sweep_ci.toml"),
            "--store", str(tmp_path / "store.json"), "--max-cells", "1"]
    assert tsweep.main([*argv, "--report", str(tmp_path / "pareto.json")]) == 0
    assert (tmp_path / "pareto.json").is_file()
    assert "on the Pareto front against cpu-host-estimate" in capsys.readouterr().out
    # The next cell is cold: --require-warm sees its probes.
    assert tsweep.main([*argv, "--require-warm"]) == 3
    assert "--require-warm: expected a fully warm store" in capsys.readouterr().err
    assert tsweep.main(["--fingerprint", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == device_fingerprint_id(device_fingerprint(CPU))
