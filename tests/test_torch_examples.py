"""The port's example drivers (`repro_torch.examples`) against the JAX
package's `examples/` on the CPU.

`decompose_tensor` on TABLE1 nell2 (rank 10, 2 iterations, the 256 KiB
plan) through every engine is held to `repro.cp_als` on the same plan and
engine (the port's `kernel` to the reference's `chunked`): fit and diff
within 1e-6 (float) and 1e-5 + 1e-3·|ref| (fixed point), the tolerances of
the earlier slices.  The JAX examples run in process through `runpy`,
unedited; their printed lines (times aside) must be the port's, and the
quickstart's four results (`kernel` in the place of `pallas`) must match
theirs at the same tolerances.  The autotuned run is compared under one
timing seam (`autotune._time_backend` in both packages), as in
tests/test_torch_autotune.py.
"""
import ast
import functools
import os
import re
import runpy
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.core as ref_core
from repro.core import table1_tensor
from repro.engine import autotune as rauto
from repro_torch.engine import autotune
from repro_torch.examples import decompose_tensor, quickstart

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
RANK, ITERS = 10, 2
FIT_ATOL = 1e-6
FIXED_ATOL, FIXED_RTOL = 1e-5, 1e-3
ENGINES = ("ref", "chunked", "kernel", "fixed", "alto", "csf", "hetero", "distributed")
#: The reference engine each of the port's is held to.
REFERENCE_ENGINE = {"kernel": "chunked"}
TORCHRUN_TIMEOUT = 180
#: Fits and diffs of the 2-rank run against one process's (the tolerance
#: of tests/test_torch_distributed.py: the ranks sum in another order).
LAUNCHED_ATOL = 1e-5
#: `main` under the launcher, with rank 0's results printed in full.
_LAUNCHED_MAIN = textwrap.dedent("""
    import os, sys
    from repro_torch.examples import decompose_tensor
    results = []
    run = decompose_tensor.run
    decompose_tensor.run = lambda args, device: results.append(run(args, device)) or results[-1]
    rc = decompose_tensor.main(sys.argv[1:])
    if os.environ["RANK"] == "0":
        print("results", repr(results[0].fit_history + results[0].diff_history), flush=True)
    sys.exit(rc)
""")
#: Seam timings (ms) per candidate and mode: every mode has its own winner.
TIMES_MS = {"alto": (3.0, 5.0, 4.0), "chunked": (2.0, 6.0, 7.0), "csf": (4.0, 4.5, 4.4),
            "hetero": (5.0, 1.0, 6.0), "ref": (6.0, 7.0, 2.5)}
#: Times in the printed lines, the only thing that may differ besides names.
_TIMES = re.compile(r"(wall=|t/iter=|\()\d+\.\d+s")


def _argv(engine, *extra):
    return ["--tensor", "nell2", "--iters", str(ITERS), "--engine", engine, *extra]


def _run_port(engine):
    """`decompose_tensor`'s run on the CPU; the one-rank group that the
    distributed engine makes in this process is destroyed again."""
    try:
        return decompose_tensor.run(decompose_tensor.parse_args(_argv(engine)), CPU)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@functools.cache
def _reference(engine):
    st = table1_tensor("nell2")
    plan = ref_core.decide_partition(st, RANK, mem_bytes=256 * 1024, rank_axis=RANK)
    return ref_core.cp_als(st, RANK, n_iters=ITERS, engine=engine, seed=0,
                           chunk_shape=plan.chunk_shape, capacity=plan.capacity)


def _jax_example(path, argv, capsys):
    """Run a JAX example unedited, in process; returns its stdout."""
    capsys.readouterr()
    old = sys.argv
    sys.argv = [path, *argv]
    try:
        runpy.run_path(str(REPO / path), run_name="__main__")
    finally:
        sys.argv = old
    return capsys.readouterr().out


def _assert_close(got, want, fixed):
    for g, w in zip(got.fit_history + got.diff_history, want.fit_history + want.diff_history,
                    strict=True):
        tol = FIXED_ATOL + FIXED_RTOL * abs(w) if fixed else FIT_ATOL
        assert abs(g - w) <= tol, (got.fit_history, got.diff_history,
                                   want.fit_history, want.diff_history)


@pytest.mark.parametrize("engine", ENGINES)
def test_decompose_matches_reference(engine, capsys):
    res = _run_port(engine)
    out = capsys.readouterr().out
    assert res.engine == engine
    assert sum(line.startswith("  iter ") for line in out.splitlines()) == ITERS
    _assert_close(res, _reference(REFERENCE_ENGINE.get(engine, engine)), engine == "fixed")


def test_decompose_prints_the_reference_lines(capsys):
    """Times aside, `--engine ref` prints what the JAX example prints."""
    want = _jax_example("examples/decompose_tensor.py", _argv("ref"), capsys)
    assert decompose_tensor.main([*_argv("ref"), "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert [ln for ln in got.splitlines() if ln.startswith(("[decompose] nell2:",
                                                            "[decompose] plan:"))] == \
        [ln for ln in want.splitlines() if ln.startswith(("[decompose] nell2:",
                                                          "[decompose] plan:"))]
    assert _TIMES.sub(r"\1", got) == _TIMES.sub(r"\1", want)


def test_quickstart_matches_reference(monkeypatch, capsys):
    """The JAX quickstart's four rows, its `cp_als` results captured, against
    the port's: `kernel` against `pallas`."""
    captured = []

    def recording(*args, **kwargs):
        captured.append(ref_core_cp_als(*args, **kwargs))
        return captured[-1]

    ref_core_cp_als = ref_core.cp_als
    monkeypatch.setattr(ref_core, "cp_als", recording)
    want_out = _jax_example("examples/quickstart.py", [], capsys)
    monkeypatch.undo()
    got = quickstart.run(CPU)
    got_out = capsys.readouterr().out
    assert list(got) == ["ref", "chunked", "fixed", "kernel"] and len(captured) == 4
    for (name, res), want in zip(got.items(), captured, strict=True):
        assert want.engine == ("pallas" if name == "kernel" else name)
        _assert_close(res, want, name == "fixed")
    # The same lines, times aside and `kernel` in `pallas`'s place.
    assert _TIMES.sub(r"\1", got_out) == \
        _TIMES.sub(r"\1", want_out).replace("engine=pallas  ", "engine=kernel  ")


def _seam(name, engine, factors, mode, *, warmup, reps):
    return TIMES_MS[name][mode % 3] * 1e-3


def test_autotuned_decompose_cold_then_warm(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(autotune, "_time_backend", _seam)
    monkeypatch.setattr(rauto, "_time_backend", _seam)
    store = ["--store", str(tmp_path / "port.json"), "--device", "cpu"]
    want = _jax_example("examples/decompose_tensor.py",
                        [*_argv("auto"), "--store", str(tmp_path / "ref.json")], capsys)
    assert decompose_tensor.main([*_argv("auto"), *store]) == 0
    cold = capsys.readouterr().out
    assert decompose_tensor.main([*_argv("auto"), *store]) == 0
    warm = capsys.readouterr().out

    def line(out, prefix):
        return [ln for ln in out.splitlines() if ln.startswith(prefix)]

    assert line(cold, "  winners:") == line(want, "  winners:") == line(warm, "  winners:")
    assert re.search(r"source=measured probes=[1-9]", line(cold, "[decompose] tuning:")[0])
    assert "probes=0" in line(warm, "[decompose] tuning:")[0]
    assert line(cold, "[decompose] engine=")[0].split()[1] == \
        line(want, "[decompose] engine=")[0].split()[1]


def _table_rows(text):
    """backend name → its chunked, fixed-point, lossless, presets and min
    devices columns (the descriptions name each package's own hardware)."""
    rows = {}
    for ln in text.splitlines()[2:]:
        cells = [c.strip() for c in ln.strip("|").split("|")]
        rows[cells[0].strip("`")] = cells[1:6]
    return rows


def test_list_backends_matches_reference(capsys):
    want = _table_rows(_jax_example("examples/decompose_tensor.py", ["--list-backends"], capsys))
    assert decompose_tensor.main(["--list-backends"]) == 0
    got = _table_rows(capsys.readouterr().out)
    assert "kernel" in got and "pallas" not in got
    assert {("pallas" if n == "kernel" else n): cols for n, cols in got.items()} == want


@pytest.mark.parametrize("module, argv", [(decompose_tensor, _argv("ref")), (quickstart, [])],
                         ids=["decompose_tensor", "quickstart"])
def test_no_card_without_device_exits_1(module, argv, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert module.main(argv) == 1
    out, err = capsys.readouterr()
    assert "no CUDA device" in err and "Traceback" not in err
    assert "iter " not in out and "engine=" not in out


def test_torchrun_two_gloo_ranks():
    """Two gloo ranks under torch.distributed.run: rank 0 alone prints, and
    its results (`run`'s return, kept by a wrapper around `main`) are those
    of the reference `chunked` run."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "--no-python", sys.executable, "-c", _LAUNCHED_MAIN, *_argv("distributed"),
         "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=TORCHRUN_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.splitlines()
    assert sum(ln.startswith("[decompose] nell2:") for ln in lines) == 1
    assert sum(ln.startswith("  iter ") for ln in lines) == ITERS
    [results] = [ast.literal_eval(ln.removeprefix("results ")) for ln in lines
                 if ln.startswith("results ")]
    want = _reference("chunked")
    np.testing.assert_allclose(results, want.fit_history + want.diff_history,
                               rtol=0, atol=LAUNCHED_ATOL)
