"""Each cell's control comes out not correct: the reference computed one precision
below the configuration's, put in the program's place (the float cells: TF32 for
float32), or the program's own lower path switched on (the fixed cell: int7 for
int15-12).  At a tiny size on the CPU; on the card at the cells' own sizes by
`perfbench/control.py`."""
import time

import pytest
import torch

from perfbench import harness, reference
from perfbench.tests._tiny import tiny_cell


@pytest.mark.parametrize("name", ["nell2.kernel", "lbnl.kernel"])
@pytest.mark.parametrize("seed", [5, 2**31 + 3, 2**33 + 1])
def test_tf32_reference_in_the_programs_place_is_not_correct(monkeypatch, name, seed):
    cell = tiny_cell(name)
    precision = cell.traffic["control"]["reference"]
    assert precision == "tf32"

    def lower(self, index):
        return reference.cp_als_ref(
            torch.from_numpy(self.coords), torch.from_numpy(self.values), self.shape,
            self.rank, self.n_iters, harness.decomposition_seed(self.seed, index),
            precision=precision)
    monkeypatch.setattr(harness.Program, "decompose", lower)
    out = harness.run(cell, seed, 0.3, False, "cpu", time.perf_counter())
    assert out["correct"] is False, out


@pytest.mark.parametrize("seed", [5, 2**31 + 3, 2**33 + 1])
def test_int7_path_of_the_program_is_not_correct(seed):
    cell = tiny_cell("lbnl.fixed-int15-12")
    options = cell.traffic["control"]["engine_options"]
    assert options == {"fixed_preset": "int7"}
    cell.traffic = dict(cell.traffic, engine_options=options)
    out = harness.run(cell, seed, 0.3, False, "cpu", time.perf_counter())
    assert out["correct"] is False, out


@pytest.mark.gpu
def test_a_traced_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = harness.run(tiny_cell("lbnl.kernel"), 7, 1.0, True, "cuda:0", time.perf_counter())
    assert out["correct"] and out["device"]["busy_s"] > 0
    assert out["breakdown"]["device_ops"]
