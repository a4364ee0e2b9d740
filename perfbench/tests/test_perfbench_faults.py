"""A run of each cell, past the look for a card, on the CPU at a tiny size: sound,
and with the timed path broken underneath, where `correct` must come out false.
The cells run on one card, so no exchange between cards can be left out."""
import time

import pytest
import torch

from perfbench import harness, reference
from perfbench.tests._tiny import SIZES, tiny_cell

CELLS = sorted(SIZES)


def _run(cell, seed=2**31 + 11):
    return harness.run(cell, seed, 0.3, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = _run(tiny_cell(name))
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1, out
    assert list(out)[-1] == "check"
    assert all(v["value"] <= v["limit"] for v in out["check"].values())


def _patch_ops(monkeypatch, alter_inputs=None, alter_output=None):
    """Wrap both kernel ops where the engines call them."""
    from repro_torch.kernels import ops
    for name in ("mttkrp_kernel_op", "mttkrp_fixed_kernel_op"):
        original = getattr(ops, name)

        def wrapped(factors, task_chunk, coords_rel, values, *a, _f=original, **kw):
            if alter_inputs is not None:
                values = alter_inputs(values)
            out = _f(factors, task_chunk, coords_rel, values, *a, **kw)
            return out if alter_output is None else alter_output(out)
        monkeypatch.setattr(ops, name, wrapped)


def _half_the_nonzeros(values):
    v = values.clone()
    v[:, 1::2] = 0
    return v


def _state_unchanged(monkeypatch):
    """Every mode update returns the factor it started from."""
    from repro_torch.core import cpals
    from repro_torch.engine import registry
    held = {}
    call = registry.Engine.__call__

    def recording(self, factors, mode):
        held["state"] = factors[mode]
        return call(self, factors, mode)

    def unchanged(f, norm):
        return held["state"], torch.ones(f.shape[1], dtype=f.dtype, device=f.device)
    monkeypatch.setattr(registry.Engine, "__call__", recording)
    monkeypatch.setattr(cpals, "_normalize", unchanged)


def _raises(monkeypatch):
    """Every decomposition after set-up's warm one raises."""
    from repro_torch.core import cpals
    calls = []
    init = cpals.init_factors

    def boom(*a, **kw):
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("planted fault")
        return init(*a, **kw)
    monkeypatch.setattr(cpals, "init_factors", boom)


FAULTS = {
    "state_unchanged": _state_unchanged,
    # half of the nonzeros left out, the sum of the rest doubled (the mean of the half)
    "half_left_out": lambda mp: _patch_ops(
        mp, alter_inputs=_half_the_nonzeros,
        alter_output=lambda out: out * 2),
    # the first row of every spMTTKRP output negated where the op produces it
    "answer_altered": lambda mp: _patch_ops(mp, alter_output=_row_negated),
    "decomposition_raises": _raises,
}


def _row_negated(out):
    out = out.clone()
    out[0] = -out[0]
    return out


def _one_entry_off(out):
    out = out.clone()
    out[0, 0] = out[0, 0] * 1.01
    return out


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    FAULTS[fault](monkeypatch)
    out = _run(tiny_cell(name))
    assert out["correct"] is False, out


@pytest.mark.parametrize("name", ["nell2.kernel", "lbnl.kernel"])
def test_one_entry_off_by_a_percent_is_not_correct_in_the_float_cells(monkeypatch, name):
    """The float cells' limits sit far enough under the control to catch one
    spMTTKRP entry off by 1% (the fixed format's own rounding moves factors more)."""
    _patch_ops(monkeypatch, alter_output=_one_entry_off)
    assert _run(tiny_cell(name))["correct"] is False


def test_the_reference_itself_passes_in_the_programs_place(monkeypatch):
    """The check is not refused by construction: the float64 reference, put where
    the program's decompositions come from, reads zero."""
    cell = tiny_cell("nell2.kernel")

    def ref_decompose(self, index):
        return reference.cp_als_ref(
            torch.from_numpy(self.coords), torch.from_numpy(self.values), self.shape,
            self.rank, self.n_iters, harness.decomposition_seed(self.seed, index))
    monkeypatch.setattr(harness.Program, "decompose", ref_decompose)
    out = _run(cell)
    assert out["correct"] and all(v["value"] == 0 for v in out["check"].values())


@pytest.mark.parametrize(("name", "number"), [("lbnl.kernel", "diff_gap"),
                                              ("lbnl.fixed-int15-12", "step_diff_gap")])
def test_a_subsampled_difference_is_not_correct(monkeypatch, name, number):
    """Each iteration's mean absolute difference, taken over every other nonzero
    only, fails the cell's difference number: the factors, λ and fit never read it."""
    from repro_torch.core import cpals
    original = cpals.avg_abs_diff

    def half(st, factors, lam, *, coo=None, **kw):
        coords, values = coo
        return original(st, factors, lam, coo=(coords[::2], values[::2]), **kw)
    monkeypatch.setattr(cpals, "avg_abs_diff", half)
    out = _run(tiny_cell(name))
    assert out["correct"] is False and out["check"][number]["value"] > \
        out["check"][number]["limit"], out["check"]
