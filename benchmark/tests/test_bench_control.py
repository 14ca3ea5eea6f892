"""The correctness check fails what it must, at a size a test run holds:
the control (the reference in TF32, the precision below the cells' float32,
run in the program's place) and the timed path broken underneath a run on
the CPU (a step that returns its state unchanged; a velocity altered where
the step produces it, by a part in 10^3).  A sound run of the same size passes."""

from __future__ import annotations

import pytest

from conftest import small_spec

from benchmark.check import verdict
from benchmark.harness import Cell, run_cell
from benchmark.readings import control_capture

CELLS = ["cavity_ne85184.explicit"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    spec = small_spec(cell, segment=8, first=3, sampled=2)
    c = Cell(spec, "cpu")
    ref, ctrl = c.reference("f64"), c.reference("tf32")
    developed = c.developed()
    for seed in (3, 4):
        start = c.start(seed, developed)
        samples = c.samples(seed)
        plan = c.plan(samples)
        numbers = c.judge(ref, control_capture(ctrl, start, plan, max(plan)), start, samples)
        assert not verdict(numbers, spec.limits)[0], numbers


def _unchanged(step):
    def broken(self, d, state):
        _, stats = step(self, d, state)
        return state, stats
    return broken


def _altered(step):
    def broken(self, d, state):
        new, stats = step(self, d, state)
        return type(new)(new[0] * (1 + 1e-3), *new[1:]), stats
    return broken


@pytest.mark.parametrize("fault", [None, "unchanged", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_step_is_not_correct(cell, fault, monkeypatch):
    from cfd_with_cuda_tpu_torch.solvers.explicit_bch import ExplicitBCHSolver as cls

    if fault:
        wrap = {"unchanged": _unchanged, "altered": _altered}[fault]
        monkeypatch.setattr(cls, "_time_step", wrap(cls._time_step))
    spec = small_spec(cell, segment=5, first=2, sampled=1)
    out = run_cell(cell, 9, 0.01, False, device="cpu", spec=spec, log=lambda *a, **k: None)
    assert out["correct"] is (fault is None), out["check"]
