"""The controls of the correctness check: the reference in fp8 put in the
program's place (and, for training, half of the batch left out) must read
above each cell's limit where the program reads below it.  On the CPU at a
tiny size the machinery and the ordering; on the card (``cuda``) at the
cells' own sizes, on three seeds, as ``portbench.control`` reads them."""

from __future__ import annotations

import time

import pytest

from conftest import tiny_cell, tiny_ctx
from portbench import spec
from portbench.runtime import Context

SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


def _control(cell, ctx):
    res = spec.driver(cell["config"]["driver"]).run(ctx)
    return res["checks"], res["controls"]


def test_training_controls_read_above_the_program():
    cell = tiny_cell("bert-base.mlm-s512")
    checks, controls = _control(cell, tiny_ctx(cell, control=True, seconds=0.2))
    assert set(controls) == {"fp8", "half_batch"}
    for name in ("fp8", "half_batch"):
        assert controls[name]["grad_gap"]["value"] > 3 * checks["grad_gap"]["value"], name


@pytest.mark.cuda
@pytest.mark.parametrize("name", spec.names("workloads"))
def test_control_fails_at_the_cells_size(card, name):
    cell = spec.cell(name)
    for seed in SEEDS:
        ctx = Context(cell=cell, seed=seed, seconds=10.0, trace=False, device=card,
                      t_start=time.perf_counter(), control=True)
        checks, controls = _control(cell, ctx)
        assert all(c["value"] <= c["limit"] for c in checks.values()), (seed, checks)
        for ctrl in controls.values():
            assert any(c["value"] > c["limit"] for c in ctrl.values()), (seed, ctrl)
