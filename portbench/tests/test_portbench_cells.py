"""Each cell's path end to end on the CPU at a tiny size against the plain
reference, and the same run with the timed path broken underneath, which
the check must see: a step that leaves its state unchanged, half of the
batch left out (the mean over the rest)."""

from __future__ import annotations

import pytest

from conftest import tiny_cell, tiny_ctx
from portbench import run as prun
from portbench import spec

CELLS = spec.names("workloads")


def _run(cell, **kw):
    ctx = tiny_ctx(cell, **kw)
    res = spec.driver(cell["config"]["driver"]).run(ctx)
    return prun.result(ctx, res, {}, {})


@pytest.mark.parametrize("name", CELLS)
def test_cell_path_against_the_reference(name):
    cell = tiny_cell(name)
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == set(cell["workload"]["end_to_end"])
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_per_layer(name):
    cell = tiny_cell(name)
    out = _run(cell, trace=True)
    assert out["correct"], out["checks"]
    # the CPU has no device records and no peak: only the host's numbers
    assert set(out["metrics"]) <= set(cell["workload"]["per_layer"])
    assert "breakdown" in out and out["device"]["busy_s"] == 0


def test_state_left_unchanged_is_caught(monkeypatch):
    from kubeflow_tpu_torch.train import trainer

    monkeypatch.setattr(trainer.AdamW, "update", lambda self, grads, state, params, grad_norm=None:
                        trainer.global_norm(grads.values()))
    out = _run(tiny_cell("bert-base.mlm-s512"))
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_batch_is_caught(monkeypatch):
    from kubeflow_tpu_torch.models import bert

    real = bert.mlm_loss

    def half(params, config, ids, labels, mask=None, max_predictions=None):
        n = ids.shape[0] // 2
        return real(params, config, ids[:n], labels[:n], mask[:n], max_predictions)

    monkeypatch.setattr(bert, "mlm_loss", half)
    out = _run(tiny_cell("bert-base.mlm-s512"))
    assert not out["correct"], out["checks"]
