"""Port parity: the entry points (kubeflow_tpu_torch/graft_entry.py)
against the JAX package's ``__graft_entry__.py``.

The mesh factorings equal the JAX ones; ``dryrun_multichip(8)`` and the
16-shard ``_dryrun_composed`` (stages, seq, expert and tensor all 2 in one
step) run on ``["cpu"] * n`` and print the JAX entry's ``OK`` lines with the
same mesh dicts; without a card the default devices raise."""

import os
import re
import subprocess
import sys

import pytest
import torch

from kubeflow_tpu_torch import graft_entry as ge

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import __graft_entry__ as jge  # noqa: E402


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16, 32])
def test_mesh_factors_match_jax(n):
    assert ge._mesh_factors(n) == jge._mesh_factors(n)
    assert ge._composed_mesh_factors(n) == jge._composed_mesh_factors(n)


def _mesh_dict(line: str) -> dict:
    return eval(re.search(r"mesh=(\{[^}]*\})", line).group(1))  # noqa: S307 — our own print


def test_dryrun_multichip_8_shards_prints_both_ok_lines(capsys):
    ge.dryrun_multichip(8, ["cpu"] * 8)
    lines = capsys.readouterr().out.splitlines()
    multi = next(x for x in lines if x.startswith("dryrun_multichip OK: mesh="))
    composed = next(x for x in lines if x.startswith("dryrun_composed OK: mesh="))
    f = jge._mesh_factors(8)
    want = {"data": f["data"], "stages": 1, "fsdp": f["fsdp"], "seq": 1, "expert": 1,
            "tensor": f["tensor"]}
    assert _mesh_dict(multi) == want
    assert _mesh_dict(composed) == {"data": 1, "stages": 2, "fsdp": 1, "seq": 2,
                                    "expert": 2, "tensor": 1}
    assert "(pp stages=2, seq-parallel, expert-parallel)" in composed
    assert any(x.startswith("dryrun_composed note: at 16 devices") for x in lines)
    for line in (multi, composed):
        assert float(line.rsplit("loss=", 1)[1]) > 0


def test_dryrun_composed_16_shards_composes_four_axes(capsys):
    loss = ge._dryrun_composed(16, ["cpu"] * 16)
    out = capsys.readouterr().out
    assert "dryrun_composed OK" in out and "note" not in out
    mesh = _mesh_dict(out)
    assert [mesh[a] for a in ("stages", "seq", "expert", "tensor")] == [2, 2, 2, 2]
    assert loss == loss and 0 < loss < 20


def test_default_devices_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default devices are its shards")
    with pytest.raises(RuntimeError, match="no visible card"):
        ge.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="cuda"):
        ge.entry()
    r = subprocess.run([sys.executable, "-m", "kubeflow_tpu_torch.graft_entry", "2"],
                       cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "no visible card" in r.stderr
    assert "OK" not in r.stdout


def test_entry_is_a_bert_base_forward():
    fn, (params, ids, mask) = ge.entry("cpu")
    assert tuple(ids.shape) == (8, 128) and tuple(mask.shape) == (8, 128)
    assert params["layers"]["attn_qkv_kernel"].shape == (12, 768, 3, 12, 64)
    logits = fn(params, ids[:1, :8], mask[:1, :8])
    assert tuple(logits.shape) == (1, 8, 30522) and bool(torch.isfinite(logits).all())
