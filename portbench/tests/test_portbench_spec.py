"""The harness finds every piece of a cell by name, BENCHMARK.json and the
files agree, and a cell added as new files alone runs with no file of the
benchmark edited."""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import pytest

from conftest import REPO, tiny_cell, tiny_ctx
from portbench import run as prun
from portbench import spec


def test_every_cell_resolves():
    assert spec.names("workloads")
    for name in spec.names("workloads"):
        c = spec.cell(name)
        w = c["workload"]
        assert spec.driver(c["config"]["driver"]).run
        assert w["chips"] == 1
        for metric, mod in c["readers"].items():
            assert callable(mod.read) and mod.UNIT, metric
        assert "setup_s" in w["end_to_end"] and len(w["end_to_end"]) >= 2
        assert w["per_layer"]


def test_benchmark_json_names_the_files():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    assert bench["paths"] == ["portbench"]
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    for c in bench["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        cfg = spec.config(c["name"])
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    for wl in bench["workloads"]:
        w = spec.workload(wl["name"])
        assert (w["config"], w["traffic"], w["chips"], w["why"]) == (
            wl["config"], wl["traffic"], wl["chips"], wl["why"])
        for metric, mod in spec.cell(wl["name"])["readers"].items():
            assert units[metric] == mod.UNIT, metric
    for m in bench["per_layer"] + bench["end_to_end"]:
        for cell in m.get("workloads", []):
            w = spec.workload(cell)
            assert m["name"] in w["end_to_end"] + w["per_layer"], (m["name"], cell)
    for wl in bench["workloads"]:
        w = spec.workload(wl["name"])
        listed = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]
                  if wl["name"] in m.get("workloads", [wl["name"]])]
        assert sorted(listed) == sorted(w["end_to_end"] + w["per_layer"]), wl["name"]


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        spec.workload("no-such-cell")
    with pytest.raises(ValueError):
        spec.workload("../configs/bert-base-uncased")
    with pytest.raises(KeyError):
        spec.reader("no_such_metric.train")


def _digests(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_a_cell_added_as_files_alone_runs(tmp_path, monkeypatch):
    src = os.path.join(REPO, "portbench")
    dst = tmp_path / "portbench"
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(str(dst))
    mix = json.loads((dst / "traffic" / "mlm-s128.json").read_text())
    (dst / "traffic" / "mlm-s64.json").write_text(json.dumps(dict(mix, seq_len=64)))
    (dst / "metrics" / "trained_steps.py").write_text(
        'UNIT = "steps"\n\n\ndef read(run):\n    return float(run.steps) if run.steps else None\n')
    (dst / "workloads" / "bert-base.mlm-s64.json").write_text(json.dumps(
        {"config": "bert-base-uncased", "traffic": "mlm-s64", "chips": 1,
         "end_to_end": ["train_samples_per_s", "setup_s"],
         "per_layer": ["trained_steps.s64", "idle_share.train"],
         "limits": spec.workload("bert-base.mlm-s128")["limits"],
         "why": "a new cell from files alone"}))
    monkeypatch.setattr(spec, "ROOT", str(dst))
    cell = spec.cell("bert-base.mlm-s64")
    tiny = tiny_cell("bert-base.mlm-s128")
    cell["config"] = tiny["config"]
    cell["traffic"] = dict(tiny["traffic"], seq_len=16)
    ctx = tiny_ctx(cell, trace=True)
    res = spec.driver("train").run(ctx)
    out = prun.result(ctx, res, {}, {})
    assert out["correct"], out["checks"]
    assert out["metrics"]["trained_steps.s64"]["value"] > 0
    after = _digests(str(dst))
    assert {k: after[k] for k in before} == before
