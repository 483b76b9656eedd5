"""Port parity: ``kubeflow_tpu_torch.parallel.profiling`` against the JAX
package's ``parallel/profiling.py``.

``profile_dir``, ``profile_steps`` and which steps ``maybe_trace`` traces
agree with the JAX module for the same environments (unset, empty, set,
N = 1 and 3); the reference's no-op case (tests/test_parity_batch.py:193);
and on the CPU the port writes a Chrome trace that parses and holds one
``train`` annotation per traced step."""

import json
import os

import jax.numpy as jnp
import pytest
import torch

from kubeflow_tpu.parallel import profiling as JP
from kubeflow_tpu_torch.parallel import profiling as TP


def _environs(d: str) -> dict:
    return {"unset": {}, "empty": {"TPU_PROFILE_DIR": ""},
            "set": {"TPU_PROFILE_DIR": d},
            "n1": {"TPU_PROFILE_DIR": d, "TPU_PROFILE_STEPS": "1"},
            "n3": {"TPU_PROFILE_DIR": d, "TPU_PROFILE_STEPS": "3"}}


@pytest.mark.parametrize("case", ["unset", "empty", "set", "n1", "n3"])
def test_settings_and_traced_steps_match_jax(case, tmp_path):
    envs = {pkg: _environs(str(tmp_path / pkg))[case] for pkg in ("jax", "port")}
    assert ((TP.profile_dir(envs["port"]) is None)
            == (JP.profile_dir(envs["jax"]) is None))
    assert TP.profile_steps(envs["port"]) == JP.profile_steps(envs["jax"])
    n = TP.profile_steps(envs["port"])
    traced = {}
    for pkg, mod, work in (("jax", JP, lambda: (jnp.ones(8) * 2).block_until_ready()),
                           ("port", TP, lambda: torch.ones(8) * 2)):
        traced[pkg] = []
        for step in range(n + 2):
            with mod.maybe_trace(step, environ=envs[pkg]) as on:
                traced[pkg].append(on)
                work()
    assert traced["port"] == traced["jax"]
    if TP.profile_dir(envs["port"]) is not None:
        assert traced["port"] == [True] * n + [False, False]
        assert os.path.exists(TP.trace_path(envs["port"]["TPU_PROFILE_DIR"]))
    else:
        assert not any(traced["port"])


def test_maybe_trace_noop_without_env():
    with TP.maybe_trace(0, environ={}) as tracing:
        assert tracing is False


def test_cpu_trace_holds_the_train_step_annotations(tmp_path):
    env = {"TPU_PROFILE_DIR": str(tmp_path / "prof"), "TPU_PROFILE_STEPS": "3"}
    a = torch.randn(64, 64)
    for step in range(5):
        with TP.maybe_trace(step, environ=env):
            (a @ a).relu().sum()
    with open(TP.trace_path(env["TPU_PROFILE_DIR"])) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events]
    assert sorted(n for n in names if n.startswith("train#")) == [
        "train#step_num=0#", "train#step_num=1#", "train#step_num=2#"]
    assert any("matmul" in n or "mm" in n for n in names)
    assert TP._active is None
