"""Nothing the benchmark runs imports JAX, jaxlib, Flax or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the plain reference imports nothing of the program."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

from conftest import REPO

BLOCKED = {"jax", "jaxlib", "flax", "kubeflow_tpu"}
ROOT = os.path.join(REPO, "portbench")


def _sources(sub=""):
    for d, dirs, files in os.walk(os.path.join(ROOT, sub)):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_import(path):
    for name in _imports(path):
        assert name.split(".")[0] not in BLOCKED, f"{path} imports {name}"


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_reference_imports_nothing_of_the_program(path):
    for name in _imports(path):
        assert name.split(".")[0] in {"__future__", "contextlib", "math", "typing", "torch"}, (
            f"{path} imports {name}")


def test_a_run_loads_no_jax():
    """A whole tiny run in a fresh process, the driver and the port's
    trainer, model and kernels' modules loaded: no blocked top-level name
    in sys.modules afterwards (what the harness checks before it prints)."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from conftest import tiny_cell, tiny_ctx\n"
        "from portbench import spec, runtime\n"
        "import portbench.run\n"
        "for name in ('bert-base.mlm-s512', 'bert-base.mlm-s128'):\n"
        "    c = tiny_cell(name)\n"
        "    spec.driver(c['config']['driver']).run(tiny_ctx(c, seconds=0.5))\n"
        "print('BLOCKED', runtime.blocked_modules())\n"
    ) % (REPO, os.path.join(ROOT, "tests"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "BLOCKED []" in r.stdout


def test_run_refuses_without_a_card(tmp_path):
    """No card: a non-zero exit and no result.  In a checkout of the
    benchmark alone (no port), the same."""
    import shutil

    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    cmd = [sys.executable, "-m", "portbench.run", "--workload", "bert-base.mlm-s128",
           "--seed", "1", "--seconds", "1", "--trace", "0"]
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
    shutil.copytree(ROOT, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    r = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
