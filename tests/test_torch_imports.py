"""The port stands alone: kubeflow_tpu_torch (and chip_smoke.py) import
neither JAX, nor ml_dtypes, optax, orbax, safetensors, tokenizers, regex or
transformers, nor anything of the JAX package.

A subprocess installs a meta-path finder that refuses ``jax``, ``jaxlib``,
``ml_dtypes``, ``optax``, ``orbax``, ``safetensors`` (the port reads the
format itself), ``tokenizers`` and ``regex`` (the port reads
``tokenizer.json`` itself), ``transformers`` and ``kubeflow_tpu`` (and their
submodules — but not ``kubeflow_tpu_torch``, whose name shares the prefix),
then imports every module of the port, and runs each training worker end
to end as ``python -m`` at a tiny size (so the imports inside its
``main()`` happen under the blocker too); a source scan backs it up for
imports a runtime path might not reach.  The one import the scan lets
through is the ``huggingface`` loader's ``transformers``: that loader IS a
transformers pipeline, imported only when a pod asks for it."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "kubeflow_tpu_torch")
BLOCKED = ("jax", "jaxlib", "ml_dtypes", "optax", "orbax", "safetensors", "tokenizers",
           "regex", "transformers", "kubeflow_tpu")
# (file relative to the repo, module): the huggingface loader's own runtime
THIRD_PARTY_LOADERS = {(os.path.join("kubeflow_tpu_torch", "serving", "runtime_main.py"),
                        "transformers")}

_BLOCKER = """
import importlib.abc, sys
BLOCKED = {blocked!r}

def _blocked(name):
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)

class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if _blocked(name):
            raise ImportError(f"blocked import of {{name}}")
        return None

for name in list(sys.modules):
    if _blocked(name):
        del sys.modules[name]
sys.meta_path.insert(0, Blocker())
"""


def _port_modules():
    """Every Python module of the port (built ``.so`` files are not)."""
    names = []
    for path in _sources():
        rel = os.path.relpath(path, REPO)
        if rel.startswith("kubeflow_tpu_torch"):
            parts = rel[:-len(".py")].split(os.sep)
            names.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return sorted(names)


def test_every_port_module_imports_with_jax_blocked():
    modules = _port_modules()
    for name in ("serving.engine.paged_attention", "serving.engine.scheduler",
                 "serving.engine.kvstore", "serving.engine.faults",
                 "serving.engine.lora", "serving.constrain",
                 "serving.engine.hf_convert", "serving.engine.hf_tokenizer",
                 "serving.explainers", "serving.storage",
                 "ops.attention", "ops.flash_attention",
                 "models.bert", "train.data", "train.trainer", "train.checkpoint",
                 "examples.bert_worker", "utils.jax_platform", "parallel.distributed",
                 "models.mnist", "models.resnet", "models.decoder", "transport.transport",
                 "examples.mnist_worker", "examples.darts_worker",
                 "examples.resnet_ddp_worker", "pipelines", "pipelines.dsl",
                 "pipelines.compiler", "pipelines.artifacts", "pipelines.launcher_main",
                 "examples.gemma_pipeline", "examples.distributed_check",
                 "parallel.profiling", "serving.engine.sharding", "parallel.mesh",
                 "parallel.sharding", "parallel.presets", "ops.shard_map_compat",
                 "ops.ring_attention", "ops.ulysses", "parallel.pipeline", "ops.moe",
                 "models.moe_transformer", "graft_entry", "utils.net", "utils.render",
                 "core.api", "core.conditions", "core.events", "core.controller",
                 "core.kubelet", "core.cluster", "scheduler.topology", "serving.api",
                 "serving.config", "serving.runtimes", "serving.controllers",
                 "serving.graph", "serving.ingress_core", "serving.overload",
                 "serving.router", "serving.autoscaler", "examples.serve_llm",
                 "examples.explain_isvc", "training", "training.api", "training.common",
                 "training.frameworks", "training.client", "tools", "tools.mpi", "katib",
                 "katib.api", "katib.client", "katib.controllers", "katib.collector_main",
                 "katib.dbmanager", "katib.metrics", "katib.obslog", "katib.service",
                 "katib.suggest", "katib.suggest.space", "katib.suggest.grid",
                 "katib.suggest.random_search", "katib.suggest.sobol",
                 "katib.suggest.bayesian", "katib.suggest.tpe", "katib.suggest.cmaes",
                 "katib.suggest.hyperband", "katib.suggest.pbt", "katib.suggest.enas",
                 "katib.suggest.darts", "pipelines.api", "pipelines.persistence",
                 "pipelines.cron", "pipelines.schedule", "pipelines.metadata",
                 "pipelines.workflow", "pipelines.service", "pipelines.client",
                 "core.authz", "platform", "platform.api", "platform.kfam",
                 "platform.controllers", "platform.spawner", "platform.dashboard",
                 "platform.kfadm", "platform.webui"):
        assert f"kubeflow_tpu_torch.{name}" in modules, name
    code = _BLOCKER.format(blocked=BLOCKED) + f"""
import importlib
for name in {modules!r}:
    importlib.import_module(name)
import runpy
sys.argv = ["chip_smoke.py"]
mod = runpy.run_path({os.path.join(REPO, "chip_smoke.py")!r}, run_name="not_main")
bad = sorted(n for n in sys.modules if _blocked(n) and sys.modules[n] is not None)
assert not bad, bad
try:
    import kubeflow_tpu
except ImportError:
    pass
else:
    raise AssertionError("the blocker let kubeflow_tpu through")
print("IMPORTED", len({modules!r}))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-4000:]
    assert f"IMPORTED {len(modules)}" in r.stdout


# each worker run end to end as ``python -m`` at a tiny size, so the imports
# inside its main() (lazy ones included) happen under the blocker
WORKER_RUNS = {
    "mnist_worker": {"TRAIN_STEPS": "1", "BATCH_SIZE": "2"},
    "darts_worker": {"SEARCH_STEPS": "2"},
    "resnet_ddp_worker": {"TRAIN_STEPS": "1", "PER_CHIP_BATCH": "1", "IMAGE_SIZE": "32",
                          "NUM_CLASSES": "10"},
    "resnet_ddp_worker:shim": {"TRAIN_STEPS": "1", "PER_CHIP_BATCH": "1", "IMAGE_SIZE": "32",
                               "NUM_CLASSES": "10", "DDP_TRANSPORT": "shim"},
    "distributed_check": {},
}


@pytest.mark.parametrize("run", sorted(WORKER_RUNS))
def test_worker_runs_with_jax_blocked(run):
    import socket

    module = "kubeflow_tpu_torch.examples." + run.split(":")[0]
    code = _BLOCKER.format(blocked=BLOCKED) + f"""
import runpy
runpy.run_module({module!r}, run_name="__main__")
bad = sorted(n for n in sys.modules if _blocked(n) and sys.modules[n] is not None)
assert not bad, bad
"""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO, TORCH_DEVICE="cpu", MASTER_PORT=str(port),
               **WORKER_RUNS[run])
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "JAX_COORDINATOR_ADDRESS"):
        env.pop(k, None)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.strip().splitlines()[-1].endswith("-OK")


def test_pipeline_steps_run_with_jax_blocked(tmp_path):
    """The Gemma pipeline's three steps, compiled by the port and run by
    the port's launcher at the pipeline's tiny defaults (2 training steps),
    then ``maybe_trace`` over 2 traced steps, all under the blocker: the
    component bodies' own imports (torch and the port, inside each
    function) happen there."""
    code = _BLOCKER.format(blocked=BLOCKED) + f"""
import json, os
from kubeflow_tpu_torch.examples.gemma_pipeline import gemma_pipeline
from kubeflow_tpu_torch.parallel import profiling
from kubeflow_tpu_torch.pipelines import launcher_main
from kubeflow_tpu_torch.pipelines.artifacts import ObjectStore
from kubeflow_tpu_torch.pipelines.compiler import Compiler

root = {str(tmp_path)!r}
ir = Compiler().compile(gemma_pipeline)
args = {{p: d["defaultValue"] for p, d in ir["root"]["inputDefinitions"]["parameters"].items()}}
args["steps"] = 2
store = ObjectStore(os.path.join(root, "objects"))
model = {{"uri": store.uri("b", "model"), "type": "system.Model", "metadata": {{}}}}
for name in ("finetune", "evaluate", "deploy"):
    task = ir["root"]["dag"]["tasks"][name]
    comp = ir["components"][task["componentRef"]]
    ex = ir["deploymentSpec"]["executors"][comp["executorLabel"]]["python"]
    params = {{p: args[ref["componentInputParameter"]]
              for p, ref in task["inputs"]["parameters"].items()}}
    outs = {{a: {{"uri": store.uri("b", a), "type": d["schemaTitle"]}}
            for a, d in comp["outputDefinitions"]["artifacts"].items()}}
    ws = os.path.join(root, name)
    os.makedirs(ws)
    with open(os.path.join(ws, "task.json"), "w") as f:
        json.dump({{"functionName": ex["functionName"], "source": ex["source"],
                   "defaults": ex["defaults"], "parameters": params,
                   "inputArtifacts": {{"model": model}} if name != "finetune" else {{}},
                   "outputArtifacts": outs, "outputParameters": ["Output"],
                   "storeRoot": store.root}}, f)
    assert launcher_main.run(ws) == 0, name
env = {{"TPU_PROFILE_DIR": os.path.join(root, "prof"), "TPU_PROFILE_STEPS": "2"}}
for step in range(3):
    with profiling.maybe_trace(step, environ=env):
        pass
assert os.path.exists(profiling.trace_path(env["TPU_PROFILE_DIR"]))
bad = sorted(n for n in sys.modules if _blocked(n) and sys.modules[n] is not None)
assert not bad, bad
print("STEPS-OK")
"""
    env = dict(os.environ, PYTHONPATH=REPO, TORCH_DEVICE="cpu")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.strip().splitlines()[-1] == "STEPS-OK"


def _component_sources():
    """The component sources the step pods exec, from the port's IR."""
    from kubeflow_tpu_torch.examples.gemma_pipeline import gemma_pipeline
    from kubeflow_tpu_torch.pipelines.compiler import Compiler

    ir = Compiler().compile(gemma_pipeline)
    return {name: ex["python"]["source"]
            for name, ex in ir["deploymentSpec"]["executors"].items()}


@pytest.mark.parametrize("executor", sorted(_component_sources()))
def test_component_source_imports_nothing_of_jax(executor):
    tree = ast.parse(_component_sources()[executor])
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, "a relative import cannot run in a step pod"
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert not any(name == b or name.startswith(b + ".") for b in BLOCKED), (
                f"{executor} imports {name}")


def _sources():
    for root, dirs, files in os.walk(PORT):
        # skip build outputs (_build/) and caches: only the package's sources
        dirs[:] = sorted(d for d in dirs if not d.startswith(("_", ".")))
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_nothing_of_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            if (os.path.relpath(path, REPO), name) in THIRD_PARTY_LOADERS:
                continue
            assert not any(name == b or name.startswith(b + ".") for b in BLOCKED), (
                f"{path}:{node.lineno} imports {name}")
