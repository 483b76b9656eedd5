"""Port parity: kubeflow_tpu_torch's pipeline SDK (``pipelines/dsl.py`` and
``pipelines/compiler.py``, copies of the JAX-free reference modules) against
the reference's.

The same pipelines, built on each package's ``dsl`` from the same component
source text, must compile to the same IR: the reference's golden files byte
for byte, every refusal with the reference's exception type and message,
and the Gemma pipeline's IR equal to the reference's in everything but the
component sources (the port's bodies train with torch)."""

import copy
import os

import pytest

from kubeflow_tpu.examples.gemma_pipeline import gemma_pipeline as j_gemma
from kubeflow_tpu.pipelines import compiler as JC
from kubeflow_tpu.pipelines import dsl as jdsl
from kubeflow_tpu_torch.examples.gemma_pipeline import gemma_pipeline as t_gemma
from kubeflow_tpu_torch.pipelines import Compiler
from kubeflow_tpu_torch.pipelines import compiler as TC
from kubeflow_tpu_torch.pipelines import dsl as tdsl

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
PACKAGES = {"jax": (jdsl, JC), "port": (tdsl, TC)}


def _library(dsl):
    """The components and pipelines of tests/test_pipelines.py, with their
    source text unchanged, built on ``dsl``."""

    @dsl.component
    def make_data(rows: int, data: dsl.Output[dsl.Dataset]) -> int:
        with open(data.path, "w") as f:
            f.write("x,y\n" * rows)
        data.metadata["rows"] = rows
        return rows

    @dsl.component
    def train(data: dsl.Input[dsl.Dataset], lr: float, model: dsl.Output[dsl.Model],
              metrics: dsl.Output[dsl.Metrics]) -> float:
        with open(data.path) as f:
            n = len(f.readlines())
        acc = min(0.5 + lr * n / 100.0, 0.99)
        with open(model.path, "w") as f:
            f.write(f"weights lr={lr}\n")
        metrics.log_metric("accuracy", acc)
        return acc

    @dsl.component
    def deploy(model: dsl.Input[dsl.Model], name: str = "svc") -> str:
        with open(model.path) as f:
            assert "weights" in f.read()
        return name

    @dsl.component
    def list_shards(n: int) -> list:
        return [f"shard-{i}" for i in range(n)]

    @dsl.component
    def process_shard(shard: str) -> str:
        return shard.upper()

    @dsl.component
    def summarize() -> str:
        return "done"

    @dsl.component
    def merge(values: list) -> str:
        return "|".join(values)

    @dsl.component
    def produce() -> int:
        return 1

    @dsl.component
    def cleanup(x: int) -> int:
        return x

    @dsl.component
    def tidy2() -> int:
        return 0

    @dsl.component
    def noop() -> int:
        return 0

    @dsl.component
    def tidy() -> int:
        return 0

    @dsl.pipeline(name="train-and-deploy", description="golden: artifacts + condition")
    def train_and_deploy(rows: int = 20, lr: float = 0.5, threshold: float = 0.2):
        d = make_data(rows=rows)
        t = train(data=d.outputs["data"], lr=lr)
        with dsl.Condition(t.output > threshold):
            deploy(model=t.outputs["model"]).set_tpu("v5e-4")

    @dsl.pipeline(name="lr-sweep", description="golden: static ParallelFor fan-out")
    def lr_sweep(rows: int = 10):
        d = make_data(rows=rows)
        with dsl.ParallelFor([0.1, 0.9]) as lr:
            train(data=d.outputs["data"], lr=lr)

    @dsl.pipeline(name="bad")
    def fan_in(rows: int = 1):
        d = make_data(rows=rows)
        with dsl.ParallelFor([0.1, 0.2]) as lr:
            t = train(data=d.outputs["data"], lr=lr)
        deploy(model=t.outputs["model"])  # consumes one iteration from outside

    @dsl.pipeline(name="bad-exit-input")
    def exit_input():
        p = produce()
        exit_task = cleanup(x=p.output)
        with dsl.ExitHandler(exit_task):
            produce().set_display_name("guarded")

    @dsl.pipeline(name="bad-exit-cond")
    def exit_cond():
        p = produce()
        with dsl.Condition(p.output > 0):
            exit_task = tidy2()
            with dsl.ExitHandler(exit_task):
                produce().set_display_name("guarded")

    @dsl.pipeline(name="bad-fanin")
    def dynamic_fan_in():
        shards = list_shards(n=2)
        with dsl.ParallelFor(shards.output) as shard:
            p = process_shard(shard=shard)
        process_shard(shard=p.output)

    @dsl.pipeline(name="bad-cloned-source")
    def cloned_source():
        with dsl.ParallelFor([1, 2]) as n:
            shards = list_shards(n=n)
            with dsl.ParallelFor(shards.output) as shard:
                process_shard(shard=shard)

    @dsl.pipeline(name="escaped")
    def escaped():
        shards = list_shards(n=2)
        with dsl.ParallelFor(shards.output) as shard:
            process_shard(shard=shard)
        process_shard(shard=shard)

    @dsl.pipeline(name="exit-in-loop")
    def exit_in_loop():
        shards = list_shards(n=2)
        with dsl.ParallelFor(shards.output) as shard:
            cleanup = summarize()
            with dsl.ExitHandler(cleanup):
                process_shard(shard=shard)

    @dsl.pipeline(name="chained-dynamic")
    def chained_dynamic():
        shards = list_shards(n=2)
        with dsl.ParallelFor(shards.output) as shard:
            inner = list_shards(n=2)
        with dsl.ParallelFor(inner.output) as x:
            process_shard(shard=x)

    @dsl.pipeline(name="collect-outside")
    def collect_outside():
        s = summarize()
        merge(values=dsl.Collected(s.output))

    @dsl.pipeline(name="collect-inside")
    def collect_inside():
        shards = list_shards(n=2)
        with dsl.ParallelFor(shards.output) as shard:
            w = process_shard(shard=shard)
            merge(values=dsl.Collected(w.output))

    @dsl.pipeline(name="collect-in-cond")
    def collect_in_cond():
        shards = list_shards(n=2)
        with dsl.ParallelFor(shards.output) as shard:
            w = process_shard(shard=shard)
        with dsl.Condition(dsl.Collected(w.output) != []):
            summarize()

    @dsl.pipeline(name="collect-cloned")
    def collect_cloned():
        shards = list_shards(n=2)
        with dsl.ParallelFor(["a", "b"]):
            with dsl.ParallelFor(shards.output) as shard:
                w = process_shard(shard=shard)
        merge(values=dsl.Collected(w.output))

    @dsl.pipeline(name="exit-ir")
    def exit_ir():
        cleanup = tidy()
        with dsl.ExitHandler(cleanup):
            a = noop()
            noop().after(a).set_display_name("noop-2")

    @dsl.pipeline(name="static-x-dynamic")
    def static_x_dynamic():
        shards = list_shards(n=2)
        with dsl.ParallelFor(["a", "b"]):
            with dsl.ParallelFor(shards.output) as shard:
                process_shard(shard=shard)

    @dsl.pipeline(name="collect-fanin")
    def collect_fanin(n: int = 3):
        shards = list_shards(n=n)
        with dsl.ParallelFor(shards.output) as shard:
            w = process_shard(shard=shard)
        merge(values=dsl.Collected(w.output))

    return {k: v for k, v in locals().items() if isinstance(v, dsl.Pipeline)}


LIBRARIES = {pkg: _library(dsl) for pkg, (dsl, _) in PACKAGES.items()}

# the compiler's refusals in tests/test_pipelines.py: fan-in (:124), the
# exit handler (:408-432), dynamic ParallelFor (:573-611) and Collected
# (:681-724), with the pattern each reference test matches
REFUSALS = {
    "fan_in": "fan-in",
    "exit_input": "constants or pipeline parameters",
    "exit_cond": "dsl.Condition",
    "dynamic_fan_in": "fan-in",
    "cloned_source": "ParallelFor",
    "escaped": "escaped",
    "exit_in_loop": "exit task",
    "chained_dynamic": "fan-in|inside another",
    "collect_outside": "not inside a dynamic",
    "collect_inside": "OUTSIDE",
    "collect_in_cond": "Condition",
    "collect_cloned": "survive",
}


@pytest.mark.parametrize("name,golden", [("train_and_deploy", "pipeline_train_and_deploy.json"),
                                         ("lr_sweep", "pipeline_lr_sweep.json")])
def test_port_compiler_reproduces_the_reference_goldens(name, golden):
    with open(os.path.join(GOLDEN_DIR, golden)) as f:
        want = f.read()
    assert TC.compile_to_json(LIBRARIES["port"][name]) == want


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_match_the_reference(name):
    """Each package compiles its own build of the same pipeline: both refuse
    it with a ``CompileError`` and the same message."""
    errors = {}
    for pkg, (_, comp) in PACKAGES.items():
        with pytest.raises(comp.CompileError, match=REFUSALS[name]) as info:
            comp.Compiler().compile(LIBRARIES[pkg][name])
        errors[pkg] = info.value
    assert type(errors["port"]) is TC.CompileError
    assert type(errors["port"]).__name__ == type(errors["jax"]).__name__
    assert str(errors["port"]) == str(errors["jax"])


@pytest.mark.parametrize("name", ["exit_ir", "static_x_dynamic", "collect_fanin"])
def test_legal_pipelines_compile_to_the_reference_json(name):
    """Exit handlers, a dynamic loop inside a static one and a ``Collected``
    fan-in: the port's JSON equals the reference's byte for byte."""
    assert (TC.compile_to_json(LIBRARIES["port"][name])
            == JC.compile_to_json(LIBRARIES["jax"][name]))


def _without_sources(ir: dict) -> dict:
    ir = copy.deepcopy(ir)
    for executor in ir["deploymentSpec"]["executors"].values():
        executor["python"]["source"] = None
    return ir


def test_gemma_pipeline_ir_equals_the_reference_but_the_sources():
    port, ref = Compiler().compile(t_gemma), JC.Compiler().compile(j_gemma)
    assert port["schemaVersion"] == ref["schemaVersion"] == TC.IR_SCHEMA == JC.IR_SCHEMA
    assert _without_sources(port) == _without_sources(ref)
    sources = [e["python"]["source"] for e in port["deploymentSpec"]["executors"].values()]
    assert all("kubeflow_tpu_torch" in s or "model.uri" in s for s in sources)
    assert not any("import jax" in s or "kubeflow_tpu." in s for s in sources)
    tasks = port["root"]["dag"]["tasks"]
    assert tasks["deploy"]["conditions"] == [{
        "op": "<", "left": {"taskOutputParameter": {"producerTask": "evaluate",
                                                    "outputParameterKey": "Output"}},
        "right": {"componentInputParameter": "max_perplexity"}}]


def test_component_called_outside_a_pipeline_runs_directly(tmp_path):
    """As tests/test_pipelines.py's case: a port component called outside a
    pipeline is the plain function."""
    out = tdsl.Dataset(uri="")
    out.path = str(tmp_path / "d.csv")
    make_data = tdsl.component(_make_rows)
    assert make_data(rows=3, data=out) == 3
    assert out.metadata["rows"] == 3


def _make_rows(rows: int, data: tdsl.Output[tdsl.Dataset]) -> int:
    with open(data.path, "w") as f:
        f.write("x,y\n" * rows)
    data.metadata["rows"] = rows
    return rows
