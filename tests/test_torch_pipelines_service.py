"""Port parity: the port's Pipelines service against the JAX package's.

Each scenario of tests/test_pipelines.py that runs a pipeline runs it on both
planes: the JAX package's ``Cluster(cpu_nodes=1)`` with its Pipelines
``Client``, and the port's ``Cluster`` with one CPU node and one GPU node of
two cards with the port's ``Client``.  The pipelines are the same DSL
pipelines, built from the same component source on each package's ``dsl``,
with the same arguments.  What the two give must be equal:
  * the run's phase and every node's phase, retries, cache hit, inputs,
    outputs and output artifacts (types, metadata, URIs);
  * the metadata store's executions, artifacts and events of the run, the
    store's ids named by the task and artifact they belong to (parallel
    steps may finish in either order, so raw ids are not compared), each
    run's uid masked by its name;
  * the controller's events on the Workflow and the persistence agent's run
    record;
  * the recurring runs a ScheduledWorkflow fires, and the next fire of
    interval and cron triggers.
The reference runs ``train_and_deploy`` on a cluster with a TPU slice for its
``set_tpu`` deploy step; here its deploy step has no TPU on either plane
(``library(..., deploy_tpu=False)``), and the TPU request is a scenario of
its own: Pending on both planes, the port's event naming ``google.com/tpu``.

Then the port on its own: a task whose ``resources`` carry ``nvidia.com/gpu``
gets its card index as ``CUDA_VISIBLE_DEVICES``; the metadata WAL written by
either package's store replays in the other; ``metadata_core.cc`` is the
reference's byte for byte and builds into ``kubeflow_tpu_torch/_build/``.
"""

import difflib
import filecmp
import json
import os
import re
import time
from types import SimpleNamespace

import pytest

from kubeflow_tpu.core.cluster import Cluster as JCluster
from kubeflow_tpu.pipelines import api as japi
from kubeflow_tpu.pipelines import client as jclient
from kubeflow_tpu.pipelines import compiler as jcompiler
from kubeflow_tpu.pipelines import cron as jcron
from kubeflow_tpu.pipelines import dsl as jdsl
from kubeflow_tpu.pipelines import metadata as jmd
from kubeflow_tpu.pipelines import schedule as jschedule
from kubeflow_tpu_torch.core.cluster import Cluster as TCluster
from kubeflow_tpu_torch.core.events import events_for
from kubeflow_tpu_torch.pipelines import api as tapi
from kubeflow_tpu_torch.pipelines import client as tclient
from kubeflow_tpu_torch.pipelines import compiler as tcompiler
from kubeflow_tpu_torch.pipelines import cron as tcron
from kubeflow_tpu_torch.pipelines import dsl as tdsl
from kubeflow_tpu_torch.pipelines import metadata as tmd
from kubeflow_tpu_torch.pipelines import schedule as tschedule
from kubeflow_tpu_torch.utils.native_build import BUILD_DIR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GPU_NODE = ("h100", "h100", 2)
PLANES = {
    "jax": SimpleNamespace(api=japi, client=jclient, compiler=jcompiler, dsl=jdsl, md=jmd),
    "port": SimpleNamespace(api=tapi, client=tclient, compiler=tcompiler, dsl=tdsl, md=tmd),
}


def library(dsl, deploy_tpu: bool = False):
    """The components and pipelines of tests/test_pipelines.py, with their
    source text unchanged, built on ``dsl``.  ``deploy_tpu`` keeps
    ``train_and_deploy``'s ``set_tpu("v5e-4")`` on its deploy step."""

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
    def flaky(marker_dir: str) -> int:
        import os as _os
        marker = _os.path.join(marker_dir, "attempted")
        if not _os.path.exists(marker):
            with open(marker, "w") as f:
                f.write("1")
            raise RuntimeError("first attempt always fails")
        return 7

    @dsl.component
    def boom() -> int:
        raise RuntimeError("kaboom")

    @dsl.component
    def downstream(x: int) -> int:
        return x

    @dsl.component
    def cleanup(path: str) -> str:
        open(path, "a").write("cleaned\n")
        return path

    @dsl.component
    def work(ok: bool) -> int:
        if not ok:
            raise RuntimeError("exploded")
        return 1

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
    def gate(x: int) -> int:
        return x

    @dsl.component
    def visible_cards() -> str:
        import os as _os
        return _os.environ.get("CUDA_VISIBLE_DEVICES", "<unset>")

    @dsl.pipeline(name="train-and-deploy", description="golden: artifacts + condition")
    def train_and_deploy(rows: int = 20, lr: float = 0.5, threshold: float = 0.2):
        d = make_data(rows=rows)
        t = train(data=d.outputs["data"], lr=lr)
        with dsl.Condition(t.output > threshold):
            dep = deploy(model=t.outputs["model"])
            if deploy_tpu:
                dep.set_tpu("v5e-4")

    @dsl.pipeline(name="lr-sweep", description="golden: static ParallelFor fan-out")
    def lr_sweep(rows: int = 10):
        d = make_data(rows=rows)
        with dsl.ParallelFor([0.1, 0.9]) as lr:
            train(data=d.outputs["data"], lr=lr)

    @dsl.pipeline(name="retry-pipe")
    def retry_pipe(marker_dir: str = ""):
        flaky(marker_dir=marker_dir).set_retry(2).set_caching_options(False)

    @dsl.pipeline(name="fail-pipe")
    def fail_pipe():
        b = boom().set_caching_options(False)
        downstream(x=b.output)

    @dsl.pipeline(name="exit-fail")
    def exit_fail(path: str = ""):
        exit_task = cleanup(path=path).set_caching_options(False)
        with dsl.ExitHandler(exit_task):
            work(ok=False).set_caching_options(False)

    @dsl.pipeline(name="exit-ok")
    def exit_ok(path: str = ""):
        exit_task = cleanup(path=path).set_caching_options(False)
        with dsl.ExitHandler(exit_task):
            work(ok=True).set_caching_options(False)

    @dsl.pipeline(name="dynamic-fanout")
    def dynamic_fanout(n: int = 3):
        shards = list_shards(n=n)
        with dsl.ParallelFor(shards.output) as shard:
            p = process_shard(shard=shard)
        summarize().after(p)

    @dsl.pipeline(name="collect-fanin")
    def collect_fanin(n: int = 3):
        shards = list_shards(n=n)
        with dsl.ParallelFor(shards.output) as shard:
            w = process_shard(shard=shard)
        merge(values=dsl.Collected(w.output))

    @dsl.pipeline(name="dyn-in-cond")
    def dyn_in_cond(n: int = 2, go: int = 0):
        g = gate(x=go)
        shards = list_shards(n=n)
        with dsl.Condition(g.output > 0):
            with dsl.ParallelFor(shards.output) as shard:
                p = process_shard(shard=shard)
        summarize().after(p)

    @dsl.pipeline(name="dyn-partial-skip")
    def dyn_partial_skip(n: int = 2):
        shards = list_shards(n=n)
        with dsl.ParallelFor(shards.output) as shard:
            with dsl.Condition(shard == "shard-1"):
                p = process_shard(shard=shard)
        summarize().after(p)

    @dsl.pipeline(name="cards")
    def cards():
        with dsl.ParallelFor(["a", "b"]):
            visible_cards().set_caching_options(False)
        visible_cards().set_caching_options(False)

    return SimpleNamespace(**{k: v for k, v in locals().items() if k != "dsl"})


def new_cluster(plane: str):
    if plane == "jax":
        return JCluster(cpu_nodes=1)
    return TCluster(cpu_nodes=1, gpu_nodes=(GPU_NODE,))


def on_both(flow, **lib_kw) -> dict:
    """``flow(plane, cluster, client, lib)`` on a fresh cluster of each plane,
    its pipelines built on that plane's ``dsl``; returns both results."""
    got = {}
    for plane, m in PLANES.items():
        cluster = new_cluster(plane)
        try:
            got[plane] = flow(plane, cluster, m.client.Client(cluster),
                              library(m.dsl, **lib_kw))
        finally:
            cluster.shutdown()
    return got


def same(got: dict):
    """Both planes' results, asserted equal (a line diff when they are not)."""
    if got["port"] != got["jax"]:
        a, b = (json.dumps(got[k], indent=1, sort_keys=True).splitlines()
                for k in ("jax", "port"))
        diff = "\n".join(difflib.unified_diff(a, b, "jax", "port", lineterm="", n=2))
        pytest.fail(f"the planes differ:\n{diff}")
    return got["port"]


_EXEC_RE = re.compile(r"execution (\d+)")


def run_view(plane: str, cluster, client, run_id: str) -> dict:
    """What a run left behind: its record, nodes, metadata and events, each
    store id named by its task (and artifact), the run's uid masked."""
    md = PLANES[plane].md
    rec = client.service.get_run(run_id)
    wf = cluster.api.get("Workflow", run_id)
    store = client.service.metadata
    names: dict = {}
    ctx = store.get_context_by_name("pipeline_run", f"default/{run_id}")
    execs = store.executions_by_context(ctx.id) if ctx else []
    arts = store.artifacts_by_context(ctx.id) if ctx else []
    for e in execs:
        names[("e", e.id)] = f"{e.properties.get('run')}/{e.properties.get('task')}"
    for a in arts:
        names[("a", a.id)] = a.uri.split("/", 4)[-1]

    def name_of(kind, i):
        # a cache hit reuses an execution of an earlier run
        if (kind, i) not in names:
            rec_ = store.get_execution(i) if kind == "e" else store.get_artifact(i)
            names[(kind, i)] = (f"{rec_.properties.get('run')}/{rec_.properties.get('task')}"
                                if kind == "e" else rec_.uri.split("/", 4)[-1])
        return names[(kind, i)]

    nodes = {}
    for t, n in sorted(rec["nodes"].items()):
        v = {k: n.get(k) for k in ("phase", "retries", "cached", "outputParameters",
                                   "inputParameters", "items", "message")}
        if n.get("executionId") is not None:
            v["execution"] = name_of("e", n["executionId"])
        v["outputArtifacts"] = {
            a: {"type": art.get("type"), "metadata": art.get("metadata"),
                "uri": art.get("uri"), "artifact": name_of("a", art["id"])}
            for a, art in sorted((n.get("outputArtifacts") or {}).items())}
        v["inputArtifacts"] = sorted((n.get("inputArtifacts") or {}))
        nodes[t] = v
    executions = sorted(
        (name_of("e", e.id), e.type, md.STATE_NAMES[e.state],
         json.dumps({k: v for k, v in e.properties.items() if k != "outputs"}, sort_keys=True),
         json.dumps(e.properties.get("outputs", {}).get("parameters"), sort_keys=True),
         sorted(e.properties.get("outputs", {}).get("artifacts", {})))
        for e in execs)
    events = sorted((name_of("e", ev.execution_id), name_of("a", ev.artifact_id), ev.type, ev.path)
                    for e in execs for ev in store.events_by_execution(e.id))
    artifacts = sorted((name_of("a", a.id), a.type, a.uri, a.state,
                        json.dumps(a.properties, sort_keys=True)) for a in arts)
    wf_events = sorted((e["reason"], _EXEC_RE.sub(
        lambda m: "execution " + name_of("e", int(m.group(1))), e["message"]))
        for e in events_for(cluster.api, wf))
    record = next(r for r in client.service.list_runs() if r["run"] == run_id)
    view = {"phase": rec["phase"], "nodes": nodes, "executions": executions,
            "metadata_events": events, "artifacts": artifacts, "events": wf_events,
            "record": {**{k: record.get(k) for k in ("phase", "pipeline", "experiment",
                                                      "namespace", "arguments")},
                       "finished": bool(record.get("finishedAt"))}}
    text = json.dumps(view)
    for w in cluster.api.list("Workflow"):  # a cache hit names an earlier run's
        text = text.replace(w["metadata"]["uid"], f"<uid of {w['metadata']['name']}>")
    return json.loads(text)


def run(plane, cluster, client, pipeline, run_id: str, args: dict = None,
        timeout: float = 120) -> dict:
    rec = client.create_run_from_pipeline_func(pipeline, arguments=args or {},
                                               run_name=run_id).wait(timeout=timeout)
    assert rec["phase"] in PLANES[plane].api.WORKFLOW_TERMINAL
    return run_view(plane, cluster, client, run_id)


# --------------------------------------------------------------- scenarios


def test_e2e_artifacts_condition_caching():
    """test_pipeline_e2e_artifacts_condition_caching: a run, the same run
    again (every node a cache hit, no new pod) and one with another argument
    (the producer chain runs again)."""

    def flow(plane, cluster, client, lib):
        first = run(plane, cluster, client, lib.train_and_deploy, "r1", {"rows": 30})
        pods = len(cluster.api.list("Pod"))
        again = run(plane, cluster, client, lib.train_and_deploy, "r2", {"rows": 30})
        new_pods = len(cluster.api.list("Pod")) - pods
        other = run(plane, cluster, client, lib.train_and_deploy, "r3", {"rows": 31})
        return {"first": first, "again": again, "new_pods": new_pods, "other": other}

    got = same(on_both(flow))
    assert got["first"]["phase"] == "Succeeded"
    assert got["first"]["nodes"]["make-data"]["outputParameters"]["Output"] == 30
    assert got["first"]["nodes"]["deploy"]["phase"] == "Succeeded"
    assert got["new_pods"] == 0
    assert all(n["cached"] for n in got["again"]["nodes"].values())
    assert not got["other"]["nodes"]["make-data"]["cached"]


def test_persistence_agent_reports_run_record():
    """The watch-driven agent folds the terminal phase into the run record;
    no poll ticker is registered."""

    def flow(plane, cluster, client, lib):
        tickers = [getattr(t, "__qualname__", "") for t in cluster.manager.tickers]
        view = run(plane, cluster, client, lib.train_and_deploy, "rec", {"rows": 20})
        return {"sync_runs": "PipelineService.sync_runs" in tickers, "record": view["record"]}

    got = same(on_both(flow))
    assert got == {"sync_runs": False, "record": {
        "phase": "Succeeded", "pipeline": "train-and-deploy", "experiment": "Default",
        "namespace": "default", "arguments": {"rows": 20}, "finished": True}}


def test_condition_false_skips():
    got = same(on_both(lambda p, c, cl, lib: run(
        p, c, cl, lib.train_and_deploy, "skip", {"rows": 4, "lr": 0.01, "threshold": 5.0})))
    assert got["phase"] == "Succeeded" and got["nodes"]["deploy"]["phase"] == "Skipped"


def test_retry_recovers(tmp_path):
    def flow(plane, cluster, client, lib):
        marker = tmp_path / plane
        marker.mkdir()
        view = run(plane, cluster, client, lib.retry_pipe, "retry",
                   {"marker_dir": str(marker)})
        # the marker dir differs per plane
        return json.loads(json.dumps(view).replace(str(marker), "<marker>"))

    got = same(on_both(flow))
    assert got["phase"] == "Succeeded"
    assert got["nodes"]["flaky"]["retries"] == 1
    assert got["nodes"]["flaky"]["outputParameters"]["Output"] == 7
    assert [r for r, _ in got["events"]].count("NodeRetry") == 1


def test_failure_marks_workflow_failed():
    got = same(on_both(lambda p, c, cl, lib: run(p, c, cl, lib.fail_pipe, "fail")))
    assert got["phase"] == "Failed"
    assert got["nodes"]["boom"]["phase"] == "Failed"
    assert got["nodes"]["downstream"]["phase"] == "Omitted"
    assert ("WorkflowFailed", "workflow failed") in [tuple(e) for e in got["events"]]


def test_static_parallelfor_runs_every_iteration():
    got = same(on_both(lambda p, c, cl, lib: run(p, c, cl, lib.lr_sweep, "sweep", {"rows": 6})))
    accs = {t: n["outputParameters"]["Output"] for t, n in got["nodes"].items()
            if t.startswith("train-")}
    assert len(accs) == 2 and accs["train-it0"] != accs["train-it1"]


@pytest.mark.parametrize("n", [4, 0])
def test_dynamic_parallelfor_runtime_fanout(n):
    """n = 4: four children, each its item; n = 0: the empty list succeeds."""
    got = same(on_both(lambda p, c, cl, lib: run(p, c, cl, lib.dynamic_fanout, "dyn", {"n": n})))
    assert got["phase"] == "Succeeded"
    assert got["nodes"]["process-shard"]["items"] == [f"shard-{i}" for i in range(n)]
    assert [t for t in got["nodes"] if t.startswith("process-shard-it")] == [
        f"process-shard-it{i}" for i in range(n)]


def test_collected_fans_in_iteration_outputs():
    got = same(on_both(lambda p, c, cl, lib: run(p, c, cl, lib.collect_fanin, "col", {"n": 3})))
    assert got["nodes"]["merge"]["inputParameters"]["values"] == ["SHARD-0", "SHARD-1",
                                                                  "SHARD-2"]


def test_exit_handler_runs_on_failure_and_success(tmp_path):
    def flow(plane, cluster, client, lib):
        marker = tmp_path / f"{plane}-cleaned"
        args = {"path": str(marker)}
        views = [run(plane, cluster, client, lib.exit_fail, "exit-fail", args),
                 run(plane, cluster, client, lib.exit_ok, "exit-ok", args)]
        return {"views": json.loads(json.dumps(views).replace(str(marker), "<marker>")),
                "marker": marker.read_text()}

    got = same(on_both(flow))
    fail, ok = got["views"]
    assert fail["phase"] == "Failed" and fail["nodes"]["cleanup"]["phase"] == "Succeeded"
    assert ok["phase"] == "Succeeded"
    assert got["marker"] == "cleaned\ncleaned\n"


def test_dynamic_parallelfor_in_false_condition_skips():
    def flow(plane, cluster, client, lib):
        return [run(plane, cluster, client, lib.dyn_in_cond, f"go{go}", {"go": go})
                for go in (0, 1)]

    off, on = same(on_both(flow))
    assert off["nodes"]["process-shard"]["phase"] == "Skipped"
    assert "process-shard-it0" not in off["nodes"]
    assert off["nodes"]["summarize"]["phase"] == "Omitted"
    assert on["nodes"]["summarize"]["phase"] == "Succeeded"


def test_dynamic_parallelfor_partial_skip_gates_dependents():
    got = same(on_both(lambda p, c, cl, lib: run(p, c, cl, lib.dyn_partial_skip, "part")))
    assert got["nodes"]["process-shard-it0"]["phase"] == "Skipped"
    assert got["nodes"]["process-shard-it1"]["phase"] == "Succeeded"
    assert got["nodes"]["process-shard"]["phase"] == "Skipped"
    assert got["nodes"]["summarize"]["phase"] == "Omitted"


def test_scheduled_workflow_interval():
    """An interval trigger fires recurring runs named ``<swf>-<n>``,
    labelled with the ScheduledWorkflow, each run to its end; disabled, it
    fires no more."""

    def flow(plane, cluster, client, lib):
        m = PLANES[plane]
        ir = m.compiler.Compiler().compile(lib.lr_sweep)
        cluster.api.create(m.api.scheduled_workflow("tick", ir, interval_seconds=0.5,
                                                    arguments={"rows": 2}))

        def runs():
            return cluster.api.list("Workflow", label_selector={"scheduledworkflow": "tick"})

        assert cluster.manager.run_until(lambda: len(runs()) >= 2, timeout=60)
        obj = cluster.api.get("ScheduledWorkflow", "tick")
        obj["spec"]["enabled"] = False
        cluster.api.update(obj)
        fired = sorted(w["metadata"]["name"] for w in runs())
        assert cluster.manager.run_until(lambda: all(
            (w.get("status") or {}).get("phase") in m.api.WORKFLOW_TERMINAL
            for w in runs()), timeout=90)
        cluster.settle(quiet=0.6)
        swf = cluster.api.get("ScheduledWorkflow", "tick")
        return {"first_two": fired[:2],
                "no_more": sorted(w["metadata"]["name"] for w in runs()) == fired,
                "phases": sorted({w["status"]["phase"] for w in runs()}),
                "owner": sorted({w["metadata"]["ownerReferences"][0]["kind"] for w in runs()}),
                "fire_count_matches": swf["status"]["fireCount"] == len(fired),
                "triggered": sorted({e["reason"] for e in events_for(cluster.api, swf)})}

    got = same(on_both(flow))
    assert got == {"first_two": ["tick-1", "tick-2"], "no_more": True,
                   "phases": ["Succeeded"], "owner": ["ScheduledWorkflow"],
                   "fire_count_matches": True, "triggered": ["WorkflowTriggered"]}


CRON_EXPRS = ["*/15 * * * *", "0 3 * * *", "5,35 */2 * * 1-5", "0 0 1 */3 *",
              "30 12 * 6 0", "* * * * *"]


def test_cron_schedules_fire_at_the_same_minutes():
    """The reference's cron scenario on both modules, then each expression's
    matches and next fire from a spread of start times, and the
    ScheduledWorkflow controller's next fire for an interval and a cron
    trigger, first and after a fire."""
    t0 = time.mktime((2026, 7, 29, 10, 0, 30, 0, 0, -1))
    for m in (jcron, tcron):
        assert time.localtime(m.next_fire("*/15 * * * *", t0)).tm_min == 15
        lt = time.localtime(m.next_fire("0 3 * * *", t0))
        assert (lt.tm_hour, lt.tm_min) == (3, 0)
        for bad in ("61 * * * *", "* * * *", "*/0 * * * *"):
            with pytest.raises(ValueError):
                m.parse(bad)
    starts = [t0 + k * 7919.0 for k in range(12)]
    for expr in CRON_EXPRS:
        assert tcron.parse(expr) == jcron.parse(expr)
        for t in starts:
            assert tcron.next_fire(expr, t) == jcron.next_fire(expr, t)
            assert tcron.matches(expr, t) == jcron.matches(expr, t)
    for trigger in ({"intervalSeconds": 30}, {"cron": "*/15 * * * *"}):
        for status in ({}, {"lastFiredAt": t0}):
            swf = {"spec": {"trigger": trigger}, "status": status}
            assert (tschedule.ScheduledWorkflowController._next_fire(None, swf, t0)
                    == jschedule.ScheduledWorkflowController._next_fire(None, swf, t0))


def _put_run(md, store):
    """The reference's WAL scenario: a context, an artifact, an execution
    that completes, an event, an association and an attribution."""
    ctx = store.put_context("pipeline_run", "r1", {"pipeline": "demo"})
    aid = store.put_artifact("system.Dataset", "mstore://b/k", properties={"rows": 5})
    eid = store.put_execution("comp-x", md.RUNNING, fingerprint="fp1")
    store.put_event(eid, aid, md.OUTPUT, "data")
    store.put_association(ctx, eid)
    store.put_attribution(ctx, aid)
    store.put_execution("comp-x", md.COMPLETE, fingerprint="fp1", execution_id=eid,
                        properties={"outputs": {"parameters": {"Output": 5}}})
    return ctx, aid, eid


def _read_run(store, ctx, aid, eid) -> dict:
    hit = store.find_cached_execution("fp1")
    return {"counts": store.counts(),
            "artifact": vars(store.get_artifact(aid)),
            "execution": vars(store.get_execution(eid)),
            "context": vars(store.get_context_by_name("pipeline_run", "r1")),
            "by_context": [x.id for x in store.executions_by_context(ctx)],
            "artifacts_by_context": [x.id for x in store.artifacts_by_context(ctx)],
            "events": [vars(e) for e in store.events_by_execution(eid)],
            "hit": hit.id if hit else None}


@pytest.mark.parametrize("writer, reader", [("jax", "port"), ("port", "jax")])
def test_metadata_wal_round_trips_across_stores(tmp_path, writer, reader):
    """A WAL written by one package's store replays in the other's to the
    same records, and the reader's appends replay in the writer's."""
    path = str(tmp_path / "meta.wal")
    wmd, rmd = PLANES[writer].md, PLANES[reader].md
    w = wmd.MetadataStore(path)
    ids = _put_run(wmd, w)
    want = _read_run(w, *ids)
    w.close()
    r = rmd.MetadataStore(path)
    assert _read_run(r, *ids) == want
    assert want["counts"] == {"artifacts": 1, "executions": 1, "contexts": 1, "events": 1}
    extra = r.put_artifact("system.Model", "mstore://b/m", properties={"by": reader})
    r.close()
    w2 = wmd.MetadataStore(path)
    assert vars(w2.get_artifact(extra))["properties"] == {"by": reader}
    assert w2.counts()["artifacts"] == 2
    w2.close()


def test_metadata_core_is_the_references_and_builds_into_the_ports_build_dir():
    assert filecmp.cmp(os.path.join(REPO, "kubeflow_tpu", "pipelines", "metadata_core.cc"),
                       os.path.join(REPO, "kubeflow_tpu_torch", "pipelines", "metadata_core.cc"),
                       shallow=False)
    tmd.MetadataStore().close()
    lib = tmd._load()
    assert os.path.dirname(lib._name) == BUILD_DIR
    assert "kubeflow_tpu" + os.sep not in lib._name


def test_tpu_task_stays_pending():
    """``set_tpu`` still becomes a ``google.com/tpu`` limit: on both planes'
    CPU-only or GPU clusters the step's pod is never bound, the node stays
    Running and the run never ends; the port's scheduler names the
    resource."""

    def flow(plane, cluster, client, lib):
        client.create_run_from_pipeline_func(lib.train_and_deploy, arguments={"rows": 20},
                                             run_name="tpu")
        pod = "tpu-deploy-r0"

        def refused():
            p = cluster.api.try_get("Pod", pod)
            return p is not None and any(e["reason"] == "FailedScheduling"
                                         for e in events_for(cluster.api, p))

        assert cluster.manager.run_until(refused, timeout=90)
        cluster.settle(quiet=0.5)
        p = cluster.api.get("Pod", pod)
        rec = client.service.get_run("tpu")
        msgs = sorted({e["message"] for e in events_for(cluster.api, p)
                       if e["reason"] == "FailedScheduling"})
        return {"phase": rec["phase"],
                "nodes": {t: n["phase"] for t, n in sorted(rec["nodes"].items())},
                "limits": p["spec"]["containers"][0]["resources"]["limits"],
                "bound": p["spec"].get("nodeName"), "messages": msgs}

    got = on_both(flow, deploy_tpu=True)
    msgs = got["port"].pop("messages")
    got["jax"].pop("messages")
    got = same(got)
    assert got == {"phase": "Running", "nodes": {"deploy": "Running", "make-data": "Succeeded",
                                                 "train": "Succeeded"},
                   "limits": {"google.com/tpu": 4}, "bound": None}
    assert any("google.com/tpu" in m for m in msgs), msgs


def test_gpu_task_gets_its_card(tmp_path):
    """On the port's plane a task whose ``resources`` carry
    ``nvidia.com/gpu: 1`` runs on the GPU node with its card index as
    ``CUDA_VISIBLE_DEVICES`` (two at once: cards 0 and 1); a task without
    one sees no card."""
    cluster = new_cluster("port")
    try:
        client = tclient.Client(cluster)
        ir = tcompiler.Compiler().compile(library(tdsl).cards)
        tasks = ir["root"]["dag"]["tasks"]
        for t in ("visible-cards-it0", "visible-cards-it1"):
            tasks[t]["resources"] = {"nvidia.com/gpu": 1}
        rec = client.create_run_from_pipeline_func(ir, run_name="cards").wait(timeout=90)
        pods = {p["metadata"]["labels"][tapi.LABEL_NODE]: p for p in cluster.api.list("Pod")}
    finally:
        cluster.shutdown()
    assert rec["phase"] == "Succeeded"
    outs = {t: n["outputParameters"]["Output"] for t, n in rec["nodes"].items()}
    assert sorted([outs["visible-cards-it0"], outs["visible-cards-it1"]]) == ["0", "1"]
    assert outs["visible-cards-2"] == ""
    for t in ("visible-cards-it0", "visible-cards-it1"):
        assert pods[t]["spec"]["nodeName"] == GPU_NODE[0]
        assert pods[t]["spec"]["containers"][0]["resources"]["limits"] == {"nvidia.com/gpu": 1}
        assert pods[t]["spec"]["containers"][0]["command"][1:3] == [
            "-m", "kubeflow_tpu_torch.pipelines.launcher_main"]


def test_a_second_install_reuses_or_refuses():
    """One service per API server: a second install at the same workdir
    returns it, one at another workdir is refused with the same message."""

    def flow(plane, cluster, client, lib):
        m = PLANES[plane]
        again = m.client.install(cluster.api, cluster.manager,
                                 os.path.join(cluster.workdir, "pipelines"))
        with pytest.raises(ValueError) as e:
            m.client.install(cluster.api, cluster.manager, os.path.join(cluster.workdir, "x"))
        return {"same": again is client.service,
                "message": str(e.value).replace(cluster.workdir, "<workdir>")}

    got = same(on_both(flow))
    assert got["same"] and "refusing a second install" in got["message"]
