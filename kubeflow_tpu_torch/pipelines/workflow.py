"""Workflow DAG controller: the Argo-equivalent executor + embedded v2 driver.

The port's copy of ``kubeflow_tpu/pipelines/workflow.py``.  What differs is
the step pod (``_pod``):

* its command runs ``kubeflow_tpu_torch.pipelines.launcher_main``;
* a task's ``resources`` are copied into the container's limits as they
  are, as the reference copies them, so an ``nvidia.com/gpu`` entry there
  gets the step a card (the kubelet's ``CUDA_VISIBLE_DEVICES``);
* a task's ``tpu`` (``Task.set_tpu``) still becomes a ``google.com/tpu``
  limit, which the port's scheduler refuses: the step pod stays Pending
  with a ``FailedScheduling`` event naming the resource, never runs
  without it.

Upstream analogue (UNVERIFIED, SURVEY.md §3.5): Argo's workflow-controller
schedules DAG nodes as pods; KFP v2 adds a per-node *driver* (input
resolution + cache check against MLMD) and a *launcher* (runs user code,
uploads artifacts).  Deviations by design of the deterministic simulator
(same pattern as katib/controllers.py):

  * the driver runs **in-process at reconcile time** instead of as a separate
    driver container — identical inputs-resolution/fingerprint contract;
  * the launcher pod reports results through its node workspace directory
    (``outputs.json``) rather than a sidecar API call, because pods here are
    plain OS processes with no apiserver endpoint;
  * the controller is the **single writer** to the metadata store (WAL is a
    one-writer format); the launcher only touches the object store.

Node lifecycle: Pending → (driver: skip | cache-hit | pod created) →
Running → Succeeded/Failed (with retries) ; condition false → Skipped ;
upstream dep failed/skipped → Omitted.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import sys
import time
from typing import Any, Optional

from ..core.api import APIServer, AlreadyExists, Obj, owner_reference
from ..core.events import EventRecorder
from ..core.controller import Request, Result
from ..scheduler.topology import TPU_RESOURCE
from . import api as papi
from .artifacts import ObjectStore
from . import metadata as md


def _resolve_ref(ref: dict, args: dict, nodes: dict) -> Any:
    """Resolve one IR value reference against run args + completed nodes."""
    if "constant" in ref:
        return ref["constant"]
    if "componentInputParameter" in ref:
        return args[ref["componentInputParameter"]]
    if "taskOutputParameter" in ref:
        src = ref["taskOutputParameter"]
        node = nodes.get(src["producerTask"], {})
        outs = node.get("outputParameters", {})
        if src["outputParameterKey"] not in outs:
            raise KeyError(
                f"task {src['producerTask']!r} produced no output "
                f"parameter {src['outputParameterKey']!r}"
            )
        return outs[src["outputParameterKey"]]
    if "collectedOutput" in ref:
        # dsl.Collected fan-in: the per-iteration outputs of a dynamic
        # ParallelFor, in item order.  The consumer depends on the loop's
        # virtual node, so every child is terminal here; iterations a
        # Condition skipped contribute nothing (upstream semantics).
        src = ref["collectedOutput"]
        virtual = nodes.get(src["producerTask"], {})
        out = []
        for k in range(len(virtual.get("items", []))):
            child = nodes.get(f"{src['producerTask']}-it{k}", {})
            outs = child.get("outputParameters")
            if outs is None:
                continue  # skipped/omitted iteration
            if src["outputParameterKey"] not in outs:
                raise KeyError(
                    f"iteration {k} of {src['producerTask']!r} produced no "
                    f"output parameter {src['outputParameterKey']!r}")
            out.append(outs[src["outputParameterKey"]])
        return out
    raise ValueError(f"unresolvable reference: {ref!r}")


_OPS = {
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}


def _eval_condition(expr: dict, args: dict, nodes: dict) -> bool:
    left = _resolve_ref(expr["left"], args, nodes)
    right = _resolve_ref(expr["right"], args, nodes)
    return bool(_OPS[expr["op"]](left, right))


def _refs_loop_item(v: Any, gid: int) -> bool:
    """True if ``v`` (a condition/operand tree) contains a ``loopItem``
    marker for iterator group ``gid`` — i.e. it can only be evaluated on an
    instantiated child, never on the virtual fan-out node."""
    if isinstance(v, dict):
        if v.get("loopItem", {}).get("groupId") == gid:
            return True
        return any(_refs_loop_item(x, gid) for x in v.values())
    if isinstance(v, list):
        return any(_refs_loop_item(x, gid) for x in v)
    return False


def _instantiate_iteration(tspec: dict, dag: dict, gid: int, k: int,
                           item: Any) -> dict:
    """One dynamic-ParallelFor child's concrete task spec: ``loopItem``
    markers become constants, and intra-group references retarget the
    same-index sibling (``dep`` → ``dep-itK``), mirroring the static
    expansion's clone_map semantics."""

    def same_group(name: str) -> bool:
        return dag.get(name, {}).get("iterator", {}).get("groupId") == gid

    def subst(v: Any) -> Any:
        if isinstance(v, dict):
            if "loopItem" in v and v["loopItem"].get("groupId") == gid:
                field = v["loopItem"].get("field")
                if field is None:
                    return {"constant": item}
                if not isinstance(item, dict) or field not in item:
                    raise ValueError(
                        f"ParallelFor item {item!r} has no field {field!r}")
                return {"constant": item[field]}
            out = {kk: subst(vv) for kk, vv in v.items()}
            for key in ("producerTask",):
                if key in out and isinstance(out[key], str) and same_group(out[key]):
                    out[key] = f"{out[key]}-it{k}"
            return out
        if isinstance(v, list):
            return [subst(x) for x in v]
        return v

    cspec = subst({kk: vv for kk, vv in tspec.items() if kk != "iterator"})
    cspec["dependentTasks"] = [
        f"{d}-it{k}" if same_group(d) else d
        for d in tspec.get("dependentTasks", [])]
    return cspec


class WorkflowController:
    kind = "Workflow"

    def __init__(
        self,
        api: APIServer,
        store: ObjectStore,
        metadata_store: md.MetadataStore,
        workdir: str,
    ):
        self.api = api
        self.store = store
        self.metadata = metadata_store
        self.workdir = workdir
        self.recorder = EventRecorder(api, "workflow-controller")

    # ------------------------------------------------------------- reconcile

    def reconcile(self, req: Request) -> Optional[Result]:
        wf = self.api.try_get("Workflow", req.name, req.namespace)
        if wf is None:
            return None
        status = wf.setdefault("status", {})
        if status.get("phase") in papi.WORKFLOW_TERMINAL:
            return None
        if "phase" not in status:
            status["phase"] = papi.RUNNING
            status["startedAt"] = time.time()
            status["nodes"] = {}
            ctx_id = self.metadata.put_context(
                "pipeline_run",
                f"{req.namespace}/{req.name}",
                {"pipeline": wf["spec"]["pipelineSpec"]["pipelineInfo"]["name"]},
            )
            status["contextId"] = ctx_id
            self.recorder.normal(wf, "WorkflowStarted", "DAG execution started")

        ir = wf["spec"]["pipelineSpec"]
        dag = ir["root"]["dag"]["tasks"]
        try:
            args = self._arguments(wf, ir)
        except ValueError as e:
            # user-supplied arguments are wrong: terminal, not retryable
            status["phase"] = papi.FAILED
            status["message"] = str(e)
            status["finishedAt"] = time.time()
            self.recorder.warning(wf, "InvalidArguments", str(e))
            self.api.update_status(wf)
            return None
        nodes = status["nodes"]
        progressed = False

        # iterate to fixpoint: phase changes (Failed/Skipped/Succeeded) must
        # propagate to dependents within one reconcile regardless of task
        # name ordering
        while True:
            pass_progressed = False
            for tname in sorted(dag):
                node = nodes.setdefault(tname, {"phase": papi.PENDING, "retries": 0})
                if node["phase"] in papi.NODE_TERMINAL:
                    continue
                if "iterator" in dag[tname]:
                    # dynamic ParallelFor: this entry is a VIRTUAL node that
                    # expands into children once its producer finishes
                    if self._drive_iterator(wf, tname, dag[tname], node, args, ir, dag):
                        pass_progressed = True
                    continue
                if node["phase"] == papi.RUNNING:
                    if self._check_pod(wf, tname, dag[tname], node, args):
                        pass_progressed = True
                    continue
                # Pending: gate on dependencies
                dep_phases = [nodes.get(d, {}).get("phase", papi.PENDING) for d in dag[tname].get("dependentTasks", [])]
                if dag[tname].get("isExitHandler"):
                    # ExitHandler cleanup: runs once every guarded task is
                    # terminal in ANY phase — failures must not omit it
                    if not all(p in papi.NODE_TERMINAL for p in dep_phases):
                        continue
                elif any(p in (papi.FAILED, papi.SKIPPED, papi.OMITTED) for p in dep_phases):
                    node["phase"] = papi.OMITTED
                    pass_progressed = True
                    continue
                elif not all(p == papi.SUCCEEDED for p in dep_phases):
                    continue
                if self._drive(wf, tname, dag[tname], node, args, ir):
                    pass_progressed = True
            if not pass_progressed:
                break
            progressed = True

        phase = self._aggregate(nodes, dag)
        if phase != status["phase"]:
            status["phase"] = phase
            if phase in papi.WORKFLOW_TERMINAL:
                status["finishedAt"] = time.time()
                self.recorder.normal(wf, f"Workflow{phase}", f"workflow {phase.lower()}")
            progressed = True
        if progressed:
            self.api.update_status(wf)
        return None

    def _arguments(self, wf: Obj, ir: dict) -> dict:
        defs = ir["root"]["inputDefinitions"]["parameters"]
        args = {}
        for pname, d in defs.items():
            if "defaultValue" in d:
                args[pname] = d["defaultValue"]
        args.update(wf["spec"].get("arguments", {}))
        unknown = set(wf["spec"].get("arguments", {})) - set(defs)
        if unknown:
            raise ValueError(f"unknown pipeline arguments: {sorted(unknown)}")
        missing = set(defs) - set(args)
        if missing:
            raise ValueError(f"missing pipeline arguments: {sorted(missing)}")
        return args

    def _aggregate(self, nodes: dict, dag: dict) -> str:
        phases = [nodes.get(t, {}).get("phase", papi.PENDING) for t in dag]
        # terminal only once EVERY node is terminal: a failure OMITs its
        # dependents within the same fixpoint, but ExitHandler cleanups still
        # have to run (and finish) before the workflow's phase settles
        if not all(p in papi.NODE_TERMINAL for p in phases):
            return papi.RUNNING
        if any(p == papi.FAILED for p in phases):
            return papi.FAILED
        return papi.SUCCEEDED

    # ------------------------------------------------- dynamic ParallelFor

    def _drive_iterator(self, wf: Obj, tname: str, tspec: dict, node: dict,
                        args: dict, ir: dict, dag: dict) -> bool:
        """Runtime fan-out (dsl.ParallelFor(task.output)): once the producer
        succeeds, read its JSON-list output and drive one child node per
        item through the normal driver (conditions, caching, retries all
        apply per child).  The virtual node's phase aggregates the children,
        so downstream dependents gate on it like any other task."""
        nodes = wf["status"]["nodes"]
        it = tspec["iterator"]
        if node["phase"] == papi.PENDING:
            dep_phases = [nodes.get(d, {}).get("phase", papi.PENDING)
                          for d in tspec.get("dependentTasks", [])]
            if any(p in (papi.FAILED, papi.SKIPPED, papi.OMITTED)
                   for p in dep_phases):
                node["phase"] = papi.OMITTED
                return True
            if not all(p == papi.SUCCEEDED for p in dep_phases):
                return False
            # the virtual node's own conditions gate expansion, mirroring
            # _drive: a dynamic ParallelFor nested in a false dsl.Condition
            # must SKIP (and OMIT its dependents) exactly like a static
            # loop.  Conditions that reference THIS group's loop item are
            # per-child — they evaluate after _instantiate_iteration
            # substitutes the item, not here
            for cond in tspec.get("conditions", []):
                if _refs_loop_item(cond, it["groupId"]):
                    continue
                if not _eval_condition(cond, args, nodes):
                    node["phase"] = papi.SKIPPED
                    return True
            raw = nodes.get(it["producerTask"], {}).get(
                "outputParameters", {}).get(it["outputParameterKey"])
            items = raw
            if isinstance(items, str):
                try:
                    items = json.loads(items)
                except ValueError:
                    items = None
            if not isinstance(items, list):
                node.update(phase=papi.FAILED,
                            message=f"ParallelFor source "
                                    f"{it['producerTask']}.{it['outputParameterKey']} "
                                    f"is not a JSON list: {raw!r}")
                self.recorder.warning(wf, "IteratorInvalid", node["message"])
                return True
            node["items"] = items
            node["phase"] = papi.SUCCEEDED if not items else papi.RUNNING
            return True
        if node["phase"] != papi.RUNNING:
            return False
        progressed = False
        child_phases = []
        for k, item in enumerate(node.get("items", [])):
            cname = f"{tname}-it{k}"
            child = nodes.setdefault(cname, {"phase": papi.PENDING, "retries": 0})
            if child["phase"] in papi.NODE_TERMINAL:
                child_phases.append(child["phase"])
                continue
            # instantiate ONCE and persist on the child: the substitution is
            # fully determined by (tspec, k, item), re-deriving it per
            # fixpoint pass would be pure per-tick overhead — and the
            # persisted spec survives a controller restart mid-run
            cspec = child.get("spec")
            if cspec is None:
                try:
                    cspec = _instantiate_iteration(tspec, dag, it["groupId"], k, item)
                except ValueError as e:  # e.g. item missing a referenced field
                    child.update(phase=papi.FAILED, message=str(e))
                    self.recorder.warning(wf, "IteratorItemInvalid", str(e))
                    child_phases.append(child["phase"])
                    progressed = True
                    continue
                child["spec"] = cspec
            if child["phase"] == papi.RUNNING:
                if self._check_pod(wf, cname, cspec, child, args):
                    progressed = True
            else:
                dep_phases = [nodes.get(d, {}).get("phase", papi.PENDING)
                              for d in cspec.get("dependentTasks", [])]
                if any(p in (papi.FAILED, papi.SKIPPED, papi.OMITTED)
                       for p in dep_phases):
                    child["phase"] = papi.OMITTED
                    progressed = True
                elif all(p == papi.SUCCEEDED for p in dep_phases):
                    if self._drive(wf, cname, cspec, child, args, ir):
                        progressed = True
            child_phases.append(child["phase"])
        if child_phases and all(p in papi.NODE_TERMINAL for p in child_phases):
            if any(p == papi.FAILED for p in child_phases):
                node["phase"] = papi.FAILED
            elif any(p in (papi.SKIPPED, papi.OMITTED) for p in child_phases):
                # static-loop parity: a static expansion attaches dependents
                # to EVERY clone, and one SKIPPED/OMITTED dep OMITs them —
                # so ANY skipped child must gate dependents of the virtual
                # node the same way (a Collected consumer of a partial
                # fan-out would otherwise read missing outputs)
                node["phase"] = papi.SKIPPED
            else:
                node["phase"] = papi.SUCCEEDED
            progressed = True
        return progressed

    # ---------------------------------------------------------------- driver

    def _drive(self, wf: Obj, tname: str, tspec: dict, node: dict, args: dict, ir: dict) -> bool:
        """KFP-v2-driver equivalent: conditions, input resolution, cache, pod."""
        nodes = wf["status"]["nodes"]
        for cond in tspec.get("conditions", []):
            if not _eval_condition(cond, args, nodes):
                node["phase"] = papi.SKIPPED
                return True

        params = {
            p: _resolve_ref(ref, args, nodes)
            for p, ref in tspec["inputs"]["parameters"].items()
        }
        in_artifacts = {}
        for aname, ref in tspec["inputs"]["artifacts"].items():
            src = ref["taskOutputArtifact"]
            prod = nodes.get(src["producerTask"], {})
            art = prod.get("outputArtifacts", {}).get(src["outputArtifactKey"])
            if art is None:
                raise KeyError(
                    f"task {src['producerTask']!r} produced no artifact {src['outputArtifactKey']!r}"
                )
            in_artifacts[aname] = art

        comp = ir["components"][tspec["componentRef"]]
        executor = ir["deploymentSpec"]["executors"][comp["executorLabel"]]
        out_param_defs = comp["outputDefinitions"]["parameters"]
        out_artifact_defs = comp["outputDefinitions"]["artifacts"]

        fp = _fingerprint(executor, params, in_artifacts, out_artifact_defs)
        node["fingerprint"] = fp
        if tspec.get("cachingOptions", {}).get("enableCache", True):
            cached = self.metadata.find_cached_execution(fp)
            if cached is not None:
                outs = cached.properties.get("outputs", {})
                node.update(
                    phase=papi.SUCCEEDED,
                    cached=True,
                    executionId=cached.id,
                    outputParameters=outs.get("parameters", {}),
                    outputArtifacts=outs.get("artifacts", {}),
                )
                self.recorder.normal(wf, "CacheHit", f"node {tname}: reused execution {cached.id}")
                return True

        # stage the node workspace + launcher pod
        run_uid = wf["metadata"]["uid"]
        workspace = os.path.join(self.workdir, run_uid, f"{tname}-r{node['retries']}")
        os.makedirs(workspace, exist_ok=True)
        out_artifacts = {
            aname: {
                "uri": self.store.uri("mlpipeline", f"{run_uid}/{tname}/{aname}"),
                "type": adef["schemaTitle"],
            }
            for aname, adef in out_artifact_defs.items()
        }
        task_doc = {
            "functionName": executor["python"]["functionName"],
            "source": executor["python"]["source"],
            "defaults": executor["python"].get("defaults", {}),
            "parameters": params,
            "inputArtifacts": in_artifacts,
            "outputArtifacts": out_artifacts,
            "outputParameters": sorted(out_param_defs),
            "storeRoot": self.store.root,
        }
        # tmp+os.replace: the launcher subprocess reads this back — a torn
        # write would crash the task with an unreadable doc (graftlint
        # atomic-write)
        task_path = os.path.join(workspace, "task.json")
        with open(task_path + ".tmp", "w") as f:
            json.dump(task_doc, f)
        os.replace(task_path + ".tmp", task_path)

        pod_name = f"{wf['metadata']['name']}-{tname}-r{node['retries']}"
        pod = self._pod(wf, tname, tspec, pod_name, workspace)
        try:
            self.api.create(pod)
        except AlreadyExists:
            pass
        node.update(phase=papi.RUNNING, podName=pod_name, workspace=workspace)
        node["inputParameters"] = params
        node["inputArtifacts"] = in_artifacts
        node["stagedOutputArtifacts"] = out_artifacts
        return True

    def _pod(self, wf: Obj, tname: str, tspec: dict, pod_name: str, workspace: str) -> Obj:
        resources: dict = dict(tspec.get("resources", {}))
        tpu = tspec.get("tpu")
        if tpu:
            # chips resolved at DSL time (Task.set_tpu); chips=0 covers IRs
            # compiled before that existed — infer from the accelerator name
            chips = int(tpu.get("chips") or 0)
            if not chips:
                tail = tpu["accelerator"].rsplit("-", 1)[-1]
                chips = _chips_in(tail) if "x" in tail else int(tail)
            resources[TPU_RESOURCE] = chips
        container = {
            "name": "main",
            "command": [sys.executable, "-m", "kubeflow_tpu_torch.pipelines.launcher_main", workspace],
            "env": [{"name": "PYTHONPATH", "value": _repo_root()}],
        }
        if resources:
            container["resources"] = {"limits": {k: v for k, v in resources.items()}}
        return {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": pod_name,
                "namespace": wf["metadata"].get("namespace", "default"),
                "labels": {
                    papi.LABEL_WORKFLOW: wf["metadata"]["name"],
                    papi.LABEL_NODE: tname,
                },
                "ownerReferences": [owner_reference(wf)],
            },
            "spec": {"restartPolicy": "Never", "containers": [container]},
        }

    # ------------------------------------------------------------ completion

    def _check_pod(self, wf: Obj, tname: str, tspec: dict, node: dict, args: dict) -> bool:
        pod = self.api.try_get("Pod", node["podName"], wf["metadata"].get("namespace", "default"))
        if pod is None:
            # pod vanished (evicted/deleted) — treat as a retryable failure
            return self._fail(wf, tname, tspec, node, "pod disappeared")
        phase = pod.get("status", {}).get("phase")
        if phase == "Succeeded":
            outputs_path = os.path.join(node["workspace"], "outputs.json")
            if not os.path.exists(outputs_path):
                return self._fail(wf, tname, tspec, node, "pod succeeded but wrote no outputs.json")
            with open(outputs_path) as f:
                outs = json.load(f)
            return self._complete(wf, tname, tspec, node, outs)
        if phase == "Failed":
            msg = pod.get("status", {}).get("message", "container exited nonzero")
            return self._fail(wf, tname, tspec, node, msg)
        return False

    def _complete(self, wf: Obj, tname: str, tspec: dict, node: dict, outs: dict) -> bool:
        ctx_id = wf["status"]["contextId"]
        artifacts: dict = {}
        for aname, spec in node["stagedOutputArtifacts"].items():
            meta = outs.get("artifactMetadata", {}).get(aname, {})
            aid = self.metadata.put_artifact(spec["type"], spec["uri"], md.LIVE, meta)
            self.metadata.put_attribution(ctx_id, aid)
            artifacts[aname] = {"id": aid, "uri": spec["uri"], "type": spec["type"], "metadata": meta}
        out_params = outs.get("outputParameters", {})
        exec_id = self.metadata.put_execution(
            f"component:{tspec['componentRef'].removeprefix('comp-')}",
            md.COMPLETE,
            fingerprint=node["fingerprint"],
            properties={
                "task": tname,
                "run": wf["metadata"]["name"],
                "outputs": {"parameters": out_params, "artifacts": artifacts},
            },
        )
        self.metadata.put_association(ctx_id, exec_id)
        for aname, art in artifacts.items():
            self.metadata.put_event(exec_id, art["id"], md.OUTPUT, aname)
        for aname, art in (node.get("inputArtifacts") or {}).items():
            if "id" in art:
                self.metadata.put_event(exec_id, art["id"], md.INPUT, aname)
        node.update(
            phase=papi.SUCCEEDED,
            executionId=exec_id,
            outputParameters=out_params,
            outputArtifacts=artifacts,
            cached=False,
        )
        return True

    def _fail(self, wf: Obj, tname: str, tspec: dict, node: dict, msg: str) -> bool:
        max_retries = tspec.get("retries", 0)
        if node["retries"] < max_retries:
            node["retries"] += 1
            node["phase"] = papi.PENDING
            node.pop("podName", None)
            self.recorder.warning(wf, "NodeRetry", f"node {tname}: {msg} (retry {node['retries']}/{max_retries})")
            return True
        node["phase"] = papi.FAILED
        node["message"] = msg
        self.recorder.warning(wf, "NodeFailed", f"node {tname}: {msg}")
        return True


def _fingerprint(executor: dict, params: dict, in_artifacts: dict, out_artifact_defs: dict) -> str:
    """KFP cache key: component spec + resolved inputs (+ output surface)."""
    doc = {
        "source": executor["python"]["source"],
        "functionName": executor["python"]["functionName"],
        "parameters": params,
        "inputArtifacts": {
            a: {"uri": art.get("uri"), "id": art.get("id")} for a, art in sorted(in_artifacts.items())
        },
        "outputs": sorted(out_artifact_defs),
    }
    return hashlib.sha256(json.dumps(doc, sort_keys=True).encode()).hexdigest()


def _chips_in(topology: str) -> int:
    """Chips in a TPU topology string (``2x4`` -> 8), as the reference's
    ``scheduler.topology.chips_in`` counts them."""
    return math.prod(int(d) for d in topology.lower().split("x"))


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
