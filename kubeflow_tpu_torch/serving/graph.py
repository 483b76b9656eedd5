"""InferenceGraph: multi-model routing graphs over InferenceServices.

A copy of ``kubeflow_tpu/serving/graph.py``.

Upstream analogue (UNVERIFIED, SURVEY.md §2a KServe rows):
``[U:kserve/pkg/apis/serving/v1alpha1/inference_graph.go]`` + the
``router`` deployment that executes it. A graph is named nodes, each with a
``routerType`` and ``steps`` targeting InferenceServices or other nodes:

  * **Sequence** — pipe the payload through the steps; a step may take the
    original request (``data: $request``) or the previous step's output
    (``$response``, the default).
  * **Switch**  — first step whose ``condition`` matches the payload runs.
  * **Ensemble** — all steps run (fan-out); responses merge into one map.
  * **Splitter** — steps carry ``weight``; one is picked by weighted draw.

The rebuild executes graphs in-process (``GraphRouter``) instead of
deploying a dedicated router pod — same capability, one less hop; the CRD,
node/step shapes and Ready-condition surface mirror upstream. Conditions use
a dot-path mini-expression (``instances.0.kind == "bark"``), standing in for
upstream's GJSON matches.
"""

from __future__ import annotations

import json
import random
from typing import Any, Optional

from ..core.api import APIServer, CRD, Invalid, Obj
from ..core.conditions import has_condition, set_condition
from ..core.controller import Request, Result
from ..core.events import EventRecorder

GROUP = "serving.kserve.io"
VERSION = "v1alpha1"
ROUTER_TYPES = ("Sequence", "Switch", "Ensemble", "Splitter")
# Max nodeName nesting depth accepted at admission.  GraphRouter executes
# graphs recursively (~2 Python frames per hop), so the validator must bound
# depth well under the interpreter's recursion limit — a deeper graph would
# validate fine and then RecursionError on every predict().
MAX_GRAPH_DEPTH = 128


def _validate(obj: Obj) -> None:
    nodes = (obj.get("spec") or {}).get("nodes") or {}
    if "root" not in nodes:
        raise Invalid("InferenceGraph: spec.nodes.root required")
    for name, node in nodes.items():
        rt = node.get("routerType")
        if rt not in ROUTER_TYPES:
            raise Invalid(f"node {name!r}: routerType must be one of {ROUTER_TYPES}")
        steps = node.get("steps") or []
        if not steps:
            raise Invalid(f"node {name!r}: steps required")
        for i, step in enumerate(steps):
            if not step.get("serviceName") and not step.get("nodeName"):
                raise Invalid(f"node {name!r} step {i}: serviceName or nodeName required")
            if step.get("nodeName") and step["nodeName"] not in nodes:
                raise Invalid(f"node {name!r} step {i}: unknown nodeName {step['nodeName']!r}")
            if rt == "Splitter" and not isinstance(step.get("weight"), (int, float)):
                raise Invalid(f"node {name!r} step {i}: Splitter steps need a numeric weight")
    # node references must be acyclic AND depth-bounded — a stored cycle (or
    # a chain deeper than the recursive executor can walk) would turn every
    # predict() into a RecursionError.  Iterative DFS with an explicit stack:
    # the validator itself can never RecursionError, and both pathologies
    # come back as a clean Invalid at admission.
    state: dict = {}  # name -> 1 visiting, 2 done
    height: dict = {}  # name -> longest nodeName chain rooted at it

    def child_nodes(name: str):
        for step in nodes[name].get("steps") or []:
            if step.get("nodeName"):
                yield step["nodeName"]

    for root in nodes:
        if state.get(root) == 2:
            continue
        # frame: [name, child iterator, max child height seen]
        stack = [[root, child_nodes(root), 0]]
        state[root] = 1
        while stack:
            frame = stack[-1]
            child = next(frame[1], None)
            if child is None:  # post-order: all children resolved
                h = 1 + frame[2]
                if h > MAX_GRAPH_DEPTH:
                    raise Invalid(
                        f"InferenceGraph: node chain deeper than "
                        f"{MAX_GRAPH_DEPTH} (at node {frame[0]!r})")
                height[frame[0]] = h
                state[frame[0]] = 2
                stack.pop()
                if stack:
                    stack[-1][2] = max(stack[-1][2], h)
                continue
            if state.get(child) == 1:
                raise Invalid(f"InferenceGraph: cycle through node {child!r}")
            if state.get(child) == 2:
                frame[2] = max(frame[2], height[child])
                continue
            state[child] = 1
            stack.append([child, child_nodes(child), 0])


def register(api: APIServer) -> None:
    api.register_crd(CRD(group=GROUP, version=VERSION, kind="InferenceGraph",
                         plural="inferencegraphs", validator=_validate))


def inference_graph(name: str, nodes: dict, namespace: str = "default") -> Obj:
    return {
        "apiVersion": f"{GROUP}/{VERSION}",
        "kind": "InferenceGraph",
        "metadata": {"name": name, "namespace": namespace},
        "spec": {"nodes": nodes},
    }


# ----------------------------------------------------------------- condition


def _lookup_path(payload: Any, path: str) -> Any:
    cur = payload
    for part in path.split("."):
        if isinstance(cur, list):
            try:
                cur = cur[int(part)]
            except (ValueError, IndexError):
                return None
        elif isinstance(cur, dict):
            cur = cur.get(part)
        else:
            return None
    return cur


def eval_condition(cond: str, payload: Any) -> bool:
    """Dot-path mini-expressions: ``path OP literal`` with OP in
    ``== != > < >= <=``; a bare path is truthiness. Literals are JSON."""
    cond = cond.strip()
    for op in ("==", "!=", ">=", "<=", ">", "<"):
        if op in cond:
            path, _, lit = cond.partition(op)
            try:
                want = json.loads(lit.strip())
            except ValueError:
                want = lit.strip()
            got = _lookup_path(payload, path.strip())
            try:
                return {
                    "==": lambda a, b: a == b,
                    "!=": lambda a, b: a != b,
                    ">": lambda a, b: a is not None and a > b,
                    "<": lambda a, b: a is not None and a < b,
                    ">=": lambda a, b: a is not None and a >= b,
                    "<=": lambda a, b: a is not None and a <= b,
                }[op](got, want)
            except TypeError:
                return False
    return bool(_lookup_path(payload, cond))


# ------------------------------------------------------------------ executor


class GraphRouter:
    """Executes InferenceGraphs against the ingress Router (router.py)."""

    def __init__(self, api: APIServer, router, seed: int = 0):
        self.api = api
        self.router = router
        self._rng = random.Random(seed)

    def predict(self, graph_name: str, payload: dict,
                namespace: str = "default") -> Any:
        graph = self.api.get("InferenceGraph", graph_name, namespace)
        return self._run_node(graph, "root", payload, namespace)

    def _run_node(self, graph: Obj, node_name: str, payload: Any, ns: str) -> Any:
        node = graph["spec"]["nodes"][node_name]
        rt = node["routerType"]
        steps = node["steps"]
        if rt == "Sequence":
            request, out = payload, payload
            for step in steps:
                data = request if step.get("data") == "$request" else out
                out = self._run_step(graph, step, data, ns)
            return out
        if rt == "Switch":
            for step in steps:
                cond = step.get("condition")
                if cond is None or eval_condition(cond, payload):
                    return self._run_step(graph, step, payload, ns)
            raise LookupError(
                f"InferenceGraph {graph['metadata']['name']}: no Switch branch "
                f"matched in node {node_name!r}")
        if rt == "Ensemble":
            return {
                step.get("name") or step.get("serviceName") or step["nodeName"]:
                self._run_step(graph, step, payload, ns)
                for step in steps
            }
        # Splitter: weighted draw
        total = sum(float(s["weight"]) for s in steps)
        roll = self._rng.uniform(0.0, total)
        acc = 0.0
        chosen = steps[-1]
        for step in steps:
            acc += float(step["weight"])
            if roll <= acc:
                chosen = step
                break
        return self._run_step(graph, chosen, payload, ns)

    def _run_step(self, graph: Obj, step: dict, payload: Any, ns: str) -> Any:
        if step.get("nodeName"):
            return self._run_node(graph, step["nodeName"], payload, ns)
        return self.router.predict(step["serviceName"], payload, namespace=ns)


# ---------------------------------------------------------------- controller


class InferenceGraphReconciler:
    """Surfaces readiness: the graph is Ready when every referenced
    InferenceService is Ready (nodes referencing other nodes resolve
    transitively through their steps)."""

    kind = "InferenceGraph"

    def __init__(self, api: APIServer):
        self.api = api
        self.recorder = EventRecorder(api, "inferencegraph-controller")
        self._attempts: dict = {}

    def reconcile(self, req: Request) -> Optional[Result]:
        graph = self.api.try_get("InferenceGraph", req.name, req.namespace)
        if graph is None:
            self._attempts.pop((req.namespace, req.name), None)
            return None
        missing = []
        for node in graph["spec"]["nodes"].values():
            for step in node["steps"]:
                svc = step.get("serviceName")
                if not svc:
                    continue
                isvc = self.api.try_get("InferenceService", svc, req.namespace)
                if isvc is None or not has_condition(isvc.get("status", {}), "Ready"):
                    missing.append(svc)
        status = dict(graph.get("status") or {})
        ready = not missing
        changed = set_condition(
            status, "Ready", "True" if ready else "False",
            "AllServicesReady" if ready else "ServicesNotReady",
            "" if ready else f"waiting on: {sorted(set(missing))}")
        if changed:
            graph["status"] = status
            self.api.update_status(graph)
            if ready:
                self.recorder.normal(graph, "GraphReady", "all referenced services ready")
        key = (req.namespace, req.name)
        if not ready:
            from .controllers import _poll_backoff

            return Result(requeue_after=_poll_backoff(self._attempts, key, 5.0))
        self._attempts.pop(key, None)
        # there is no per-graph watch fan-out over N referenced services, so
        # re-check periodically: Ready must DEGRADE when a backend is deleted
        # or turns unready (staleness bounded at the poll interval)
        return Result(requeue_after=5.0)
