"""Serving controllers: Deployment reconciler + InferenceService reconciler.

The port's copy of ``kubeflow_tpu/serving/controllers.py``.  Two things
differ: the storage initializer init container runs
``python -m kubeflow_tpu_torch.serving.storage``, and models land under
that module's ``MOUNT_PATH``; a payload logger with no ``url`` writes
under the process's temporary directory, not the fixed ``/tmp``.

Upstream analogue (UNVERIFIED, SURVEY.md §2a "KServe: controller"): the
``InferenceServiceReconciler`` and its per-component (predictor/transformer/
explainer) reconcilers, which render Knative Services.  In this in-process
rebuild the serverless substrate is explicit: the ISVC controller renders
plain Deployments + Services, the concurrency autoscaler (autoscaler.py)
plays Knative KPA, and the router (router.py) plays istio-ingress + activator.

Canary rollout follows upstream semantics: the last fully-promoted component
spec is remembered (PROMOTED_SPEC_ANNOTATION); setting
``spec.canaryTrafficPercent`` runs latest + promoted revisions side by side
with the traffic split recorded in status and on the component Service;
clearing it promotes latest and garbage-collects the old revision.
"""

from __future__ import annotations

import copy
import hashlib
import json
import os
import tempfile
import time
import urllib.request
from typing import Optional

from ..core.api import APIServer, AlreadyExists, Obj, owner_reference
from ..core.conditions import set_condition
from ..core.controller import Request, Result
from ..core.events import EventRecorder
from ..utils.net import find_free_ports
from ..utils.render import deep_substitute
from . import api as sapi
from .api import (
    COMPONENTS,
    LABEL_COMPONENT,
    LABEL_ISVC,
    LABEL_REVISION,
    MAX_REPLICAS_ANNOTATION,
    MIN_REPLICAS_ANNOTATION,
    PROMOTED_SPEC_ANNOTATION,
    READY,
    TARGET_CONCURRENCY_ANNOTATION,
)
from .runtimes import render_container, select_runtime
from .storage import MOUNT_PATH

POD_PORT_PLACEHOLDER = "{{pod_port}}"
POD_PORT_ANNOTATION = f"{sapi.GROUP}/port"
TEMPLATE_HASH_ANNOTATION = f"{sapi.GROUP}/template-hash"
PROXY_PORT_ANNOTATION = f"{sapi.GROUP}/proxy-port"
TRAFFIC_ANNOTATION = f"{sapi.GROUP}/traffic"
SCALED_TO_ZERO_ANNOTATION = f"{sapi.GROUP}/scaled-to-zero"
DEPLOYMENT_FOR_SERVICE_ANNOTATION = f"{sapi.GROUP}/deployments"
# graceful replica drain (README "Fleet robustness"): a scale-down victim is
# MARKED draining (value = wall time the drain began) instead of deleted;
# the service proxy stops routing to it, the reconciler waits for its
# in-flight work to finish (or the timeout), then deletes it.
DRAINING_ANNOTATION = f"{sapi.GROUP}/draining"
DRAIN_TIMEOUT_S = 10.0
DRAIN_POLL_S = 0.1


def _hash(obj) -> str:
    return hashlib.md5(json.dumps(obj, sort_keys=True).encode()).hexdigest()[:8]


def _poll_backoff(attempts: dict, key, cap: float) -> float:
    """Capped exponential not-ready poll delay: 0.1 → 0.2 → … → cap.
    The counter is clamped so the exponent cannot overflow float range on a
    permanently not-ready object."""
    n = attempts[key] = min(attempts.get(key, 0) + 1, 64)
    return min(0.1 * (2 ** min(n - 1, 8)), cap)


def probe_http(port: int, path: str, timeout: float = 0.25) -> bool:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
            return 200 <= r.status < 400
    except Exception:  # noqa: BLE001 — any failure means not-ready
        return False


def pod_is_ready(pod: Obj) -> bool:
    for c in pod.get("status", {}).get("conditions", []):
        if c["type"] == "Ready":
            return c["status"] == "True"
    return False


def pod_port(pod: Obj) -> Optional[int]:
    p = pod["metadata"].get("annotations", {}).get(POD_PORT_ANNOTATION)
    return int(p) if p else None


class DeploymentReconciler:
    """Deployments → pods, with per-pod port allocation + readiness probing.

    The kubelet runs every pod on 127.0.0.1, so N replicas cannot share one
    containerPort; the reconciler allocates a free port per pod and
    substitutes ``{{pod_port}}`` in command/args/env.  Readiness = the
    container's readinessProbe.httpGet answered 2xx/3xx on that port, recorded
    as a Ready condition on the pod (the role kubelet probes play upstream).
    """

    kind = "Deployment"

    def __init__(self, api: APIServer):
        self.api = api
        self.recorder = EventRecorder(api, "deployment-controller")
        self._attempts: dict = {}  # (ns, name) -> not-ready poll count

    def reconcile(self, req: Request) -> Optional[Result]:
        deploy = self.api.try_get("Deployment", req.name, req.namespace)
        if deploy is None:
            self._attempts.pop((req.namespace, req.name), None)
            return None
        spec = deploy["spec"]
        desired = int(spec.get("replicas", 1))
        template = spec["template"]
        thash = _hash(template)
        selector = (spec.get("selector") or {}).get("matchLabels") or template["metadata"]["labels"]

        pods = [
            p
            for p in self.api.list("Pod", namespace=req.namespace, label_selector=selector)
            if any(r.get("uid") == deploy["metadata"]["uid"] for r in p["metadata"].get("ownerReferences", []))
        ]
        by_name = {p["metadata"]["name"]: p for p in pods}

        # replace pods rendered from an older template
        for p in pods:
            if p["metadata"].get("annotations", {}).get(TEMPLATE_HASH_ANNOTATION) != thash:
                self.api.try_delete("Pod", p["metadata"]["name"], req.namespace)
                by_name.pop(p["metadata"]["name"], None)

        # scale down: drain highest indices first — mark the victim
        # draining (the proxy stops routing to it on sight of the
        # annotation), wait for its in-flight work to finish, then delete.
        # A pod that never empties is force-deleted at the drain timeout.
        live = sorted(by_name)
        draining = False
        # a cancelled scale-down (replicas bounced back up before the
        # victim emptied) must UN-mark the survivor, or it would stay
        # invisible to the router and autoscaler forever
        for name in live[:desired]:
            if DRAINING_ANNOTATION in by_name[name]["metadata"].get(
                    "annotations", {}):
                self.api.patch(
                    "Pod", name,
                    {"metadata": {"annotations": {DRAINING_ANNOTATION: None}}},
                    req.namespace)
        for victim in live[desired:]:
            pod = by_name[victim]
            ann = pod["metadata"].get("annotations", {})
            if DRAINING_ANNOTATION not in ann:
                self.api.patch(
                    "Pod", victim,
                    {"metadata": {"annotations": {
                        DRAINING_ANNOTATION: str(time.time())}}},
                    req.namespace)
                draining = True
                continue
            started = float(ann.get(DRAINING_ANNOTATION) or 0.0)
            if (self._pod_drained(pod)
                    or time.time() - started >= DRAIN_TIMEOUT_S):
                self.api.try_delete("Pod", victim, req.namespace)
                by_name.pop(victim, None)
            else:
                draining = True

        # scale up: fill the lowest free indices
        i = 0
        while len(by_name) < desired:
            name = f"{req.name}-{i}"
            if name in by_name:
                i += 1
                continue
            self._create_pod(deploy, name, template, thash)
            by_name[name] = self.api.get("Pod", name, req.namespace)
            i += 1

        # readiness probing
        ready = 0
        for p in by_name.values():
            if self._probe_pod(p):
                ready += 1

        # NOTE: no resourceVersion-derived fields here — status must be a pure
        # function of pod state or the != guard below self-retriggers forever
        status = {
            "replicas": len(by_name),
            "readyReplicas": ready,
            "updatedReplicas": len(by_name),
        }
        fresh = self.api.get("Deployment", req.name, req.namespace)
        if fresh.get("status") != status:
            fresh["status"] = status
            self.api.update_status(fresh)
        key = (req.namespace, req.name)
        if ready < desired:
            # probe polling with capped backoff: a pod that never turns ready
            # must not pin the manager at 10 Hz (1s cap — probes are the only
            # readiness signal, so stay reasonably fresh)
            return Result(requeue_after=_poll_backoff(self._attempts, key, 1.0))
        self._attempts.pop(key, None)
        if draining:
            # a drain in progress needs the reconciler back promptly: the
            # victim is deleted the moment its in-flight count hits zero
            return Result(requeue_after=DRAIN_POLL_S)
        return None

    def _pod_drained(self, pod: Obj) -> bool:
        """True when a draining pod provably has no in-flight work left: no
        active HTTP requests AND (for engine pods) no active slots or
        queued generations.  A failed scrape is UNKNOWN, not drained — a
        busy pod is exactly the one whose scrape times out, and deleting
        on unknown would kill the in-flight work the drain exists to
        protect; a truly dead pod is force-deleted at DRAIN_TIMEOUT_S."""
        port = pod_port(pod)
        if port is None:
            return True
        from .autoscaler import scrape_metrics  # local: avoids import cycle

        m = scrape_metrics(port, timeout=0.5)
        if m is None:
            return False
        return (m.get("inflight_requests", 0.0) == 0.0
                and m.get("engine_active_slots", 0.0) == 0.0
                and m.get("engine_queue_depth", 0.0) == 0.0)

    def _create_pod(self, deploy: Obj, name: str, template: dict, thash: str) -> None:
        port = find_free_ports(1)[0]
        pod = {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": name,
                "namespace": deploy["metadata"].get("namespace", "default"),
                "labels": dict(template["metadata"].get("labels", {})),
                "annotations": {
                    **template["metadata"].get("annotations", {}),
                    TEMPLATE_HASH_ANNOTATION: thash,
                    POD_PORT_ANNOTATION: str(port),
                },
                "ownerReferences": [owner_reference(deploy)],
            },
            "spec": deep_substitute(copy.deepcopy(template["spec"]), {POD_PORT_PLACEHOLDER: str(port)}),
        }
        pod["spec"].setdefault("restartPolicy", "Always")
        try:
            self.api.create(pod)
        except AlreadyExists:
            pass

    def _probe_pod(self, pod: Obj) -> bool:
        phase = pod.get("status", {}).get("phase")
        if phase != "Running":
            return False
        probe = (pod["spec"]["containers"][0].get("readinessProbe") or {}).get("httpGet")
        port = pod_port(pod)
        if probe is None or port is None:
            ok = True  # no probe: running == ready
        else:
            ok = probe_http(port, probe.get("path", "/"))
        fresh = self.api.try_get("Pod", pod["metadata"]["name"], pod["metadata"].get("namespace", "default"))
        if fresh is not None:
            status = fresh.setdefault("status", {})
            if set_condition(status, "Ready", "True" if ok else "False", "Probe", ""):
                self.api.update_status(fresh)
        return ok


class InferenceServiceReconciler:
    kind = "InferenceService"

    def __init__(self, api: APIServer):
        self.api = api
        self.recorder = EventRecorder(api, "inferenceservice-controller")
        self._attempts: dict = {}  # (ns, name) -> not-ready poll count

    # ------------------------------------------------------------- reconcile

    def reconcile(self, req: Request) -> Optional[Result]:
        isvc = self.api.try_get("InferenceService", req.name, req.namespace)
        if isvc is None:
            self._attempts.pop((req.namespace, req.name), None)
            return None
        spec = isvc["spec"]
        status = isvc.setdefault("status", {})
        # non-condition status fields, for the change guard at the end
        # (condition changes are tracked via set_condition's return value;
        # their lastUpdateTime churns every call and must not count)
        old_fields = {k: copy.deepcopy(v) for k, v in status.items() if k != "conditions"}
        cond_changed = False
        canary = spec.get("canaryTrafficPercent")
        annotations = isvc["metadata"].setdefault("annotations", {})
        promoted_raw = annotations.get(PROMOTED_SPEC_ANNOTATION)
        promoted = json.loads(promoted_raw) if promoted_raw else None

        all_ready = True
        components_status = {}
        predictor_addr = None
        # predictor first: the transformer env needs its service address
        for comp in ("predictor", "explainer", "transformer"):
            cspec = spec.get(comp)
            if cspec is None:
                continue
            revisions = self._desired_revisions(comp, cspec, promoted, canary)
            comp_ready, info = self._reconcile_component(
                isvc, comp, revisions, predictor_addr=predictor_addr
            )
            latest_hash = revisions[0][0]
            latest_ready = latest_hash in info.pop("readyRevisions")
            if comp == "predictor":
                predictor_addr = info["address"]
                # promote once the latest revision is ready and no canary is set
                if latest_ready and canary is None:
                    if promoted is None or _hash(promoted.get(comp, {})) != latest_hash:
                        promoted = dict(promoted or {})
                        promoted[comp] = cspec
                        fresh = self.api.get("InferenceService", req.name, req.namespace)
                        fresh["metadata"].setdefault("annotations", {})[
                            PROMOTED_SPEC_ANNOTATION
                        ] = json.dumps(promoted)
                        isvc = self.api.update(fresh)
                        status = isvc.setdefault("status", {})
            if latest_ready:
                # old revisions are torn down only once latest serves (no-downtime)
                self._gc_old_revisions(isvc, comp, keep={r for r, _, _ in revisions})
            ctype = {"predictor": sapi.PREDICTOR_READY, "transformer": sapi.TRANSFORMER_READY, "explainer": sapi.EXPLAINER_READY}[comp]
            cond_changed |= set_condition(status, ctype, "True" if comp_ready else "False", "ComponentReady" if comp_ready else "ComponentNotReady")
            all_ready = all_ready and comp_ready
            components_status[comp] = info

        entry = "transformer" if "transformer" in spec else "predictor"
        entry_port = components_status[entry]["proxyPort"]
        status["components"] = components_status
        # upstream shape: status.url is the EXTERNAL ingress URL (rendered
        # from the inferenceservice-config ConfigMap), status.address.url the
        # in-cluster address the router actually dials
        from .config import external_url, isvc_config

        status["url"] = external_url(
            isvc_config(self.api), isvc["metadata"]["name"],
            isvc["metadata"].get("namespace", "default"))
        status["address"] = {"url": f"http://127.0.0.1:{entry_port}"}
        cond_changed |= set_condition(status, READY, "True" if all_ready else "False", "AllReady" if all_ready else "NotReady")
        new_fields = {k: v for k, v in status.items() if k != "conditions"}
        if cond_changed or new_fields != old_fields:
            # write only on a real change: an unconditional write retriggers
            # this controller's own watch — a self-sustaining reconcile storm
            self.api.update_status(isvc)
        key = (req.namespace, req.name)
        if not all_ready:
            # poll with capped exponential backoff: a never-ready service must
            # not pin the manager at 10 Hz forever (deployment/pod watch
            # events still requeue immediately on real transitions)
            return Result(requeue_after=_poll_backoff(self._attempts, key, 5.0))
        self._attempts.pop(key, None)
        return None

    # -------------------------------------------------------------- revisions

    def _desired_revisions(
        self, comp: str, cspec: dict, promoted: Optional[dict], canary: Optional[int]
    ) -> list[tuple[str, dict, int]]:
        """[(revision_hash, component_spec, traffic_percent)] — latest first.

        Canary applies to the predictor (upstream semantics); other components
        always run only the latest spec.
        """
        latest = (_hash(cspec), cspec)
        if comp != "predictor" or canary is None or promoted is None or comp not in promoted:
            return [(*latest, 100)]
        prom = (_hash(promoted[comp]), promoted[comp])
        if prom[0] == latest[0]:
            return [(*latest, 100)]
        return [(*latest, canary), (*prom, 100 - canary)]

    # -------------------------------------------------------------- component

    def _reconcile_component(
        self,
        isvc: Obj,
        comp: str,
        revisions: list[tuple[str, dict, int]],
        predictor_addr: Optional[str],
    ) -> tuple[bool, dict]:
        name = isvc["metadata"]["name"]
        ns = isvc["metadata"].get("namespace", "default")
        service = self._ensure_service(isvc, comp)
        proxy_port = int(service["metadata"]["annotations"][PROXY_PORT_ANNOTATION])

        traffic = {}
        deployments = []
        ready_any = False
        latest_ready = None
        ready_revs: set[str] = set()
        for rev, cspec, pct in revisions:
            dname = f"{name}-{comp}-{rev}"
            deploy = self._ensure_deployment(isvc, comp, rev, cspec, dname, predictor_addr)
            deployments.append(dname)
            traffic[rev] = pct
            st = deploy.get("status", {})
            rev_ready = st.get("readyReplicas", 0) >= 1 or (
                deploy["metadata"].get("annotations", {}).get(SCALED_TO_ZERO_ANNOTATION) == "true"
            )
            if rev_ready:
                ready_any = True
                ready_revs.add(rev)
                if latest_ready is None:
                    latest_ready = rev
        # the service proxy needs the split + deployment list (for activation)
        self.api.patch(
            "Service",
            service["metadata"]["name"],
            {
                "metadata": {
                    "annotations": {
                        TRAFFIC_ANNOTATION: json.dumps(traffic),
                        DEPLOYMENT_FOR_SERVICE_ANNOTATION: json.dumps(deployments),
                    }
                }
            },
            ns,
        )
        info = {
            "address": f"127.0.0.1:{proxy_port}",
            "proxyPort": proxy_port,
            "latestReadyRevision": latest_ready,
            "readyRevisions": ready_revs,
            "traffic": [
                {"revisionName": f"{name}-{comp}-{rev}", "percent": pct, "latestRevision": i == 0}
                for i, (rev, _, pct) in enumerate(revisions)
            ],
        }
        return ready_any, info

    def _ensure_service(self, isvc: Obj, comp: str) -> Obj:
        name = isvc["metadata"]["name"]
        ns = isvc["metadata"].get("namespace", "default")
        sname = f"{name}-{comp}"
        svc = self.api.try_get("Service", sname, ns)
        if svc is not None:
            return svc
        port = find_free_ports(1)[0]
        return self.api.create(
            {
                "apiVersion": "v1",
                "kind": "Service",
                "metadata": {
                    "name": sname,
                    "namespace": ns,
                    "labels": {LABEL_ISVC: name, LABEL_COMPONENT: comp},
                    "annotations": {PROXY_PORT_ANNOTATION: str(port)},
                    "ownerReferences": [owner_reference(isvc)],
                },
                "spec": {"selector": {LABEL_ISVC: name, LABEL_COMPONENT: comp}},
            }
        )

    def _ensure_deployment(
        self, isvc: Obj, comp: str, rev: str, cspec: dict, dname: str, predictor_addr: Optional[str]
    ) -> Obj:
        ns = isvc["metadata"].get("namespace", "default")
        existing = self.api.try_get("Deployment", dname, ns)
        if existing is not None:
            return existing
        name = isvc["metadata"]["name"]
        pod_spec = self._render_pod_spec(isvc, comp, cspec, predictor_addr)
        labels = {LABEL_ISVC: name, LABEL_COMPONENT: comp, LABEL_REVISION: rev}
        deploy = {
            "apiVersion": "apps/v1",
            "kind": "Deployment",
            "metadata": {
                "name": dname,
                "namespace": ns,
                "labels": dict(labels),
                "annotations": {
                    TARGET_CONCURRENCY_ANNOTATION: str(cspec.get("scaleTarget", 4)),
                    MIN_REPLICAS_ANNOTATION: str(cspec.get("minReplicas", 1)),
                    MAX_REPLICAS_ANNOTATION: str(cspec.get("maxReplicas", 3)),
                },
                "ownerReferences": [owner_reference(isvc)],
            },
            "spec": {
                "replicas": max(1, cspec.get("minReplicas", 1)),
                "selector": {"matchLabels": dict(labels)},
                "template": {"metadata": {"labels": dict(labels)}, "spec": pod_spec},
            },
        }
        created = self.api.create(deploy)
        self.recorder.normal(isvc, "DeploymentCreated", f"{comp} revision {rev} -> {dname}")
        return created

    def _render_pod_spec(
        self, isvc: Obj, comp: str, cspec: dict, predictor_addr: Optional[str]
    ) -> dict:
        name = isvc["metadata"]["name"]
        if cspec.get("containers"):
            containers = copy.deepcopy(cspec["containers"])
            init = copy.deepcopy(cspec.get("initContainers", []))
        else:
            model = cspec["model"]
            runtime = select_runtime(self.api, isvc["metadata"].get("namespace", "default"), model)
            model_dir = f"{MOUNT_PATH}/{isvc['metadata']['uid']}-{comp}"
            container = render_container(
                runtime,
                model_name=name,
                model_dir=model_dir,
                port=POD_PORT_PLACEHOLDER,  # deferred to per-pod allocation
                storage_uri=model.get("storageUri", ""),
            )
            init = []
            if model.get("storageUri"):
                import sys

                init.append(
                    {
                        "name": "storage-initializer",
                        "command": [sys.executable, "-m", "kubeflow_tpu_torch.serving.storage"],
                        "args": [model["storageUri"], model_dir],
                    }
                )
            containers = [container]
        main = containers[0]
        main.setdefault(
            "readinessProbe",
            {"httpGet": {"path": "/v2/health/ready", "port": POD_PORT_PLACEHOLDER}},
        )
        env = main.setdefault("env", [])
        have = {e["name"] for e in env}
        # transformers AND explainers interrogate the predictor over HTTP
        # (upstream: the Alibi explainer pod calls the predictor service)
        if (comp in ("transformer", "explainer") and predictor_addr
                and "PREDICTOR_HOST" not in have):
            env.append({"name": "PREDICTOR_HOST", "value": predictor_addr})
        # KServe-agent features (SURVEY.md §2a agent row): component-level
        # batcher/logger specs become env the runtime wraps the model with
        batcher = cspec.get("batcher")
        if batcher is not None:  # {} = enable with defaults (kserve semantics)
            env.append({"name": "BATCHER_MAX_BATCH_SIZE",
                        "value": str(batcher.get("maxBatchSize", 8))})
            env.append({"name": "BATCHER_MAX_LATENCY_MS",
                        "value": str(batcher.get("maxLatency", 20))})
        logger = cspec.get("logger")
        if logger is not None:
            env.append({"name": "LOGGER_MODE", "value": logger.get("mode", "all")})
            env.append({"name": "LOGGER_PATH",
                        "value": logger.get("url", os.path.join(
                            tempfile.gettempdir(),
                            f"{name}-{comp}-payload.jsonl"))})
        return {"containers": containers, "initContainers": init}

    def _gc_old_revisions(self, isvc: Obj, comp: str, keep: set[str]) -> None:
        name = isvc["metadata"]["name"]
        ns = isvc["metadata"].get("namespace", "default")
        for d in self.api.list(
            "Deployment", namespace=ns, label_selector={LABEL_ISVC: name, LABEL_COMPONENT: comp}
        ):
            if d["metadata"]["labels"].get(LABEL_REVISION) not in keep:
                self.api.try_delete("Deployment", d["metadata"]["name"], ns)
