"""Platform controllers: Profile, Notebook (+ StatefulSet), PodDefaults.

A copy of ``kubeflow_tpu/platform/controllers.py``.

Upstream analogues (UNVERIFIED, SURVEY.md §2a):
  * profile-controller — ``Profile`` CR → per-user namespace, RBAC
    (Role/RoleBinding), ResourceQuota, Istio AuthorizationPolicy;
  * notebook-controller — ``Notebook`` CR → StatefulSet + Service, idle
    culling via the last-activity annotation;
  * admission-webhook — ``PodDefault`` mutating injection into pods whose
    labels match the selector (wired through the APIServer's
    register_mutating_webhook, the in-process admission chain).

The StatefulSet reconciler lives here because notebooks are its only platform
consumer (serving owns its Deployment reconciler for the same reason).
"""

from __future__ import annotations

import time
from typing import Optional

from ..core.api import AlreadyExists, APIServer, Obj, owner_reference
from ..core.conditions import set_condition
from ..core.events import EventRecorder
from ..core.controller import Request, Result
from . import api as papi

DEFAULT_CULL_IDLE_SECONDS = 3600.0


class ProfileController:
    kind = "Profile"

    def __init__(self, api: APIServer):
        self.api = api
        self.recorder = EventRecorder(api, "profile-controller")

    def reconcile(self, req: Request) -> Optional[Result]:
        prof = self.api.try_get("Profile", req.name)
        if prof is None:
            return None
        owner = prof["spec"]["owner"]["name"]
        ns_name = prof["metadata"]["name"]

        ns = self.api.try_get("Namespace", ns_name)
        if ns is None:
            self.api.create(
                {
                    "apiVersion": "v1",
                    "kind": "Namespace",
                    "metadata": {
                        "name": ns_name,
                        "labels": {papi.PROFILE_OWNER_LABEL: owner, papi.PROFILE_LABEL: ns_name},
                        "ownerReferences": [owner_reference(prof)],
                    },
                }
            )
            self.recorder.normal(prof, "NamespaceCreated", f"namespace {ns_name} for {owner}")

        self._ensure(
            {
                "apiVersion": "rbac.authorization.k8s.io/v1",
                "kind": "Role",
                "metadata": {"name": "namespaceAdmin", "namespace": ns_name,
                             "ownerReferences": [owner_reference(prof)]},
                "rules": [{"apiGroups": ["*"], "resources": ["*"], "verbs": ["*"]}],
            }
        )
        self._ensure(
            {
                "apiVersion": "rbac.authorization.k8s.io/v1",
                "kind": "RoleBinding",
                "metadata": {"name": f"user-{_slug(owner)}-admin", "namespace": ns_name,
                             "labels": {"role": "admin", "user": owner},
                             "ownerReferences": [owner_reference(prof)]},
                "subjects": [{"kind": "User", "name": owner}],
                "roleRef": {"kind": "Role", "name": "namespaceAdmin"},
            }
        )
        self._ensure(
            {
                "apiVersion": "v1",
                "kind": "ServiceAccount",
                "metadata": {"name": "default-editor", "namespace": ns_name,
                             "ownerReferences": [owner_reference(prof)]},
            }
        )
        self._ensure(
            {
                "apiVersion": "security.istio.io/v1beta1",
                "kind": "AuthorizationPolicy",
                "metadata": {"name": "ns-owner-access", "namespace": ns_name,
                             "ownerReferences": [owner_reference(prof)]},
                "spec": {"rules": [{"when": [{"key": "request.headers[kubeflow-userid]",
                                              "values": [owner]}]}]},
            }
        )
        quota = prof["spec"].get("resourceQuotaSpec")
        if quota:
            self._ensure(
                {
                    "apiVersion": "v1",
                    "kind": "ResourceQuota",
                    "metadata": {"name": "kf-resource-quota", "namespace": ns_name,
                                 "ownerReferences": [owner_reference(prof)]},
                    "spec": dict(quota),
                }
            )

        status = dict(prof.get("status", {}))
        if set_condition(status, papi.READY, "True", "ProfileReady",
                         f"namespace {ns_name} provisioned"):
            # only write on a real transition: an unconditional status write
            # bumps resourceVersion, which re-triggers this controller's own
            # watch — a self-sustaining reconcile storm (r2 settle() stalls)
            prof["status"] = status
            self.api.update_status(prof)
        return None

    def _ensure(self, obj: Obj) -> None:
        try:
            self.api.create(obj)
        except AlreadyExists:
            pass


def _slug(email: str) -> str:
    return email.replace("@", "-").replace(".", "-")


class StatefulSetReconciler:
    """Ordered, stable-identity pods <name>-0..n-1 (subset notebooks need)."""

    kind = "StatefulSet"

    def __init__(self, api: APIServer):
        self.api = api

    def reconcile(self, req: Request) -> Optional[Result]:
        sts = self.api.try_get("StatefulSet", req.name, req.namespace)
        if sts is None:
            return None
        spec = sts["spec"]
        desired = int(spec.get("replicas", 1))
        template = spec["template"]
        labels = dict(template.get("metadata", {}).get("labels", {}))

        ready = 0
        for i in range(desired):
            pname = f"{req.name}-{i}"
            pod = self.api.try_get("Pod", pname, req.namespace)
            if pod is None:
                self.api.create(
                    {
                        "apiVersion": "v1",
                        "kind": "Pod",
                        "metadata": {
                            "name": pname,
                            "namespace": req.namespace,
                            "labels": labels,
                            "ownerReferences": [owner_reference(sts)],
                        },
                        "spec": dict(template["spec"]),
                    }
                )
            elif pod.get("status", {}).get("phase") == "Running":
                ready += 1
        # scale down: delete extra ordinals (highest first, like upstream)
        i = desired
        while self.api.try_delete("Pod", f"{req.name}-{i}", req.namespace):
            i += 1

        old = sts.get("status") or {}
        if old.get("replicas") != desired or old.get("readyReplicas") != ready:
            sts["status"] = {**old, "replicas": desired, "readyReplicas": ready}
            self.api.update_status(sts)
        return None


class NotebookController:
    kind = "Notebook"

    def __init__(self, api: APIServer):
        self.api = api
        self.recorder = EventRecorder(api, "notebook-controller")

    def reconcile(self, req: Request) -> Optional[Result]:
        nb = self.api.try_get("Notebook", req.name, req.namespace)
        if nb is None:
            return None
        culled = nb["metadata"].get("annotations", {}).get(papi.CULLED_ANNOTATION) == "true"
        replicas = 0 if culled else 1

        template = dict(nb["spec"]["template"])
        template.setdefault("metadata", {}).setdefault("labels", {})[papi.NOTEBOOK_LABEL] = req.name
        sts = {
            "apiVersion": "apps/v1",
            "kind": "StatefulSet",
            "metadata": {"name": req.name, "namespace": req.namespace,
                         "ownerReferences": [owner_reference(nb)]},
            "spec": {"replicas": replicas, "template": template},
        }
        existing = self.api.try_get("StatefulSet", req.name, req.namespace)
        if existing is None:
            self.api.create(sts)
        elif int(existing["spec"].get("replicas", 1)) != replicas:
            existing["spec"]["replicas"] = replicas
            self.api.update(existing)

        try:
            self.api.create(
                {
                    "apiVersion": "v1",
                    "kind": "Service",
                    "metadata": {"name": req.name, "namespace": req.namespace,
                                 "ownerReferences": [owner_reference(nb)]},
                    "spec": {"selector": {papi.NOTEBOOK_LABEL: req.name}},
                }
            )
        except AlreadyExists:
            pass

        pod = self.api.try_get("Pod", f"{req.name}-0", req.namespace)
        running = pod is not None and pod.get("status", {}).get("phase") == "Running"
        status = dict(nb.get("status", {}))
        ready_changed = set_condition(
            status, papi.READY, "True" if running else "False",
            "NotebookRunning" if running else "NotebookPending",
            f"pod {req.name}-0 {'running' if running else 'not running'}")
        culled_changed = set_condition(
            status, papi.CULLED, "True" if culled else "False",
            "Culled" if culled else "Active",
            "idle-culled to zero" if culled else "notebook active")
        if ready_changed or culled_changed:  # guard: see ProfileController
            nb["status"] = status
            self.api.update_status(nb)
        return None


class NotebookCuller:
    """Ticker: cull notebooks idle past the threshold (scale STS to zero).

    Activity signal = the last-activity annotation (refreshed by the spawner
    /notebook UI upstream; tests and the dashboard refresh it here).
    """

    def __init__(self, api: APIServer, idle_seconds: float = DEFAULT_CULL_IDLE_SECONDS):
        self.api = api
        self.idle_seconds = idle_seconds
        self.recorder = EventRecorder(api, "notebook-culler")

    def sync(self) -> bool:
        changed = False
        for nb in self.api.list("Notebook"):
            ann = nb["metadata"].get("annotations", {})
            if ann.get(papi.CULLED_ANNOTATION) == "true":
                continue
            last = float(ann.get(papi.LAST_ACTIVITY_ANNOTATION, nb["metadata"]["creationTimestamp"]))
            if time.time() - last >= self.idle_seconds:
                self.api.patch(
                    "Notebook",
                    nb["metadata"]["name"],
                    {"metadata": {"annotations": {papi.CULLED_ANNOTATION: "true"}}},
                    nb["metadata"].get("namespace", "default"),
                )
                self.recorder.normal(nb, "NotebookCulled",
                                     f"idle {time.time() - last:.0f}s >= {self.idle_seconds:.0f}s")
                changed = True
        return changed


def install_poddefaults_webhook(api: APIServer) -> None:
    """Mutating admission: inject matching PodDefaults into new pods."""

    def mutate(pod: Obj) -> None:
        ns = pod["metadata"].get("namespace", "default")
        labels = pod["metadata"].get("labels") or {}
        for pd in api.list("PodDefault", namespace=ns):
            sel = (pd["spec"]["selector"] or {}).get("matchLabels") or {}
            if not sel or not all(labels.get(k) == v for k, v in sel.items()):
                continue
            spec = pd["spec"]
            pod["metadata"].setdefault("annotations", {}).update(spec.get("annotations", {}))
            for c in pod.get("spec", {}).get("containers", []):
                have = {e["name"] for e in c.get("env", [])}
                c.setdefault("env", []).extend(
                    e for e in spec.get("env", []) if e["name"] not in have
                )
                c.setdefault("volumeMounts", []).extend(spec.get("volumeMounts", []))
            pod["spec"].setdefault("volumes", []).extend(spec.get("volumes", []))
            pod["spec"].setdefault("tolerations", []).extend(spec.get("tolerations", []))

    api.register_mutating_webhook("Pod", mutate)


def install(api: APIServer, manager, cull_idle_seconds: float = DEFAULT_CULL_IDLE_SECONDS):
    """Wire the platform shell into a Manager."""
    papi.register(api)
    install_poddefaults_webhook(api)
    manager.add(ProfileController(api), owns=("Namespace",))
    manager.add(StatefulSetReconciler(api), owns=("Pod",))
    manager.add(NotebookController(api), owns=("StatefulSet",))
    culler = NotebookCuller(api, cull_idle_seconds)
    manager.add_ticker(culler.sync)
    return culler
