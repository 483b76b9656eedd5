"""kfadm: the kfctl-equivalent platform deployment CLI.

Upstream analogue (UNVERIFIED, SURVEY.md §2a/§3.2): ``kfctl apply -f
kfdef.yaml`` — a ``KfDef`` spec lists applications; the coordinator renders
and applies them, CRDs first, then waits for readiness.  Here "applying an
application" wires that pillar's CRDs + controllers into the cluster's
Manager (the in-process equivalent of installing its manifests), and the
KfDef CR's status records per-application conditions.

The port's copy of ``kubeflow_tpu/platform/kfadm.py``: each application is
the port's plane of that pillar (its training operator, Katib, serving
control plane and Pipelines service) on the port's cluster of GPU nodes.
"""

from __future__ import annotations

import os
from typing import Optional

from ..core.api import AlreadyExists, APIServer, CRD, Invalid, Obj
from ..core.cluster import Cluster

APPLICATIONS = ("platform", "training", "katib", "serving", "pipelines")


def register(api: APIServer) -> None:
    api.register_crd(
        CRD(group="kfdef.apps.kubeflow.org", version="v1", kind="KfDef", plural="kfdefs",
            validator=_validate)
    )


def _validate(obj: Obj) -> None:
    apps = [a.get("name") for a in obj.get("spec", {}).get("applications", [])]
    unknown = [a for a in apps if a not in APPLICATIONS]
    if unknown:
        raise Invalid(f"unknown applications {unknown}; available: {list(APPLICATIONS)}")


def kfdef(name: str = "kubeflow", applications: tuple = APPLICATIONS) -> Obj:
    return {
        "apiVersion": "kfdef.apps.kubeflow.org/v1",
        "kind": "KfDef",
        "metadata": {"name": name, "namespace": "kubeflow"},
        "spec": {"applications": [{"name": a} for a in applications]},
    }


class KfAdm:
    """Coordinator: Init → Generate → Apply over a live Cluster."""

    def __init__(self, cluster: Cluster):
        self.cluster = cluster
        self.installed: dict = {}
        register(cluster.api)

    def apply(self, kfdef_obj: Obj) -> Obj:
        api, manager = self.cluster.api, self.cluster.manager
        try:
            obj = api.create(kfdef_obj)
        except AlreadyExists:
            obj = api.get("KfDef", kfdef_obj["metadata"]["name"], "kubeflow")
        statuses = []
        for app in obj["spec"]["applications"]:
            name = app["name"]
            if name in self.installed:
                statuses.append({"name": name, "status": "Ready", "note": "already installed"})
                continue
            handle = self._install(name, api, manager)
            self.installed[name] = handle
            statuses.append({"name": name, "status": "Ready"})
        obj["status"] = {"applications": statuses, "phase": "Ready"}
        return api.update_status(obj)

    def _install(self, name: str, api: APIServer, manager):
        if name == "platform":
            from . import controllers as platform_controllers

            return platform_controllers.install(api, manager)
        if name == "training":
            from ..training.frameworks import install as training_install

            return training_install(api, manager)
        if name == "katib":
            from ..katib.controllers import install as katib_install

            return katib_install(
                api, manager, self.cluster.logs,
                store_path=os.path.join(self.cluster.workdir, "katib", "obslog.wal"),
            )
        if name == "serving":
            from ..serving import install as serving_install

            return serving_install(api, manager)
        if name == "pipelines":
            from ..pipelines.client import install as pipelines_install

            return pipelines_install(api, manager, os.path.join(self.cluster.workdir, "pipelines"))
        raise Invalid(f"unknown application {name!r}")

    def delete(self, name: str = "kubeflow") -> None:
        """Delete the KfDef (installed controllers stay until shutdown —
        upstream kfctl delete likewise leaves CRDs by default)."""
        self.cluster.api.try_delete("KfDef", name, "kubeflow")
