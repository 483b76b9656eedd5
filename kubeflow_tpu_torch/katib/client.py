"""Katib Python SDK (upstream analogue: kubeflow-katib KatibClient).

A copy of ``kubeflow_tpu/katib/client.py``
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Optional

from ..core.api import Obj
from ..core.cluster import Cluster
from ..core.conditions import has_condition
from . import api as kapi


class KatibClient:
    def __init__(self, cluster: Cluster, namespace: str = "default"):
        self.cluster = cluster
        self.namespace = namespace

    def create_experiment(self, exp: Obj) -> Obj:
        exp.setdefault("metadata", {}).setdefault("namespace", self.namespace)
        return self.cluster.api.create(exp)

    def get_experiment(self, name: str) -> Optional[Obj]:
        return self.cluster.api.try_get("Experiment", name, self.namespace)

    def wait_for_experiment(self, name: str, timeout: float = 600.0) -> str:
        def done() -> bool:
            e = self.get_experiment(name)
            return e is not None and (
                has_condition(e.get("status", {}), kapi.SUCCEEDED)
                or has_condition(e.get("status", {}), kapi.FAILED)
            )

        self.cluster.wait_for(done, timeout=timeout)
        e = self.get_experiment(name)
        status = e.get("status", {}) if e else {}
        if has_condition(status, kapi.SUCCEEDED):
            return kapi.SUCCEEDED
        if has_condition(status, kapi.FAILED):
            return kapi.FAILED
        raise TimeoutError(f"experiment {name} not terminal after {timeout}s")

    def get_optimal_trial(self, name: str) -> Optional[dict]:
        e = self.get_experiment(name)
        return (e or {}).get("status", {}).get("currentOptimalTrial")

    def list_trials(self, name: str) -> list[Obj]:
        return self.cluster.api.list(
            "Trial", namespace=self.namespace,
            label_selector={kapi.LABEL_EXPERIMENT: name},
        )
