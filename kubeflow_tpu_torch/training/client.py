"""Training Python SDK.

A copy of ``kubeflow_tpu/training/client.py``
(the port imports nothing of the JAX package).

Upstream analogue (UNVERIFIED, SURVEY.md §2a): ``kubeflow.training.
TrainingClient`` — create/get/wait/logs/delete for every job kind.  Katib
trials and Pipelines steps drive jobs through this client, exactly as
upstream's do (SURVEY.md §3.3).
"""

from __future__ import annotations

from typing import Optional

from ..core.api import Obj
from ..core.cluster import Cluster
from ..core.conditions import has_condition
from . import api as tapi


class TrainingClient:
    def __init__(self, cluster: Cluster, namespace: str = "default"):
        self.cluster = cluster
        self.namespace = namespace

    def create_job(self, job: Obj) -> Obj:
        job.setdefault("metadata", {}).setdefault("namespace", self.namespace)
        return self.cluster.api.create(job)

    def get_job(self, kind: str, name: str) -> Optional[Obj]:
        return self.cluster.api.try_get(kind, name, self.namespace)

    def job_condition(self, kind: str, name: str) -> Optional[str]:
        job = self.get_job(kind, name)
        if job is None:
            return None
        status = job.get("status", {})
        for cond in (tapi.SUCCEEDED, tapi.FAILED, tapi.RUNNING, tapi.CREATED):
            if has_condition(status, cond):
                return cond
        return None

    def wait_for_job(self, kind: str, name: str, timeout: float = 300.0) -> str:
        """Block (driving the cluster) until the job is terminal."""
        def done() -> bool:
            return self.job_condition(kind, name) in (tapi.SUCCEEDED, tapi.FAILED)

        self.cluster.wait_for(done, timeout=timeout)
        cond = self.job_condition(kind, name)
        if cond not in (tapi.SUCCEEDED, tapi.FAILED):
            raise TimeoutError(f"{kind} {name} not terminal after {timeout}s (at {cond})")
        return cond

    def get_job_logs(self, kind: str, name: str) -> dict[str, str]:
        pods = self.cluster.api.list(
            "Pod", namespace=self.namespace, label_selector={tapi.LABEL_JOB_NAME: name}
        )
        return {
            p["metadata"]["name"]: self.cluster.logs(p["metadata"]["name"], self.namespace)
            for p in pods
        }

    def delete_job(self, kind: str, name: str) -> None:
        self.cluster.api.try_delete(kind, name, self.namespace)

    def scale_job(self, kind: str, name: str, replicas: int, rtype: str = "Worker") -> Obj:
        """Elastic scale (upstream: HPA on ElasticPolicy): clamp to the
        job's [minReplicas, maxReplicas] and update the spec; the controller
        converges pods to the new world size."""
        job = self.cluster.api.get(kind, name, self.namespace)
        elastic = job["spec"].get("elasticPolicy") or {}
        lo = int(elastic.get("minReplicas", 1))
        hi = int(elastic.get("maxReplicas", replicas))
        replicas = max(lo, min(int(replicas), hi))
        job["spec"]["replicaSpecs"][rtype]["replicas"] = replicas
        # an explicit scale supersedes any elastic shrink recorded in status
        if (job.get("status") or {}).get("elasticReplicas", {}).get(rtype) is not None:
            job["status"]["elasticReplicas"].pop(rtype)
        return self.cluster.api.update(job)
