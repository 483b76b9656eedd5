"""Katib UI data API: the endpoints the katib-ui frontend binds to.

A copy of ``kubeflow_tpu/katib/service.py``
(the port imports nothing of the JAX package).

Upstream analogue (UNVERIFIED, SURVEY.md §2a "Katib: db-manager + UI" row):
the Katib UI's backend REST layer (experiment/trial listings and detail
views) plus db-manager's ``GetObservationLog``.  Scope per SURVEY.md §7:
capabilities, not pixels — this is the data layer a UI would render.
"""

from __future__ import annotations

from typing import Optional

from ..core.api import APIServer
from ..core.conditions import has_condition
from . import api as kapi
from .obslog import ObservationStore


def _phase(status: dict) -> str:
    for cond, phase in ((kapi.EARLY_STOPPED, "EarlyStopped"), (kapi.SUCCEEDED, "Succeeded"),
                        (kapi.FAILED, "Failed"), (kapi.RUNNING, "Running"),
                        (kapi.CREATED, "Created")):
        if has_condition(status, cond):
            return phase
    return "Pending"


class KatibService:
    """Read-side aggregation over the API store + observation store."""

    def __init__(self, api: APIServer, store: ObservationStore):
        self.api = api
        self.store = store

    # -------------------------------------------------------- experiments

    def list_experiments(self, namespace: Optional[str] = None) -> list[dict]:
        out = []
        for exp in self.api.list("Experiment", namespace=namespace):
            status = exp.get("status", {})
            out.append({
                "name": exp["metadata"]["name"],
                "namespace": exp["metadata"].get("namespace", "default"),
                "status": _phase(status),
                "algorithm": exp["spec"]["algorithm"]["algorithmName"],
                "objective": exp["spec"]["objective"]["objectiveMetricName"],
                "trials": status.get("trials", 0),
                "trialsSucceeded": status.get("trialsSucceeded", 0),
                "trialsFailed": status.get("trialsFailed", 0),
                "trialsRunning": status.get("trialsRunning", 0),
            })
        return out

    def get_experiment(self, name: str, namespace: str = "default") -> Optional[dict]:
        exp = self.api.try_get("Experiment", name, namespace)
        if exp is None:
            return None
        status = exp.get("status", {})
        return {
            "name": name,
            "namespace": namespace,
            "status": _phase(status),
            "spec": exp["spec"],
            "conditions": status.get("conditions", []),
            "currentOptimalTrial": status.get("currentOptimalTrial"),
            "trials": self.list_trials(name, namespace),
        }

    # ------------------------------------------------------------- trials

    def list_trials(self, experiment: str, namespace: str = "default") -> list[dict]:
        out = []
        for t in self.api.list("Trial", namespace=namespace,
                               label_selector={kapi.LABEL_EXPERIMENT: experiment}):
            status = t.get("status", {})
            out.append({
                "name": t["metadata"]["name"],
                "status": _phase(status),
                "parameterAssignments": t["spec"].get("parameterAssignments", []),
                "observation": status.get("observation", {"metrics": []}),
            })
        return out

    def get_trial(self, name: str, namespace: str = "default") -> Optional[dict]:
        t = self.api.try_get("Trial", name, namespace)
        if t is None:
            return None
        status = t.get("status", {})
        metrics = self.store.metrics(name)
        return {
            "name": name,
            "namespace": namespace,
            "status": _phase(status),
            "parameterAssignments": t["spec"].get("parameterAssignments", []),
            "observation": status.get("observation", {"metrics": []}),
            "conditions": status.get("conditions", []),
            # full intermediate series per metric — the GetObservationLog view
            "observationLog": {m: self.get_observation_log(name, m) for m in metrics},
        }

    def get_observation_log(self, trial: str, metric: str,
                            start: int = 0) -> list[dict]:
        return [{"step": s, "value": v} for s, v in self.store.get_log(trial, metric, start)]
