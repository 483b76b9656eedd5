"""Katib CRD types: Experiment / Suggestion / Trial.

A copy of ``kubeflow_tpu/katib/api.py``
(the port imports nothing of the JAX package).

Upstream analogue (UNVERIFIED, SURVEY.md §2a Katib rows): the
``kubeflow.org/v1beta1`` Katib API — objective/algorithm/parameters/
trialTemplate on Experiment, parameter assignments on Suggestion/Trial,
observation metrics on Trial status.  Trial templates embed any training job
kind (TPUJob-first here) with ``${trialParameters.x}`` substitution.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..core.api import APIServer, CRD, Invalid, Obj

GROUP = "kubeflow.org"
VERSION = "v1beta1"
API_VERSION = f"{GROUP}/{VERSION}"

PARAMETER_TYPES = ("double", "int", "categorical", "discrete")

# condition types
CREATED = "Created"
RUNNING = "Running"
SUCCEEDED = "Succeeded"
FAILED = "Failed"
EARLY_STOPPED = "EarlyStopped"

LABEL_EXPERIMENT = "katib.kubeflow.org/experiment"


def _validate_experiment(obj: Obj) -> None:
    spec = obj.get("spec", {})
    if not spec.get("parameters"):
        raise Invalid("Experiment: spec.parameters required")
    for p in spec["parameters"]:
        if p.get("parameterType") not in PARAMETER_TYPES:
            raise Invalid(f"Experiment: bad parameterType {p.get('parameterType')!r}")
        fs = p.get("feasibleSpace", {})
        if p["parameterType"] in ("double", "int") and ("min" not in fs or "max" not in fs):
            raise Invalid(f"Experiment: parameter {p.get('name')}: feasibleSpace.min/max required")
        if p["parameterType"] in ("categorical", "discrete") and not fs.get("list"):
            raise Invalid(f"Experiment: parameter {p.get('name')}: feasibleSpace.list required")
    obj_spec = spec.get("objective", {})
    if obj_spec.get("type") not in ("maximize", "minimize"):
        raise Invalid("Experiment: objective.type must be maximize|minimize")
    if not obj_spec.get("objectiveMetricName"):
        raise Invalid("Experiment: objective.objectiveMetricName required")
    if not spec.get("trialTemplate", {}).get("trialSpec"):
        raise Invalid("Experiment: trialTemplate.trialSpec required")
    algo = spec.get("algorithm", {}).get("algorithmName", "random")
    from .suggest import algorithm_names

    if algo not in algorithm_names():
        raise Invalid(f"Experiment: unknown algorithm {algo!r}; have {algorithm_names()}")


def _default_experiment(obj: Obj) -> None:
    spec = obj.setdefault("spec", {})
    spec.setdefault("maxTrialCount", 10)
    spec.setdefault("parallelTrialCount", 3)
    spec.setdefault("maxFailedTrialCount", 3)
    spec.setdefault("algorithm", {}).setdefault("algorithmName", "random")
    spec.setdefault("metricsCollectorSpec", {"collector": {"kind": "StdOut"}})
    # NAS experiments (upstream nasConfig): expand the cell description into
    # one categorical parameter per layer — the shape the enas suggester and
    # the ${trialParameters.*} rendering already understand
    nas = spec.get("nasConfig")
    if nas and not spec.get("parameters"):
        ops = [o.get("operationType", str(i)) for i, o in enumerate(nas.get("operations", []))]
        layers = int(nas.get("graphConfig", {}).get("numLayers", 1))
        spec["parameters"] = [
            {"name": f"layer_{i}_op", "parameterType": "categorical",
             "feasibleSpace": {"list": ops}}
            for i in range(layers)
        ]


def register(api: APIServer) -> None:
    api.register_crd(CRD(GROUP, VERSION, "Experiment", "experiments",
                         validator=_validate_experiment, defaulter=_default_experiment))
    api.register_crd(CRD(GROUP, VERSION, "Suggestion", "suggestions"))
    api.register_crd(CRD(GROUP, VERSION, "Trial", "trials"))


# ------------------------------------------------------------ typed builders

@dataclass
class Parameter:
    name: str
    parameter_type: str  # double|int|categorical|discrete
    min: Optional[float] = None
    max: Optional[float] = None
    step: Optional[float] = None
    list: Optional[list] = None

    def to_obj(self) -> dict:
        fs: dict = {}
        if self.min is not None:
            fs["min"] = self.min
        if self.max is not None:
            fs["max"] = self.max
        if self.step is not None:
            fs["step"] = self.step
        if self.list is not None:
            fs["list"] = list(self.list)
        return {"name": self.name, "parameterType": self.parameter_type, "feasibleSpace": fs}


def experiment(
    name: str,
    parameters: list[Parameter],
    trial_spec: Obj,
    objective_metric: str,
    objective_type: str = "maximize",
    goal: Optional[float] = None,
    algorithm: str = "random",
    algorithm_settings: Optional[dict] = None,
    max_trials: int = 10,
    parallel_trials: int = 3,
    max_failed: int = 3,
    trial_parameters: Optional[list[dict]] = None,
    namespace: str = "default",
    metrics_collector: Optional[dict] = None,
) -> Obj:
    objective = {"type": objective_type, "objectiveMetricName": objective_metric}
    if goal is not None:
        objective["goal"] = goal
    spec_extra = (
        {"metricsCollectorSpec": metrics_collector} if metrics_collector else {})
    return {
        "apiVersion": API_VERSION,
        "kind": "Experiment",
        "metadata": {"name": name, "namespace": namespace},
        "spec": {
            "objective": objective,
            "algorithm": {
                "algorithmName": algorithm,
                "algorithmSettings": [
                    {"name": k, "value": str(v)} for k, v in (algorithm_settings or {}).items()
                ],
            },
            "parameters": [p.to_obj() for p in parameters],
            "maxTrialCount": max_trials,
            "parallelTrialCount": parallel_trials,
            "maxFailedTrialCount": max_failed,
            "trialTemplate": {
                "primaryContainerName": "main",
                "trialParameters": trial_parameters
                or [{"name": p.name, "reference": p.name} for p in parameters],
                "trialSpec": trial_spec,
            },
            **spec_extra,
        },
    }
