"""Training job CRD types: TPUJob/JAXJob, TFJob, PyTorchJob, MPIJob, XGBoostJob.

A copy of ``kubeflow_tpu/training/api.py``
(the port imports nothing of the JAX package).  The API accepts
``spec.tpu`` as the JAX package's does; on the port's GPU nodes such a job
is refused by scheduling (training/common.py).

Upstream analogue (UNVERIFIED, SURVEY.md §2a): training-operator's
``kubeflow.org/v1`` API — ``ReplicaSpec{replicas, template, restartPolicy}``,
``RunPolicy{cleanPodPolicy, ttlSecondsAfterFinished, backoffLimit,
schedulingPolicy}``, ``JobCondition{Created,Running,Restarting,Succeeded,
Failed}``.  The TPU-first addition is ``spec.tpu`` on every job kind:
``{accelerator, topology, numSlices}`` drives topology-aware gang scheduling
and rendezvous env injection (the reference's NCCL/TF_CONFIG wiring mapped to
ICI/DCN, SURVEY.md §2c).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..core.api import APIServer, CRD, Invalid, Obj

GROUP = "kubeflow.org"
VERSION = "v1"
API_VERSION = f"{GROUP}/{VERSION}"

# job kinds and their replica-type conventions
JOB_KINDS = {
    "TPUJob": {"types": ("Worker",), "chief": "Worker"},
    "JAXJob": {"types": ("Worker",), "chief": "Worker"},
    "TFJob": {"types": ("Chief", "Master", "PS", "Worker", "Evaluator"), "chief": "Chief"},
    "PyTorchJob": {"types": ("Master", "Worker"), "chief": "Master"},
    "MPIJob": {"types": ("Launcher", "Worker"), "chief": "Launcher"},
    "MXJob": {"types": ("Scheduler", "Server", "Worker"), "chief": "Worker"},
    "PaddleJob": {"types": ("Master", "Worker"), "chief": "Worker"},
    "XGBoostJob": {"types": ("Master", "Worker"), "chief": "Master"},
}

# condition types (upstream JobCondition)
CREATED = "Created"
RUNNING = "Running"
RESTARTING = "Restarting"
SUCCEEDED = "Succeeded"
FAILED = "Failed"

# labels (group/domain mirrors upstream's training.kubeflow.org labels)
LABEL_JOB_NAME = "training.kubeflow.org/job-name"
LABEL_REPLICA_TYPE = "training.kubeflow.org/replica-type"
LABEL_REPLICA_INDEX = "training.kubeflow.org/replica-index"

RESTART_POLICIES = ("Always", "OnFailure", "Never", "ExitCode")
CLEAN_POD_POLICIES = ("Running", "All", "None")


def _validate_job(obj: Obj) -> None:
    kind = obj["kind"]
    spec = obj.get("spec", {})
    replica_specs = spec.get("replicaSpecs") or {}
    if not replica_specs:
        raise Invalid(f"{kind}: spec.replicaSpecs required (spec.tpu only sizes them)")
    allowed = JOB_KINDS[kind]["types"]
    for rtype, rspec in replica_specs.items():
        if rtype not in allowed:
            raise Invalid(f"{kind}: unknown replica type {rtype!r}; allowed {allowed}")
        rp = rspec.get("restartPolicy", "Never")
        if rp not in RESTART_POLICIES:
            raise Invalid(f"{kind}: bad restartPolicy {rp!r}")
        if "template" not in rspec:
            raise Invalid(f"{kind}: replicaSpecs[{rtype}].template required")
        # single-coordinator replica types (upstream enforces one master)
        if rtype in ("Master", "Chief", "Launcher", "Scheduler") and rspec.get("replicas", 1) > 1:
            raise Invalid(f"{kind}: replicaSpecs[{rtype}].replicas must be 1")
    run = spec.get("runPolicy", {})
    cpp = run.get("cleanPodPolicy", "None")
    if cpp not in CLEAN_POD_POLICIES:
        raise Invalid(f"{kind}: bad cleanPodPolicy {cpp!r}")


def _default_job(obj: Obj) -> None:
    spec = obj.setdefault("spec", {})
    run = spec.setdefault("runPolicy", {})
    run.setdefault("cleanPodPolicy", "None")
    run.setdefault("backoffLimit", 3)
    for rspec in (spec.get("replicaSpecs") or {}).values():
        rspec.setdefault("replicas", 1)
        rspec.setdefault("restartPolicy", "Never")


def register(api: APIServer) -> None:
    for kind in JOB_KINDS:
        api.register_crd(
            CRD(
                group=GROUP,
                version=VERSION,
                kind=kind,
                plural=kind.lower() + "s",
                validator=_validate_job,
                defaulter=_default_job,
            )
        )


# ------------------------------------------------------------ typed builders

@dataclass
class TPUSpec:
    """TPU-first extension: request a slice by shape, not by pod arithmetic."""

    accelerator: str = "v5e"
    topology: str = "2x2"
    num_slices: int = 1

    def to_obj(self) -> dict:
        return {
            "accelerator": self.accelerator,
            "topology": self.topology,
            "numSlices": self.num_slices,
        }


@dataclass
class ReplicaSpec:
    replicas: int = 1
    restart_policy: str = "Never"
    command: list[str] = field(default_factory=list)
    env: dict[str, str] = field(default_factory=dict)
    image: str = "local"
    resources: dict = field(default_factory=dict)
    node_selector: dict = field(default_factory=dict)

    def to_obj(self) -> dict:
        return {
            "replicas": self.replicas,
            "restartPolicy": self.restart_policy,
            "template": {
                "spec": {
                    "nodeSelector": dict(self.node_selector) or None,
                    "containers": [
                        {
                            "name": "main",
                            "image": self.image,
                            "command": list(self.command),
                            "env": [{"name": k, "value": v} for k, v in self.env.items()],
                            "resources": dict(self.resources),
                        }
                    ],
                }
            },
        }


def job(
    kind: str,
    name: str,
    replica_specs: dict[str, ReplicaSpec],
    namespace: str = "default",
    tpu: Optional[TPUSpec] = None,
    run_policy: Optional[dict] = None,
) -> Obj:
    return {
        "apiVersion": API_VERSION,
        "kind": kind,
        "metadata": {"name": name, "namespace": namespace},
        "spec": {
            "replicaSpecs": {t: r.to_obj() for t, r in replica_specs.items()},
            **({"tpu": tpu.to_obj()} if tpu else {}),
            **({"runPolicy": run_policy} if run_policy else {}),
        },
    }
