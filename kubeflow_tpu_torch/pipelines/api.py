"""Pipelines CRDs + typed builders.

A copy of ``kubeflow_tpu/pipelines/api.py``.

Upstream analogue (UNVERIFIED, SURVEY.md §2): Argo's ``Workflow`` CR (the KFP
execution substrate) and KFP's ``ScheduledWorkflow`` CR.  Pipeline/run/
experiment records live in the PipelineService (service.py) — upstream keeps
those in MySQL, not CRDs, and we mirror that split.
"""

from __future__ import annotations

from typing import Optional

from ..core.api import APIServer, CRD, Invalid, Obj

GROUP = "pipelines.kubeflow.org"
VERSION = "v1"

LABEL_RUN = f"{GROUP}/run"
LABEL_WORKFLOW = f"{GROUP}/workflow"
LABEL_NODE = f"{GROUP}/node"

# workflow / node phases
PENDING = "Pending"
RUNNING = "Running"
SUCCEEDED = "Succeeded"
FAILED = "Failed"
SKIPPED = "Skipped"    # condition evaluated false
OMITTED = "Omitted"    # upstream dependency failed/skipped
NODE_TERMINAL = {SUCCEEDED, FAILED, SKIPPED, OMITTED}
WORKFLOW_TERMINAL = {SUCCEEDED, FAILED}


def _validate_workflow(obj: Obj) -> None:
    spec = obj.get("spec", {})
    ir = spec.get("pipelineSpec")
    if not isinstance(ir, dict) or "root" not in ir or "deploymentSpec" not in ir:
        raise Invalid("Workflow.spec.pipelineSpec must be a compiled pipeline IR")
    tasks = ir["root"].get("dag", {}).get("tasks", {})
    if not tasks:
        raise Invalid("Workflow pipelineSpec has no tasks")
    for name, node in tasks.items():
        for dep in node.get("dependentTasks", []):
            if dep not in tasks:
                raise Invalid(f"task {name!r} depends on unknown task {dep!r}")


def _validate_scheduled(obj: Obj) -> None:
    spec = obj.get("spec", {})
    trigger = spec.get("trigger", {})
    if ("intervalSeconds" in trigger) == ("cron" in trigger):
        raise Invalid("ScheduledWorkflow.spec.trigger needs exactly one of intervalSeconds | cron")
    if "pipelineSpec" not in spec:
        raise Invalid("ScheduledWorkflow.spec.pipelineSpec is required")


def register(api: APIServer) -> None:
    api.register_crd(
        CRD(group=GROUP, version=VERSION, kind="Workflow", plural="workflows", validator=_validate_workflow)
    )
    api.register_crd(
        CRD(
            group=GROUP,
            version=VERSION,
            kind="ScheduledWorkflow",
            plural="scheduledworkflows",
            validator=_validate_scheduled,
        )
    )


def workflow(
    name: str,
    pipeline_spec: dict,
    arguments: Optional[dict] = None,
    namespace: str = "default",
    labels: Optional[dict] = None,
) -> Obj:
    return {
        "apiVersion": f"{GROUP}/{VERSION}",
        "kind": "Workflow",
        "metadata": {"name": name, "namespace": namespace, "labels": dict(labels or {})},
        "spec": {"pipelineSpec": pipeline_spec, "arguments": dict(arguments or {})},
    }


def scheduled_workflow(
    name: str,
    pipeline_spec: dict,
    interval_seconds: Optional[float] = None,
    cron: Optional[str] = None,
    arguments: Optional[dict] = None,
    max_concurrency: int = 1,
    namespace: str = "default",
) -> Obj:
    trigger: dict = {}
    if interval_seconds is not None:
        trigger["intervalSeconds"] = interval_seconds
    if cron is not None:
        trigger["cron"] = cron
    return {
        "apiVersion": f"{GROUP}/{VERSION}",
        "kind": "ScheduledWorkflow",
        "metadata": {"name": name, "namespace": namespace},
        "spec": {
            "pipelineSpec": pipeline_spec,
            "arguments": dict(arguments or {}),
            "trigger": trigger,
            "maxConcurrency": max_concurrency,
            "enabled": True,
        },
    }
