"""kfp-style client: compile-and-run pipelines against a Cluster.

A copy of ``kubeflow_tpu/pipelines/client.py``: ``install`` wires the
port's workflow, schedule and persistence controllers.

Upstream analogue (UNVERIFIED, SURVEY.md §3.5): ``kfp.Client`` —
``create_run_from_pipeline_func`` posts to the API server and the SDK polls
run state.  Here the "API server" is the in-process PipelineService and
polling drives the deterministic Manager.
"""

from __future__ import annotations

import os
from typing import Optional, Union

from . import api as papi
from .artifacts import ObjectStore
from .dsl import Pipeline
from .metadata import MetadataStore
from .persistence import PersistenceAgent
from .service import PipelineService
from .schedule import ScheduledWorkflowController
from .workflow import WorkflowController


def install(api, manager, workdir: str, metadata_path: Optional[str] = None):
    """Wire the pipelines control plane into a Manager (idempotent per api).

    Returns the PipelineService (the user-facing API).  A second install on
    the same apiserver returns the existing service — a second MetadataStore
    on the same WAL would corrupt it (single-writer format).
    """
    existing = getattr(api, "_kfp_service", None)
    if existing is not None:
        if os.path.abspath(os.path.join(workdir, "objects")) != existing.store.root:
            raise ValueError(
                f"pipelines already installed with workdir {existing.store.root!r}; "
                f"refusing a second install at {workdir!r} (one WAL writer per cluster)"
            )
        return existing
    papi.register(api)
    store = ObjectStore(os.path.join(workdir, "objects"))
    metadata = MetadataStore(metadata_path or os.path.join(workdir, "metadata.wal"))
    wf = WorkflowController(api, store, metadata, os.path.join(workdir, "nodes"))
    manager.add(wf, owns=("Pod",))
    manager.add(ScheduledWorkflowController(api), owns=("Workflow",))
    service = PipelineService(api, metadata, store)
    # the persistence agent is its own Workflow watcher (upstream informer →
    # ReportWorkflow architecture), not a service-internal poll ticker
    manager.add(PersistenceAgent(api, service))
    api._kfp_service = service
    return service


class RunHandle:
    def __init__(self, client: "Client", run_id: str):
        self.client = client
        self.run_id = run_id

    @property
    def state(self) -> dict:
        return self.client.service.get_run(self.run_id)

    def wait(self, timeout: float = 120.0) -> dict:
        """Drive the cluster until the run is terminal; returns the run record."""
        ok = self.client.manager.run_until(
            lambda: self.state.get("phase") in papi.WORKFLOW_TERMINAL, timeout=timeout
        )
        rec = self.state
        if not ok:
            raise TimeoutError(f"run {self.run_id} still {rec.get('phase')} after {timeout}s")
        return rec


class Client:
    """One per cluster; install() the control plane first (or let us do it)."""

    def __init__(self, cluster, service: Optional[PipelineService] = None):
        self.cluster = cluster
        self.manager = cluster.manager
        self.service = service or install(cluster.api, cluster.manager, os.path.join(cluster.workdir, "pipelines"))

    def create_run_from_pipeline_func(
        self,
        pipeline: Union[Pipeline, dict, str],
        arguments: Optional[dict] = None,
        run_name: Optional[str] = None,
        experiment: Optional[str] = None,
    ) -> RunHandle:
        run_id = self.service.create_run(pipeline, arguments=arguments, run_name=run_name, experiment=experiment)
        return RunHandle(self, run_id)
