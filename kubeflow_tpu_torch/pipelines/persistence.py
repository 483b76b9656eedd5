"""KFP persistence agent: a dedicated Workflow watcher reporting run state.

A copy of ``kubeflow_tpu/pipelines/persistence.py``.

Upstream analogue (UNVERIFIED, SURVEY.md §2a "KFP persistence agent" row):
``[U:pipelines/backend/src/agent/persistence/]`` — an informer on Argo
``Workflow`` CRs that calls the API server's ``ReportWorkflow`` RPC so the
run database reflects workflow state without the API server polling Argo.

Round 2 folded this into a ``sync_runs`` ticker inside the service (the
documented single-process deviation); this module restores the upstream
architecture: a separate watch-driven controller whose only job is
Workflow → ReportWorkflow.  Event-driven, not polled — the controller's
watch stream fires exactly when a Workflow's status changes.
"""

from __future__ import annotations

from typing import Optional

from ..core.api import APIServer
from ..core.controller import Request, Result


class PersistenceAgent:
    """Watches Workflow CRs; reports each change to the service's
    ``report_workflow`` (the ReportWorkflow RPC stand-in)."""

    kind = "Workflow"

    def __init__(self, api: APIServer, service):
        self.api = api
        self.service = service

    def reconcile(self, req: Request) -> Optional[Result]:
        wf = self.api.try_get("Workflow", req.name, req.namespace)
        if wf is None:
            return None
        self.service.report_workflow(wf)
        return None
