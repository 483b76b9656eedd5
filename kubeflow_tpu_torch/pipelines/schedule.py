"""ScheduledWorkflow controller: cron/interval-triggered pipeline runs.

A copy of ``kubeflow_tpu/pipelines/schedule.py``.

Upstream analogue (UNVERIFIED, SURVEY.md §2): KFP's ScheduledWorkflow CRD +
controller (`[U:pipelines/backend/src/crd/controller/scheduledworkflow]`) —
recurring runs with max-concurrency gating.
"""

from __future__ import annotations

import time
from typing import Optional

from ..core.api import AlreadyExists, APIServer, Obj, owner_reference
from ..core.events import EventRecorder
from ..core.controller import Request, Result
from . import api as papi
from . import cron


class ScheduledWorkflowController:
    kind = "ScheduledWorkflow"

    def __init__(self, api: APIServer):
        self.api = api
        self.recorder = EventRecorder(api, "scheduledworkflow-controller")

    def _active(self, swf: Obj) -> int:
        wfs = self.api.list(
            "Workflow",
            namespace=swf["metadata"].get("namespace", "default"),
            label_selector={"scheduledworkflow": swf["metadata"]["name"]},
        )
        return sum(
            1
            for w in wfs
            if w.get("status", {}).get("phase") not in papi.WORKFLOW_TERMINAL
        )

    def _next_fire(self, swf: Obj, now: float) -> Optional[float]:
        trigger = swf["spec"]["trigger"]
        last = swf.get("status", {}).get("lastFiredAt")
        if "intervalSeconds" in trigger:
            base = last if last is not None else now - trigger["intervalSeconds"]
            return base + trigger["intervalSeconds"]
        return cron.next_fire(trigger["cron"], last if last is not None else now)

    def reconcile(self, req: Request) -> Optional[Result]:
        swf = self.api.try_get("ScheduledWorkflow", req.name, req.namespace)
        if swf is None:
            return None
        status = swf.setdefault("status", {})
        if not swf["spec"].get("enabled", True):
            return None
        now = time.time()
        fire_at = self._next_fire(swf, now)
        if fire_at is None:
            return None
        if fire_at > now:
            return Result(requeue_after=min(fire_at - now, 60.0))
        if self._active(swf) >= swf["spec"].get("maxConcurrency", 1):
            status["conditions"] = [{"type": "Throttled", "lastUpdate": now}]
            self.api.update_status(swf)
            return Result(requeue_after=1.0)
        n = status.get("fireCount", 0) + 1
        wf = papi.workflow(
            f"{req.name}-{n}",
            swf["spec"]["pipelineSpec"],
            arguments=swf["spec"].get("arguments"),
            namespace=req.namespace,
            labels={"scheduledworkflow": req.name},
        )
        wf["metadata"]["ownerReferences"] = [owner_reference(swf)]
        try:
            self.api.create(wf)
            self.recorder.normal(swf, "WorkflowTriggered", f"created workflow {req.name}-{n}")
        except AlreadyExists:
            pass
        status["fireCount"] = n
        status["lastFiredAt"] = now
        self.api.update_status(swf)
        nxt = self._next_fire(swf, now)
        return Result(requeue_after=max(0.05, min((nxt or now + 60) - now, 60.0)))
