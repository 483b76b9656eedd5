"""EventRecorder — k8s Events on every reconcile decision.

A copy of ``kubeflow_tpu/core/events.py``.

Upstream analogue (UNVERIFIED): client-go ``record.EventRecorder``; SURVEY.md
§5 notes events+conditions are the platform's observability UX and must be
kept verbatim.
"""

from __future__ import annotations

import time
import uuid

from .api import APIServer, Obj


class EventRecorder:
    def __init__(self, api: APIServer, component: str):
        self.api = api
        self.component = component

    def event(self, obj: Obj, etype: str, reason: str, message: str) -> None:
        meta = obj.get("metadata", {})
        ns = meta.get("namespace", "default")
        self.api.create(
            {
                "apiVersion": "v1",
                "kind": "Event",
                "metadata": {
                    "name": f"{meta.get('name', 'unknown')}.{uuid.uuid4().hex[:12]}",
                    "namespace": ns,
                },
                "type": etype,  # Normal | Warning
                "reason": reason,
                "message": message,
                "source": {"component": self.component},
                "involvedObject": {
                    "kind": obj.get("kind"),
                    "name": meta.get("name"),
                    "namespace": ns,
                    "uid": meta.get("uid"),
                },
                "firstTimestamp": time.time(),
            }
        )

    def normal(self, obj: Obj, reason: str, message: str) -> None:
        self.event(obj, "Normal", reason, message)

    def warning(self, obj: Obj, reason: str, message: str) -> None:
        self.event(obj, "Warning", reason, message)


def events_for(api: APIServer, obj: Obj) -> list[Obj]:
    uid = obj["metadata"]["uid"]
    return [
        e
        for e in api.list("Event", namespace=obj["metadata"].get("namespace", "default"))
        if e.get("involvedObject", {}).get("uid") == uid
    ]
