"""Status conditions — the platform's user-facing state machine.

A copy of ``kubeflow_tpu/core/conditions.py``.

Upstream analogue (UNVERIFIED): ``JobCondition`` handling in
training-operator's common controller and the metav1.Condition conventions
used across Kubeflow controllers (SURVEY.md §5 "conditions+events model").
"""

from __future__ import annotations

import time
from typing import Optional


def get_condition(status: dict, ctype: str) -> Optional[dict]:
    for c in status.get("conditions", []):
        if c["type"] == ctype:
            return c
    return None


def has_condition(status: dict, ctype: str, value: str = "True") -> bool:
    c = get_condition(status, ctype)
    return c is not None and c["status"] == value


def set_condition(
    status: dict,
    ctype: str,
    value: str,
    reason: str = "",
    message: str = "",
) -> bool:
    """Upsert a condition. Returns True if anything changed.

    Mirrors upstream semantics: lastTransitionTime only moves when the
    condition's status flips, and setting a terminal/active condition is the
    caller's policy (see training.common for the Job condition rules).
    """
    conditions = status.setdefault("conditions", [])
    now = time.time()
    for c in conditions:
        if c["type"] == ctype:
            changed = c["status"] != value or c.get("reason") != reason or c.get("message") != message
            if c["status"] != value:
                c["lastTransitionTime"] = now
            c["status"] = value
            c["reason"] = reason
            c["message"] = message
            c["lastUpdateTime"] = now
            return changed
    conditions.append(
        {
            "type": ctype,
            "status": value,
            "reason": reason,
            "message": message,
            "lastUpdateTime": now,
            "lastTransitionTime": now,
        }
    )
    return True
