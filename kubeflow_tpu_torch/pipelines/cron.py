"""Minimal 5-field cron matcher for ScheduledWorkflow triggers.

A copy of ``kubeflow_tpu/pipelines/cron.py``.

Upstream analogue (UNVERIFIED): KFP's ScheduledWorkflow controller supports
cron + interval triggers (`[U:pipelines/backend/src/crd/controller/
scheduledworkflow]`).  Supported syntax per field (minute hour dom month dow):
``*``, ``*/N``, ``A``, ``A-B``, and comma lists thereof.  dow: 0-6, 0=Sunday.
"""

from __future__ import annotations

import time
from typing import Optional

_RANGES = [(0, 59), (0, 23), (1, 31), (1, 12), (0, 6)]


def _parse_field(field: str, lo: int, hi: int) -> set[int]:
    out: set[int] = set()
    for part in field.split(","):
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            step = int(step_s)
            if step <= 0:
                raise ValueError(f"bad cron step in {field!r}")
        if part == "*":
            lo2, hi2 = lo, hi
        elif "-" in part:
            a, b = part.split("-", 1)
            lo2, hi2 = int(a), int(b)
        else:
            lo2 = hi2 = int(part)
        if not (lo <= lo2 <= hi2 <= hi):
            raise ValueError(f"cron field {field!r} out of range [{lo},{hi}]")
        out.update(range(lo2, hi2 + 1, step))
    return out


def parse(expr: str) -> list[set[int]]:
    fields = expr.split()
    if len(fields) != 5:
        raise ValueError(f"cron expression needs 5 fields, got {expr!r}")
    return [_parse_field(f, lo, hi) for f, (lo, hi) in zip(fields, _RANGES)]


def _matches_fields(fields: list[set[int]], ts: float) -> bool:
    minute, hour, dom, month, dow = fields
    t = time.localtime(ts)
    return (
        t.tm_min in minute
        and t.tm_hour in hour
        and t.tm_mday in dom
        and t.tm_mon in month
        and t.tm_wday in _to_cron_dow(dow)
    )


def matches(expr: str, ts: float) -> bool:
    return _matches_fields(parse(expr), ts)


def _to_cron_dow(dow: set[int]) -> set[int]:
    # struct_time: Monday=0..Sunday=6; cron: Sunday=0..Saturday=6
    return {(d - 1) % 7 for d in dow}


def next_fire(expr: str, after: float, horizon_days: int = 366) -> Optional[float]:
    """Next minute-aligned timestamp strictly after `after` matching the expr."""
    fields = parse(expr)  # parse once; the probe loop is minute-by-minute
    t = int(after // 60 + 1) * 60
    end = after + horizon_days * 86400
    while t <= end:
        if _matches_fields(fields, t):
            return float(t)
        t += 60
    return None
