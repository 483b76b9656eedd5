"""Reading one profiler capture of the program: the Chrome trace that the
port's ``parallel.profiling.Capture`` exports.

A capture opens with a primer of small kernels and a lead-in, then leaves a
mark (a ``profiling.capture`` annotation) from which it counts.  The device
records kept here are those of the launch calls made at or after the mark,
tied to them by correlation id, so the primer is left out, as is the
lead-out after the last record.  The capture's own count of lost records
is the program's (``Capture.lost_records``); a capture that lost any is not
read at all.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Optional

MARK = "profiling.capture"
_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH = ("cuda_runtime", "cuda_driver")
_HOST = ("cpu_op", "user_annotation", "python_function")


def short_name(name: str) -> str:
    """A kernel's name without ``void``, template arguments or parameters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    for sep in ("<", "("):
        name = name.split(sep, 1)[0]
    return name.strip() or "?"


class TraceView:
    """The device records of one capture from its mark on (``records``:
    ``(name, start_s, end_s)``), the host events of the thread that launched
    most of them."""

    def __init__(self, path: str):
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        marks = [e["ts"] for e in events if e.get("name") == MARK]
        t_mark = min(marks) if marks else float("-inf")
        launch_ts, launch_tid = {}, {}
        for e in events:
            if e.get("cat") in _LAUNCH and "correlation" in e.get("args", {}):
                launch_ts[e["args"]["correlation"]] = e["ts"]
                launch_tid[e["args"]["correlation"]] = e.get("tid")
        self.records = []
        tids = defaultdict(int)
        for e in events:
            if e.get("cat") not in _DEVICE:
                continue
            corr = e.get("args", {}).get("correlation")
            if corr in launch_ts and launch_ts[corr] >= t_mark:
                self.records.append((e["name"], e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6))
                tids[launch_tid[corr]] += 1
        self.records.sort(key=lambda r: r[1])
        host_tid = max(tids, key=tids.get) if tids else None
        self.host = sorted((e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6, e["name"])
                           for e in events
                           if e.get("cat") in _HOST and e.get("tid") == host_tid
                           and e["ts"] >= t_mark)
        self._busy = _merge([(s, e) for _, s, e in self.records])

    @property
    def window_s(self) -> float:
        """From the first counted record's start to the last one's end."""
        if not self._busy:
            return 0.0
        return self._busy[-1][1] - self._busy[0][0]

    @property
    def busy_s(self) -> float:
        """Seconds in which some counted record ran on the device."""
        return sum(e - s for s, e in self._busy)

    def kernels(self, marker: str) -> list:
        """``(start_s, end_s)`` of the records whose name holds ``marker``."""
        return [(s, e) for n, s, e in self.records if marker in n]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by what the host thread was doing at each gap's middle (its
        innermost event there, else the last one that ended before)."""
        by_op = defaultdict(float)
        for n, s, e in self.records:
            by_op[short_name(n)] += e - s
        gaps = [(a, b) for (_, a), (b, _) in zip(self._busy, self._busy[1:])]
        by_host = defaultdict(float)
        for (a, b), name in zip(gaps, self._host_at([(a + b) / 2 for a, b in gaps])):
            by_host[name] += b - a
        pick = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": pick(by_op), "idle_gaps": pick(by_host)}

    def _host_at(self, times: list) -> list:
        """For each of the ascending ``times``, the innermost host event
        open then (a thread's events nest), else "after" the last one that
        had ended."""
        out, stack = [], []
        last: Optional[tuple] = None
        i = 0

        def close(t):
            nonlocal last
            while stack and stack[-1][1] < t:
                ended = stack.pop()
                if last is None or ended[1] > last[1]:
                    last = ended

        for t in times:
            while i < len(self.host) and self.host[i][0] <= t:
                close(self.host[i][0])
                stack.append(self.host[i])
                i += 1
            close(t)
            if stack:
                out.append(stack[-1][2])
            else:
                out.append("after " + last[2] if last is not None else "no host event")
        return out


def _merge(spans: list) -> list:
    out: list = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out
