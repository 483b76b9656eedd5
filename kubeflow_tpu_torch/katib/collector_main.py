"""Katib metrics-collector sidecar: tail the main container's log, push
observations to the db-manager.

A copy of ``kubeflow_tpu/katib/collector_main.py``
(the port imports nothing of the JAX package).

Upstream analogue (UNVERIFIED, SURVEY.md §2a "Katib: metrics collectors"):
the webhook-injected sidecar ``[U:katib/pkg/metricscollector/v1beta1/]`` that
tails stdout and calls ReportObservationLog.  Injected by the katib pod
webhook (controllers.py) as a second container when the trial's
metricsCollectorSpec asks for push mode; the kubelet runs it alongside the
main container, exports ``POD_LOG_PATH``, and SIGTERMs it after the main
exits — the handler does one final tail-and-push pass before exiting, and
the kubelet only marks the pod terminal once that flush finished.

Env contract: POD_LOG_PATH (kubelet), KATIB_DB_MANAGER host:port,
KATIB_TRIAL trial name, KATIB_METRICS comma-joined metric names.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import time
import urllib.request

from .metrics import parse_metrics


def _push(addr: str, trial: str, metric: str, value: float) -> None:
    body = json.dumps({"trial": trial, "metric": metric, "value": value}).encode()
    req = urllib.request.Request(
        f"http://{addr}/report", data=body,
        headers={"Content-Type": "application/json"}, method="POST",
    )
    # timeout well under the kubelet's drain grace: the final flush must get
    # retry attempts in before the pod is force-killed
    urllib.request.urlopen(req, timeout=2).read()


def main() -> int:
    log_path = os.environ["POD_LOG_PATH"]
    stop_file = os.environ.get("POD_STOP_FILE", log_path + ".stop")
    addr = os.environ["KATIB_DB_MANAGER"]
    trial = os.environ["KATIB_TRIAL"]
    metric_names = [m for m in os.environ["KATIB_METRICS"].split(",") if m]
    stop = {"now": False}
    signal.signal(signal.SIGTERM, lambda *_: stop.update(now=True))

    offset = 0

    def drain(final: bool) -> bool:
        """One tail-parse-push pass; returns False if any push failed (the
        offset is then NOT advanced, so the next pass retries)."""
        nonlocal offset
        try:
            with open(log_path, "rb") as f:
                f.seek(offset)
                chunk = f.read()
        except OSError:
            return True
        if not chunk:
            return True
        if not final:
            # hold back a trailing partial line until newline-terminated
            # (byte-level cut so the offset stays exact under any encoding)
            cut = chunk.rfind(b"\n")
            if cut < 0:
                return True
            chunk = chunk[:cut + 1]
        text = chunk.decode(errors="replace")
        # at-least-once: advance the offset only after EVERY push in the
        # chunk succeeded; a transient db-manager failure re-drains (and may
        # re-push — the store tolerates duplicate observations, losing the
        # trial's only objective line would fail it)
        ok = True
        for metric, values in parse_metrics(text, metric_names).items():
            for v in values:
                try:
                    _push(addr, trial, metric, v)
                except OSError as e:
                    print(f"collector: push failed (will retry): {e}", flush=True)
                    ok = False
        if ok:
            offset += len(chunk)
        return ok

    def stopping() -> bool:
        # SIGTERM can land before the handler above is installed (interpreter
        # startup); the kubelet also creates the stop file, which a
        # late-starting collector cannot miss
        return stop["now"] or os.path.exists(stop_file)

    while not stopping():
        drain(final=False)
        time.sleep(0.2)
    # the pre-terminal flush the kubelet's drain window waits for: retry a
    # failed pass a couple of times — one transient push failure must not
    # cost the trial its only objective line
    for _ in range(3):
        if drain(final=True):
            break
        time.sleep(0.2)
    print("collector: final flush done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
