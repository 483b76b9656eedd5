"""The port's autoscaler after an activation: scale to zero waits for the
activated pod to have been ready for the grace period.

The activator (router.py) un-zeroes a Deployment on a request and holds the
request until a pod is ready; the autoscaler scales a Deployment with no
traffic back to zero once the grace has passed since the activation.  A pod
that takes longer than the grace to start (a busy host) used to be scaled
away in the sync that first saw it ready, before the held request reached
it: the request then failed.  The grace now also counts from the moment
every replica is ready."""

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from kubeflow_tpu_torch.core.api import APIServer
from kubeflow_tpu_torch.serving.api import (MIN_REPLICAS_ANNOTATION,
                                            SCALE_TO_ZERO_GRACE_ANNOTATION,
                                            TARGET_CONCURRENCY_ANNOTATION)
from kubeflow_tpu_torch.serving.autoscaler import (ACTIVATED_AT_ANNOTATION,
                                                   ConcurrencyAutoscaler)
from kubeflow_tpu_torch.serving.controllers import POD_PORT_ANNOTATION

GRACE = 0.3


class _Idle(BaseHTTPRequestHandler):
    """A model server with nothing in flight and no request served yet."""

    def do_GET(self):  # noqa: N802
        body = b"inflight_requests 0\n"
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


@pytest.fixture()
def idle_server():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Idle)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv.server_address[1]
    srv.shutdown()
    srv.server_close()


def _activated(api: APIServer, port: int, activated_s_ago: float, ready: bool = True):
    api.create({"apiVersion": "apps/v1", "kind": "Deployment",
                "metadata": {"name": "d", "annotations": {
                    TARGET_CONCURRENCY_ANNOTATION: "1", MIN_REPLICAS_ANNOTATION: "0",
                    SCALE_TO_ZERO_GRACE_ANNOTATION: str(GRACE),
                    ACTIVATED_AT_ANNOTATION: str(time.time() - activated_s_ago)}},
                "spec": {"replicas": 1, "selector": {"matchLabels": {"app": "d"}},
                         "template": {"metadata": {"labels": {"app": "d"}},
                                      "spec": {"containers": [{"name": "c",
                                                               "command": ["x"]}]}}}})
    api.create({"apiVersion": "v1", "kind": "Pod",
                "metadata": {"name": "d-1", "labels": {"app": "d"},
                             "annotations": {POD_PORT_ANNOTATION: str(port)}},
                "spec": {},
                "status": {"phase": "Running", "conditions": [
                    {"type": "Ready", "status": "True" if ready else "False"}]}})
    time.sleep(GRACE + 0.05)  # the Deployment is older than the grace


def _replicas(api: APIServer) -> int:
    return api.get("Deployment", "d")["spec"]["replicas"]


def test_activated_pod_ready_late_is_not_scaled_away_at_once(idle_server):
    """Activated 5 s ago (past the grace), its pod ready only now: the first
    sync keeps it (its held request is on its way); a sync after the grace,
    with still no traffic, scales it to zero."""
    api = APIServer()
    _activated(api, idle_server, activated_s_ago=5.0)
    asc = ConcurrencyAutoscaler(api)
    assert not asc.sync()
    assert _replicas(api) == 1
    time.sleep(GRACE + 0.05)
    assert asc.sync()
    assert _replicas(api) == 0


def test_grace_restarts_when_a_replica_is_not_ready(idle_server):
    """A replica that is not ready vetoes scale to zero and resets the
    readiness clock: the grace counts again from the sync that sees every
    replica ready."""
    api = APIServer()
    _activated(api, idle_server, activated_s_ago=5.0, ready=False)
    asc = ConcurrencyAutoscaler(api)
    assert not asc.sync()
    time.sleep(GRACE + 0.05)
    pod = api.get("Pod", "d-1")
    pod["status"]["conditions"][0]["status"] = "True"
    api.update_status(pod)
    assert not asc.sync()  # ready from now on: the grace starts here
    assert _replicas(api) == 1
    time.sleep(GRACE + 0.05)
    assert asc.sync()
    assert _replicas(api) == 0
