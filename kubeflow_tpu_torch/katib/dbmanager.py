"""Katib db-manager service: the push-mode observation-log endpoint.

A copy of ``kubeflow_tpu/katib/dbmanager.py``
(the port imports nothing of the JAX package).

Upstream analogue (UNVERIFIED, SURVEY.md §2a "Katib: db-manager + UI" row):
``[U:katib/cmd/db-manager]`` — a gRPC façade (ReportObservationLog /
GetObservationLog) over MySQL that the webhook-injected metrics-collector
sidecars push to.  Here it is a threaded HTTP façade over the C++ WAL
ObservationStore (obslog.py), bound to loopback on an ephemeral port; the
collector sidecar (collector_main.py) POSTs each parsed observation.  The
store's C core holds the mutex, so server threads and the trial
controller's reads interleave safely.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from .obslog import ObservationStore


class DBManagerServer:
    """ReportObservationLog/GetObservationLog over loopback HTTP."""

    def __init__(self, store: ObservationStore, port: int = 0):
        self.store = store
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_POST(self):
                if urlparse(self.path).path != "/report":
                    self.send_error(404)
                    return
                n = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(n))
                    outer.store.report(
                        str(body["trial"]), str(body["metric"]),
                        float(body["value"]),
                        step=int(body["step"]) if body.get("step") is not None else None,
                    )
                except (ValueError, KeyError, TypeError) as e:
                    self.send_error(400, str(e))
                    return
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"ok")

            def do_GET(self):
                url = urlparse(self.path)
                if url.path != "/log":
                    self.send_error(404)
                    return
                q = parse_qs(url.query)
                series = outer.store.get_log(
                    q.get("trial", [""])[0], q.get("metric", [""])[0],
                    start=int(q.get("start", ["0"])[0]),
                )
                payload = json.dumps(series).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def address(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"{host}:{port}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
