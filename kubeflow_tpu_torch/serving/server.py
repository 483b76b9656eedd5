"""Model server: the V1 predict and V2 generate HTTP surfaces.

A reduced copy of ``kubeflow_tpu/serving/server.py`` (the port imports
nothing from the JAX package): ``Model`` is the kserve-style base class and
``ModelServer`` a dependency-free ThreadingHTTPServer serving

    GET  /v2/health/live, /v2/health/ready, /v2/models/<name>/ready
    POST /v2/models/<name>/generate, /v1/models/<name>:predict

with the same request and response shapes and the same error mapping
(RequestError 400, DeadlineExceeded 504, SessionBusy 409,
EngineOverloaded/EngineShutdown 503, anything else 500).  Streaming, the
OpenAI surfaces, /metrics and the engine debug routes come in later slices.
"""

from __future__ import annotations

import json
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

from .errors import (DeadlineExceeded, EngineOverloaded, EngineShutdown,
                     RequestError, SessionBusy)


class Model:
    """Base model: override load/predict (and optionally pre/postprocess).

    The call chain for one request is ``preprocess -> predict ->
    postprocess``."""

    def __init__(self, name: str):
        self.name = name
        self.ready = False

    def load(self) -> None:
        self.ready = True

    def preprocess(self, payload: Any, headers: Optional[dict] = None) -> Any:
        return payload

    def predict(self, payload: Any, headers: Optional[dict] = None) -> Any:
        raise NotImplementedError

    def postprocess(self, payload: Any, headers: Optional[dict] = None) -> Any:
        return payload

    def explain(self, payload: Any, headers: Optional[dict] = None) -> Any:
        raise NotImplementedError(f"model {self.name} has no explainer")

    def health(self) -> dict:
        """Replica health; engine-backed models report the engine's state."""
        return {"state": "SERVING" if self.ready else "DEAD"}

    def __call__(self, payload: Any, headers: Optional[dict] = None, verb: str = "predict") -> Any:
        x = self.preprocess(payload, headers)
        y = self.explain(x, headers) if verb == "explain" else self.predict(x, headers)
        return self.postprocess(y, headers)


class ModelServer:
    """Serves registered models over the V1 + V2 protocols on one port."""

    def __init__(self, models: list[Model], port: int = 0, host: str = "127.0.0.1"):
        self.models = {m.name: m for m in models}
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # keepalive clients: Nagle + delayed-ACK stall ~40ms per response
            disable_nagle_algorithm = True

            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, body: Any, content_type: str = "application/json",
                      extra_headers: Optional[dict] = None):
                data = body.encode() if isinstance(body, str) else json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                for k, v in (extra_headers or {}).items():
                    self.send_header(k, str(v))
                self.end_headers()
                self.wfile.write(data)

            def _body(self) -> Any:
                n = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(n) if n else b"{}"
                try:
                    return json.loads(raw or b"{}")
                except ValueError as e:
                    raise RequestError(f"malformed JSON body: {e}") from e

            def do_GET(self):
                server._handle_get(self)

            def do_POST(self):
                server._handle_post(self)

        class Srv(ThreadingHTTPServer):
            daemon_threads = True

            # track accepted sockets so stop() can sever live keep-alive
            # connections: "stopped" must mean every connection dies
            def process_request(self, request, client_address):
                self._live_conns.add(request)
                super().process_request(request, client_address)

            def close_request(self, request):
                self._live_conns.discard(request)
                super().close_request(request)

        self.httpd = Srv((host, port), Handler)
        self.httpd._live_conns = set()
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle

    def start(self, block: bool = False) -> None:
        for m in self.models.values():
            if not m.ready:
                m.load()
        if block:
            self.httpd.serve_forever(poll_interval=0.05)
        else:
            self._thread = threading.Thread(target=self.httpd.serve_forever,
                                            kwargs={"poll_interval": 0.05}, daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        for sock in list(self.httpd._live_conns):
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        self.httpd._live_conns.clear()

    # ------------------------------------------------------------- handlers

    def _handle_get(self, h) -> None:
        path = h.path.split("?")[0].rstrip("/")
        if path in ("", "/healthz", "/v2/health/live"):
            h._send(200, {"status": "alive"})
        elif path == "/v2/health/ready":
            ready = all(m.ready for m in self.models.values())
            h._send(200 if ready else 503, {"ready": ready})
        elif path.startswith("/v2/models/") and path.endswith("/ready"):
            name = path[len("/v2/models/"):-len("/ready")]
            m = self.models.get(name)
            if m is None:
                h._send(404, {"error": f"model {name} not found"})
            else:
                h._send(200 if m.ready else 503, {"name": name, "ready": m.ready})
        else:
            h._send(404, {"error": f"no route {path}"})

    def _handle_post(self, h) -> None:
        path = h.path.split("?")[0]
        try:
            if path.startswith("/v1/models/") and ":" in path:
                name, _, verb = path[len("/v1/models/"):].partition(":")
                self._v1(h, name, verb)
            elif path.startswith("/v2/models/") and path.endswith("/generate"):
                name = path[len("/v2/models/"):-len("/generate")]
                self._generate(h, name)
            else:
                h._send(404, {"error": f"no route {path}"})
        except RequestError as e:
            h._send(400, {"error": f"{type(e).__name__}: {e}"})
        except DeadlineExceeded as e:
            h._send(504, {"error": f"{type(e).__name__}: {e}",
                          "reason": "deadline"})
        except SessionBusy as e:
            h._send(409, {"error": f"{type(e).__name__}: {e}"})
        except (EngineOverloaded, EngineShutdown) as e:
            overloaded = isinstance(e, EngineOverloaded)
            ra = float(getattr(e, "retry_after_s", 1.0) or 1.0)
            h._send(503, {"error": f"{type(e).__name__}: {e}",
                          "reason": ("engine_overloaded" if overloaded
                                     else "engine_shutdown"),
                          "retry_after_s": ra},
                    extra_headers=({"Retry-After": f"{ra:g}"}
                                   if overloaded else None))
        except Exception as e:  # noqa: BLE001 — server must answer
            h._send(500, {"error": f"{type(e).__name__}: {e}"})

    def _v1(self, h, name: str, verb: str) -> None:
        m = self.models.get(name)
        if m is None:
            h._send(404, {"error": f"model {name} not found"})
            return
        if verb not in ("predict", "explain"):
            h._send(400, {"error": f"unknown verb {verb}"})
            return
        body = h._body()
        headers = dict(h.headers.items())
        result = m(body, headers, verb=verb)
        # V1 contract: {"instances": [...]} -> {"predictions": [...]}
        if isinstance(result, dict) and ("predictions" in result or "explanations" in result):
            h._send(200, result)
        else:
            key = "explanations" if verb == "explain" else "predictions"
            h._send(200, {key: result})

    def _generate(self, h, name: str) -> None:
        """V2 generate extension (the KServe/OIP LLM surface), unary."""
        m = self.models.get(name)
        if m is None:
            h._send(404, {"error": f"model {name} not found"})
            return
        verb = getattr(m, "generate", None)
        if verb is None:
            h._send(400, {"error": f"model {name} does not support generate"})
            return
        body = h._body()
        headers = dict(h.headers.items())
        out = verb(body, headers)
        out = dict(out) if isinstance(out, dict) else {"text_output": out}
        out.setdefault("model_name", name)
        extra = _session_headers(out)
        if isinstance(out.get("ttft_s"), (int, float)):
            extra["X-TTFT-S"] = f"{out['ttft_s']:.4f}"
        if isinstance(out.get("latency_s"), (int, float)):
            extra["X-Engine-Wall-S"] = f"{out['latency_s']:.6f}"
        h._send(200, out, extra_headers=extra or None)


def _session_headers(out: dict) -> dict:
    """Session response headers for a unary generate: the restore tier, the
    pin outcome, and HOW MANY sessions the tiered store evicted to make room
    for this pin (a count, never the evicted ids: session ids are bearer
    capabilities of other clients).  The id itself is safe to echo: it was
    validated to visible ASCII at parse time, so it cannot split headers."""
    sess = out.get("session")
    if not isinstance(sess, dict):
        return {}
    hdrs = {"X-Session-Id": sess.get("id", ""),
            "X-Session-Restore": sess.get("restore", "cold"),
            "X-Session-Pinned": "true" if sess.get("pinned") else "false"}
    if sess.get("evicted"):
        hdrs["X-Session-Evicted"] = str(sess["evicted"])
    return hdrs
