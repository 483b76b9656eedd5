"""Model server: the V1 and V2 (Open Inference) HTTP surfaces.

A reduced copy of ``kubeflow_tpu/serving/server.py`` (the port imports
nothing from the JAX package): ``Model`` is the kserve-style base class and
``ModelServer`` a dependency-free ThreadingHTTPServer serving

    GET  /, /healthz, /v2/health/live, /v2/health/ready
    GET  /v1/models, /v2, /v2/models, /openai/v1/models,
         /v1/models/<name>, /v2/models/<name>[/ready]
    GET  /metrics            (inflight_requests + the models' gauges and
                              telemetry registries)
    GET  /engine/health      (200 SERVING/DEGRADED, 503 DRAINING/DEAD)
    GET  /engine/perf[?view=cache], /engine/trace/<trace_id>,
         /engine/incidents[/<id>], /engine/waterfall/<rid>, /engine/latency
    GET  /engine/kv_handoff/<handle>, /engine/kv_fabric/<key>
                             (raw KVPG frame bytes, or 404)
    POST /engine/profile     ({"ticks": N}; 409 while a capture is in flight)
    POST /v1/models/<name>:predict|:explain, /v2/models/<name>/infer
    POST /v2/models/<name>/generate, /v2/models/<name>/generate_stream (SSE)
    POST /openai/v1/completions, /openai/v1/chat/completions (unary or SSE)

with the same request and response shapes and the same error mapping
(RequestError 400, DeadlineExceeded 504, SessionBusy 409,
EngineOverloaded/EngineShutdown 503, anything else 500; the OpenAI routes
answer in the OpenAI error schema).  ``/metrics`` carries ``inflight_requests``
and each model's ``extra_metrics`` gauges, which is what the ingress's
least-loaded pick and the autoscaler scrape, then each model's
``metrics_text`` registry.
"""

from __future__ import annotations

import json
import socket
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

from .errors import (DeadlineExceeded, EngineOverloaded, EngineShutdown,
                     RequestError, SessionBusy)
from .incidents import timeline as incident_timeline
from .kvfabric import KEY_RE


def openai_constrain_spec(body: dict) -> Optional[dict]:
    """OpenAI structured-output surface -> a ``parameters.constrain``
    spec (README "Structured output"), or None when the request asks for
    free-form text.

    ``response_format: {"type": "json_object"}`` -> ``{"format": "json"}``;
    ``{"type": "json_schema", "json_schema": {"schema": {...}}}`` ->
    ``{"schema": {...}}``; a single function in ``tools`` with
    ``tool_choice`` forcing it (``"required"`` or the by-name form) ->
    ``{"tool": {...}}``.  Anything malformed raises ValueError — the
    caller renders it as the surface's 400, the same admission-time
    strictness the native ``constrain`` parameter gets."""
    rf = body.get("response_format")
    tools = body.get("tools")
    choice = body.get("tool_choice")
    if rf is not None:
        if not isinstance(rf, dict) or "type" not in rf:
            raise ValueError("response_format must be an object with a "
                             "\"type\" field")
        t = rf.get("type")
        if t == "text":
            return None
        if t == "json_object":
            return {"format": "json"}
        if t == "json_schema":
            js = rf.get("json_schema")
            if not isinstance(js, dict) or not isinstance(
                    js.get("schema"), dict):
                raise ValueError("response_format.json_schema.schema must "
                                 "be a schema object")
            return {"schema": js["schema"]}
        raise ValueError(f"response_format.type {t!r} not supported "
                         "(text | json_object | json_schema)")
    if not choice or choice == "none" or not isinstance(tools, list):
        return None
    fns = [t.get("function") for t in tools
           if isinstance(t, dict) and t.get("type") == "function"
           and isinstance(t.get("function"), dict)]
    name = None
    if isinstance(choice, dict):
        name = (choice.get("function") or {}).get("name") \
            if choice.get("type") == "function" else None
        if not name:
            raise ValueError("tool_choice object must name a function")
    elif choice == "required":
        if len(fns) != 1:
            raise ValueError("tool_choice \"required\" needs exactly one "
                             "tool to constrain against; name one with "
                             "the function form")
        name = fns[0].get("name")
    elif choice == "auto":
        return None  # the model may answer free-form: nothing to force
    else:
        raise ValueError(f"tool_choice {choice!r} not supported")
    fn = next((f for f in fns if f.get("name") == name), None)
    if fn is None:
        raise ValueError(f"tool_choice names unknown function {name!r}")
    params = fn.get("parameters")
    if not isinstance(params, dict):
        raise ValueError(f"tool {name!r} has no parameters schema to "
                         "constrain against")
    return {"tool": {"name": name, "parameters": params}}


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
        """Replica health (served on GET /engine/health); engine-backed
        models report the engine's SERVING/DEGRADED/DRAINING/DEAD state."""
        return {"state": "SERVING" if self.ready else "DEAD"}

    def extra_metrics(self) -> dict:
        """Numeric gauges merged into the server's /metrics output: engine
        models report queue and slot state here, so the ingress can route
        least-loaded and the autoscaler can see the backlog."""
        return {}

    def __call__(self, payload: Any, headers: Optional[dict] = None, verb: str = "predict") -> Any:
        x = self.preprocess(payload, headers)
        y = self.explain(x, headers) if verb == "explain" else self.predict(x, headers)
        return self.postprocess(y, headers)


class _Metrics:
    def __init__(self):
        self.lock = threading.Lock()
        self.inflight = 0
        self.total = 0
        self.latency_sum = 0.0
        self.last_request_time = 0.0

    def start(self) -> float:
        with self.lock:
            self.inflight += 1
            self.total += 1
            self.last_request_time = time.time()
        return time.perf_counter()

    def finish(self, t0: float) -> None:
        with self.lock:
            self.inflight -= 1
            self.latency_sum += time.perf_counter() - t0

    def render(self) -> str:
        with self.lock:
            return (
                "# TYPE inflight_requests gauge\n"
                f"inflight_requests {self.inflight}\n"
                "# TYPE request_count counter\n"
                f"request_count {self.total}\n"
                "# TYPE request_latency_seconds_sum counter\n"
                f"request_latency_seconds_sum {self.latency_sum:.6f}\n"
                "# TYPE last_request_timestamp gauge\n"
                f"last_request_timestamp {self.last_request_time:.3f}\n"
            )


class ModelServer:
    """Serves registered models over the V1 + V2 protocols on one port."""

    def __init__(self, models: list[Model], port: int = 0, host: str = "127.0.0.1"):
        self.models = {m.name: m for m in models}
        self.metrics = _Metrics()
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

    def _adapter_owners(self, adapter: str) -> list:
        """Every base model serving LoRA adapter ``adapter`` — the ONE
        definition of bare-adapter-id ownership, shared by the /models
        listing and the POST routing so they can never skew (an id the
        listing advertises must be one the router accepts)."""
        return [m for m in self.models.values()
                if adapter in (getattr(m, "adapters", {}) or {})]

    def _render_metrics(self) -> str:
        """Prometheus text exposition: the server's own HTTP gauges, then the
        models' flat ``extra_metrics`` gauges (non-numeric values skipped —
        a bad model metric must not 500 the scrape — and ``# TYPE`` emitted
        once per metric name), then each model's telemetry registry
        (``metrics_text``: TTFT/TPOT/queue-wait/tick histograms), with
        duplicate HELP/TYPE
        headers dropped when several models share a registry metric name."""
        chunks = [self.metrics.render()]
        typed = {line.split(" ")[2] for line in chunks[0].splitlines()
                 if line.startswith("# TYPE ")}
        extra: dict = {}
        for m in self.models.values():
            try:
                em = m.extra_metrics()
            except Exception:  # noqa: BLE001 — scrape must answer
                continue
            for k, v in em.items():
                try:
                    extra[k] = extra.get(k, 0.0) + float(v)
                except (TypeError, ValueError):
                    continue  # non-numeric gauge: skip, don't 500
        for k in sorted(extra):
            if k not in typed:
                typed.add(k)
                chunks.append(f"# TYPE {k} gauge\n")
            chunks.append(f"{k} {extra[k]}\n")
        for m in self.models.values():
            fn = getattr(m, "metrics_text", None)
            if not callable(fn):
                continue
            try:
                block = fn() or ""
            except Exception:  # noqa: BLE001
                continue
            kept = []
            for line in block.splitlines():
                if line.startswith(("# TYPE ", "# HELP ")):
                    name = line.split(" ")[2]
                    if line.startswith("# TYPE "):
                        if name in typed:
                            continue
                        typed.add(name)
                    elif name in typed:
                        continue  # HELP for an already-emitted metric
                kept.append(line)
            if kept:
                chunks.append("\n".join(kept) + "\n")
        return "".join(chunks)

    # worst-first ordering of replica health states: a multi-model server
    # reports the sickest model's state (the proxy ejects on DEAD, drains
    # on DRAINING, keeps routing on DEGRADED)
    _HEALTH_ORDER = ("DEAD", "DRAINING", "DEGRADED", "SERVING")

    def _engine_health(self) -> tuple[int, dict]:
        """Aggregate replica health: per-model states + the worst one.
        200 while the replica can still serve (SERVING/DEGRADED), 503 once
        it should stop receiving traffic (DRAINING/DEAD)."""
        states = {}
        worst = "SERVING"
        for name, m in self.models.items():
            try:
                hd = m.health()
            except Exception as e:  # noqa: BLE001 — a probe must answer
                hd = {"state": "DEAD", "reason": f"{type(e).__name__}: {e}"}
            states[name] = hd
            # clamp unknown states to DEAD BEFORE comparing AND assigning:
            # a custom model returning e.g. "READY" must degrade the
            # aggregate, not crash the next iteration's index()
            st = hd.get("state", "DEAD")
            if st not in self._HEALTH_ORDER:
                st = "DEAD"
            if (self._HEALTH_ORDER.index(st)
                    < self._HEALTH_ORDER.index(worst)):
                worst = st
        code = 200 if worst in ("SERVING", "DEGRADED") else 503
        return code, {"state": worst, "models": states}

    def _handle_get(self, h) -> None:
        path = h.path.split("?")[0].rstrip("/")
        if path == "/metrics":
            h._send(200, self._render_metrics(), content_type="text/plain")
        elif path in ("", "/", "/healthz", "/v2/health/live"):
            h._send(200, {"status": "alive"})
        elif path == "/engine/health":
            code, body = self._engine_health()
            h._send(code, body)
        elif path == "/engine/perf":
            # per-model FLOPs/MFU/goodput ledger, cache analytics, tick-phase
            # timeline, profiler runs.  Always 200; ``?view=cache`` answers
            # the slim subset the ingress's fleet cache view polls
            slim = "view=cache" in h.path.partition("?")[2].split("&")
            out = {}
            for name, m in self.models.items():
                fn = getattr(m, "perf_snapshot", None)
                if not callable(fn):
                    continue
                try:
                    snap = fn()
                except Exception:  # noqa: BLE001 — introspection answers
                    snap = {"enabled": False}
                if slim:
                    snap = {k: snap.get(k) for k in
                            ("enabled", "platform", "mfu", "goodput_ratio", "cache")}
                out[name] = snap
            h._send(200, {"models": out})
        elif path.startswith("/engine/trace/"):
            # replica-local spans for one distributed trace id (always 200:
            # the ingress's fan-out merges empties); ids are lowercase
            tid = path[len("/engine/trace/"):].strip().lower()
            spans, dumps = [], []
            for m in self.models.values():
                fn = getattr(m, "trace_spans", None)
                if not callable(fn):
                    continue
                try:
                    rec = fn(tid) or {}
                except Exception:  # noqa: BLE001 — debug read must answer
                    continue
                spans.extend(rec.get("spans") or ())
                dumps.extend(rec.get("flight_dumps") or ())
            h._send(200, {"trace_id": tid, "spans": spans, "flight_dumps": dumps})
        elif path == "/engine/incidents":
            # every model's classified incidents, open first (always 200)
            out = []
            for name, m in self.models.items():
                fn = getattr(m, "incident_list", None)
                if not callable(fn):
                    continue
                try:
                    incs = fn() or []
                except Exception:  # noqa: BLE001 — debug read answers
                    continue
                out.extend({**inc, "model": name} for inc in incs)
            out.sort(key=lambda i: (i.get("state") != "open",
                                    i.get("opened_wall") or 0.0))
            h._send(200, {"incidents": out,
                          "open": sum(1 for i in out if i.get("state") == "open")})
        elif path.startswith("/engine/incidents/"):
            # one incident's postmortem as the responder's timeline; 404
            # when no model holds the id (it may live on another replica)
            iid = path[len("/engine/incidents/"):]
            found = None
            for name, m in self.models.items():
                fn = getattr(m, "incident_get", None)
                if not callable(fn):
                    continue
                try:
                    inc = fn(iid)
                except Exception:  # noqa: BLE001 — debug read answers
                    inc = None
                if inc is not None:
                    found = {**inc, "model": name}
                    break
            if found is None:
                h._send(404, {"error": "unknown incident id"})
            else:
                h._send(200, {"incident": found, "timeline": incident_timeline(found)})
        elif path.startswith("/engine/waterfall/"):
            # one request's waterfall of non-overlapping segments; 404 when
            # no model knows the rid
            rid = path[len("/engine/waterfall/"):].strip()
            found = None
            if rid.isdigit():
                for name, m in self.models.items():
                    fn = getattr(m, "waterfall", None)
                    if not callable(fn):
                        continue
                    try:
                        wf = fn(rid)
                    except Exception:  # noqa: BLE001 — debug read answers
                        wf = None
                    if wf is not None:
                        found = {**wf, "model": name}
                        break
            if found is None:
                h._send(404, {"error": "unknown request id"})
            else:
                h._send(200, found)
        elif path == "/engine/latency":
            # replica-local latency budget samples per SLO class (always 200)
            out = {}
            for name, m in self.models.items():
                fn = getattr(m, "latency_budget", None)
                if not callable(fn):
                    continue
                try:
                    out[name] = fn() or {"classes": {}, "samples": {}}
                except Exception:  # noqa: BLE001 — debug read answers
                    continue
            h._send(200, {"models": out})
        elif path.startswith("/engine/kv_handoff/"):
            # a decode replica pulls a prefill replica's exported KV frame
            # by its one-shot handle; a 404 (unknown, expired or already
            # pulled) makes it degrade to re-prefill
            self._send_frame(h, "pull_handoff", path[len("/engine/kv_handoff/"):],
                             "unknown, expired or already-pulled handoff handle")
        elif path.startswith("/engine/kv_fabric/"):
            # any replica pulls another's published prefix frame by its
            # chain-hash key (multi-reader: the entry survives the pull)
            key = path[len("/engine/kv_fabric/"):]
            if not KEY_RE.fullmatch(key):
                # keys are 16-hex chain hashes; anything else is forged
                h._send(404, {"error": "malformed fabric key"})
                return
            self._send_frame(h, "pull_fabric", key,
                             "unknown, expired or evicted fabric key")
        elif path == "/v2/health/ready":
            ready = all(m.ready for m in self.models.values())
            h._send(200 if ready else 503, {"ready": ready})
        elif path == "/v1/models":
            h._send(200, {"models": sorted(self.models)})
        elif path == "/v2":
            h._send(200, {"name": "kubeflow-tpu-server", "extensions": []})
        elif path == "/v2/models":
            h._send(200, {"models": sorted(self.models)})
        elif path == "/openai/v1/models":
            data = [{"id": n, "object": "model", "owned_by": "kubeflow-tpu"}
                    for n in sorted(self.models)]
            for n in sorted(self.models):
                # vLLM-style multi-LoRA: each loaded adapter is served as
                # its own model id, rooted at its base model.  An adapter
                # name shared by several bases is listed ONLY under its
                # qualified base:adapter id — never advertise an id the
                # POST routes would then 400 as ambiguous
                for ad in sorted(getattr(self.models[n], "adapters", {}) or {}):
                    mid = ad if len(self._adapter_owners(ad)) == 1 \
                        else f"{n}:{ad}"
                    data.append({"id": mid, "object": "model",
                                 "owned_by": "kubeflow-tpu", "root": n})
            h._send(200, {"object": "list", "data": data})
        elif path.startswith("/v1/models/"):
            name = path[len("/v1/models/"):]
            m = self.models.get(name)
            if m is None:
                h._send(404, {"error": f"model {name} not found"})
            else:
                h._send(200 if m.ready else 503, {"name": name, "ready": m.ready})
        elif path.startswith("/v2/models/"):
            rest = path[len("/v2/models/"):]
            name = rest.split("/")[0]
            m = self.models.get(name)
            if m is None:
                h._send(404, {"error": f"model {name} not found"})
            elif rest.endswith("/ready"):
                h._send(200 if m.ready else 503, {"name": name, "ready": m.ready})
            else:
                h._send(200, {"name": name, "platform": "pytorch", "versions": ["1"]})
        else:
            h._send(404, {"error": f"no route {path}"})

    def _send_frame(self, h, method: str, ident: str, missing: str) -> None:
        """Answer a KVPG frame pull: the first model whose ``method``
        (``pull_handoff`` / ``pull_fabric``) returns bytes serves them raw
        with a Content-Length, else 404.  Probing several models for the
        owner charges a miss only when the server holds a single one."""
        capable = [m for m in self.models.values()
                   if callable(getattr(m, method, None))]
        data = None
        for m in capable:
            try:
                data = getattr(m, method)(ident, count_miss=len(capable) == 1)
            except Exception:  # noqa: BLE001 — a pull must answer
                data = None
            if data is not None:
                break
        if data is None:
            h._send(404, {"error": missing})
            return
        h.send_response(200)
        h.send_header("Content-Type", "application/octet-stream")
        h.send_header("Content-Length", str(len(data)))
        h.end_headers()
        h.wfile.write(data)

    def _handle_post(self, h) -> None:
        path = h.path.split("?")[0]
        t0 = self.metrics.start()
        try:
            if path.startswith("/v1/models/") and ":" in path:
                name, _, verb = path[len("/v1/models/"):].partition(":")
                self._v1(h, name, verb)
            elif path.startswith("/v2/models/") and path.endswith("/infer"):
                name = path[len("/v2/models/"):-len("/infer")]
                self._v2(h, name)
            elif path.startswith("/v2/models/") and path.endswith("/generate_stream"):
                name = path[len("/v2/models/"):-len("/generate_stream")]
                self._generate(h, name, stream=True)
            elif path.startswith("/v2/models/") and path.endswith("/generate"):
                name = path[len("/v2/models/"):-len("/generate")]
                self._generate(h, name, stream=False)
            elif path == "/openai/v1/completions":
                self._openai(h, chat=False)
            elif path == "/openai/v1/chat/completions":
                self._openai(h, chat=True)
            elif path.rstrip("/") == "/engine/profile":
                self._engine_profile(h)
            else:
                h._send(404, {"error": f"no route {path}"})
        except RequestError as e:
            # per-request client faults (malformed body, unknown adapter,
            # over-capacity prompt) — raised ONLY at request-validation
            # sites, so engine-internal ValueErrors still surface as 500s.
            # The OpenAI surface keeps its own error schema: clients there
            # read error["message"], not a bare string.
            if path.startswith("/openai/"):
                h._send(400, {"error": {"message": str(e),
                                        "type": "invalid_request_error"}})
            else:
                h._send(400, {"error": f"{type(e).__name__}: {e}"})
        except DeadlineExceeded as e:
            # request shed before its first token: the gateway timeout code,
            # so clients/routers distinguish "too slow" from "broken".
            # The machine-readable reason lets the storm bench (and any
            # accounting ingress) count queue-deadline churn without
            # string-matching the message.
            h._send(504, {"error": f"{type(e).__name__}: {e}",
                          "reason": "deadline"})
        except SessionBusy as e:
            # a session's turns are strictly serial: a second concurrent
            # turn conflicts with the in-flight one — 409, retry after it
            # resolves (NOT 503: another replica cannot serve it either,
            # the session's KV timeline lives with the in-flight turn)
            if path.startswith("/openai/"):
                h._send(409, {"error": {"message": str(e),
                                        "type": "session_busy"}})
            else:
                h._send(409, {"error": f"{type(e).__name__}: {e}"})
        except (EngineOverloaded, EngineShutdown) as e:
            # backpressure / drain: retryable against another replica.
            # Retry-After (README "Overload control"): the engine attaches
            # a load-proportional hint at the raise site — the ingress
            # retry loop honors it with jitter instead of immediately
            # hammering the next replica, and a direct client reads the
            # same machine-readable surface the ingress 429s carry.
            # ONLY EngineOverloaded carries the header: the router types
            # a 503-with-Retry-After as "full, not broken" (no health
            # strike), and a DRAINING/stopped replica is the opposite —
            # its 503s must keep walking the health FSM toward ejection.
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
        finally:
            self.metrics.finish(t0)

    def _engine_profile(self, h) -> None:
        """POST /engine/profile: arm an on-demand torch.profiler capture —
        ``{"ticks": N, "model": optional, "dir": optional}`` — wrapping
        ``Engine.trace_n_ticks``.  409 while a capture is in flight."""
        body = h._body() or {}
        ticks = body.get("ticks", 8)
        if not isinstance(ticks, int) or ticks < 1:
            raise RequestError(f"ticks must be a positive integer, got {ticks!r}")
        trace_dir = body.get("dir")
        if trace_dir is not None and not isinstance(trace_dir, str):
            raise RequestError(f"dir must be a string, got {trace_dir!r}")
        name = body.get("model")
        if name is None:
            capable = [n for n, m in self.models.items()
                       if callable(getattr(m, "start_profile", None))]
            if len(capable) != 1:
                raise RequestError("model required (profile-capable models: "
                                   f"{sorted(capable)})")
            name = capable[0]
        m = self.models.get(name)
        if m is None or not callable(getattr(m, "start_profile", None)):
            h._send(404, {"error": f"model {name!r} not found or not "
                                   "profile-capable"})
            return
        try:
            out = m.start_profile(ticks, trace_dir)
        except RuntimeError as e:
            # a capture is already in flight: retry after it completes
            h._send(409, {"error": f"{type(e).__name__}: {e}"})
            return
        out["model"] = name
        h._send(200, out)

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

    def _generate(self, h, name: str, stream: bool) -> None:
        """V2 generate extension (the KServe/OIP LLM surface): unary
        ``/generate`` returns one JSON body; ``/generate_stream`` answers
        Server-Sent Events (`data: {...}` per token, read-until-close)."""
        m = self.models.get(name)
        if m is None:
            h._send(404, {"error": f"model {name} not found"})
            return
        verb = getattr(m, "generate_stream" if stream else "generate", None)
        if verb is None:
            h._send(400, {"error": f"model {name} does not support generate"})
            return
        body = h._body()
        headers = dict(h.headers.items())
        if not stream:
            t0 = time.perf_counter()
            out = verb(body, headers)
            out = dict(out) if isinstance(out, dict) else {"text_output": out}
            out.setdefault("model_name", name)
            extra = _session_headers(out) or {}
            if isinstance(out.get("ttft_s"), (int, float)):
                # queue+TTFT feedback for the ingress overload controller
                # (README "Overload control"): the deadline early-reject
                # estimator reads this header instead of re-parsing every
                # relayed response body
                extra["X-TTFT-S"] = f"{out['ttft_s']:.4f}"
            if isinstance(out.get("latency_s"), (int, float)):
                # engine-attributed wall for the ingress waterfall
                # assembler (README "Latency attribution"): the proxy
                # subtracts this from its own hop wall to get
                # per-request proxy overhead without a second scrape
                extra["X-Engine-Wall-S"] = f"{out['latency_s']:.6f}"
                tel = getattr(getattr(m, "engine", None), "telemetry", None)
                if tel is not None:
                    # model-server scope of ingress_proxy_overhead_seconds:
                    # serve-layer wall minus the engine-reported wall
                    tel.observe_proxy_overhead(max(
                        0.0, time.perf_counter() - t0 - float(out["latency_s"])))
            h._send(200, out, extra_headers=extra or None)
            return
        gen = verb(body, headers)
        self._sse_write(
            h, gen,
            (b"data: " + json.dumps(e).encode() + b"\n\n" for e in gen),
            lambda e: b"data: " + json.dumps(
                {"error": f"{type(e).__name__}: {e}", "done": True}
            ).encode() + b"\n\n")

    @staticmethod
    def _sse_write(h, gen, lines, error_line) -> None:
        """SSE mechanics shared by /generate_stream and the OpenAI surface.

        Once headers are out, errors must stay INSIDE the event stream —
        letting them reach _handle_post's catch-all would write a second
        HTTP response into the SSE body (and a client disconnect would
        raise again from that very write).  ``gen`` is closed in all cases
        for a deterministic GeneratorExit → engine cancel."""
        h.send_response(200)
        h.send_header("Content-Type", "text/event-stream")
        h.send_header("Cache-Control", "no-cache")
        h.send_header("Connection", "close")  # stream length unknown: SSE
        h.end_headers()
        try:
            for line in lines:
                h.wfile.write(line)
                h.wfile.flush()
        except OSError:
            pass  # client went away mid-stream
        except Exception as e:  # noqa: BLE001 — surface as a final event
            try:
                h.wfile.write(error_line(e))
            except OSError:
                pass
        finally:
            if hasattr(gen, "close"):
                gen.close()

    # ------------------------------------------------ OpenAI compatibility

    def _openai(self, h, chat: bool) -> None:
        """OpenAI-compatible completions surface (the KServe huggingface
        runtime exposes the same paths for LLM clients): ``/openai/v1/
        completions`` and ``/chat/completions``, unary or ``stream: true``
        SSE chunks ending with ``data: [DONE]``.  Chat messages render
        through a minimal role-tagged template."""
        body = h._body() or {}
        name = body.get("model")
        if name is None and len(self.models) == 1:
            name = next(iter(self.models))
        m = self.models.get(name)
        adapter = None
        if m is None and name:
            # multi-LoRA: an adapter id is addressable as its own model —
            # bare ("my-adapter") or qualified ("base:my-adapter")
            base, _, ad = name.partition(":")
            cand = self.models.get(base)
            if cand is not None and ad in (getattr(cand, "adapters", {}) or {}):
                m, adapter = cand, ad
            else:
                owners = self._adapter_owners(name)
                if len(owners) > 1:
                    # two bases expose the same adapter name — bare routing
                    # would silently pick dict order; demand the qualified id
                    h._send(400, {"error": {
                        "message": f"adapter {name!r} is served by multiple "
                                   "base models; use the qualified "
                                   "'base:adapter' model id",
                        "type": "invalid_request_error"}})
                    return
                if owners:
                    m, adapter = owners[0], name
        if m is None or getattr(m, "generate", None) is None:
            h._send(404, {"error": {
                "message": f"model {name!r} not found or not generative",
                "type": "invalid_request_error"}})
            return
        def bad_request(msg: str) -> None:
            h._send(400, {"error": {"message": msg,
                          "type": "invalid_request_error"}})

        if chat:
            msgs = body.get("messages")
            if not isinstance(msgs, list) or not msgs:
                bad_request("messages required")
                return
            parts = []
            for mm in msgs:
                content = mm.get("content", "")
                if isinstance(content, list):
                    # OpenAI content-parts form: flatten the text parts
                    # (the official SDKs emit this for multimodal requests)
                    content = "".join(p.get("text", "") for p in content
                                      if isinstance(p, dict)
                                      and p.get("type") == "text")
                elif not isinstance(content, str):
                    bad_request(f"message content must be a string or "
                                f"content-part list, got {type(content).__name__}")
                    return
                parts.append(f"<|{mm.get('role', 'user')}|>{content}\n")
            prompt = "".join(parts) + "<|assistant|>"
        else:
            prompt = body.get("prompt")
            if not isinstance(prompt, str):
                bad_request("prompt required")
                return
        max_tokens = body.get("max_tokens")
        if max_tokens is None:
            max_tokens = 16  # OpenAI's documented default; null means unset
        if not isinstance(max_tokens, int) or max_tokens < 1:
            bad_request(f"max_tokens must be a positive integer, "
                        f"got {max_tokens!r}")
            return
        try:
            # structured output (README "Structured output"): the OpenAI
            # response_format / forced-tool surface rewrites into the
            # native constrain parameter; the model layer compiles it at
            # admission and 400s bad schemas
            constrain = openai_constrain_spec(body)
        except ValueError as e:
            bad_request(str(e))
            return
        payload = {"text_input": prompt,
                   "parameters": {"max_tokens": max_tokens,
                                  "adapter": adapter,
                                  # QoS passthrough (engine scheduler):
                                  # body param wins; the model layer falls
                                  # back to the X-Priority header and 400s
                                  # unknown classes
                                  "priority": body.get("priority"),
                                  # conversation pinning passthrough (the
                                  # model layer falls back to X-Session-Id)
                                  "session_id": body.get("session_id"),
                                  # ingress brownout passthrough (README
                                  # "Overload control"): the overload
                                  # controller marks OpenAI bodies at the
                                  # top level; the model layer validates
                                  # the stage
                                  "brownout": body.get("brownout"),
                                  "constrain": constrain}}
        headers = dict(h.headers.items())
        oid = f"{'chatcmpl' if chat else 'cmpl'}-{uuid.uuid4().hex[:24]}"
        obj = "chat.completion" if chat else "text_completion"
        if not body.get("stream"):
            out = m.generate(payload, headers)
            # only engine-backed models report tokens/max_tokens; without
            # both keys 0>=0 would mislabel every response "length"
            finish = ("length" if "tokens" in out and "max_tokens" in out
                      and out["tokens"] >= out["max_tokens"] else "stop")
            # a forced tool call's tool_calls message comes with constrained
            # decoding (ROADMAP item 1.4), which is what would produce one
            choice = ({"index": 0,
                       "message": {"role": "assistant",
                                   "content": out["text_output"]},
                       "finish_reason": finish} if chat else
                      {"index": 0, "text": out["text_output"],
                       "finish_reason": finish})
            h._send(200, {
                "id": oid, "object": obj, "created": int(time.time()),
                "model": name, "choices": [choice],
                "usage": {"prompt_tokens": out.get("prompt_tokens", 0),
                          "completion_tokens": out.get("tokens", 0),
                          "total_tokens": out.get("prompt_tokens", 0)
                          + out.get("tokens", 0)},
            })
            return
        if getattr(m, "generate_stream", None) is None:
            h._send(400, {"error": {"message": "streaming unsupported",
                          "type": "invalid_request_error"}})
            return
        chunk_obj = "chat.completion.chunk" if chat else "text_completion"

        def chunk(piece: str, finish=None, delta_extra=None) -> dict:
            if chat:
                delta = dict(delta_extra or {})
                if piece:
                    delta["content"] = piece
                c = {"index": 0, "delta": delta, "finish_reason": finish}
            else:
                c = {"index": 0, "text": piece, "finish_reason": finish}
            return {"id": oid, "object": chunk_obj,
                    "created": int(time.time()), "model": name,
                    "choices": [c]}

        gen = m.generate_stream(payload, headers)

        def lines():
            first = True
            for event in gen:
                if event.get("done"):
                    finish = ("length" if "tokens" in event
                              and "max_tokens" in event
                              and event["tokens"] >= event["max_tokens"]
                              else "stop")
                    yield (b"data: " + json.dumps(chunk("", finish)).encode()
                           + b"\n\n")
                    break
                # the stream contract's first chat chunk carries the role —
                # strict parsers key message assembly off delta.role
                extra = {"role": "assistant"} if chat and first else None
                first = False
                yield (b"data: " + json.dumps(
                    chunk(event["text_output"], delta_extra=extra)).encode()
                    + b"\n\n")
            yield b"data: [DONE]\n\n"

        self._sse_write(
            h, gen, lines(),
            lambda e: b"data: " + json.dumps(
                {"error": {"message": f"{type(e).__name__}: {e}"}}
            ).encode() + b"\n\ndata: [DONE]\n\n")

    def _v2(self, h, name: str) -> None:
        m = self.models.get(name)
        if m is None:
            h._send(404, {"error": f"model {name} not found"})
            return
        body = h._body()
        headers = dict(h.headers.items())
        # V2 request: {"inputs": [{name, shape, datatype, data}]}
        result = m(body, headers)
        if isinstance(result, dict) and "outputs" in result:
            out = result
            out.setdefault("model_name", name)
        else:
            data, shape, dtype = _as_v2_tensor(result)
            out = {
                "model_name": name,
                "outputs": [{"name": "output-0", "shape": shape, "datatype": dtype, "data": data}],
            }
        h._send(200, out)



def _session_headers(out: dict) -> Optional[dict]:
    """Session/eviction response headers for a unary generate (README
    "Sessions & tiered KV"): the restore tier and pin outcome, plus HOW
    MANY sessions the tiered store evicted to make room for this pin —
    the client-visible pressure signal.  A count, never the evicted ids:
    session ids are bearer capabilities and belong to other clients.
    The id itself is safe to echo — validated to visible ASCII at parse
    time (kvstore.normalize_session_id), so it cannot split headers."""
    sess = out.get("session") if isinstance(out, dict) else None
    if not isinstance(sess, dict):
        return None
    hdrs = {"X-Session-Id": sess.get("id", ""),
            "X-Session-Restore": sess.get("restore", "cold"),
            "X-Session-Pinned": "true" if sess.get("pinned") else "false"}
    if sess.get("evicted"):
        hdrs["X-Session-Evicted"] = str(sess["evicted"])
    return hdrs


def _as_v2_tensor(result: Any) -> tuple[list, list[int], str]:
    """Flatten a nested-list/np result into (flat data, shape, datatype)."""
    import numpy as np

    arr = np.asarray(result)
    dtype = {"f": "FP32", "i": "INT64", "b": "BOOL", "u": "UINT64"}.get(arr.dtype.kind, "FP32")
    if arr.dtype.kind == "U" or arr.dtype.kind == "O":
        return arr.reshape(-1).tolist(), list(arr.shape), "BYTES"
    return arr.reshape(-1).tolist(), list(arr.shape), dtype


def v2_inputs_to_arrays(body: dict):
    """Decode a V2 request's inputs into numpy arrays (helper for models)."""
    import numpy as np

    out = {}
    for t in body.get("inputs", []):
        out[t["name"]] = np.asarray(t["data"]).reshape(t["shape"])
    return out
