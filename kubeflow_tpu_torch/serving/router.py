"""Service proxy + ingress router + activator.

A copy of ``kubeflow_tpu/serving/router.py`` (``Router``,
``ServiceProxy``), over the port's ``disagg``, ``kvfabric``, ``transport``,
``incidents``, ``waterfall``, ``overload``, ``core/tracing`` and
``core/metrics``.  It relays to the port's runtime pods; its chaos hooks
are the port's ``engine/faults.FleetChaos``.  One difference: the JAX
module's ``KUBEFLOW_TPU_INGRESS_CORE=legacy`` switch (a benchmark arm that
answers through a thread-per-connection server and dials every hop fresh)
is left out, so the ingress always answers through
``ingress_core.IngressServer``.

Upstream analogue (UNVERIFIED, SURVEY.md §3.4 request path): Istio ingress
(Envoy) → Knative activator/queue-proxy → model server.  In-process
equivalents:

  * ``ServiceProxy`` — one HTTP listener per serving Service (port pinned in
    the Service's proxy-port annotation by the ISVC controller).  Each request
    picks a revision by the Service's traffic-split annotation (canary), then
    round-robins over that revision's READY pods.  This is what makes
    ``PREDICTOR_HOST`` a stable address for transformers while revisions and
    replicas churn underneath.
  * activator — when a request arrives and every backing Deployment is scaled
    to zero, the proxy patches replicas back to >=1 and holds the request
    until a pod reports ready (Knative's activator hand-off).
  * ``Router`` — the client-facing entry: resolves an InferenceService to its
    entry component (transformer if present, else predictor) and speaks
    V1/V2 protocol to its service proxy.

Fleet fault tolerance (README "Fleet robustness"): every backend carries a
health state machine (healthy → suspect → ejected → probation, plus
draining) fed by active ``/engine/health`` probes AND passive request
outcomes (connect errors, 5xx, stream stalls).  Ejection is a per-backend
circuit breaker with exponential backoff; an empty routable set fails fast
with 503.  Failed non-streamed requests retry against another replica with
a jittered exponential backoff under a retry budget; a ``generate_stream``
relay that loses its backend mid-stream RE-ADMITS the request on a healthy
replica with the already-relayed token ids folded into the prompt
(``resume_token_ids``) so the continuation is a re-prefill — a prefix-cache
hit when those pages exist — and the client stream resumes with no
duplicated or dropped tokens.
"""

from __future__ import annotations

import collections
import copy
import json
import random
import threading
import time
import urllib.error
import urllib.request
from typing import Optional

from ..core import tracing
from ..core.api import APIServer, Obj
from ..core.metrics import REGISTRY, merge_expositions
from . import disagg, ingress_core, kvfabric
from . import transport
from . import incidents as incidents_mod
from . import overload as overload_mod
from . import waterfall as waterfall_mod
from .api import GROUP, LABEL_ISVC, LABEL_REVISION
from .controllers import (
    DEPLOYMENT_FOR_SERVICE_ANNOTATION,
    DRAINING_ANNOTATION,
    PROXY_PORT_ANNOTATION,
    SCALED_TO_ZERO_ANNOTATION,
    TRAFFIC_ANNOTATION,
    pod_is_ready,
    pod_port,
)

ACTIVATION_TIMEOUT = 30.0

# Per-Service relay knobs (annotations on the Service object; defaults are
# the ServiceProxy class attributes).  relay-timeout is the per-read backend
# silence budget (stall detector); hedge-timeout, when set, caps the FIRST
# attempt of a non-streamed request so a slow replica triggers a re-dispatch
# to another backend instead of holding the client; retry-budget is the max
# number of failover re-attempts after the first try.
RELAY_TIMEOUT_ANNOTATION = f"{GROUP}/relay-timeout"
HEDGE_TIMEOUT_ANNOTATION = f"{GROUP}/hedge-timeout"
RETRY_BUDGET_ANNOTATION = f"{GROUP}/retry-budget"
# Overload control (README "Overload control"): per-Service annotation
# whose value is "on" (defaults) or a JSON overload.OverloadConfig
# object — per-tenant token-bucket quotas, the AIMD concurrency limiter,
# deadline early-rejection and staged brownout all hang off it.  Absent
# or "off" = legacy behavior (every request relays).
OVERLOAD_ANNOTATION = f"{GROUP}/overload"

# Ingress-side observability (shared core registry, rendered by
# core.metrics.serve): per-backend relay counts by status class and the
# ingress-observed latency distribution — the request-path complement of the
# engine's own TTFT/TPOT histograms (a gap between the two is queueing or
# relay overhead, exactly what a latency postmortem needs to localize).
INGRESS_REQUESTS = REGISTRY.counter(
    "ingress_requests_total",
    "requests relayed by service proxies, by service/backend/status class")
INGRESS_LATENCY = REGISTRY.histogram(
    "ingress_request_seconds",
    "ingress-observed relay latency incl. backend time, by service",
    buckets=(0.005, 0.025, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
             60.0, 120.0))
# Fleet fault-tolerance surface: failover retries by reason
# (connect/status_5xx/stall/stream), backend ejections (circuit-breaker
# opens), stall-triggered hedged re-dispatches, and a gauge of backends per
# health state — together these are the story a failover incident leaves.
INGRESS_RETRIES = REGISTRY.counter(
    "ingress_retries_total",
    "failover re-attempts by service and reason")
INGRESS_EJECTIONS = REGISTRY.counter(
    "ingress_ejections_total",
    "backend ejections (circuit breaker opened), by service")
INGRESS_HEDGED = REGISTRY.counter(
    "ingress_hedged_total",
    "stall-triggered hedged re-dispatches of non-streamed requests")
INGRESS_BACKEND_STATE = REGISTRY.gauge(
    "ingress_backend_state",
    "backends per health state (healthy/suspect/ejected/probation/draining)")
# Fleet observability surface: every relay gets a W3C-style
# trace context (minted here, or adopted from an inbound traceparent);
# every attempt — retries, hedges, mid-stream failover re-admissions —
# becomes a child hop span stored in a bounded per-proxy TraceStore that
# GET /debug/trace/<id> assembles (with the engines' spans) into the hop
# tree.  The eviction counter is the history-pressure signal.
INGRESS_TRACE_EVICTIONS = REGISTRY.counter(
    "ingress_trace_evictions_total",
    "relay traces evicted from the proxy's bounded trace store")
# Overload-control surface (README "Overload control"): requests refused
# at the ingress by class and reason (quota/concurrency/deadline — every
# one answered 429 + Retry-After, never relayed to die in an engine
# queue), per-tenant token-bucket levels, and the current brownout stage
# (0 = normal service; 1-3 degrade quality before availability).
INGRESS_SHED = REGISTRY.counter(
    "ingress_shed_total",
    "requests shed at the ingress by the overload controller, by "
    "service, priority class and reason (quota/concurrency/deadline)")
INGRESS_TENANT_TOKENS = REGISTRY.gauge(
    "ingress_tenant_tokens",
    "per-tenant admission token-bucket level (refills at the tenant's "
    "weighted fair share of the service's admission rate)")
# Latency attribution, ingress scope (README "Latency attribution"): the
# per-request proxy-added wall — ingress hop wall minus the engine-
# reported wall (X-Engine-Wall-S on unary relays; the final stream
# event's latency_s on resumable streams) — the ROADMAP "proxy-added
# latency in µs" number measured per request, not inferred from paired
# benches.  Engine scope registers the same name in the model server's
# registry (serve-layer wall minus engine wall); conformance pins both.
INGRESS_PROXY_OVERHEAD = REGISTRY.histogram(
    "ingress_proxy_overhead_seconds",
    "serving-stack wall added around the engine per request (engine "
    "scope: model server; ingress scope: service proxy)",
    buckets=(0.00001, 0.000025, 0.00005, 0.0001, 0.00025, 0.0005,
             0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 1.0))
INGRESS_BROWNOUT = REGISTRY.gauge(
    "ingress_brownout_stage",
    "current brownout degradation stage per service (0 = normal; "
    "1 = max_tokens clamped; 2 = + speculation/fabric placement off; "
    "3 = + fabric publishes deferred)")
# Incident plane, ingress scope (README "Incident plane"): the service
# proxy runs one incident manager per service — failover retries,
# circuit-breaker opens, and autoscaler flapping feed its detectors, and
# GET /fleet/incidents merges its incidents with every replica's
# /engine/incidents.  Same three series the engine registers in its own
# registry (one metric contract, two scopes).
INCIDENTS_OPEN = REGISTRY.gauge(
    "incidents_open",
    "open (unresolved) incidents held by this component's incident "
    "manager")
INCIDENTS_TOTAL = REGISTRY.counter(
    "incidents_total",
    "resolved incidents by classified root cause")
INCIDENT_FIRINGS = REGISTRY.counter(
    "incident_detector_firings_total",
    "incident detector firings by detector")

# health states a backend can occupy; terminal routing decision per state:
# healthy/suspect route, probation routes only as a fallback set, ejected
# and draining never route.
_BACKEND_STATES = ("healthy", "suspect", "ejected", "probation", "draining")


class _BackendHealth:
    """Per-backend failure-detector record (guarded by _ProxyState.lock)."""

    __slots__ = ("state", "fails", "ejections", "until", "probed_at")

    def __init__(self):
        self.state = "healthy"
        self.fails = 0        # consecutive failures since last success
        self.ejections = 0    # consecutive ejection rounds (breaker backoff)
        self.until = 0.0      # monotonic deadline of the current ejection
        self.probed_at = 0.0  # monotonic time of the last active probe


class _ClientGone(Exception):
    """The downstream client hung up mid-relay: stop, never failover."""


class _BackendStreamError(Exception):
    """The backend's SSE stream broke (EOF before done, read error, stall,
    or an in-stream error event): failover material."""


class _ProxyState:
    def __init__(self, service_name: str, namespace: str):
        self.service_name = service_name
        self.namespace = namespace
        self.rr = 0
        self.split_key: Optional[str] = None  # guarded-by: lock
        self.credits: dict[str, int] = {}  # guarded-by: lock
        # engine-aware routing: port -> (scraped_at, load) with a short TTL,
        # plus in-flight deltas so back-to-back requests don't pile onto the
        # replica whose scrape is momentarily stale
        # port -> (scraped_at, load | None): None = negative cache (replica
        # unreachable at scraped_at) so back-to-back requests don't re-eat
        # the scrape timeout inline until the TTL expires
        self.loads: dict[int, tuple[float, Optional[float]]] = {}  # guarded-by: lock
        self.pending: dict[int, int] = {}  # guarded-by: lock
        # ports some thread is currently scraping OUTSIDE the lock — other
        # threads must not block on (or duplicate) that network call
        self.refreshing: set[int] = set()  # guarded-by: lock
        # backends expose no engine gauges (non-engine runtime): cached so
        # plain round-robin services don't pay per-request scrape sweeps
        self.engineless_until = 0.0
        # LEGACY prefix affinity memory: prompt-prefix -> port it was last
        # routed to.  Affinity only applies to prefixes SEEN here before —
        # a never-seen prompt has no cached KV anywhere, so hashing it to
        # a replica would just randomize load (measured r5: hash-affinity
        # on all-distinct prompts made 2 replicas no faster than 1).
        # Superseded by the GLOBAL cache-aware placement below whenever
        # the fleet publishes fabric prefixes (README "Fleet KV fabric");
        # it remains the fallback for fabric-less fleets, whose only warm
        # state is the device-local cache this map approximates.
        # Insertion-ordered; capped in _pick_engine_aware.
        self.affinity: dict[str, int] = {}  # guarded-by: lock
        # fleet cache view (README "Fleet KV fabric"): replica name ->
        # last-known cache analytics + published fabric prefixes from
        # GET /engine/perf?view=cache — the GLOBAL cache state the
        # cache-aware placement scores (deepest-matched-prefix wins,
        # load-balanced tiebreak).  Refreshed in the BACKGROUND on the
        # request path (TTL'd, single-flight — a pick never blocks on a
        # fleet fan-out) and synchronously by GET /fleet/cache polls.
        # Stale entries serve their last-known state annotated with age
        # (staleness-tolerant: a wrong placement costs one degraded pull,
        # never correctness); entries for pods that left the service are
        # PRUNED on every refresh.
        self.cache_view: dict[str, dict] = {}  # guarded-by: lock
        self.cache_view_at = 0.0     # monotonic time of the last refresh
        self.cache_refreshing = False  # single-flight background refresh
        # fleet latency view (README "Latency attribution"): merged
        # per-class budget samples from every replica's GET
        # /engine/latency, refreshed on the same TTL'd single-flight
        # background cadence as the cache view (a /fleet/latency poll
        # serves the last-known view, never blocks on the fan-out)
        self.latency_view: dict = {}  # guarded-by: lock
        self.latency_view_at = 0.0   # monotonic time of the last refresh
        self.latency_refreshing = False  # single-flight background refresh
        # fleet fault tolerance: per-backend health records + the set of
        # ports some thread is actively probing outside the lock (single-
        # flight, same discipline as `refreshing` above)
        self.health: dict[int, _BackendHealth] = {}  # guarded-by: lock
        self.probing: set[int] = set()  # guarded-by: lock
        # sticky session routing (README "Disaggregated serving"): session
        # id -> the port whose engine pinned that session's KV.  Without
        # this, turn N+1 load-balances like any other request and can
        # land on a replica without the pinned pages — a silent cold
        # restore.  LRU-capped; pruned on pod churn like `health`.
        self.sessions: dict[str, int] = {}  # guarded-by: lock
        # incident plane (README "Incident plane"): per-service ingress
        # incident manager (wired by ServiceProxy._start — it needs the
        # proxy's hooks) + the health-FSM transition log its evidence
        # snapshots cite.  The log is diffed into existence by
        # _set_state_gauge, the one funnel every transition already
        # passes through.
        self.incidents = None
        self.health_log: collections.deque = collections.deque(maxlen=256)  # guarded-by: lock
        self.health_last: dict[int, str] = {}  # guarded-by: lock
        # overload control (README "Overload control"): the service's
        # admission controller, built lazily from the overload annotation
        # (overload_key caches the raw annotation string so a rebuild
        # happens only when the operator actually changes it)
        self.overload = None
        self.overload_key: Optional[str] = None
        self.lock = threading.Lock()


class _ApiSnapshotCache:
    """Store-version-gated read cache for the relay hot path.

    ``api.list``/``api.get`` deepcopy every object on every call; the
    relay used to pay that per request for a pod list that changes
    maybe once a minute.  Entries are valid only for the exact
    ``APIServer.store_version()`` they were built at — any write to
    the store (create/update/status/delete) bumps the version and
    drops the whole cache, so a hit is indistinguishable from an
    uncached read.

    Contract: returned objects are SHARED across requests — callers
    treat them as read-only (the relay only ever reads them; the
    per-call deepcopies were pure waste).
    """

    _MISS = object()

    def __init__(self, api: APIServer):
        self._api = api
        self._lock = threading.Lock()
        self._version = -1
        self._entries: dict = {}

    def cached(self, key, build):
        v = self._api.store_version()
        with self._lock:
            if v != self._version:
                self._entries.clear()
                self._version = v
            else:
                hit = self._entries.get(key, self._MISS)
                if hit is not self._MISS:
                    return hit
        value = build()  # outside the lock: builds may take the API lock
        with self._lock:
            if self._version == v:
                self._entries[key] = value
        return value


class ServiceProxy:
    """Manages one HTTP listener per serving Service. Run .sync() as a ticker."""

    def __init__(self, api: APIServer):
        self.api = api
        self._servers: dict[tuple[str, str], ingress_core.IngressServer] = {}
        # per-service proxy state, kept alongside the listener so _stop
        # can retire the state's incident manager with its server
        self._states: dict[tuple[str, str], _ProxyState] = {}
        # optional fleet chaos hooks (faults.FleetChaos): the resumable
        # relay reports every relayed token event so seeded kill/hang/cut
        # injections fire at exact token counts (bench/test substrate)
        self.chaos = None
        # ingress half of the distributed trace (README "Observability"):
        # finished relay hop spans, bounded in traces AND bytes
        self.traces = tracing.TraceStore(
            max_traces=512, max_bytes=2_000_000,
            on_evict=lambda n: INGRESS_TRACE_EVICTIONS.inc(n))
        # self-driving fleet (README "Self-driving fleet"): the attached
        # FleetRemediator (attach_remediator) — its TierQuarantine gates
        # fabric/handoff placement below, and GET /fleet/remediation
        # serves its action log.  None = remediation plane off.
        self.remediator = None
        self.quarantine = None
        # structured output (README "Structured output"): ingress-side
        # spec validation registry — grammar compiles are memoized per
        # distinct spec, so the admission check is a dict hit for every
        # request after a tenant's first
        self._constrain_reg = None
        # hot-path read cache (README "Ingress data plane"): the relay
        # reads the Service object and the ready-pod list per request,
        # and api.get/list deepcopy every object per call — at wire
        # speed that deepcopy storm was the single largest CPU item on
        # the relay path.  Snapshots are keyed by api.store_version(),
        # so any store write invalidates everything and callers see
        # exactly what an uncached read would return.
        self._snap = _ApiSnapshotCache(api)

    def attach_remediator(self, remediator) -> None:
        """Wire the remediation controller (remediator.FleetRemediator):
        every existing service's incident manager is attached (new ones
        attach in ``_start``), and the remediator's tier quarantine
        becomes the placement gate ``_plan_fabric``/``_plan_disagg``
        consult."""
        self.remediator = remediator
        self.quarantine = getattr(remediator, "quarantine", None)
        for state in list(self._states.values()):
            if state.incidents is not None:
                remediator.attach(state.incidents)

    def sync(self) -> bool:
        changed = False
        seen = set()
        for svc in self.api.list("Service", label_selector=None):
            ann = svc["metadata"].get("annotations", {})
            if PROXY_PORT_ANNOTATION not in ann or LABEL_ISVC not in svc["metadata"].get("labels", {}):
                continue
            key = (svc["metadata"].get("namespace", "default"), svc["metadata"]["name"])
            seen.add(key)
            if key not in self._servers:
                self._start(key, int(ann[PROXY_PORT_ANNOTATION]))
                changed = True
        for key in list(self._servers):
            if key not in seen:
                self._stop(key)
                changed = True
        return False if not changed else True

    def _start(self, key: tuple[str, str], port: int) -> None:
        proxy = self
        ns, name = key
        state = _ProxyState(name, ns)
        # ingress incident manager (README "Incident plane"): event-driven
        # only — failover retries, breaker opens and autoscaler flap
        # reports feed it; a clean fleet pays one idle wait per poll
        # interval and nothing on any request path
        state.incidents = incidents_mod.IncidentManager(
            scope=f"ingress:{name}",
            detectors=incidents_mod.ingress_detectors(),
            evidence=lambda s=state: proxy._ingress_evidence(s),
            on_firing=lambda d: INCIDENT_FIRINGS.inc(detector=d),
            on_resolve=lambda c: INCIDENTS_TOTAL.inc(cause=c),
            on_open_count=lambda n, s=state: INCIDENTS_OPEN.set(
                n, service=s.service_name))
        state.incidents.start()
        if self.remediator is not None:
            # a service started after attach_remediator still gets its
            # incidents remediated (attach is idempotent per manager)
            self.remediator.attach(state.incidents)

        # Event-loop data plane (README "Ingress data plane"): one
        # selectors readiness loop owns accept/framing/keep-alive; a
        # fixed worker set runs the admission pipeline + relay state
        # machine per framed request.
        server = ingress_core.IngressServer(
            ("127.0.0.1", port),
            lambda conn: proxy._handle_request(conn, state))
        threading.Thread(target=server.serve_forever, daemon=True).start()
        self._servers[key] = server
        self._states[key] = state

    def _handle_request(self, handler, state: "_ProxyState") -> None:
        """Route one framed request: proxy-native GET surfaces answer from
        the proxy itself; everything else relays.  ``handler`` is an
        ingress_core.Conn (command/path/headers/rfile/_reply)."""
        # the body is always drained, even for the proxy-native
        # GETs below: unread Content-Length bytes would be parsed
        # as the NEXT request line on this keep-alive connection
        n = int(handler.headers.get("Content-Length") or 0)
        body = handler.rfile.read(n) if n else None
        path = handler.path.split("?")[0].rstrip("/")
        if handler.command == "GET":
            # proxy-native debug/aggregation surface:
            # these answer FROM the proxy (fanning out underneath)
            # instead of relaying to one backend
            if path.startswith("/debug/trace/"):
                self._serve_trace(handler, state,
                                  path[len("/debug/trace/"):])
                return
            if path.startswith("/fleet/trace/"):
                # /fleet/trace/<id> is /debug/trace/<id> under its
                # fleet-surface name; the /waterfall suffix asks
                # for the assembled latency attribution instead
                # of the raw span tree
                rest = path[len("/fleet/trace/"):]
                if rest.endswith("/waterfall"):
                    self._serve_fleet_waterfall(
                        handler, state, rest[:-len("/waterfall")])
                else:
                    self._serve_trace(handler, state, rest)
                return
            if path == "/fleet/latency":
                self._serve_fleet_latency(handler, state)
                return
            if path == "/fleet/metrics":
                self._serve_fleet_metrics(handler, state)
                return
            if path == "/fleet/cache":
                self._serve_fleet_cache(handler, state)
                return
            if path == "/fleet/incidents":
                self._serve_fleet_incidents(handler, state)
                return
            if path.startswith("/fleet/incidents/"):
                self._serve_fleet_incident(
                    handler, state,
                    path[len("/fleet/incidents/"):])
                return
            if path == "/fleet/remediation":
                self._serve_fleet_remediation(handler, state)
                return
        self._relay(handler, state, body)

    def _relay_stream(self, handler, r, ctype: str) -> bool:
        """Relay a non-resumable SSE response to the client; True unless
        the BACKEND failed mid-stream (the caller charges the strike).

        Zero-copy passthrough: the backend's SSE is close-delimited raw
        bytes (the model server's ``_sse_write`` sends ``Connection:
        close`` and no framing), so the proxy answers with the same
        close-delimited framing and forwards ``read1`` buffers untouched
        — no decode, no re-chunking, no per-event work.
        """
        return self._stream_passthrough(handler, r, ctype)

    @staticmethod
    def _stream_passthrough(handler, r, ctype: str) -> bool:
        # Once any response byte is on the wire nothing may bubble out of
        # here (a second HTTP response would land in the body); a backend
        # death mid-splice emits the same terminal structured error event
        # as the reframing arm, then closes — and the connection always
        # closes afterward because close-delimited framing has no
        # end-of-body marker.
        backend_ok = True
        try:
            handler.send_response(r.status)
            handler.send_header("Content-Type", ctype)
            handler.send_header("Cache-Control", "no-cache")
            handler.send_header("Connection", "close")
            if getattr(handler, "_trace_id", None):
                handler.send_header("X-Trace-Id", handler._trace_id)
            handler.end_headers()
        except Exception:  # noqa: BLE001 — client gone pre-headers
            handler.close_connection = True
            return backend_ok
        try:
            while True:
                try:
                    chunk = r.read1(65536)  # whatever the backend flushed
                except Exception as e:  # noqa: BLE001 — incl. stalls
                    backend_ok = False
                    err = json.dumps({"error": f"backend: {e}",
                                      "done": True}).encode()
                    handler.wfile.write(b"data: " + err + b"\n\n")
                    break
                if not chunk:
                    break
                handler.wfile.write(chunk)
            handler.wfile.flush()
        except Exception:  # noqa: BLE001 — client hung up mid-stream
            pass
        handler.close_connection = True
        return backend_ok

    def _stop(self, key: tuple[str, str]) -> None:
        server = self._servers.pop(key)
        state = self._states.pop(key, None)

        def close():
            server.shutdown()
            server.server_close()  # release the listening socket, not just the loop
            if state is not None and state.incidents is not None:
                state.incidents.stop()

        threading.Thread(target=close, daemon=True).start()

    # ------------------------------------------------------- failover relay

    # default relay knobs (overridable per Service via annotations above)
    _RELAY_TIMEOUT_S = 300.0  # per-read backend silence budget
    _RETRY_BUDGET = 3         # failover re-attempts after the first try
    _BACKOFF_BASE_S = 0.05
    _BACKOFF_MAX_S = 2.0

    def _get_service(self, state: _ProxyState) -> Optional[Obj]:
        # snapshot-cached (read-only contract, see _ApiSnapshotCache)
        return self._snap.cached(
            ("Service", state.namespace, state.service_name),
            lambda: self.api.try_get("Service", state.service_name,
                                     state.namespace))

    def _relay(self, handler, state: _ProxyState, body: Optional[bytes]) -> None:
        """One client request end to end: pick → attempt → (on failure)
        re-pick and retry under the budget.  Retry is idempotency-safe by
        construction: a non-streamed request retries only while NOTHING has
        been written to the client, and a streamed one re-admits with its
        relayed token ids so the continuation picks up exactly where the
        dead backend stopped."""
        # waterfall pre-segments (README "Latency attribution"): the two
        # marks below bracket proxy work that happens BEFORE the relay
        # clock t0 starts — json parse and the admission/setup gate —
        # so the assembled waterfall's wall telescopes t_entry -> t_parse
        # -> t0 -> end with no untimed seam
        t_entry = time.perf_counter()
        svc = self._get_service(state)
        ann = (svc or {}).get("metadata", {}).get("annotations", {})
        budget = int(float(ann.get(RETRY_BUDGET_ANNOTATION,
                                   self._RETRY_BUDGET)))
        relay_timeout = float(ann.get(RELAY_TIMEOUT_ANNOTATION,
                                      self._RELAY_TIMEOUT_S))
        hedge_s = float(ann.get(HEDGE_TIMEOUT_ANNOTATION, 0.0))
        # ONE body parse for every proxy-native consumer on this request
        # (resume context, session stickiness, disagg classification) —
        # multi-KB prompt bodies must not be re-decoded per concern
        payload = None
        if body:
            try:
                payload = json.loads(body)
            except ValueError:
                payload = None
        t_parse = time.perf_counter()
        # ---- structured-output admission (README "Structured output"):
        # a malformed constrain spec 400s HERE, before it costs an
        # admission token, a relay hop or a backend compile — the same
        # compiler the serve layer runs, so ingress and engine can never
        # disagree about what is well-formed
        if (handler.command == "POST"
                and self._validate_constrain(handler, payload)):
            return
        # ---- overload control (README "Overload control"): the shed-at-
        # ingress decision runs BEFORE any relay/placement work — a
        # refused request costs one bucket refill and a 429, not a relay,
        # a queue slot and a prefill.  Admitted requests may come back
        # browned out: the body is rewritten (max_tokens clamp, engine
        # brownout stage) before the resume/session machinery snapshots it.
        ov = self._overload_for(state, svc)
        decision = None
        ov_ttfb: Optional[float] = None
        saw_backpressure = False  # an ENGINE 503+Retry-After was relayed
        if ov is not None and handler.command == "POST":
            decision = self._admit_overload(state, ov, handler, payload)  # graftlint: acquires=inflight-slot
            if not decision.admitted:
                return  # _admit_overload answered the 429
        try:
            # everything between admission and the relay loop runs under
            # the same release guarantee as the loop's finally: the
            # inflight slot taken at admission must not leak if any
            # pre-relay step throws (leaked slots ratchet the AIMD count
            # up until the service sheds everything with 'concurrency')
            if (decision is not None and decision.stage >= 1
                    and isinstance(payload, dict)):
                body, payload = self._apply_brownout(
                    payload, decision.stage, ov.config)
            resume = self._resume_context(handler.path, payload)
            session = self._session_key(handler.headers, payload)
            sse = _SSERelay(handler)
            # distributed trace (README "Observability"): adopt the caller's
            # traceparent (this relay's root span becomes its child) or mint a
            # fresh trace; every attempt below is a child hop of the root.
            # The inbound header is stripped from the forwarded set — each
            # attempt re-stamps its OWN hop context.
            inbound = tracing.parse_traceparent(
                handler.headers.get(tracing.TRACEPARENT_HEADER))
            root = inbound.child() if inbound is not None \
                else tracing.TraceContext.mint()
            sse.trace_id = root.trace_id
            handler._trace_id = root.trace_id
            prev_failed_hop: Optional[str] = None
            hop_by_hop = {"host", "content-length", "connection", "keep-alive",
                          "transfer-encoding", "upgrade", "te", "trailers",
                          # internal signaling headers the relay mints itself:
                          # forwarding a client's copy would let it forge
                          # failover (resumed_from) edges into traces
                          tracing.TRACEPARENT_HEADER, "x-resume-from"}
            fwd_headers = {k: v for k, v in handler.headers.items()
                           if k.lower() not in hop_by_hop}
            fwd_headers.setdefault("Content-Type", "application/json")
            t0 = time.perf_counter()
            # admission covers the overload gate plus the pre-relay setup
            # (brownout rewrite, resume/session context, trace mint) —
            # everything between the parse mark and the relay clock
            pre_s = {"ingress_parse": round(t_parse - t_entry, 6),
                     "admission": round(t0 - t_parse, 6)}
            # engine-attributed wall for THIS request, read from the
            # winning hop (unary: X-Engine-Wall-S header; resumable
            # stream: the final event's latency_s) — the per-request
            # proxy-overhead sample is ingress wall minus this
            eng_wall: Optional[float] = None
            status = 502
            backend_label = "none"
            attempt = 0
            tried: set[int] = set()
            # disaggregated prefill/decode (README "Disaggregated serving"):
            # when the service runs role-split replicas and this request
            # classifies as prefill-heavy, run the PREFILL phase now (one
            # unary hop to a prefill replica that exports the prompt's KV) and
            # rewrite the body into the DECODE phase the retry loop below
            # relays — restricted to decode-capable replicas.  Any prefill-
            # phase failure falls through to the plain unified relay.
            # Prefill-role replicas never take general traffic: every pick
            # below prefers decode/unified roles (fall-back inside the pick
            # keeps an all-prefill fleet serving rather than 503ing).
            roles = ("decode", "unified")
            split = False
            fabric_seen: dict = {}
            # brownout stage >= 2 sheds the ingress OPTIMIZATIONS first: the
            # disagg split and the fabric placement both fan out extra work
            # (prefill hops, view scoring, pulls) to buy latency — exactly
            # the quality spend that goes before availability does
            browned_out = decision is not None and decision.stage >= 2
            if session is None and svc is not None and not browned_out:
                plan = self._plan_disagg(state, svc, handler, body, payload,
                                         fabric_out=fabric_seen)
                if plan is not None:
                    decode_body = self._disagg_prefill(
                        state, svc, handler, plan, fwd_headers, root, t0,
                        relay_timeout)
                    if decode_body is not None:
                        body = decode_body
                        split = True
            # global cache-aware placement (README "Fleet KV fabric"): score
            # the fleet's published prefixes against this prompt.  The plan
            # steers the pick toward the deepest-matched owner; when the pick
            # lands elsewhere (load, stickiness, failover) the relay injects
            # a parameters.fabric pull hint so the chosen replica faults the
            # prefix in instead of re-prefilling it.  Split requests keep
            # their rewritten handoff body untouched; a plan the disagg
            # classifier already computed is reused, not re-hashed.
            fabric_plan = None
            if svc is not None and not split and not browned_out:
                fabric_plan = (fabric_seen["plan"] if "plan" in fabric_seen
                               else self._plan_fabric(state, handler, payload))
            # true only for the dispatch immediately following a hedge-armed
            # stall: THAT attempt is the hedged re-dispatch ingress_hedged_total
            # counts, not the tight-timeout first attempt that armed it
            hedge_redispatch = False

            def reply(code: int, data: bytes, ctype: Optional[str] = None,
                      extra: Optional[dict] = None):
                handler._reply(code, data, ctype,
                               extra={**(extra or {}),
                                      "X-Trace-Id": root.trace_id})

            def note_hop(hop, backend, kind, hop_t0, outcome,
                         error: Optional[str] = None,
                         backend_state: Optional[str] = None,
                         timing: Optional[dict] = None) -> None:
                span = {"trace_id": root.trace_id, "span_id": hop.span_id,
                        "parent_id": hop.parent_id, "component": "ingress",
                        "name": "relay_attempt", "attempt": attempt,
                        "kind": kind, "backend": backend,
                        "backend_state": backend_state, "outcome": outcome,
                        "t_start_s": round(hop_t0 - t0, 6),
                        "duration_s": round(time.perf_counter() - hop_t0, 6)}
                if timing is not None:
                    # pooled-transport sub-segments (README "Ingress data
                    # plane"): the waterfall assembler carves pool_wait/
                    # connect/first_byte out of this hop's lead-in
                    span["transport"] = {
                        "outcome": timing.get("outcome"),
                        "pool_wait_s": round(
                            float(timing.get("pool_wait_s") or 0.0), 9),
                        "connect_s": round(
                            float(timing.get("connect_s") or 0.0), 9),
                        "first_byte_s": round(
                            float(timing.get("first_byte_s") or 0.0), 9)}
                if error is not None:
                    span["error"] = error
                if prev_failed_hop is not None:
                    # the hop this one picks up from: retries reference the
                    # failed attempt; stream re-admissions are the satellite's
                    # "resumed_from" edge in the assembled tree
                    span["resumed_from"] = prev_failed_hop
                self.traces.put(root.trace_id, span)

        except BaseException:
            if ov is not None and decision is not None:
                ov.release(decision, ok=False, ttfb_s=None,
                           now=time.monotonic())
                decision = None
            raise
        try:
            while True:
                pick_note: dict = {}
                try:
                    backend = self._pick_backend(state, body=body,
                                                 exclude=frozenset(tried),
                                                 svc=svc, roles=roles,
                                                 session=session,
                                                 fabric=fabric_plan,
                                                 note=pick_note)
                except LookupError as e:
                    status = 503
                    note_hop(root.child(), None, "pick",
                             time.perf_counter(), "no_backend", str(e))
                    if sse.started:
                        sse.error_event(str(e))
                    else:
                        reply(503, json.dumps({"error": str(e)}).encode())
                    return
                backend_label = str(backend)
                hop = root.child()
                hop_t0 = time.perf_counter()
                with state.lock:
                    h_rec = state.health.get(backend)
                    hop_state = h_rec.state if h_rec is not None else "unknown"
                data, hdrs = body, dict(fwd_headers)
                hdrs[tracing.TRACEPARENT_HEADER] = hop.traceparent()
                if fabric_plan is not None:
                    if pick_note.get("fabric_pick") == backend:
                        # the pick landed ON the deepest-prefix owner:
                        # the warm device cache serves the prefix with no
                        # pull at all — the placement win the fabric view
                        # exists for
                        disagg.PLACEMENTS.inc(reason="cache")
                    else:
                        hint = self._fabric_hint(
                            fabric_plan, backend,
                            pick_note.get("session_remap_from"))
                        if hint is not None:
                            data = self._inject_fabric(payload, hint)
                            hdrs["Content-Type"] = "application/json"
                if resume is not None:
                    # ask the engine surface to annotate stream events with
                    # the token ids they cover — the re-admission currency
                    hdrs["X-Stream-Resume"] = "1"
                    if resume.token_ids:
                        data = resume.request_body()
                        hdrs["Content-Type"] = "application/json"
                        if prev_failed_hop is not None:
                            # the engine span links the failed hop: the
                            # assembled tree shows the continuation
                            # hanging off the attempt that died
                            hdrs["X-Resume-From"] = prev_failed_hop
                # relay timeout = per-read backend silence (the stall
                # detector), NOT total request time; it must exceed any
                # client-side budget or the ingress would 502 slow-but-
                # alive generations.  A hedge timeout, when configured,
                # tightens only the first non-streamed attempt.
                attempt_timeout = relay_timeout
                # never hedge a request that will stream: the transport's
                # timeout persists as the per-read socket timeout for the WHOLE
                # relay, so a tight hedge cap would kill healthy slow
                # streams mid-generation.  The path check covers EVERY
                # generate_stream request (string-body ones have no resume
                # ctx); _wants_stream covers OpenAI "stream": true bodies.
                hedging = (hedge_s > 0 and resume is None
                           and attempt == 0 and handler.command != "GET"
                           and not handler.path.split("?")[0].rstrip("/")
                           .endswith("/generate_stream")
                           and not self._wants_stream(body))
                if hedging:
                    attempt_timeout = min(attempt_timeout, hedge_s)
                kind = ("resume" if resume is not None and resume.token_ids
                        else "hedge" if hedge_redispatch else "relay")
                hedge_redispatch = False
                reason = None
                retry_hint: Optional[float] = None
                try:
                    # pooled keepalive transport (README "Ingress data
                    # plane"): no TCP dial per attempt — the pool hands
                    # back a warm socket or dials fresh, and ≥400 raises
                    # the same urllib HTTPError envelope the branches
                    # below were built against
                    with transport.request(
                            handler.command, backend, handler.path,
                            body=data, headers=hdrs,
                            timeout=attempt_timeout) as r:
                        status = r.status
                        ctype = r.headers.get("Content-Type") or ""
                        if ctype.startswith("text/event-stream"):
                            if resume is not None:
                                def _set_ttfb(v: float) -> None:
                                    nonlocal ov_ttfb
                                    ov_ttfb = v

                                def _set_eng_wall(v: float) -> None:
                                    nonlocal eng_wall
                                    eng_wall = v
                                self._relay_resumable(
                                    state, r, sse, resume, backend,
                                    keep_ids=self._client_wants_ids(
                                        handler.headers),
                                    on_ttfb=(_set_ttfb if decision
                                             is not None else None),
                                    on_engine_wall=_set_eng_wall)
                                ok = True
                            else:
                                ok = self._relay_stream(handler, r, ctype)
                            self._note_backend(state, backend, ok)
                            note_hop(hop, backend, kind, hop_t0,
                                     "ok" if ok else "stream_error",
                                     backend_state=hop_state,
                                     timing=getattr(r, "timing", None))
                            return
                        payload = r.read()
                        try:
                            eng_wall = float(
                                r.headers.get("X-Engine-Wall-S") or "")
                        except ValueError:
                            eng_wall = None
                        if decision is not None:
                            # queue+TTFT feedback for the overload
                            # controller's deadline estimator (the
                            # engine's X-TTFT-S response surface)
                            try:
                                ov_ttfb = float(
                                    r.headers.get("X-TTFT-S") or "")
                            except ValueError:
                                ov_ttfb = None
                        self._note_backend(state, backend, True)
                        if sse.started:
                            # a RESUMED stream landed on a backend that
                            # answered non-SSE: replying normally would
                            # write a second HTTP response into the live
                            # chunked body — terminal error event instead.
                            # The request dies here, so the hop must NOT
                            # read outcome=ok (the trace would show the
                            # failed re-admission as a clean failover)
                            note_hop(hop, backend, kind, hop_t0,
                                     "resume_non_stream",
                                     f"HTTP {r.status}, {ctype or '?'}",
                                     backend_state=hop_state)
                            sse.error_event(
                                "re-admission returned a non-stream "
                                f"response ({r.status}, {ctype or '?'})")
                            return
                        note_hop(hop, backend, kind, hop_t0, "ok",
                                 backend_state=hop_state,
                                 timing=getattr(r, "timing", None))
                        # session surface headers pass through: a client
                        # behind the fleet reads X-Session-Restore/-Pinned
                        # exactly like one talking to a replica directly
                        reply(r.status, payload, ctype or None,
                              extra={k: v for k, v in r.headers.items()
                                     if k.lower().startswith("x-session-")})
                        return
                except urllib.error.HTTPError as e:
                    status = e.code
                    # 504 = the ENGINE shed this request's deadline
                    # (DeadlineExceeded): the replica is healthy and the
                    # request's time budget is spent — a failover retry
                    # would restart the deadline on another replica and
                    # double the queueing work exactly when the fleet is
                    # drowning (waste amplification), so it reports
                    # terminal like a client fault, with no health strike
                    if e.code < 500 or e.code == 504:
                        self._note_backend(state, backend, True)
                        note_hop(hop, backend, kind, hop_t0,
                                 f"status_{e.code}",
                                 backend_state=hop_state)
                        if sse.started:  # a RESUMED request was refused
                            sse.error_event(
                                f"re-admission refused: {e.code}")
                        else:
                            reply(e.code, e.read(),
                                  e.headers.get("Content-Type"))
                        return
                    try:
                        # engine-side backpressure names its own backoff
                        # (README "Overload control"): honor it below
                        # instead of immediately re-pick hammering the
                        # next replica with the same doomed burst
                        retry_hint = float(
                            e.headers.get("Retry-After") or "")
                    except (TypeError, ValueError):
                        retry_hint = None
                    # a 503 WITH Retry-After is typed BACKPRESSURE
                    # (EngineOverloaded): the replica is full, not
                    # broken — no health strike (breaker opens would
                    # amplify the storm by shrinking the routable set),
                    # and the incident evidence is capacity-shaped, not
                    # replica death
                    backpressure = (e.code == 503
                                    and retry_hint is not None)
                    saw_backpressure = saw_backpressure or backpressure
                    self._note_backend(state, backend, ok=backpressure)
                    note_hop(hop, backend, kind, hop_t0, "status_5xx",
                             f"HTTP {e.code}", backend_state=hop_state)
                    if attempt >= budget:
                        if sse.started:
                            sse.error_event(
                                f"backend failed with {e.code} after "
                                f"{attempt + 1} attempts")
                        else:
                            reply(e.code, e.read(),
                                  e.headers.get("Content-Type"))
                        return
                    reason = "backpressure" if backpressure \
                        else "status_5xx"
                except _ClientGone as e:
                    note_hop(hop, backend, kind, hop_t0, "client_gone",
                             str(e), backend_state=hop_state)
                    handler.close_connection = True
                    return
                except _BackendStreamError as e:
                    self._note_backend(state, backend, False)
                    note_hop(hop, backend, kind, hop_t0, "stream_error",
                             str(e), backend_state=hop_state)
                    if attempt >= budget:
                        status = 502
                        sse.error_event(
                            f"backend stream failed after {attempt + 1} "
                            f"attempts: {e}")
                        return
                    reason = "stream"
                except Exception as e:  # noqa: BLE001 — URLError/OSError/...
                    self._note_backend(state, backend, False)
                    stalled = self._is_timeout(e)
                    note_hop(hop, backend, kind, hop_t0,
                             "stall" if stalled else "connect", str(e),
                             backend_state=hop_state)
                    if attempt >= budget:
                        status = 502
                        msg = f"backend: {e}"
                        if sse.started:
                            sse.error_event(msg)
                        else:
                            reply(502, json.dumps({"error": msg}).encode())
                        return
                    if hedging and stalled:
                        reason = "stall"
                        INGRESS_HEDGED.inc(service=state.service_name)
                        hedge_redispatch = True
                    else:
                        reason = "stall" if stalled else "connect"
                attempt += 1
                tried.add(backend)
                prev_failed_hop = hop.span_id
                INGRESS_RETRIES.inc(service=state.service_name, reason=reason)
                if state.incidents is not None:
                    # failover incident signal (README "Incident plane"):
                    # one event per failed attempt — a kill/hang/cut burst
                    # coalesces into one incident citing this trace, and
                    # the re-admission (resume) rides the same chain.
                    # Typed backpressure is CAPACITY evidence, not
                    # replica death — feeding it as failover would let
                    # one engine 503 reclassify a whole storm incident.
                    state.incidents.feed(
                        "queue_growth" if reason == "backpressure"
                        else "failover", service=state.service_name,
                        backend=backend, reason=reason,
                        resume=bool(resume is not None and resume.token_ids),
                        trace_ids=[root.trace_id])
                if not sse.started:
                    # jittered exponential backoff — but never while a live
                    # client stream is waiting on its continuation
                    delay = min(self._BACKOFF_MAX_S,
                                self._BACKOFF_BASE_S * (2 ** (attempt - 1)))
                    if retry_hint is not None and retry_hint > 0:
                        # the backend's Retry-After wins (capped so one
                        # replica's generous hint can't stall the relay
                        # past the breaker's own timescale), jittered so
                        # a shed burst doesn't re-arrive in lockstep
                        delay = min(self._BACKOFF_MAX_S,
                                    max(delay, retry_hint))
                        time.sleep(delay * random.uniform(0.5, 1.0))
                    else:
                        time.sleep(random.uniform(0, delay))
        finally:
            if ov is not None and decision is not None and decision.admitted:
                # free the inflight slot + feed the AIMD signals: TYPED
                # engine backpressure (503+Retry-After) that leaked
                # through means the limiter let too much past — direct
                # overload evidence.  A bare 503 is NOT: the ingress'
                # own no-backend reply and a draining replica's refusal
                # must not drive the AIMD into brownout on an idle fleet.
                ov.release(decision, ok=status < 500, ttfb_s=ov_ttfb,  # graftlint: releases=inflight-slot
                           now=time.monotonic(),
                           engine_overloaded=saw_backpressure)
                self._drain_overload_events(state, ov)
            # latency covers the full relay (SSE: the whole stream, across
            # every failover attempt)
            INGRESS_LATENCY.observe(time.perf_counter() - t0,
                                    service=state.service_name)
            INGRESS_REQUESTS.inc(service=state.service_name,
                                 backend=backend_label,
                                 code=f"{status // 100}xx")
            if eng_wall is not None:
                # ingress scope of ingress_proxy_overhead_seconds: the
                # full proxy wall (entry to reply, parse + admission +
                # relay) minus the engine-reported wall — clipped at 0
                # because the two clocks are different processes
                INGRESS_PROXY_OVERHEAD.observe(
                    max(0.0, time.perf_counter() - t_entry - eng_wall),
                    service=state.service_name)
            # root span last: the hop spans are its children in the tree.
            # pre_s carries the pre-relay segments; the waterfall wall is
            # sum(pre_s) + duration_s, telescoped with no untimed seam.
            self.traces.put(root.trace_id, {
                "trace_id": root.trace_id, "span_id": root.span_id,
                "parent_id": root.parent_id, "component": "ingress",
                "name": "request", "service": state.service_name,
                "path": handler.path, "method": handler.command,
                "status": status, "attempts": attempt + 1,
                "pre_s": pre_s,
                "engine_wall_s": eng_wall,
                "t_start_s": 0.0,
                "duration_s": round(time.perf_counter() - t0, 6)})

    @staticmethod
    def _wants_stream(body: Optional[bytes]) -> bool:
        """True when the request body asks for a streamed response (the
        OpenAI surface's ``"stream": true``)."""
        if not body:
            return False
        try:
            payload = json.loads(body)
        except ValueError:
            return False
        return bool(isinstance(payload, dict) and payload.get("stream"))

    @staticmethod
    def _is_timeout(e: Exception) -> bool:
        import socket

        cause = getattr(e, "reason", e)
        return isinstance(cause, (TimeoutError, socket.timeout))

    @staticmethod
    def _resume_context(path: str, payload):
        """A _ResumeCtx when this request is a resumable token stream (the
        V2 generate_stream surface with a text prompt), else None.
        ``payload`` is the relay's one parsed copy of the request body."""
        if not path.split("?")[0].rstrip("/").endswith("/generate_stream"):
            return None
        if not isinstance(payload, dict) or not isinstance(
                payload.get("text_input"), str):
            return None
        return _ResumeCtx(payload)

    @staticmethod
    def _client_wants_ids(headers) -> bool:
        """True when the DOWNSTREAM client itself sent X-Stream-Resume: it
        wants the per-event token ids too (a chained ingress, the fleet
        bench's identity audit) — the relay then forwards them instead of
        consuming them for its own re-admission bookkeeping."""
        for k, v in headers.items():
            if (k.lower() == "x-stream-resume"
                    and str(v).strip().lower() not in ("", "0", "false",
                                                       "no")):
                return True
        return False

    def _relay_resumable(self, state: _ProxyState, r, sse: "_SSERelay",
                         resume: "_ResumeCtx", backend: int,
                         keep_ids: bool = False, on_ttfb=None,
                         on_engine_wall=None) -> None:
        """Parse-and-relay one backend SSE stream, recording the token ids
        behind every relayed event into ``resume`` so a broken stream can be
        re-admitted elsewhere.  ``keep_ids`` forwards the ids to the client
        as well (it asked with its own X-Stream-Resume header) instead of
        stripping them.  Raises _BackendStreamError on EOF-before-
        done, read errors/stalls, or an in-stream backend error event;
        raises _ClientGone when the downstream client hangs up."""
        chaos = self.chaos
        buf = b""
        while True:
            try:
                chunk = r.read1(65536)
            except Exception as e:  # noqa: BLE001 — conn reset, stall, ...
                raise _BackendStreamError(f"read: {e}") from e
            if not chunk:
                # SSE is close-delimited: EOF before the done event means
                # the backend died mid-generation
                raise _BackendStreamError("stream ended before done event")
            buf += chunk
            while b"\n\n" in buf:
                raw, buf = buf.split(b"\n\n", 1)
                event = None
                for line in raw.splitlines():
                    if line.startswith(b"data:"):
                        try:
                            event = json.loads(line[5:].strip())
                        except ValueError:
                            event = None
                if not isinstance(event, dict):
                    continue
                if "error" in event:
                    # engine fault surfaced as a structured in-stream error
                    # event (the model server's _sse_write contract): same
                    # failover path as a dropped connection
                    raise _BackendStreamError(str(event["error"]))
                ids = (event.get("token_ids") if keep_ids
                       else event.pop("token_ids", None))
                if ids:
                    resume.token_ids.extend(int(i) for i in ids)
                if event.get("done"):
                    if on_ttfb is not None and isinstance(
                            event.get("ttft_s"), (int, float)):
                        # the stream's final record carries the engine's
                        # queue+TTFT — the overload controller's deadline
                        # estimator feeds from it (the plain passthrough
                        # relay never parses events, so SSE-only fleets
                        # without resume contexts stay unsampled)
                        on_ttfb(float(event["ttft_s"]))
                    if on_engine_wall is not None and isinstance(
                            event.get("latency_s"), (int, float)):
                        # engine-attributed wall for the waterfall's
                        # per-request proxy-overhead sample — same final
                        # record, same passthrough caveat as ttft_s
                        on_engine_wall(float(event["latency_s"]))
                    if resume.token_ids and "tokens" in event:
                        # across failovers the LAST backend only knows its
                        # continuation; the ingress knows the whole run
                        event["tokens"] = max(int(event["tokens"]),
                                              len(resume.token_ids))
                    sse.event(event)
                    sse.finish()
                    return
                if event.get("text_output") or (keep_ids and ids):
                    # empty pieces exist only to carry token_ids promptly
                    # (held-back UTF-8 tails); an id-wanting client gets
                    # them, anyone else never sees them
                    sse.event(event)
                if chaos is not None:
                    act = chaos.on_relay_event(backend, resume.key)
                    if act == "cut":
                        raise _BackendStreamError(
                            "chaos: injected mid-stream disconnect")

    # --------------------------------------------------- overload control
    # (README "Overload control"): the ingress admission layer.  The
    # controller (serving/overload.py) owns the policy — per-tenant
    # weighted quotas, the AIMD concurrency limit, deadline early-reject,
    # staged brownout; this is the wiring: annotation parsing, the 429
    # surface, brownout body rewrites, metric/incident feeds.

    def _overload_for(self, state: _ProxyState,
                      svc: Optional[Obj]) -> Optional[object]:
        """The service's overload controller, built (and cached) from the
        overload annotation.  Absent/off/unparseable = None — admission
        control is opt-in, and a bad config disables shedding rather than
        shedding on garbage thresholds."""
        if svc is None:
            return state.overload
        raw = svc["metadata"].get("annotations", {}).get(
            OVERLOAD_ANNOTATION)
        key = None if raw is None else str(raw)
        with state.lock:
            if key == state.overload_key:
                return state.overload
        ctrl = None
        if key is not None and key.strip().lower() not in ("", "off",
                                                           "false", "0"):
            try:
                if key.strip().lower() in ("on", "true", "1"):
                    cfg = overload_mod.OverloadConfig()
                else:
                    cfg = overload_mod.OverloadConfig.from_json(
                        json.loads(key))
                ctrl = overload_mod.OverloadController(cfg)
            except (ValueError, TypeError):
                ctrl = None  # misconfigured: fail open, not closed
        with state.lock:
            state.overload_key = key
            state.overload = ctrl
        INGRESS_BROWNOUT.set(0, service=state.service_name)
        return ctrl

    def _validate_constrain(self, handler, payload) -> bool:
        """Compile-validate ``parameters.constrain`` at ingress; True when
        the 400 was already answered.  Compiles the GRAMMAR only (the
        token map is the replica's, tied to its tokenizer) through a
        memoized registry, so the steady-state cost is one dict lookup."""
        if not isinstance(payload, dict):
            return False
        params = payload.get("parameters")
        spec = params.get("constrain") if isinstance(params, dict) else None
        if spec is None:
            return False
        from .constrain import ConstrainRegistry, GrammarError

        if self._constrain_reg is None:
            self._constrain_reg = ConstrainRegistry()
        try:
            self._constrain_reg.grammar_for(spec)
            return False
        except GrammarError as e:
            try:
                handler._reply(400, json.dumps({"error": str(e)}).encode())
            except Exception:  # noqa: BLE001 — client gone before the 400
                handler.close_connection = True
            return True

    def _admit_overload(self, state: _ProxyState, ov, handler, payload):
        """Run one POST through the admission gates; on refusal, answer
        the 429 (Retry-After header + machine-readable body) HERE so the
        relay path stays linear.  Returns the Decision either way."""
        decision = ov.admit(
            tenant=self._tenant_key(handler.headers, payload),
            cls=self._overload_class(handler.headers, payload),
            cost=self._overload_cost(payload),
            deadline_s=self._overload_deadline(payload),
            now=time.monotonic())
        svc_label = state.service_name
        INGRESS_BROWNOUT.set(decision.stage, service=svc_label)
        if decision.tokens_left is not None:
            INGRESS_TENANT_TOKENS.set(decision.tokens_left,
                                      service=svc_label,
                                      tenant=decision.tenant)
        self._drain_overload_events(state, ov)
        if decision.admitted:
            return decision
        INGRESS_SHED.inc(service=svc_label, reason=decision.reason,
                         **{"class": decision.cls})
        body = json.dumps({
            "error": f"overloaded: {decision.detail or decision.reason}",
            "reason": decision.reason,
            "retry_after_s": decision.retry_after_s,
            "tenant": decision.tenant,
            "class": decision.cls,
            "brownout_stage": decision.stage,
        }).encode()
        try:
            handler._reply(429, body,
                           extra={"Retry-After":
                                  f"{decision.retry_after_s:g}"})
        except Exception:  # noqa: BLE001 — client gone before the 429
            handler.close_connection = True
        return decision

    def _drain_overload_events(self, state: _ProxyState, ov) -> None:
        """Feed the controller's aggregated shed/brownout events into the
        service's incident manager — the self-resolving ``capacity``
        evidence source (README "Incident plane"): a storm reads as ONE
        classified incident citing shed counts and brownout stages."""
        for t in ov.drain_pruned_tenants():
            # the controller pruned this tenant's bucket: drop its gauge
            # series too, or a unique-X-Tenant-Id storm grows the metric
            # registry one series per tenant forever
            INGRESS_TENANT_TOKENS.remove(service=state.service_name,
                                         tenant=t)
        if state.incidents is None:
            return
        for ev in ov.drain_events():
            state.incidents.feed(ev.pop("kind"),
                                 service=state.service_name, **ev)

    @staticmethod
    def _tenant_key(headers, payload) -> Optional[str]:
        """The request's tenant — ``X-Tenant-Id`` header, a top-level
        ``tenant`` body field, or ``parameters.tenant``; None lands on
        the default tenant (legacy traffic keeps working, it just
        shares one bucket)."""
        for k, v in headers.items():
            if k.lower() == "x-tenant-id" and str(v).strip():
                return str(v).strip()
        if isinstance(payload, dict):
            t = payload.get("tenant")
            if t is None:
                params = payload.get("parameters")
                if isinstance(params, dict):
                    t = params.get("tenant")
            if isinstance(t, str) and t:
                return t
        return None

    @staticmethod
    def _overload_class(headers, payload) -> Optional[str]:
        """The request's SLO/priority class for shed ordering —
        ``parameters.priority`` / a top-level ``priority`` wins over the
        ``X-Priority`` header; junk falls back to the default class at
        the controller (the backend's 400 names the real error)."""
        if isinstance(payload, dict):
            params = payload.get("parameters")
            p = params.get("priority") if isinstance(params, dict) else None
            if p is None:
                p = payload.get("priority")
            if isinstance(p, str) and p:
                return p
        for k, v in headers.items():
            if k.lower() == "x-priority" and str(v).strip():
                return str(v).strip()
        return None

    @staticmethod
    def _overload_cost(payload) -> float:
        """Token-bucket cost estimate: ~prompt tokens + requested output
        tokens.  The proxy has no tokenizer, so chars/4 approximates the
        prompt — quotas need proportionality, not token-exactness.  V1
        predict batches charge PER INSTANCE: one HTTP request fanning
        out into N engine submissions must not cost the same as one tiny
        generate, or batching becomes a quota bypass."""
        if isinstance(payload, dict) \
                and isinstance(payload.get("instances"), list):
            total = 0.0
            for inst in payload["instances"]:
                if isinstance(inst, dict):
                    prompt = inst.get("prompt")
                    n = len(prompt) if isinstance(prompt, str) else 0
                    try:
                        mt = max(1, int(inst.get("max_tokens", 32)))
                    except (TypeError, ValueError):
                        mt = 32
                else:
                    n = len(inst) if isinstance(inst, str) else 0
                    mt = 32
                total += max(1.0, n / 4.0) + mt
            return max(1.0, total)
        text = ServiceProxy._payload_text(payload) or ""
        mt = 32
        if isinstance(payload, dict):
            params = payload.get("parameters")
            raw = params.get("max_tokens") \
                if isinstance(params, dict) else None
            if raw is None:
                raw = payload.get("max_tokens")
            try:
                mt = max(1, int(raw)) if raw is not None else 32
            except (TypeError, ValueError):
                mt = 32
        return max(1.0, len(text) / 4.0) + mt

    @staticmethod
    def _overload_deadline(payload) -> Optional[float]:
        if not isinstance(payload, dict):
            return None
        params = payload.get("parameters")
        dl = params.get("deadline_s") if isinstance(params, dict) else None
        try:
            return float(dl) if dl is not None else None
        except (TypeError, ValueError):
            return None

    @staticmethod
    def _apply_brownout(payload: dict, stage: int, cfg) -> tuple:
        """Rewrite an admitted request's body for brownout ``stage``:
        clamp the requested output budget (stage >= 1) and carry the
        stage to the engine (stage >= 2: ``parameters.brownout`` —
        speculation drafting off there, fabric publish deferred at 3).
        Returns ``(body_bytes, payload)``; the original payload object is
        never mutated (retries re-derive from the rewritten copy)."""
        p = copy.deepcopy(payload)
        clamp = int(cfg.brownout_max_tokens)
        params = p.get("parameters")
        if not isinstance(params, dict) and isinstance(
                p.get("text_input"), str):
            # V2 generate with no parameters block: the engine default
            # (32) may still exceed the clamp, and stage >= 2 needs a
            # place to carry the engine-side brownout marker
            params = p["parameters"] = {}
        if isinstance(params, dict):
            try:
                cur = int(params.get("max_tokens", 32))
            except (TypeError, ValueError):
                cur = 32
            params["max_tokens"] = min(cur, clamp)
            if stage >= 2:
                params["brownout"] = int(stage)
        if isinstance(p.get("max_tokens"), int):
            # OpenAI surface carries max_tokens at the top level
            p["max_tokens"] = min(p["max_tokens"], clamp)
        if stage >= 2 and not isinstance(p.get("parameters"), dict) \
                and (isinstance(p.get("prompt"), str)
                     or isinstance(p.get("messages"), list)):
            # OpenAI-shaped body: the server's _openai handler forwards a
            # top-level ``brownout`` into the engine parameters — without
            # it, stage >= 2 would clamp tokens but leave speculation and
            # fabric publishes running for exactly this surface
            p["brownout"] = int(stage)
        if isinstance(p.get("instances"), list):
            # V1 predict: per-instance budgets + the whole batch's
            # engine marker top-level (serve.predict reads it there)
            for inst in p["instances"]:
                if isinstance(inst, dict) \
                        and isinstance(inst.get("max_tokens"), int):
                    inst["max_tokens"] = min(inst["max_tokens"], clamp)
            if stage >= 2:
                p["brownout"] = int(stage)
        return json.dumps(p).encode(), p

    # ------------------------------------ disaggregated prefill/decode
    # (README "Disaggregated serving"): the proxy-side orchestration of
    # the two-phase split.  serving/disagg.py owns the policy (roles,
    # classification, the handoff store); this is the wiring.

    @staticmethod
    def _session_key(headers, payload) -> Optional[str]:
        """The request's session id, if any — X-Session-Id header, the V2
        ``parameters.session_id``, or the OpenAI body field — the sticky-
        routing key that sends turn N+1 to the replica holding turn N's
        pinned KV.  ``payload`` is the relay's one parsed body copy."""
        for k, v in headers.items():
            if k.lower() == "x-session-id" and str(v).strip():
                return str(v).strip()
        if not isinstance(payload, dict):
            return None
        params = payload.get("parameters")
        sid = params.get("session_id") if isinstance(params, dict) else None
        if sid is None:
            sid = payload.get("session_id")  # OpenAI surface body field
        return str(sid) if isinstance(sid, str) and sid else None

    def _plan_disagg(self, state: _ProxyState, svc: Obj, handler,
                     body: Optional[bytes], payload,
                     fabric_out: Optional[dict] = None) -> Optional[dict]:
        """Decide whether THIS request splits into prefill + decode
        phases: the service must run at least one prefill-role and one
        decode-capable ready replica, the path/payload must classify
        (disagg.should_disaggregate), and a prompt whose prefix-affinity
        entry points at a warm decode-capable replica prefers that cache
        hit over a handoff.  None = relay unified.  ``payload`` is the
        relay's one parsed copy of ``body``.  A computed fabric plan is
        surfaced through ``fabric_out["plan"]`` so the relay reuses it
        instead of re-hashing the prompt's fingerprint ladder."""
        ann = svc["metadata"].get("annotations", {})
        mode = str(ann.get(disagg.DISAGG_ANNOTATION, "auto")).lower()
        if mode == "off" or handler.command != "POST" or payload is None:
            return None
        q = self.quarantine
        if q is not None and q.active("handoff"):
            # handoff tier quarantined (README "Self-driving fleet"):
            # no prefill/decode splits are planned — requests relay
            # unified (degraded-local) until the probe lifts it
            return None
        if not disagg.eligible_path(handler.path):
            return None
        model = disagg.model_from_path(handler.path)
        if model is None:
            return None
        try:
            min_prompt = int(float(ann.get(
                disagg.DISAGG_MIN_PROMPT_ANNOTATION,
                disagg.DEFAULT_MIN_PROMPT_CHARS)))
            ratio = float(ann.get(disagg.DISAGG_RATIO_ANNOTATION,
                                  disagg.DEFAULT_PROMPT_DECODE_RATIO))
        except ValueError:
            return None
        if not disagg.should_disaggregate(payload, mode, min_prompt, ratio):
            return None
        pods = self._ready_pods(state.namespace,
                                svc["spec"].get("selector") or {}, None)
        roles_by_port = {pod_port(p): disagg.pod_role(p) for p in pods}
        if ("prefill" not in roles_by_port.values()
                or not any(r in ("decode", "unified")
                           for r in roles_by_port.values())):
            return None
        prefix = self._payload_prefix(payload)
        if prefix is not None:
            with state.lock:
                seen = state.affinity.get(prefix)
            if (seen in roles_by_port
                    and roles_by_port[seen] in ("decode", "unified")):
                # this prefix's KV is plausibly cached on a decode-capable
                # replica already: the warm re-prefill there beats paying
                # a handoff (the whole point of the affinity map)
                return None
        fplan = self._plan_fabric(state, handler, payload)
        if fabric_out is not None:
            fabric_out["plan"] = fplan
        if fplan is not None and any(
                roles_by_port.get(p) in ("decode", "unified")
                for p in fplan["owners"]):
            # the GLOBAL view knows a decode-capable replica published
            # this prefix: the cache-aware pick (or a fabric pull) beats
            # paying a fresh prefill + handoff for the same pages
            return None
        return {"payload": payload, "model": model}

    def _disagg_prefill(self, state: _ProxyState, svc: Obj, handler,
                        plan: dict, fwd_headers: dict, root, t0: float,
                        relay_timeout: float) -> Optional[bytes]:
        """Run the PREFILL phase: one unary POST to a prefill-role replica
        with ``parameters.kv_handoff``, yielding the first token and the
        exported-KV pull handle.  Returns the DECODE-phase body for the
        relay loop (``parameters.handoff``), or None — the degradation
        path — when no prefill replica is routable or the phase fails;
        the caller then relays the ORIGINAL body unified."""
        try:
            port = self._pick_backend(state, body=None, svc=svc,
                                      roles=("prefill",))
        except LookupError:
            disagg.PLACEMENTS.inc(role="unified")
            return None
        hop = root.child()
        hop_t0 = time.perf_counter()
        pbody = copy.deepcopy(plan["payload"])
        params = pbody.setdefault("parameters", {})
        if not isinstance(params, dict):
            params = pbody["parameters"] = {}
        params.pop("handoff", None)
        params["kv_handoff"] = True
        hdrs = dict(fwd_headers)
        hdrs[tracing.TRACEPARENT_HEADER] = hop.traceparent()
        hdrs["Content-Type"] = "application/json"

        def hop_span(outcome: str, error: Optional[str] = None) -> None:
            span = {"trace_id": root.trace_id, "span_id": hop.span_id,
                    "parent_id": hop.parent_id, "component": "ingress",
                    "name": "relay_attempt", "kind": "prefill",
                    "backend": port, "outcome": outcome,
                    "t_start_s": round(hop_t0 - t0, 6),
                    "duration_s": round(time.perf_counter() - hop_t0, 6)}
            if error is not None:
                span["error"] = error
            self.traces.put(root.trace_id, span)

        try:
            with transport.request(
                    "POST", port,
                    f"/v2/models/{plan['model']}/generate",
                    body=json.dumps(pbody).encode(), headers=hdrs,
                    timeout=relay_timeout) as r:
                rec = json.loads(r.read())
            ids = rec.get("token_ids")
            if (not isinstance(ids, list) or not ids
                    or not all(isinstance(i, int) for i in ids)):
                raise ValueError(f"prefill phase returned no tokens: {rec}")
        except urllib.error.HTTPError as e:
            # 4xx = the request itself is bad; let the unified relay
            # surface the same error to the client.  5xx = this replica is
            # sick; strike it and degrade.
            self._note_backend(state, port, e.code < 500)
            hop_span(f"status_{e.code}", f"HTTP {e.code}")
            disagg.PLACEMENTS.inc(role="unified")
            return None
        except Exception as e:  # noqa: BLE001 — connect error/stall/junk
            self._note_backend(state, port, False)
            hop_span("connect", str(e))
            disagg.PLACEMENTS.inc(role="unified")
            return None
        self._note_backend(state, port, True)
        hop_span("ok")
        disagg.PLACEMENTS.inc(role="prefill")
        if not rec.get("complete"):
            # a complete prefill phase (EOS on the only token) still runs
            # the decode-phase hop — its handler answers the degenerate
            # case with the right unary/SSE framing — but that hop pulls
            # nothing and places no decode work, so it is not a decode
            # PLACEMENT (the exporter already dropped the frame)
            disagg.PLACEMENTS.inc(role="decode")
        hand = rec.get("handoff") if isinstance(rec.get("handoff"), dict) \
            else {}
        dbody = copy.deepcopy(plan["payload"])
        params = dbody.setdefault("parameters", {})
        if not isinstance(params, dict):
            params = dbody["parameters"] = {}
        if params.get("deadline_s") is not None:
            # the deadline budget covers the WHOLE request: the decode
            # phase gets what the prefill phase left, not a fresh budget
            # (a tiny floor keeps the shed on the engine's typed 504 path
            # rather than a proxy-invented error)
            try:
                params["deadline_s"] = max(
                    0.001, float(params["deadline_s"])
                    - (time.perf_counter() - hop_t0))
            except (TypeError, ValueError):
                pass  # malformed deadline: the backend's 400 says so
        params["handoff"] = {"handle": hand.get("handle"),
                             "source_port": port,
                             "token_ids": [int(i) for i in ids],
                             # the client's TTFT/latency include the
                             # prefill phase — the decode replica folds
                             # these into its response so a split request
                             # reports honest end-to-end numbers
                             "phase_ttft_s": rec.get("ttft_s") or 0.0,
                             "phase_latency_s": rec.get("latency_s") or 0.0}
        return json.dumps(dbody).encode()

    # --------------------------------------- fleet observability endpoints

    _FANOUT_TIMEOUT_S = 0.5  # per-replica budget for trace/metrics fan-out

    def _service_pods(self, state: _ProxyState) -> list:
        """(name, port) of EVERY pod behind the service — all revisions,
        ready or not, draining included: a dying replica's server usually
        still answers, and its spans/flight dumps are exactly what a
        failover postmortem needs."""
        svc = self._get_service(state)
        if svc is None:
            return []
        selector = svc["spec"].get("selector") or {}
        out = []
        for p in self.api.list("Pod", namespace=state.namespace,
                               label_selector=selector):
            port = pod_port(p)
            if port is not None:
                out.append((p["metadata"]["name"], port))
        return sorted(out)

    def _fan_out(self, pods: list, path: str) -> dict:
        """Concurrently GET ``path`` from every replica; {name: (body or
        None, latency_s)}.  One slow replica costs the fan-out timeout
        once, not once per replica — and its latency is REPORTED: the
        fleet-metrics header carries per-replica scrape latency, so a
        slow-but-alive replica is visible before it trips the health
        FSM."""
        results: dict = {}

        def fetch(name: str, port: int) -> None:
            t0 = time.perf_counter()
            try:
                # pooled keepalive scrape: fleet fan-outs ride the same
                # persistent sockets as relay attempts
                body = transport.get(port, path,
                                     timeout=self._FANOUT_TIMEOUT_S)
            except Exception:  # noqa: BLE001 — unreachable replica
                body = None
            results[name] = (body, time.perf_counter() - t0)

        ts = [threading.Thread(target=fetch, args=(n, p)) for n, p in pods]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        return results

    def _collect_trace(self, state: _ProxyState, trace_id: str) -> tuple:
        """One assembled distributed trace: this proxy's relay hop spans
        plus every replica's engine spans (GET /engine/trace/<id>
        fan-out), deduped on (trace_id, span_id) and ordered by
        skew-adjusted start time — a failover request's two engine spans
        read in causal order, not scrape order.  Returns ``(spans,
        dumps, pods, unreachable)``."""
        spans = [dict(s) for s in self.traces.get(trace_id)]
        dumps: list = []
        pods = self._service_pods(state)
        unreachable: list = []
        for name, (raw, _lat) in sorted(self._fan_out(
                pods, f"/engine/trace/{trace_id}").items()):
            if raw is None:
                unreachable.append(name)
                continue
            try:
                rec = json.loads(raw)
            except ValueError:
                unreachable.append(name)
                continue
            for s in rec.get("spans") or ():
                s = dict(s)
                s["replica"] = name
                spans.append(s)
            for p in rec.get("flight_dumps") or ():
                dumps.append({"replica": name, "path": p})
        spans = waterfall_mod.order_spans(waterfall_mod.dedupe_spans(spans))
        return spans, dumps, pods, unreachable

    def _serve_trace(self, handler, state: _ProxyState,
                     trace_id: str) -> None:
        """GET /debug/trace/<id> (alias /fleet/trace/<id>): the assembled
        end-to-end trace, nested into the hop tree, with the
        flight-recorder dumps any replica recorded for this trace."""
        trace_id = trace_id.strip().lower()
        spans, dumps, pods, unreachable = self._collect_trace(
            state, trace_id)
        body = {"trace_id": trace_id, "spans": spans,
                "tree": tracing.build_tree(spans),
                "flight_dumps": dumps,
                "replicas_queried": [n for n, _ in pods],
                "replicas_unreachable": unreachable}
        handler._reply(200 if spans else 404, json.dumps(body).encode())

    def _serve_fleet_waterfall(self, handler, state: _ProxyState,
                               trace_id: str) -> None:
        """GET /fleet/trace/<id>/waterfall: the trace assembled into one
        end-to-end latency waterfall on the ingress clock (README
        "Latency attribution") — parse/admission/placement, failed hops
        as failover + retry_gap, each successful hop's engine partition
        placed via the per-backend clock-offset estimate.  404 when the
        trace is unknown or has no ingress root span to anchor a wall."""
        trace_id = trace_id.strip().lower()
        spans, _dumps, pods, unreachable = self._collect_trace(
            state, trace_id)
        wf = waterfall_mod.build_fleet_waterfall(
            {"trace_id": trace_id, "spans": spans}) if spans else None
        if wf is None:
            handler._reply(404, json.dumps(
                {"error": "no ingress root span for trace",
                 "trace_id": trace_id}).encode())
            return
        wf["replicas_queried"] = [n for n, _ in pods]
        wf["replicas_unreachable"] = unreachable
        handler._reply(200, json.dumps(wf).encode())

    def _serve_fleet_metrics(self, handler, state: _ProxyState) -> None:
        """GET /fleet/metrics: every replica's /metrics merged into one
        exposition — counters and histograms sum across replicas
        (bucket-exact), gauges keep a ``replica`` label
        (core.metrics.merge_expositions)."""
        pods = self._service_pods(state)
        texts: dict = {}
        unreachable: list = []
        lat: dict = {}
        for name, (raw, elapsed) in self._fan_out(pods, "/metrics").items():
            lat[name] = elapsed
            if raw is None:
                unreachable.append(name)
            else:
                texts[name] = raw.decode(errors="replace")
        header = (f"# fleet/metrics: {len(texts)}/{len(pods)} replicas "
                  f"of {state.service_name} merged")
        if unreachable:
            header += f"; unreachable: {','.join(sorted(unreachable))}"
        if lat:
            # per-replica scrape latency: a SLOW (not dead) replica shows
            # up here long before it trips the health FSM — unreachable
            # names report the timeout they burned
            header += "\n# scrape_seconds: " + ",".join(
                f"{n}={lat[n]:.4f}" for n in sorted(lat))
        body = header + "\n" + merge_expositions(texts)
        handler._reply(200, body.encode(),
                       "text/plain; version=0.0.4")

    def _collect_cache_view(self, state: _ProxyState) -> tuple:
        """One fleet cache-view refresh: fan out every replica's slim
        ``GET /engine/perf?view=cache`` (the full snapshot carries
        timeline tails and profiler histories the placer never reads),
        fold the results into ``state.cache_view``, prune pod churn, and
        return ``(snapshot, pods, unreachable)``.  A replica that fails
        this refresh keeps serving its LAST-KNOWN view annotated with
        its age — a momentary scrape miss must not make a warm replica
        look cold to the cache-aware placer."""
        pods = self._service_pods(state)
        live = {n for n, _ in pods}
        ports = dict(pods)
        now = time.time()
        unreachable: list = []
        fresh: dict = {}
        for name, (raw, elapsed) in self._fan_out(
                pods, "/engine/perf?view=cache").items():
            rec = None
            if raw is not None:
                try:
                    body = json.loads(raw)
                    models = body.get("models") or {}
                    rec = {"fetched_at": now, "scrape_s": round(elapsed, 4),
                           "port": ports.get(name),
                           "models": {
                               mn: {"cache": ms.get("cache") or {},
                                    "mfu": ms.get("mfu"),
                                    "goodput_ratio": ms.get("goodput_ratio"),
                                    "platform": ms.get("platform")}
                               for mn, ms in models.items()}}
                except ValueError:
                    rec = None
            if rec is not None:
                fresh[name] = rec
            else:
                unreachable.append(name)
        out = {}
        with state.lock:  # cache_view is shared proxy state, like health
            state.cache_view.update(fresh)
            # pod-churn pruning: a deleted/recreated replica must not
            # haunt the view as phantom cache capacity
            for name in list(state.cache_view):
                if name not in live:
                    del state.cache_view[name]
            for name, rec in sorted(state.cache_view.items()):
                out[name] = {**rec,
                             "age_s": round(now - rec["fetched_at"], 3),
                             "stale": name in unreachable}
        return out, pods, unreachable

    # how long a cache-view snapshot places requests before a background
    # refresh is kicked off; staleness past the TTL is TOLERATED (the
    # last-known view keeps placing) — a wrong placement costs one
    # degraded pull, never correctness
    _FABRIC_VIEW_TTL_S = 1.0
    # load slack a deepest-prefix owner may carry over the least-loaded
    # replica and still win the pick (same shape as _AFFINITY_SLACK but
    # wider: a fabric hit saves whole prefill pages, not a maybe-warm
    # device cache)
    _FABRIC_SLACK = 2.0

    def _maybe_refresh_cache_view(self, state: _ProxyState) -> None:
        """Kick a BACKGROUND cache-view refresh when the TTL lapsed —
        single-flight, never blocking the pick that noticed (the fan-out
        costs up to _FANOUT_TIMEOUT_S against a sick replica, which is
        relay-path poison; the placement meanwhile uses the last-known
        view, exactly the staleness tolerance the degradation contract
        pays for)."""
        with state.lock:
            now = time.monotonic()
            if (state.cache_refreshing
                    or now - state.cache_view_at < self._FABRIC_VIEW_TTL_S):
                return
            state.cache_refreshing = True  # graftlint: acquires=view-refresh

        def refresh() -> None:
            try:
                self._collect_cache_view(state)
            except Exception:  # noqa: BLE001 — a refresh must not wedge
                pass
            finally:
                with state.lock:
                    state.cache_view_at = time.monotonic()
                    state.cache_refreshing = False  # graftlint: releases=view-refresh

        threading.Thread(target=refresh, daemon=True).start()

    def _serve_fleet_cache(self, handler, state: _ProxyState) -> None:
        """GET /fleet/cache: the read-only per-replica fleet cache view
        (README "Fleet KV fabric") — every replica's prefix-cache
        analytics (hit/miss by reason, page occupancy, fragmentation,
        per-prefix reuse WITH page counts) and its published fabric
        prefixes, plus the MFU/goodput headline.  The same snapshot the
        router's cache-aware placement scores; polling this endpoint
        refreshes it synchronously."""
        out, pods, unreachable = self._collect_cache_view(state)
        with state.lock:
            state.cache_view_at = time.monotonic()
        handler._reply(200, json.dumps({
            "service": state.service_name,
            "replicas": out,
            "replicas_queried": [n for n, _ in pods],
            "replicas_unreachable": sorted(unreachable),
        }).encode())

    # ------------------------------------------- fleet latency endpoint
    # (README "Latency attribution"): per-SLO-class TTFT budget
    # breakdowns merged from every replica's GET /engine/latency — raw
    # budget samples merge exactly where per-replica quantiles would
    # not.  Same staleness-tolerant TTL'd single-flight background
    # refresh as the cache view: a poll serves the last-known view and
    # kicks the refresh, never blocking on a fan-out against a sick
    # replica.

    _LATENCY_VIEW_TTL_S = _FABRIC_VIEW_TTL_S

    def _collect_latency_view(self, state: _ProxyState) -> dict:
        """One fleet latency-view refresh: fan out every replica's
        ``GET /engine/latency``, merge the per-class budget samples, and
        fold the computed class budgets into ``state.latency_view``."""
        pods = self._service_pods(state)
        unreachable: list = []
        payloads: list = []
        for name, (raw, _lat) in sorted(self._fan_out(
                pods, "/engine/latency").items()):
            if raw is None:
                unreachable.append(name)
                continue
            try:
                body = json.loads(raw)
            except ValueError:
                unreachable.append(name)
                continue
            for rec in (body.get("models") or {}).values():
                if isinstance(rec, dict):
                    payloads.append(rec)
        samples = waterfall_mod.merge_budget_samples(payloads)
        view = {"service": state.service_name,
                "classes": waterfall_mod.class_budgets(samples),
                "replicas_queried": [n for n, _ in pods],
                "replicas_unreachable": sorted(unreachable)}
        with state.lock:  # latency_view is shared proxy state
            state.latency_view = view
            state.latency_view_at = time.monotonic()
        return view

    def _maybe_refresh_latency_view(self, state: _ProxyState) -> None:
        """Kick a BACKGROUND latency-view refresh when the TTL lapsed —
        single-flight, never blocking the poll that noticed (same
        discipline as _maybe_refresh_cache_view)."""
        with state.lock:
            now = time.monotonic()
            if (state.latency_refreshing
                    or now - state.latency_view_at
                    < self._LATENCY_VIEW_TTL_S):
                return
            state.latency_refreshing = True  # graftlint: acquires=latency-refresh

        def refresh() -> None:
            try:
                self._collect_latency_view(state)
            except Exception:  # noqa: BLE001 — a refresh must not wedge
                pass
            finally:
                with state.lock:
                    state.latency_view_at = time.monotonic()
                    state.latency_refreshing = False  # graftlint: releases=latency-refresh

        threading.Thread(target=refresh, daemon=True).start()

    def _serve_fleet_latency(self, handler, state: _ProxyState) -> None:
        """GET /fleet/latency: per-SLO-class p50/p95 TTFT budget
        breakdowns (what fraction of interactive p95 TTFT is queue vs
        prefill vs pull), plus the cross-check of the overload deadline
        estimator's per-class queue+TTFT p50 against the
        waterfall-derived figure — two independent measurements of the
        same quantity; a gap is a calibration bug in one of them."""
        with state.lock:
            view = dict(state.latency_view)
        if not view:
            # first poll: there is no last-known view to tolerate
            # staleness with — collect synchronously once
            view = self._collect_latency_view(state)
        else:
            self._maybe_refresh_latency_view(state)
        ov = self._overload_for(state, self._get_service(state))
        if ov is not None:
            try:
                deadline = (ov.snapshot() or {}).get("deadline_p50") or {}
            except Exception:  # noqa: BLE001 — a debug read must answer
                deadline = {}
            cross = {}
            for cls, budget in (view.get("classes") or {}).items():
                o = deadline.get(cls)
                w = budget.get("ttft_p50_s")
                if isinstance(o, (int, float)):
                    cross[cls] = {
                        "overload_p50_s": round(float(o), 6),
                        "waterfall_p50_s": w,
                        "delta_s": (round(float(o) - w, 6)
                                    if isinstance(w, (int, float))
                                    else None)}
            if cross:
                view = {**view, "deadline_crosscheck": cross}
        handler._reply(200, json.dumps(view).encode())

    # ------------------------------------------- fleet incident endpoints
    # (README "Incident plane"): the proxy's own ingress-scope incidents
    # merged with every replica's GET /engine/incidents — the same
    # fan-out-and-merge shape as /fleet/metrics.  Two replicas reporting
    # the same fault (both ends of one failover) dedupe on shared trace
    # evidence, so a fleet-wide fault reads as ONE incident with every
    # origin listed, not an alert per replica.

    def _collect_fleet_incidents(self, state: _ProxyState) -> tuple:
        """(merged incident list, pods, unreachable) across the proxy's
        own manager and every replica's /engine/incidents."""
        entries = []
        if state.incidents is not None:
            for inc in state.incidents.list():
                entries.append(("ingress", inc))
        pods = self._service_pods(state)
        unreachable: list = []
        for name, (raw, _lat) in sorted(self._fan_out(
                pods, "/engine/incidents").items()):
            if raw is None:
                unreachable.append(name)
                continue
            try:
                body = json.loads(raw)
            except ValueError:
                unreachable.append(name)
                continue
            for inc in body.get("incidents") or ():
                entries.append((name, inc))
        merged = incidents_mod.merge_fleet_incidents(entries)
        return merged, pods, unreachable

    def _serve_fleet_incidents(self, handler, state: _ProxyState) -> None:
        """GET /fleet/incidents: the fleet-wide classified incident list,
        open first, newest last — ingress incidents (failover bursts,
        breaker opens, autoscaler flap) next to every replica's engine
        incidents, deduped on shared trace evidence."""
        merged, pods, unreachable = self._collect_fleet_incidents(state)
        merged.sort(key=lambda i: (i.get("state") != "open",
                                   i.get("opened_wall") or 0.0))
        handler._reply(200, json.dumps({
            "service": state.service_name,
            "incidents": merged,
            "open": sum(1 for i in merged if i.get("state") == "open"),
            "replicas_queried": [n for n, _ in pods],
            "replicas_unreachable": sorted(unreachable),
        }, default=str).encode())

    def _serve_fleet_incident(self, handler, state: _ProxyState,
                              incident_id: str) -> None:
        """GET /fleet/incidents/<id>: one incident's postmortem as the
        responder's timeline (detector firing -> evidence refs ->
        classification -> resolution), found on whichever component
        holds it; merged ids resolve to their merged entry."""
        merged, _pods, unreachable = self._collect_fleet_incidents(state)
        found = next(
            (m for m in merged
             if m.get("id") == incident_id
             or incident_id in (m.get("merged_ids") or ())), None)
        if found is None:
            handler._reply(404, json.dumps(
                {"error": "unknown incident id",
                 "replicas_unreachable": sorted(unreachable)}).encode())
            return
        handler._reply(200, json.dumps({
            "incident": found,
            "timeline": incidents_mod.timeline(found),
        }, default=str).encode())

    def _serve_fleet_remediation(self, handler, state: _ProxyState) -> None:
        """GET /fleet/remediation: the self-driving fleet's action log —
        every playbook decision (dry-run included), quarantine state,
        escalations, and the autoscaler floor proposals currently in
        flight (README "Self-driving fleet")."""
        rem = self.remediator
        if rem is None:
            handler._reply(404, json.dumps(
                {"error": "no remediator attached"}).encode())
            return
        body = rem.status()
        asc = getattr(rem, "autoscaler", None)
        if asc is not None and hasattr(asc, "proposals"):
            body["proposals"] = asc.proposals()
        handler._reply(200, json.dumps(body, default=str).encode())

    # ------------------------------------- global cache-aware placement
    # (README "Fleet KV fabric"): the fleet-scope replacement for the
    # per-replica prefix-affinity LRU.  Every request's prompt is reduced
    # to the kvfabric text fingerprint ladder; replicas advertise the
    # fingerprints of their published prefixes through the cache view;
    # the pick routes to the deepest-matched owner (load-balanced
    # tiebreak) — and when load or stickiness places the request
    # ELSEWHERE, the relay injects a ``parameters.fabric`` pull hint so
    # the chosen replica faults the prefix in from the owner instead of
    # re-prefilling it.

    def _plan_fabric(self, state: _ProxyState, handler,
                     payload) -> Optional[dict]:
        """Score the fleet's published prefixes against this request ->
        ``{"owners": {port: (depth_chars, key, pages)}}`` or None when
        nothing matches (or the request is no placement candidate: not a
        generate path, already a disagg phase, or carrying its own
        fabric hint)."""
        if handler.command != "POST" or not isinstance(payload, dict):
            return None
        q = self.quarantine
        if q is not None and q.active("fabric"):
            # fabric tier quarantined (README "Self-driving fleet"):
            # no remote-prefix placement, no pull hints — every request
            # serves degraded-local until the health probe lifts it
            return None
        if not disagg.eligible_path(handler.path):
            return None
        params = payload.get("parameters")
        params = params if isinstance(params, dict) else {}
        if (params.get("kv_handoff") or params.get("handoff") is not None
                or params.get("fabric") is not None):
            return None
        text = self._payload_text(payload)
        if not text:
            return None
        fps = kvfabric.fingerprints(text)
        if not fps:
            return None
        self._maybe_refresh_cache_view(state)
        with state.lock:
            view = dict(state.cache_view)
        owners: dict = {}
        for rec in view.values():
            port = rec.get("port")
            if port is None:
                continue
            for ms in (rec.get("models") or {}).values():
                for ent in (ms.get("cache") or {}).get("fabric") or ():
                    d = kvfabric.match_depth(fps, ent.get("fps") or ())
                    if d <= 0:
                        continue
                    cur = owners.get(port)
                    pages = int(ent.get("pages") or 0)
                    # per port keep the deepest match; page count breaks
                    # ties (bytes saved, the satellite the reuse counters
                    # grew page counts for)
                    if cur is None or (d, pages) > (cur[0], cur[2]):
                        owners[port] = (d, str(ent.get("key")), pages)
        return {"owners": owners} if owners else None

    def _fabric_hint(self, plan: dict, backend: int,
                     remap_from: Optional[int]) -> Optional[dict]:
        """The ``parameters.fabric`` pull hint for a request placed on
        ``backend``: pull from the deepest owner that beats whatever
        ``backend`` itself holds (None when backend IS the deepest —
        nothing to pull).  A sticky-session failover remap prefers the
        replica the session was remapped FROM: that is where the pinned
        prefix actually lives, even when the view's fingerprint match
        for it is shallower or stale."""
        owners = plan["owners"]
        own_depth = owners.get(backend, (0, "", 0))[0]
        cand = {p: v for p, v in owners.items()
                if p != backend and v[0] > own_depth}
        if not cand:
            return None
        src = remap_from if remap_from in cand else max(
            cand, key=lambda p: (cand[p][0], cand[p][2], -p))
        depth, key, pages = cand[src]
        return {"key": key, "source_port": src, "pages": pages}

    @staticmethod
    def _inject_fabric(payload: dict, hint: dict) -> bytes:
        """Rewrite the request body with the pull hint (the relay's one
        parsed copy stays untouched — retries against a different
        backend re-inject their own hint)."""
        p = copy.deepcopy(payload)
        params = p.setdefault("parameters", {})
        if not isinstance(params, dict):
            params = p["parameters"] = {}
        params["fabric"] = dict(hint)
        return json.dumps(p).encode()

    # --------------------------------------------------- backend health FSM

    _HEALTH_TTL = 0.5        # active probe cadence per backend
    _PROBE_TIMEOUT_S = 0.25
    _FAIL_THRESHOLD = 3      # consecutive failures: suspect -> ejected
    _EJECT_BASE_S = 1.0      # first ejection duration; doubles per round
    _EJECT_MAX_S = 30.0

    def _note_backend(self, state: _ProxyState, port: int, ok: bool) -> None:
        """Passive failure detection: every relay outcome feeds the backend
        state machine.  Success heals (and closes the breaker); consecutive
        failures walk healthy → suspect → ejected; a probation failure
        re-ejects with doubled backoff."""
        with state.lock:
            h = state.health.setdefault(port, _BackendHealth())
            if ok:
                # a completing IN-FLIGHT relay must not resurrect a
                # draining backend (its orderly goodbye stands; only a
                # probe seeing SERVING again — drain cancelled — heals it)
                if h.state != "draining":
                    h.state = "healthy"
                h.fails = 0
                h.ejections = 0
            else:
                h.fails += 1
                if h.state == "probation" or h.fails >= self._FAIL_THRESHOLD:
                    self._eject(state, h, port)
                elif h.state == "healthy":
                    h.state = "suspect"
            self._set_state_gauge(state)

    def _eject(self, state: _ProxyState, h: _BackendHealth,
               port: Optional[int] = None) -> None:
        """Open the breaker (caller holds state.lock): route nothing to this
        backend until the backoff lapses, then probation."""
        h.state = "ejected"
        h.until = time.monotonic() + min(
            self._EJECT_MAX_S, self._EJECT_BASE_S * (2.0 ** h.ejections))
        h.ejections += 1
        h.fails = 0
        INGRESS_EJECTIONS.inc(service=state.service_name)
        if state.incidents is not None:
            # breaker-open incident signal (README "Incident plane"):
            # feed() is an O(1) append, safe under state.lock
            state.incidents.feed("breaker_open",
                                 service=state.service_name,
                                 backend=port, trace_ids=[])

    def _set_state_gauge(self, state: _ProxyState) -> None:  # graftlint: holds-lock=lock
        counts = {s: 0 for s in _BACKEND_STATES}
        now = time.time()
        for port, h in state.health.items():
            counts[h.state] = counts.get(h.state, 0) + 1
            # health-FSM transition log (README "Incident plane"): every
            # transition batch already funnels through this gauge refresh
            # (caller holds state.lock), so diffing here records the log
            # without touching any individual transition site
            prev = state.health_last.get(port)
            if prev != h.state:
                state.health_last[port] = h.state
                state.health_log.append(
                    {"wall": round(now, 3), "backend": port,
                     "from": prev, "to": h.state})
        for port in [p for p in state.health_last if p not in state.health]:
            del state.health_last[port]
        for s, n in counts.items():
            INGRESS_BACKEND_STATE.set(n, service=state.service_name, state=s)

    def _probe_engine_health(self, port: int) -> str:
        """One active probe: 'ok' | 'draining' | 'dead' | 'fail'.  Backends
        without the route (non-engine runtimes) count as ok — readiness
        probes already cover them."""
        try:
            with transport.request("GET", port, "/engine/health",
                                   timeout=self._PROBE_TIMEOUT_S) as r:
                payload = json.loads(r.read())
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return "ok"
            try:
                payload = json.loads(e.read())
            except Exception:  # noqa: BLE001
                return "fail"
        except Exception:  # noqa: BLE001 — connect error / stall
            return "fail"
        st = (payload or {}).get("state", "SERVING")
        if st in ("SERVING", "DEGRADED"):
            return "ok"  # DEGRADED still serves; passive detection decides
        if st == "DRAINING":
            return "draining"
        return "dead"

    def _refresh_health(self, state: _ProxyState, ports: list[int]) -> None:
        """Active probing with the same single-flight-outside-the-lock
        discipline as the load scrape: claim expired ports, probe unlocked,
        write transitions back."""
        claimed = []
        with state.lock:
            now = time.monotonic()
            for p in ports:
                h = state.health.setdefault(p, _BackendHealth())
                if (now - h.probed_at >= self._HEALTH_TTL
                        and p not in state.probing):
                    state.probing.add(p)  # graftlint: acquires=probe-claim
                    claimed.append(p)
        if not claimed:
            return
        results: dict[int, str] = {}
        try:
            if len(claimed) == 1:
                results[claimed[0]] = self._probe_engine_health(claimed[0])
            else:
                # probe independently-failing backends concurrently: serial
                # probing would charge the one claiming request up to
                # N x _PROBE_TIMEOUT_S of latency before its relay starts
                def probe(p=None):
                    results[p] = self._probe_engine_health(p)

                ts = [threading.Thread(target=probe, kwargs={"p": p})
                      for p in claimed]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join()
        finally:
            # claimed ports MUST leave `probing` even if a probe (or a
            # thread spawn) throws — a port stranded in the claim set is
            # never probed again, freezing its health record forever
            # (found by graftlint release-guarantee).  Release and
            # write-back share ONE locked block: dropping the lock
            # between them would let another request re-claim and
            # re-probe a port whose probed_at was still unwritten.
            with state.lock:
                now = time.monotonic()
                for p in claimed:
                    state.probing.discard(p)  # graftlint: releases=probe-claim
                    h = state.health.setdefault(p, _BackendHealth())
                    h.probed_at = now
                    if p not in results:
                        continue  # probe never ran: retried next TTL
                    res = results[p]
                    if res == "ok":
                        # a passing probe confirms the ENGINE is alive; it
                        # does not erase passive strikes (a backend can
                        # report SERVING while 500ing requests) and never
                        # reopens a live breaker — ejection timing is the
                        # breaker's.  It heals probation (the half-open
                        # trial) and undoes a drain that was cancelled.
                        if h.state == "probation":
                            h.state = "healthy"
                            h.fails = 0
                            h.ejections = 0
                        elif h.state == "draining":
                            h.state = "healthy"
                    elif res == "draining":
                        # drain is an orderly goodbye, not a failure: stop
                        # routing but charge no breaker strikes
                        h.state = "draining"
                        h.fails = 0
                    elif res == "dead":
                        # a DEAD engine needs no three strikes
                        if h.state != "ejected":
                            self._eject(state, h, p)
                    else:  # "fail": passive-style strike
                        h.fails += 1
                        if (h.state == "probation"
                                or h.fails >= self._FAIL_THRESHOLD):
                            self._eject(state, h, p)
                        elif h.state == "healthy":
                            h.state = "suspect"
                self._set_state_gauge(state)

    def _prune_health(self, state: _ProxyState, ports: list[int],
                      selector: dict) -> None:
        """Drop health records for backends that no longer exist: pod churn
        (rollouts, scale cycles) allocates fresh ports, and keeping the old
        records would leak one _BackendHealth per port ever seen AND freeze
        their last state into the ingress_backend_state gauge (phantom
        'ejected' backends on dashboards).  The keep-set is EVERY pod of
        the service — all revisions, ready or not, draining included — so
        a canary request cannot wipe the stable revision's breaker state;
        records mid-probe are left for the probe writeback to finish."""
        with state.lock:
            if len(state.health) <= len(ports):
                return  # quick out: nothing can be stale
        keep = {pod_port(p)
                for p in self.api.list("Pod", namespace=state.namespace,
                                       label_selector=selector)}
        keep.discard(None)
        with state.lock:
            for p in list(state.health):
                if p not in keep and p not in state.probing:
                    del state.health[p]
            # session stickiness follows the same churn rule: a mapping
            # whose replica is gone would pin every future turn of that
            # session to a dead port (the pick would ignore it, but the
            # entry would still hold LRU budget forever)
            for sid in [s for s, p in state.sessions.items()
                        if p not in keep]:
                del state.sessions[sid]
            self._set_state_gauge(state)

    def _routable_ports(self, state: _ProxyState, ports: list[int]) -> list[int]:
        """Ports the state machine allows traffic to: healthy/suspect first;
        probation backends only as the fallback set (their next request is
        the breaker's half-open trial); ejected and draining never."""
        with state.lock:
            now = time.monotonic()
            primary, fallback = [], []
            for p in ports:
                h = state.health.get(p)
                if h is None:
                    primary.append(p)
                    continue
                if h.state == "ejected" and now >= h.until:
                    h.state = "probation"
                if h.state in ("healthy", "suspect"):
                    primary.append(p)
                elif h.state == "probation":
                    fallback.append(p)
            self._set_state_gauge(state)
        return primary or fallback

    # ----------------------------------------------------------- backend pick

    def _pick_backend(self, state: _ProxyState, body: Optional[bytes] = None,
                      exclude: frozenset = frozenset(),
                      svc: Optional[Obj] = None,
                      roles: Optional[tuple] = None,
                      session: Optional[str] = None,
                      fabric: Optional[dict] = None,
                      note: Optional[dict] = None) -> int:
        # the caller's relay loop passes the Service it already fetched;
        # a sub-second-stale object is fine here (annotations and selector
        # churn far slower than requests)
        if svc is None:
            svc = self._get_service(state)
        if svc is None:
            raise LookupError(f"service {state.service_name} gone")
        ann = svc["metadata"].get("annotations", {})
        traffic: dict[str, int] = json.loads(ann.get(TRAFFIC_ANNOTATION, "{}"))
        selector = svc["spec"].get("selector") or {}

        revision = self._pick_revision(state, traffic)
        pods = self._ready_pods(state.namespace, selector, revision)
        if not pods:
            self._activate(svc)
            deadline = time.monotonic() + ACTIVATION_TIMEOUT
            while time.monotonic() < deadline:
                pods = self._ready_pods(state.namespace, selector, revision)
                if pods:
                    break
                time.sleep(0.05)
            if not pods:
                raise LookupError(f"no ready backend for {state.service_name} (rev={revision})")
        all_ports = [pod_port(p) for p in pods]
        ports = all_ports
        if roles:
            # disaggregation role filter (README "Disaggregated serving"):
            # restrict to replicas declaring one of ``roles`` — with a
            # fall-back to the full set when none match, because a
            # degraded placement beats a failed request (a fleet of only
            # prefill replicas still serves decode traffic)
            rp = [pod_port(p) for p in pods if disagg.pod_role(p) in roles]
            if rp:
                ports = rp
        self._prune_health(state, all_ports, selector)
        self._refresh_health(state, ports)
        routable = self._routable_ports(state, ports)
        if not routable and ports is not all_ports:
            # the whole preferred-role pool is ejected/draining: the same
            # degraded-placement-beats-failed-request rule applies to
            # HEALTH as to role absence — fail over to the off-role
            # replicas rather than 503ing while healthy capacity exists
            self._refresh_health(state, all_ports)
            routable = self._routable_ports(state, all_ports)
        if not routable:
            # the empty-healthy-set fail-fast path: every backend is
            # ejected (breaker open) or draining — a 503 NOW beats a
            # doomed relay attempt against a known-bad replica
            raise LookupError(
                f"no healthy backend for {state.service_name}: "
                f"{len(all_ports)} ready but all ejected/draining")
        cand = [p for p in routable if p not in exclude] or routable
        picked = None
        if session is not None:
            # sticky session routing: the replica that pinned this
            # session's KV serves its next turn — but only while it is
            # still routable and not excluded (a failover MUST move; the
            # new replica pins the turn and the mapping follows below)
            with state.lock:
                sp = state.sessions.get(session)
            if sp in cand:
                picked = sp
            elif sp is not None and note is not None:
                # the session REMAPS: record the replica it leaves behind
                # so the relay can route the remap through the KV fabric
                # (the pinned prefix lives THERE — a pull beats restoring
                # cold, and a dead old replica just degrades the pull)
                note["session_remap_from"] = sp
        if picked is None and len(cand) > 1:
            picked = self._pick_engine_aware(state, cand, body,
                                             fabric=fabric, note=note)
        if picked is None:
            state.rr += 1
            picked = cand[state.rr % len(cand)]
        if session is not None:
            with state.lock:
                # pop-then-insert keeps live sessions at the LRU tail
                state.sessions.pop(session, None)
                state.sessions[session] = picked
                while len(state.sessions) > self._SESSION_CAP:
                    state.sessions.pop(next(iter(state.sessions)))
        return picked

    # engine-aware pick (SURVEY.md §3.4 production QPS; VERDICT r2 #7): with
    # several engine replicas behind one Service, round-robin ignores that
    # decode requests have wildly different costs.  Scrape each replica's
    # engine gauges (short TTL), score load = queue_depth + active_slots (+
    # picks routed since the scrape), and send the request to the least
    # loaded — except when the request's prompt prefix was already routed
    # somewhere (so its KV pages are plausibly cached there) and that
    # replica is within one request of the minimum: the shared-prefix KV
    # cache beats perfect balance, but never-seen prompts always go
    # least-loaded.
    _LOAD_TTL = 0.25
    _ENGINELESS_TTL = 2.0
    _AFFINITY_SLACK = 1.0
    _AFFINITY_CAP = 1024  # prefix->port entries kept per proxy (LRU)
    _SESSION_CAP = 2048   # session->port stickiness entries (LRU)

    def _pick_engine_aware(self, state: _ProxyState, ports: list[int],
                           body: Optional[bytes],
                           fabric: Optional[dict] = None,
                           note: Optional[dict] = None) -> Optional[int]:
        from .autoscaler import scrape_metrics

        # Scrapes are blocking HTTP calls, so they must happen OUTSIDE the
        # state lock — with one replica unresponsive (mid-compile), a scrape
        # under the lock would stall every concurrent handler thread behind
        # it.  Single-flight per port: a thread claims expired ports via
        # state.refreshing, scrapes them unlocked, and writes results back;
        # other threads use the last-known load (even if past TTL) instead
        # of waiting.  Replicas whose scrape fails are excluded for this
        # pick (overloaded — exactly who shouldn't get the request); a
        # replica set with no engine gauges at all falls back to round-robin.
        claimed: dict[int, int] = {}  # port -> pending count at claim time
        with state.lock:
            now = time.monotonic()
            if now < state.engineless_until:
                return None  # known non-engine backends: plain round-robin
            for port in ports:
                ts_load = state.loads.get(port)
                if ((ts_load is None or now - ts_load[0] >= self._LOAD_TTL)
                        and port not in state.refreshing):
                    state.refreshing.add(port)  # graftlint: acquires=load-claim
                    claimed[port] = state.pending.get(port, 0)
        scraped: dict[int, Optional[dict]] = {}
        engineless = False
        try:
            for port in claimed:
                scraped[port] = scrape_metrics(port, timeout=0.1)
        finally:
            # claimed ports MUST leave `refreshing` even on an unexpected
            # scrape exception, or they would never be scraped again
            with state.lock:
                now = time.monotonic()
                for port in claimed:
                    state.refreshing.discard(port)  # graftlint: releases=load-claim
                    m = scraped.get(port)
                    if m is None:
                        # negative cache: unreachable replicas are excluded
                        # from picks but NOT re-scraped until the TTL lapses
                        state.loads[port] = (now, None)
                        continue
                    if "engine_queue_depth" not in m:
                        engineless = True
                        continue
                    load = (m["engine_queue_depth"]
                            + m.get("engine_active_slots", 0.0))
                    state.loads[port] = (now, load)
                    if state.overload is not None:
                        # worst-replica SLO burn feed for the overload
                        # controller's AIMD signal: the scrape this pick
                        # already paid for carries the SloTracker's
                        # exported slo_burn_rate series — no extra fan-out
                        burns = [v for k, v in m.items()
                                 if k.startswith("slo_burn_rate{")]
                        if burns:
                            state.overload.note_burn(port, max(burns), now)
                    # subtract the snapshot, don't zero: picks that landed on
                    # this port WHILE the scrape ran are in neither the
                    # scraped gauges nor (after a reset) pending — zeroing
                    # would undercount the burst and pile more onto it
                    state.pending[port] = max(
                        0, state.pending.get(port, 0) - claimed[port])
                if engineless:
                    state.engineless_until = now + self._ENGINELESS_TTL
        if engineless:
            return None  # round-robin fallback
        prefix = self._prompt_prefix(body)
        with state.lock:
            loads = {p: state.loads[p][1] + state.pending.get(p, 0)
                     for p in ports
                     if p in state.loads and state.loads[p][1] is not None}
            if not loads:
                return None
            best = min(loads, key=lambda p: (loads[p], p))
            if fabric is not None:
                # GLOBAL cache-aware placement (README "Fleet KV fabric"):
                # deepest-matched published prefix wins, load-balanced
                # tiebreak — the fleet-scope replacement for the affinity
                # LRU below, which only remembers where THIS proxy routed.
                # An overloaded owner (past the slack) loses the pick; the
                # relay then injects a pull hint instead, so the prefix
                # still arrives warm.
                routable_owners = {p: v for p, v in fabric["owners"].items()
                                   if p in loads}
                if routable_owners:
                    maxd = max(d for d, _, _ in routable_owners.values())
                    deepest = [p for p, (d, _, _) in routable_owners.items()
                               if d == maxd]
                    owner = min(deepest, key=lambda p: (loads[p], p))
                    if loads[owner] <= loads[best] + self._FABRIC_SLACK:
                        if note is not None:
                            note["fabric_pick"] = owner
                        state.pending[owner] = \
                            state.pending.get(owner, 0) + 1
                        return owner
                state.pending[best] = state.pending.get(best, 0) + 1
                return best
            # sticky-prefix affinity: ONLY for a prefix this proxy has
            # routed before (its KV pages are plausibly cached there), and
            # only while that replica is within slack of the least loaded
            if prefix is not None:
                seen = state.affinity.get(prefix)
                if (seen in loads
                        and loads[seen] <= loads[best] + self._AFFINITY_SLACK):
                    best = seen
                # the mapping moves ONLY when the seen replica is gone from
                # the ready set — an overload detour or a momentarily
                # unscrapable replica (mid-compile blip) does not relocate
                # the prefix's cached KV, so it must not relocate the
                # mapping either; re-insertion keeps hot prefixes at the
                # LRU tail even across detours
                target = seen if seen in ports else best
                state.affinity.pop(prefix, None)
                state.affinity[prefix] = target
                while len(state.affinity) > self._AFFINITY_CAP:
                    state.affinity.pop(next(iter(state.affinity)))
            state.pending[best] = state.pending.get(best, 0) + 1
            return best

    @staticmethod
    def _prompt_prefix(body: Optional[bytes]) -> Optional[str]:
        """The request's prompt prefix (first 64 chars) — the affinity key
        for landing shared system prompts where their KV is cached."""
        if not body:
            return None
        try:
            payload = json.loads(body)
        except ValueError:
            return None
        return ServiceProxy._payload_prefix(payload)

    @staticmethod
    def _payload_text(payload) -> Optional[str]:
        """The request's FULL prompt text out of an already-parsed body —
        the fingerprint input for global cache-aware placement (the
        ladder needs real depth, not the 64-char affinity prefix)."""
        if not isinstance(payload, dict):
            return None
        prompt = payload.get("text_input")  # V1-generate style
        if not isinstance(prompt, str):
            prompt = payload.get("prompt")  # OpenAI completions
        if not isinstance(prompt, str):
            # OpenAI chat: the leading (usually system) message is the shared
            # prefix — exactly what prefix-cache affinity exists for
            msgs = payload.get("messages")
            if isinstance(msgs, list) and msgs and isinstance(msgs[0], dict):
                content = msgs[0].get("content")
                if isinstance(content, list):  # multi-part content blocks
                    content = "".join(
                        p["text"] for p in content
                        if isinstance(p, dict) and isinstance(p.get("text"), str))
                prompt = content if isinstance(content, str) else None
        if not isinstance(prompt, str) or not prompt:
            return None
        return prompt

    @staticmethod
    def _payload_prefix(payload) -> Optional[str]:
        """_prompt_prefix over an ALREADY-PARSED body — for callers on the
        relay path that hold the one shared parse (``_plan_disagg``)."""
        text = ServiceProxy._payload_text(payload)
        return text[:64] if text else None

    def _pick_revision(self, state: _ProxyState, traffic: dict[str, int]) -> Optional[str]:
        live = {r: p for r, p in traffic.items() if p > 0}
        if not live:
            return None  # no split recorded: any revision
        # smooth weighted round-robin (nginx algorithm): deterministic AND
        # interleaved, so a 20% canary sees ~1-in-5 requests from the start.
        # Under state.lock: concurrent handler threads otherwise lose
        # credit increments (skewing the split) and can KeyError when a
        # traffic change swaps the credits dict mid-update (found by
        # graftlint lock-discipline)
        key = json.dumps(live, sort_keys=True)
        with state.lock:
            if state.split_key != key:
                state.split_key = key
                state.credits = {r: 0 for r in live}
            total = sum(live.values())
            for r, w in live.items():
                state.credits[r] += w
            best = max(sorted(live), key=lambda r: state.credits[r])
            state.credits[best] -= total
        return best

    def _ready_pods(self, ns: str, selector: dict, revision: Optional[str]) -> list[Obj]:
        sel = dict(selector)
        if revision is not None:
            sel[LABEL_REVISION] = revision
        # snapshot-cached per (ns, selector, revision): readiness and the
        # draining annotation live on the pod objects, so any transition
        # is a store write and invalidates the cache
        return self._snap.cached(
            ("ready-pods", ns, tuple(sorted(sel.items())), revision),
            lambda: self._list_ready_pods(ns, sel))

    def _list_ready_pods(self, ns: str, sel: dict) -> list[Obj]:
        pods = [
            p
            for p in self.api.list("Pod", namespace=ns, label_selector=sel)
            if pod_is_ready(p) and pod_port(p) is not None
            # draining pods (scale-down victims finishing their in-flight
            # work, controllers.py) take no NEW traffic — this is the
            # "stop routing" half of graceful replica drain
            and DRAINING_ANNOTATION not in p["metadata"].get("annotations", {})
        ]
        return sorted(pods, key=lambda p: p["metadata"]["name"])

    def _activate(self, svc: Obj) -> None:
        ns = svc["metadata"].get("namespace", "default")
        ann = svc["metadata"].get("annotations", {})
        for dname in json.loads(ann.get(DEPLOYMENT_FOR_SERVICE_ANNOTATION, "[]")):
            deploy = self.api.try_get("Deployment", dname, ns)
            if deploy is None:
                continue
            if int(deploy["spec"].get("replicas", 1)) == 0:
                from .autoscaler import ACTIVATED_AT_ANNOTATION

                self.api.patch(
                    "Deployment",
                    dname,
                    {
                        "spec": {"replicas": 1},
                        "metadata": {
                            "annotations": {
                                SCALED_TO_ZERO_ANNOTATION: None,
                                ACTIVATED_AT_ANNOTATION: str(time.time()),
                            }
                        },
                    },
                    ns,
                )

    def _ingress_evidence(self, state: _ProxyState) -> dict:
        """Evidence snapshot for a newly opened ingress incident (manager
        thread).  Takes state.lock like every other shared-proxy-state
        reader: an unlocked iteration would race pod-churn mutation and
        — because the manager swallows evidence errors — silently write
        bundles with NO health log exactly when churn is the story."""
        with state.lock:
            out = {"health_log": list(state.health_log)[-32:],
                   "backends": {str(p): h.state
                                for p, h in state.health.items()}}
            ov = state.overload
        if ov is not None:
            # capacity incidents cite the overload story (README
            # "Overload control"): shed counts by class/reason, brownout
            # stage, the live AIMD limit, per-tenant pressure — the
            # controller snapshot takes its OWN lock, so it runs outside
            # state.lock (no nested-lock ordering to get wrong)
            try:
                out["overload"] = ov.snapshot()
            except Exception:  # noqa: BLE001 — evidence is best-effort
                pass
        return out

    def incident_view(self) -> "_ProxyIncidentView":
        """The autoscaler's handle into the ingress incident plane
        (README "Incident plane"): manager-shaped — ``open_count()``
        across every service's manager (the scale-down veto input) and
        ``feed()`` routing a flap event to the manager of the service
        that owns the flapping deployment."""
        return _ProxyIncidentView(self)

    def shutdown(self) -> None:
        for key in list(self._servers):
            self._stop(key)


class _ProxyIncidentView:
    """Aggregate facade over a ServiceProxy's per-service incident
    managers, so components that see the FLEET (the autoscaler) and not
    one service can still read and feed the plane."""

    def __init__(self, proxy: ServiceProxy):
        self._proxy = proxy

    def open_count(self) -> int:
        return sum(s.incidents.open_count()
                   for s in list(self._proxy._states.values())
                   if s.incidents is not None)

    def unremediated_open_count(self) -> int:
        """Open incidents with no remediation in flight, across every
        service — the autoscaler's refined scale-down veto input (README
        "Self-driving fleet")."""
        total = 0
        for s in list(self._proxy._states.values()):
            mgr = s.incidents
            if mgr is None:
                continue
            count = getattr(mgr, "unremediated_open_count",
                            mgr.open_count)
            total += count()
        return total

    def feed(self, kind: str, **attrs) -> None:
        """Route to the service owning ``attrs['deployment']`` (Services
        list their Deployments under the controllers' deployments
        annotation); an unowned or unnamed event lands on every
        manager — better a duplicate symptom than a dropped one."""
        deployment = attrs.get("deployment")
        targets = []
        for state in list(self._proxy._states.values()):
            if state.incidents is None:
                continue
            if deployment is not None:
                svc = self._proxy._get_service(state)
                ann = (svc or {}).get("metadata", {}) \
                    .get("annotations", {})
                try:
                    owned = json.loads(
                        ann.get(DEPLOYMENT_FOR_SERVICE_ANNOTATION, "[]"))
                except ValueError:
                    owned = []
                if deployment in owned:
                    targets = [state]
                    break
            targets.append(state)
        for state in targets:
            state.incidents.feed(kind, **attrs)


class _ResumeCtx:
    """Re-admission state for one resumable client stream: the parsed
    request payload plus every generated token id relayed so far.  A
    failover re-submits the ORIGINAL prompt with ``resume_token_ids`` so the
    new replica re-prefills prompt+generated (a prefix-cache hit when those
    pages exist) and streams only the continuation."""

    __slots__ = ("payload", "token_ids", "key")
    _seq = iter(range(1, 2 ** 62))

    def __init__(self, payload: dict):
        self.payload = payload
        self.token_ids: list[int] = []
        # process-unique stream key (id() can be recycled after GC): the
        # fleet-chaos injector counts streams and events by this
        self.key = next(self._seq)

    def request_body(self) -> bytes:
        p = copy.deepcopy(self.payload)
        params = p.setdefault("parameters", {})
        if not isinstance(params, dict):
            params = p["parameters"] = {}
        params["resume_token_ids"] = list(self.token_ids)
        return json.dumps(p).encode()


class _SSERelay:
    """Client-side SSE writer for the resumable relay: headers go out
    lazily (a pre-stream failure can still be a clean HTTP error), events
    are chunked-framed, and client write failures surface as _ClientGone so
    the failover loop stops instead of burning replicas for nobody."""

    __slots__ = ("h", "started", "trace_id")

    def __init__(self, handler):
        self.h = handler
        self.started = False
        self.trace_id: Optional[str] = None

    def start(self) -> None:
        if self.started:
            return
        try:
            self.h.send_response(200)
            self.h.send_header("Content-Type", "text/event-stream")
            self.h.send_header("Cache-Control", "no-cache")
            self.h.send_header("Transfer-Encoding", "chunked")
            if self.trace_id:
                # the stream's handle into GET /debug/trace/<id>
                self.h.send_header("X-Trace-Id", self.trace_id)
            self.h.end_headers()
        except Exception as e:  # noqa: BLE001
            raise _ClientGone(str(e)) from e
        self.started = True

    def event(self, obj: dict) -> None:
        self.start()
        data = b"data: " + json.dumps(obj).encode() + b"\n\n"
        try:
            self.h._chunk(data)
        except Exception as e:  # noqa: BLE001
            raise _ClientGone(str(e)) from e

    def finish(self) -> None:
        try:
            self.h.wfile.write(b"0\r\n\r\n")
            self.h.wfile.flush()
        except Exception as e:  # noqa: BLE001
            raise _ClientGone(str(e)) from e

    def error_event(self, msg: str) -> None:
        """Terminal structured error event (the satellite fix for silent
        mid-SSE truncation) — best-effort: the client may be gone too."""
        try:
            self.event({"error": msg, "done": True})
            self.finish()
        except _ClientGone:
            pass
        self.h.close_connection = True


class Router:
    """Client-facing entry — the kubectl-port-forward/ingress equivalent."""

    def __init__(self, api: APIServer, pump=None):
        self.api = api
        self.pump = pump  # optional callable(predicate, timeout) driving the cluster

    def _entry_port(self, name: str, namespace: str) -> int:
        isvc = self.api.get("InferenceService", name, namespace)
        url = isvc.get("status", {}).get("address", {}).get("url")
        if not url:
            raise LookupError(f"InferenceService {name} has no status.address yet")
        return int(url.rsplit(":", 1)[1])

    def _post(self, port: int, path: str, payload: dict, timeout: float = 60.0,
              headers: Optional[dict] = None) -> dict:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json", **(headers or {})},
        )
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read())

    def predict(self, name: str, payload: dict, namespace: str = "default",
                protocol: str = "v1", priority: Optional[str] = None,
                headers: Optional[dict] = None) -> dict:
        """``priority`` rides as an ``X-Priority`` header: the ingress proxy
        forwards it verbatim (it is not hop-by-hop) and the engine-backed
        model applies it to every instance that doesn't carry its own
        ``priority`` field — so callers can demote a whole batch request to
        the ``batch`` class without rewriting its instances."""
        port = self._entry_port(name, namespace)
        hdrs = dict(headers or {})
        if priority is not None:
            hdrs.setdefault("X-Priority", priority)
        if protocol == "v1":
            return self._post(port, f"/v1/models/{name}:predict", payload,
                              headers=hdrs)
        return self._post(port, f"/v2/models/{name}/infer", payload,
                          headers=hdrs)

    def explain(self, name: str, payload: dict, namespace: str = "default") -> dict:
        # upstream ingress routes :explain to the EXPLAINER component's
        # service when the ISVC has one; predictor/transformer otherwise
        isvc = self.api.get("InferenceService", name, namespace)
        status = isvc.get("status", {})
        comp = (status.get("components", {}).get("explainer") or {})
        port = comp.get("proxyPort")
        if not port:
            url = status.get("address", {}).get("url")
            if not url:
                raise LookupError(f"InferenceService {name} has no status.address yet")
            port = int(url.rsplit(":", 1)[1])
        return self._post(port, f"/v1/models/{name}:explain", payload)

    # ------------------------------------------------- OpenAI-compat surface
    # The model server speaks /openai/v1/* (server.py); these entries make it
    # reachable the way upstream users reach it — through the ingress, by
    # InferenceService name, with canary/activator/engine-aware routing
    # applying.  stream=True returns a generator of parsed SSE events
    # (excluding the [DONE] sentinel) that yields as chunks arrive — the
    # proxy relays event-stream responses unbuffered.

    def openai_completions(self, name: str, payload: dict,
                           namespace: str = "default"):
        return self._openai(name, "completions", payload, namespace)

    def openai_chat(self, name: str, payload: dict, namespace: str = "default"):
        return self._openai(name, "chat/completions", payload, namespace)

    def openai_models(self, name: str, namespace: str = "default") -> dict:
        port = self._entry_port(name, namespace)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/openai/v1/models", timeout=60) as r:
            return json.loads(r.read())

    def _openai(self, name: str, path: str, payload: dict, namespace: str):
        port = self._entry_port(name, namespace)
        if not payload.get("stream"):
            return self._post(port, f"/openai/v1/{path}", payload, timeout=120.0)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/openai/v1/{path}",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )

        def events():
            with urllib.request.urlopen(req, timeout=120) as r:
                buf = b""
                while True:
                    chunk = r.read1(65536)
                    if not chunk:
                        # the SSE stream is close-delimited: EOF before the
                        # [DONE] sentinel means the backend died mid-
                        # generation — surface it, a truncated stream must
                        # not look like a clean completion
                        raise ConnectionError(
                            f"SSE stream from {name} ended without [DONE]")
                    buf += chunk
                    while b"\n\n" in buf:
                        event, buf = buf.split(b"\n\n", 1)
                        for line in event.splitlines():
                            if not line.startswith(b"data:"):
                                continue
                            data = line[5:].strip()
                            if data == b"[DONE]":
                                return
                            yield json.loads(data)

        return events()
