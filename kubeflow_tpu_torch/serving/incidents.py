"""Fleet incident plane: fault detectors, cross-signal evidence
correlation, classified postmortem bundles (README "Incident plane").

A copy of ``kubeflow_tpu/serving/incidents.py``: the port's engine feeds it
at the JAX engine's sites, and ``EngineConfig(incidents=True)`` turns it on.

The fleet emits every signal an incident responder needs — W3C traces
through failover (core/tracing.py), flight-recorder dumps (telemetry.py),
per-class SLO burn rates (slo.py), health-FSM transitions and circuit-
breaker opens (router.py), degradation outcomes from storage/handoff/
fabric faults (kvstore.py / disagg.py / kvfabric.py) — but nothing
correlated them: one injected fault scattered its story across five
surfaces.  This module is the correlation layer, deliberately OFF the
tick loop (JetStream's "orchestration off the critical path", PAPERS.md):

  * ``IncidentManager`` — per-component (one per engine, one per service
    proxy) background correlator.  Producers ``feed()`` raw signal events
    (an O(1) deque append — the only cost any hot path ever pays);
    pluggable ``Detector``s decide which events are incident-worthy; a
    firing opens an ``Incident`` that snapshots correlated evidence
    (trace ids, a flight-recorder dump, a metrics window, the health
    transition log, the SLO burn series) and subsequent firings within
    the debounce window COALESCE into that incident's causal chain
    instead of fanning an alert storm.  A quiet period resolves it.
  * ``classify`` — the rule-based root-cause classifier: it names the
    cause from the evidence *shape* (which signals fired together), per
    the taxonomy below.  Sarathi-Serve (PAPERS.md) names the canonical
    serving root cause — prefill interference inflating decode TPOT —
    recognized here from burn-rate + prefill-backlog evidence alone.
  * Postmortem bundles — every incident is durably written as atomic
    JSON (tmp + os.replace, the kvstore tier's write discipline), capped
    in count with oldest-first eviction, and served via
    ``GET /engine/incidents`` per replica and ``GET /fleet/incidents``
    fleet-wide (router.py merges + dedupes, like ``/fleet/metrics``).

Root-cause taxonomy (``CAUSES``):

  replica_death        — watchdog trip / loop death on the engine, or
                         router failover + circuit-breaker opens at the
                         ingress (kill / hang / slow / cut chaos)
  prefill_interference — decode-TPOT SLO burn with a live prefill
                         backlog (Sarathi-Serve's signature)
  storage_degradation  — tiered-KV verification failures degrading
                         session restores to recompute (torn / flip /
                         ENOSPC storage chaos)
  handoff_degradation  — disaggregation KV imports falling back to
                         re-prefill (torn / slow / dead-link / expired
                         handoff chaos)
  fabric_degradation   — fleet-fabric prefix pulls falling back to
                         re-prefill
  capacity             — admission pressure with healthy replicas:
                         EngineOverloaded rejections, ingress overload
                         shedding / brownout stages (overload.py),
                         autoscaler flapping
  unknown              — the honest fallback: signals that match no rule
                         (a lone tick overrun, a lone NaN trip)

Determinism: ``_process(now)`` takes an explicit clock so tests drive
detection/debounce/resolution synchronously; the background thread is
just ``_process(time.monotonic())`` on a short interval.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import json
import os
import tempfile
import threading
import time
from typing import Callable, Optional

CAUSES = ("replica_death", "prefill_interference", "storage_degradation",
          "handoff_degradation", "fabric_degradation", "capacity",
          "constraint_stall", "unknown")

# signal event kinds producers may feed (attrs by kind are documented at
# the feed sites; every event SHOULD carry ``trace_ids`` so the bundle
# can cite the live traces the fault touched)
EVENT_KINDS = ("watchdog", "tick_overrun", "nan_guard", "degradation",
               "slo_burn", "queue_growth", "failover", "breaker_open",
               "flap", "shed", "brownout", "constraint_stall")


@dataclasses.dataclass(frozen=True)
class Detector:
    """One pluggable fault detector: fires on events whose ``kind`` is in
    ``kinds`` and (when set) whose attrs satisfy ``predicate``.  The name
    labels ``incident_detector_firings_total{detector}`` and the
    incident's ``detector`` field."""

    name: str
    kinds: tuple
    predicate: Optional[Callable[[dict], bool]] = None

    def matches(self, event: dict) -> bool:
        if event.get("kind") not in self.kinds:
            return False
        if self.predicate is not None:
            try:
                return bool(self.predicate(event))
            except Exception:  # noqa: BLE001 — a detector must not crash
                return False
        return True


def engine_detectors() -> list:
    """The engine-side detector set: watchdog trips, tick-deadline
    overruns, NaN-guard trips, every degradation outcome (storage
    recompute, handoff re-prefill, fabric degraded pull), SLO burn-
    threshold crossings, and admission-queue pressure."""
    return [
        Detector("watchdog", ("watchdog",)),
        Detector("tick_deadline", ("tick_overrun",)),
        Detector("nan_guard", ("nan_guard",)),
        Detector("storage_degradation", ("degradation",),
                 lambda e: e.get("source") == "storage"),
        Detector("handoff_degradation", ("degradation",),
                 lambda e: e.get("source") == "handoff"),
        Detector("fabric_degradation", ("degradation",),
                 lambda e: e.get("source") == "fabric"),
        Detector("slo_burn", ("slo_burn",)),
        Detector("admission_pressure", ("queue_growth",)),
        # constrained decoding (README "Structured output"): a mask with
        # zero legal tokens is an engine-side compile/mapping bug — the
        # client's schema already passed admission validation
        Detector("constraint_stall", ("constraint_stall",)),
    ]


def ingress_detectors() -> list:
    """The router-side detector set: failover re-attempts (connect /
    stall / 5xx / stream death), circuit-breaker opens, and autoscaler
    flapping (the autoscaler feeds ``flap`` into the proxy's manager)."""
    return [
        Detector("failover", ("failover",)),
        Detector("circuit_breaker", ("breaker_open",)),
        Detector("autoscaler_flap", ("flap",)),
        # overload control (README "Overload control"): the ingress
        # admission controller's aggregated shed bursts, brownout stage
        # transitions, and relayed engine BACKPRESSURE (503+Retry-After
        # — capacity evidence, not replica death) — the ingress-scope
        # twin of the engine's admission_pressure detector.  Self-
        # resolving by construction: shed events stop when the storm
        # does, and the quiet window closes the capacity incident.
        Detector("admission_pressure", ("shed", "brownout",
                                        "queue_growth")),
    ]


def classify(symptoms: list) -> tuple:
    """Name the root cause from the evidence SHAPE of a symptom list
    (event dicts) -> ``(cause, rule)``.  Rule order encodes severity
    precedence: a replica death often drags secondary symptoms (burns,
    degradations) behind it, and the death is what the responder pages
    on.  ``unknown`` is the honest fallback — a wrong confident label is
    worse than no label."""
    by_kind: dict = {}
    for s in symptoms:
        by_kind.setdefault(s.get("kind"), []).append(s)
    if any(k in by_kind for k in ("watchdog", "failover", "breaker_open")):
        return ("replica_death",
                "watchdog/failover/breaker evidence: the replica (or its "
                "loop thread) stopped serving")
    if "constraint_stall" in by_kind:
        # precedence over degradation/capacity shapes: a stall burst can
        # drag a failure-cap shed storm behind it, and the stall is what
        # the responder pages on (a code bug, not load)
        return ("constraint_stall",
                "a constrained slot's automaton reached a state with zero "
                "legal tokens — a grammar compile or token-map bug, never "
                "the client's fault")
    sources = [s.get("source") for s in by_kind.get("degradation", ())]
    if sources:
        # the dominant degradation source names the cause: one chaos
        # burst fires one injector class, and a stray secondary
        # degradation must not outvote it
        top = max(set(sources), key=sources.count)
        cause = {"storage": "storage_degradation",
                 "handoff": "handoff_degradation",
                 "fabric": "fabric_degradation"}.get(top)
        if cause is not None:
            return (cause, f"degradation outcomes dominated by "
                           f"source={top}")
        return ("unknown", f"degradation with unrecognized source {top!r}")
    burns = by_kind.get("slo_burn", ())
    tpot_burn = [b for b in burns if b.get("metric") == "tpot"]
    prefill_pressure = any((b.get("prefill_active") or 0) > 0
                           for b in burns)
    if tpot_burn and prefill_pressure:
        return ("prefill_interference",
                "decode TPOT burning its budget while a prefill backlog "
                "is live (Sarathi-Serve signature)")
    if any(k in by_kind for k in ("queue_growth", "flap", "shed",
                                  "brownout")):
        return ("capacity",
                "admission pressure (queue growth / ingress shedding / "
                "brownout / scaling oscillation) with no replica-health "
                "evidence")
    return ("unknown", "no classification rule matched the evidence shape")


@dataclasses.dataclass(frozen=True)
class IncidentConfig:
    """Frozen incident-plane knobs (ride inside the frozen EngineConfig).

    ``debounce_s`` groups cascading symptoms into one incident (sliding
    from the LAST symptom); ``resolve_s`` of quiet marks the incident
    resolved — debounce must not exceed resolve or a burst could bridge
    straight through resolution.  ``bundle_dir`` None lands bundles under
    <tmpdir>/<scope>_incidents; bundles are capped at ``max_bundles``
    files, oldest unlinked first, and the in-memory ring at
    ``max_incidents`` (resolved evicted before open)."""

    debounce_s: float = 5.0
    resolve_s: float = 15.0
    poll_interval_s: float = 0.25

    def __post_init__(self):
        if self.debounce_s > self.resolve_s:
            # a resolve window shorter than the debounce would close an
            # incident while its coalescing window is still live — a
            # fault emitting symptoms between the two re-creates exactly
            # the alert storm (one incident + one forced flight dump per
            # symptom) debounce exists to prevent
            raise ValueError(
                f"incident debounce_s ({self.debounce_s}) must not "
                f"exceed resolve_s ({self.resolve_s})")
    bundle_dir: Optional[str] = None
    max_bundles: int = 32
    max_incidents: int = 64
    # per-incident symptom-chain cap: a pathological storm coalesces into
    # ONE incident, but its causal chain must not grow without bound —
    # past the cap only the dropped-count advances
    max_symptoms: int = 128
    # per-incident evidence trace-id cap (the bundle CITES traces, it
    # does not archive them — a storm appending one unique id per
    # degraded request would otherwise grow evidence without bound)
    max_trace_ids: int = 64


def timeline(incident: dict) -> list:
    """Render one incident as the responder's timeline: detector firing →
    evidence refs → classification → (symptoms …) → remediation
    decisions → resolution.  Served
    by ``GET /fleet/incidents/<id>`` and ``GET /engine/incidents/<id>``."""
    rows = []
    symptoms = incident.get("symptoms") or []
    if symptoms:
        first = symptoms[0]
        rows.append({"t_s": 0.0, "step": "detector_fired",
                     "detector": first.get("detector"),
                     "kind": first.get("kind")})
    ev = incident.get("evidence") or {}
    rows.append({"t_s": 0.0, "step": "evidence",
                 "trace_ids": ev.get("trace_ids") or [],
                 "flight_dump": ev.get("flight_dump"),
                 "refs": sorted(k for k in ev
                                if k not in ("trace_ids", "flight_dump"))})
    cls = incident.get("classification") or {}
    rows.append({"t_s": 0.0, "step": "classified",
                 "cause": incident.get("cause"),
                 "rule": cls.get("rule")})
    for s in symptoms[1:]:
        rows.append({"t_s": s.get("t_s"), "step": "symptom",
                     "detector": s.get("detector"), "kind": s.get("kind")})
    rem = incident.get("remediation") or {}
    for a in rem.get("actions") or ():
        rows.append({"t_s": a.get("t_s"), "step": "remediation",
                     "playbook": a.get("playbook"),
                     "outcome": a.get("outcome"),
                     "dry_run": bool(a.get("dry_run"))})
    if incident.get("state") == "resolved":
        rows.append({"t_s": incident.get("duration_s"), "step": "resolved",
                     "reason": (incident.get("resolution") or {})
                     .get("reason")})
    return rows


def _slim_event(event: dict) -> dict:
    """A symptom entry: the event minus bookkeeping, bounded attr sizes
    (trace id lists are capped — the bundle cites, it does not archive)."""
    out = {}
    for k, v in event.items():
        if k in ("t", "wall"):
            continue
        if k == "trace_ids":
            v = list(v or ())[:8]
        out[k] = v
    return out


class IncidentManager:
    """One component's incident correlator (an engine's, or a service
    proxy's).  Everything expensive — detection, evidence snapshots,
    classification, bundle writes — happens on the manager's own
    background thread (or a test's explicit ``_process(now)`` call);
    the producer-facing surface is ``feed()``: stamp + append + wake.

    Hooks (all optional, all called on the manager thread):
      ``evidence()``            -> dict merged into every new incident's
                                   evidence block (metrics window, health
                                   log, SLO snapshot — whatever the host
                                   component can answer)
      ``dump(first_event)``     -> flight-recorder dump path for a newly
                                   opened incident (reuse the triggering
                                   event's own dump when it carries one —
                                   the engine's watchdog/NaN paths already
                                   dumped, and the recorder's lifetime cap
                                   must not be burned twice per fault)
      ``on_firing(detector)``   -> incident_detector_firings_total
      ``on_resolve(cause)``     -> incidents_total{cause} (terminal count,
                                   by FINAL cause — the analogy is
                                   engine_requests_total counting at the
                                   terminal outcome)
      ``on_open_count(n)``      -> incidents_open gauge
    """

    def __init__(self, scope: str, config: Optional[IncidentConfig] = None,
                 detectors: Optional[list] = None,
                 evidence: Optional[Callable[[], dict]] = None,
                 dump: Optional[Callable[[dict], Optional[str]]] = None,
                 on_firing: Optional[Callable[[str], None]] = None,
                 on_resolve: Optional[Callable[[str], None]] = None,
                 on_open_count: Optional[Callable[[int], None]] = None):
        self.scope = scope
        self.config = config or IncidentConfig()
        self.detectors = list(detectors or ())
        self.evidence = evidence
        self.dump = dump
        self.on_firing = on_firing
        self.on_resolve = on_resolve
        self.on_open_count = on_open_count
        self._events: collections.deque = collections.deque(maxlen=4096)
        self._incidents: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        self._bundle_paths: list = []
        self._pollers: list = []
        # remediation subscribers (README "Self-driving fleet"): called
        # on the manager thread with a DEEP COPY of each newly opened or
        # resolving incident — a remediator must never write through to
        # the live dict except via annotate_remediation()
        self._subscribers: list = []
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.firings = 0
        self.events_seen = 0
        self.events_dropped = 0  # matched no detector

    # ------------------------------------------------------------ producers

    def feed(self, kind: str, **attrs) -> None:  # graftlint: hot-path
        """Signal intake — the ONLY incident-plane call any hot path ever
        makes: one deque append plus an event set.  Never raises."""
        try:
            # the wall stamp IS the payload here (incident timestamps
            # humans read), not timing arithmetic; durations use the
            # monotonic stamp beside it
            wall = time.time()  # graftlint: disable=hot-path -- payload stamp, not timing
            self._events.append({"kind": kind, "t": time.monotonic(),
                                 "wall": wall, **attrs})
            self._wake.set()
        except Exception:  # noqa: BLE001 — pragma: no cover (defensive)
            pass

    def add_poller(self, fn: Callable[[], None]) -> None:
        """Register a signal poller run once per processing pass on the
        manager thread (the SLO burn detector reads rolling windows that
        nothing events on).  Pollers call ``feed()`` themselves."""
        self._pollers.append(fn)

    def subscribe(self, fn: Callable[[dict], None]) -> None:
        """Register an incident subscriber (the remediation controller,
        remediator.py): called on the MANAGER thread with a deep copy of
        each incident when it opens and when it resolves.  Subscribers
        must be O(1) (enqueue + wake) — they run inside the correlation
        pass."""
        self._subscribers.append(fn)

    def _notify(self, inc: dict) -> None:
        if not self._subscribers:
            return
        snap = copy.deepcopy({k: v for k, v in inc.items()
                              if not k.startswith("_")})
        for fn in self._subscribers:
            try:
                fn(snap)
            except Exception:  # noqa: BLE001 — a subscriber must not
                pass           # crash the incident plane

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"incidents-{self.scope}")
        self._thread.start()

    def stop(self) -> None:
        """Stop the thread after one final processing pass so fed-but-
        unprocessed events still open/coalesce before shutdown."""
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
            self._thread = None
        try:
            self._process(time.monotonic())
        except Exception:  # noqa: BLE001 — shutdown must not raise
            pass

    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(timeout=self.config.poll_interval_s)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self._process(time.monotonic())
            except Exception:  # noqa: BLE001 — the plane must not crash
                pass

    # ------------------------------------------------------------- readers

    def list(self) -> list:
        """Every held incident (open first, newest last within state).
        DEEP copies: readers (the fleet merge mutates evidence while
        deduping) must never write through to the live incident."""
        with self._lock:
            incs = [copy.deepcopy(i) for i in self._incidents.values()]
        incs.sort(key=lambda i: (i.get("state") != "open",
                                 i.get("opened_wall") or 0.0))
        return incs

    def get(self, incident_id: str) -> Optional[dict]:
        with self._lock:
            inc = self._incidents.get(incident_id)
            return copy.deepcopy(inc) if inc is not None else None

    def open_count(self) -> int:
        with self._lock:
            return sum(1 for i in self._incidents.values()
                       if i.get("state") == "open")

    def unremediated_open_count(self) -> int:
        """Open incidents with NO remediation in flight — the
        autoscaler's scale-down veto input (README "Self-driving
        fleet"): an incident whose playbook is already executing (or
        that was explicitly escalated to a human) must not pin fleet
        size; one nobody has answered still does."""
        with self._lock:
            return sum(
                1 for i in self._incidents.values()
                if i.get("state") == "open"
                and (i.get("remediation") or {}).get("status")
                not in ("in_flight", "escalated"))

    # ------------------------------------------------------ remediation

    # per-incident remediation action cap: the flap guard escalates long
    # before this, so the cap only defends the bundle size against a
    # misbehaving annotator
    MAX_REMEDIATION_ACTIONS = 16

    def annotate_remediation(self, incident_id: str, action: dict,
                             status: Optional[str] = None) -> bool:
        """Record one remediation decision into the incident it answers
        (remediator.py calls this for every playbook outcome, dry-run
        included) and re-write its bundle: the postmortem timeline reads
        detector → classification → remediation → resolution.  False
        when the incident is not held here — the fleet-merge path probes
        every manager and only the origin accepts."""
        with self._lock:
            inc = self._incidents.get(incident_id)
            if inc is None:
                return False
            rem = inc.setdefault("remediation",
                                 {"playbook": None, "status": "none",
                                  "actions": []})
            entry = {k: v for k, v in action.items()}
            entry.setdefault("t_s", round(time.monotonic()
                                          - inc["_opened_t"], 4))
            if len(rem["actions"]) < self.MAX_REMEDIATION_ACTIONS:
                rem["actions"].append(entry)
            else:
                rem["actions_dropped"] = rem.get("actions_dropped", 0) + 1
            rem["playbook"] = action.get("playbook") or rem["playbook"]
            if status is not None:
                rem["status"] = status
        self._write_bundle(inc)
        return True

    def stats(self) -> dict:
        with self._lock:
            open_n = sum(1 for i in self._incidents.values()
                         if i.get("state") == "open")
            return {"incidents": len(self._incidents), "open": open_n,
                    "firings": self.firings,
                    "events_seen": self.events_seen,
                    "events_dropped": self.events_dropped}

    # ------------------------------------------------------------ processing

    def _process(self, now: float) -> None:
        """One correlation pass: run pollers, drain the event queue
        through the detectors, open/coalesce incidents, resolve quiet
        ones.  Tests call this directly with an explicit clock."""
        for fn in self._pollers:
            try:
                fn()
            except Exception:  # noqa: BLE001 — a poller must not crash
                pass
        while True:
            try:
                event = self._events.popleft()
            except IndexError:
                break
            self.events_seen += 1
            det = next((d for d in self.detectors if d.matches(event)),
                       None)
            if det is None:
                self.events_dropped += 1
                continue
            self.firings += 1
            if self.on_firing is not None:
                self.on_firing(det.name)
            self._attach(event, det, now)
        self._resolve_quiet(now)

    def _attach(self, event: dict, det: Detector, now: float) -> None:
        """Coalesce into the open incident whose causal chain is still
        within the debounce window of this event, else open a fresh one.
        Classification re-runs as the chain grows: the first symptom may
        be a secondary effect of a root cause a later symptom names."""
        with self._lock:
            target = None
            for inc in reversed(self._incidents.values()):
                if (inc.get("state") == "open"
                        and event["t"] - inc["_last_t"]
                        <= self.config.debounce_s):
                    target = inc
                    break
        if target is None:
            self._open(event, det, now)
            return
        with self._lock:
            target["_last_t"] = event["t"]
            if len(target["symptoms"]) < self.config.max_symptoms:
                target["symptoms"].append({
                    **_slim_event(event), "detector": det.name,
                    "t_s": round(event["t"] - target["_opened_t"], 4)})
            else:
                target["symptoms_dropped"] = \
                    target.get("symptoms_dropped", 0) + 1
            ids = target["evidence"]["trace_ids"]
            for tid in (event.get("trace_ids") or ())[:8]:
                if (tid and len(ids) < self.config.max_trace_ids
                        and tid not in ids):
                    ids.append(tid)
            cause, rule = classify(target["symptoms"])
            target["cause"] = cause
            target["classification"] = {"rule": rule,
                                        "symptom_count":
                                            len(target["symptoms"])}

    def _open(self, event: dict, det: Detector, now: float) -> None:
        inc_id = f"inc-{os.urandom(4).hex()}"
        symptom = {**_slim_event(event), "detector": det.name, "t_s": 0.0}
        cause, rule = classify([symptom])
        evidence: dict = {"trace_ids": [t for t in
                                        (event.get("trace_ids") or ())[:8]
                                        if t],
                          "flight_dump": None}
        if self.dump is not None:
            try:
                evidence["flight_dump"] = self.dump(event)
            except Exception:  # noqa: BLE001 — evidence is best-effort
                pass
        if self.evidence is not None:
            try:
                extra = self.evidence() or {}
                # sanitize once at the boundary: evidence snapshots flow
                # into HTTP JSON replies and bundle files verbatim, and a
                # stray numpy scalar must not 500 a debug endpoint
                extra = json.loads(json.dumps(extra, default=str))
                for k, v in extra.items():
                    evidence.setdefault(k, v)
            except Exception:  # noqa: BLE001
                pass
        inc = {
            "id": inc_id,
            "scope": self.scope,
            "state": "open",
            "opened_wall": event.get("wall") or time.time(),
            "detector": det.name,
            "cause": cause,
            "classification": {"rule": rule, "symptom_count": 1},
            "symptoms": [symptom],
            "evidence": evidence,
            "bundle_path": None,
            "_opened_t": event["t"],
            "_last_t": event["t"],
        }
        with self._lock:
            self._incidents[inc_id] = inc
            self._evict_incidents()
        self._write_bundle(inc)
        if self.on_open_count is not None:
            self.on_open_count(self.open_count())
        self._notify(inc)

    def _resolve_quiet(self, now: float) -> None:
        resolved = []
        with self._lock:
            for inc in self._incidents.values():
                if (inc.get("state") == "open"
                        and now - inc["_last_t"] >= self.config.resolve_s):
                    inc["state"] = "resolved"
                    inc["resolved_wall"] = time.time()
                    inc["duration_s"] = round(inc["_last_t"]
                                              - inc["_opened_t"], 4)
                    inc["resolution"] = {
                        "reason": f"no new symptoms for "
                                  f"{self.config.resolve_s:g}s"}
                    resolved.append(inc)
        for inc in resolved:
            # re-write the bundle with the final causal chain + cause
            self._write_bundle(inc)
            if self.on_resolve is not None:
                self.on_resolve(inc["cause"])
            self._notify(inc)
        if resolved and self.on_open_count is not None:
            self.on_open_count(self.open_count())

    def _evict_incidents(self) -> None:
        """Caller holds the lock.  Resolved incidents age out first;
        open ones only under a pathological pileup."""
        cap = self.config.max_incidents
        while len(self._incidents) > cap:
            victim = next(
                (k for k, v in self._incidents.items()
                 if v.get("state") != "open"),
                next(iter(self._incidents)))
            self._incidents.pop(victim)

    # --------------------------------------------------------------- bundles

    def bundle_dir(self) -> str:
        return (self.config.bundle_dir
                or os.path.join(tempfile.gettempdir(),
                                f"{self.scope.replace(':', '_')}"
                                f"_incidents"))

    def _write_bundle(self, inc: dict) -> None:
        """Durable postmortem bundle: atomic JSON (tmp + os.replace — a
        crash mid-write leaves the previous version or nothing, never a
        torn file), capped in count.  Failures are swallowed: a full disk
        must not take the incident plane (let alone serving) down."""
        d = self.bundle_dir()
        path = os.path.join(d, f"{inc['id']}.json")
        public = {k: v for k, v in inc.items() if not k.startswith("_")}
        public["bundle_path"] = path
        try:
            os.makedirs(d, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(public, f, default=str, indent=1)
            os.replace(tmp, path)
        except OSError:
            return
        with self._lock:
            inc["bundle_path"] = path
            if path not in self._bundle_paths:
                self._bundle_paths.append(path)
            while len(self._bundle_paths) > self.config.max_bundles:
                old = self._bundle_paths.pop(0)
                try:
                    os.unlink(old)
                except OSError:
                    pass


# -------------------------------------------------------------- fleet merge


def merge_fleet_incidents(entries: list) -> list:
    """Fleet-wide incident merge (``GET /fleet/incidents``): ``entries``
    is ``[(origin, incident_dict), ...]`` from the proxy's own manager and
    every replica's ``/engine/incidents``.  Two replicas reporting the
    SAME event — e.g. both ends of one failover, or a re-admitted request
    opening symptom records on two engines — produce incidents with the
    same cause citing overlapping trace ids; those merge into ONE entry
    listing every origin (``origins``/``merged_ids``), keeping the
    earliest-opened incident's body.  Incidents with no shared trace
    evidence stay distinct — cause alone is not identity."""
    merged: list = []
    for origin, inc in sorted(
            entries, key=lambda e: (e[1].get("opened_wall") or 0.0)):
        tids = set((inc.get("evidence") or {}).get("trace_ids") or ())
        target = None
        if tids:
            for m in merged:
                if (m["cause"] == inc.get("cause")
                        and m["_tids"] & tids):
                    target = m
                    break
        if target is None:
            merged.append({**{k: v for k, v in inc.items()
                              if not k.startswith("_")},
                           "origins": [origin],
                           "merged_ids": [inc.get("id")],
                           "_tids": set(tids)})
        else:
            target["origins"].append(origin)
            target["merged_ids"].append(inc.get("id"))
            target["_tids"] |= tids
            for tid in tids:
                ev = target.setdefault("evidence", {})
                ids = ev.setdefault("trace_ids", [])
                if tid not in ids:
                    ids.append(tid)
            # any origin still open keeps the merged entry open
            if inc.get("state") == "open":
                target["state"] = "open"
    for m in merged:
        m.pop("_tids", None)
    return merged
