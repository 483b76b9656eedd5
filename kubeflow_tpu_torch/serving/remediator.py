"""Self-driving fleet: closed-loop incident remediation (README
"Self-driving fleet").

Counterpart of ``kubeflow_tpu/serving/remediator.py``, copied as it is: the
remediator acts on the control plane only (incident bundles, autoscaler
floor proposals, pod role annotations), so nothing in it touches the card.

The incident plane CLASSIFIES root causes (incidents.py), the overload
controller SHEDS (overload.py), the autoscaler SCALES (autoscaler.py)
and the disagg role machinery can FLIP replica roles (disagg.py) — this
module closes the loop between them: a classified incident triggers the
per-cause playbook its own taxonomy names, with no human in between.
Per JetStream's off-critical-path discipline (PAPERS.md) every decision
runs on this controller's own background thread; the hot paths never
pay more than the O(1) ``IncidentManager.feed()`` they already paid.

Playbooks (``CAUSE_PLAYBOOK`` — the executable half of the incident
taxonomy; ``faults.EXPECTED_REMEDIATIONS`` pins chaos class → cause →
playbook as a contract):

  replica_death        → ``replace_replica``: confirm the breaker already
                         ejected the dead backend (router.py fed the
                         evidence), then pre-warm a replacement by
                         PROPOSING a replica floor to the autoscaler.
  prefill_interference → ``split_roles``: flip two unified replicas to a
                         disagg prefill/decode pair (pod role
                         annotations, disagg.py) so prefill bursts stop
                         inflating decode TPOT (Sarathi-Serve signature).
  capacity             → ``prescale``: reactive floor bump, plus a
                         PREDICTIVE path — the seeded
                         ``faults.StormFaultConfig`` diurnal/burst rate
                         envelope is deterministic, so the controller
                         forecasts the next burst and proposes capacity
                         BEFORE the burn trips (``set_forecast``).
  *_degradation        → ``quarantine_tier``: stop publishing/pulling
                         the offending KV tier (storage / handoff /
                         fabric) and serve degraded-local; un-quarantine
                         is gated on consecutive healthy probes.
  unknown              → ``observe``: annotate, act on nothing — a wrong
                         confident fix is worse than no fix.

Safety rails (first-class, not bolted on):

  * single-writer arbitration — the remediator NEVER patches
    ``spec.replicas``; it calls ``autoscaler.propose_floor()`` and the
    autoscaler's ``_scale()`` remains the only writer, so the two can
    never duel over replica counts.  Proposals expire after a TTL: a
    dead remediator cannot pin fleet size.
  * per-playbook cooldowns + a global action-rate budget — a cascading
    storm coalesces into throttled, deliberate actions.
  * flap guard — the same (cause, target) remediated ``flap_max`` times
    inside the window escalates to ``needs_human`` instead of
    oscillating, and stays escalated for the window.
  * dry-run — computes and annotates the action it WOULD take with zero
    actuator calls (the rails advance identically, so the log reads
    exactly like a live run).
  * every decision is written into the incident bundle it answers
    (``IncidentManager.annotate_remediation``), so the postmortem
    timeline reads detector → classification → remediation → resolution.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import threading
import time
from typing import Callable, Optional

from ..core.metrics import REGISTRY
from .controllers import DEPLOYMENT_FOR_SERVICE_ANNOTATION, pod_is_ready
from .disagg import DISAGG_ANNOTATION, ROLE_ANNOTATION, pod_role

# ---- telemetry (README "Self-driving fleet"; pinned both directions by
# tests/test_metrics_conformance.py) ---------------------------------------
REMEDIATION_ACTIONS = REGISTRY.counter(
    "remediation_actions_total",
    "remediation playbook decisions by outcome "
    "(executed/dry_run/skipped/escalated/proposed/lifted/deferred)")
REMEDIATION_QUARANTINED = REGISTRY.gauge(
    "remediation_quarantined_tiers",
    "1 while the labelled KV tier (storage/handoff/fabric) is "
    "quarantined, removed when the health probe lifts it")
INCIDENTS_ESCALATED = REGISTRY.counter(
    "incidents_escalated_total",
    "incidents the flap guard escalated to needs_human instead of "
    "re-running an oscillating playbook")

# cause -> playbook: the executable half of incidents.CAUSES.  A new
# cause added to the taxonomy must name its playbook here (or land in
# "observe" by the .get() default) — faults.EXPECTED_REMEDIATIONS pins
# the full chaos-class contract on top of this table.
CAUSE_PLAYBOOK = {
    "replica_death": "replace_replica",
    "prefill_interference": "split_roles",
    "capacity": "prescale",
    "storage_degradation": "quarantine_tier",
    "handoff_degradation": "quarantine_tier",
    "fabric_degradation": "quarantine_tier",
    # constrained-decoding stall (README "Structured output"): a grammar
    # compile / token-map bug needs a code fix, not an actuator — the
    # playbook keeps the bundle open for a human, it does not auto-heal
    "constraint_stall": "observe",
    "unknown": "observe",
}
PLAYBOOKS = ("replace_replica", "split_roles", "prescale",
             "quarantine_tier", "observe", "needs_human")
# degradation cause -> the KV tier its playbook quarantines
TIER_FOR_CAUSE = {"storage_degradation": "storage",
                  "handoff_degradation": "handoff",
                  "fabric_degradation": "fabric"}
QUARANTINE_TIERS = ("storage", "handoff", "fabric")


# ------------------------------------------------------------ storm forecast


def storm_rate_qps(storm, t_s: float) -> float:
    """The deterministic arrival-rate envelope of a seeded
    ``faults.StormFaultConfig`` at ``t_s`` seconds into the storm —
    the diurnal sinusoid times the burst multiplier, NO randomness
    (thinning only decides which arrivals survive under this envelope),
    so the forecast is exact for the schedule both bench arms replay."""
    r = float(storm.base_qps)
    if storm.diurnal_period_s > 0:
        r *= 1.0 + storm.diurnal_depth * math.sin(
            2.0 * math.pi * t_s / storm.diurnal_period_s)
    if storm.burst_every_s > 0 and (t_s % storm.burst_every_s) < storm.burst_len_s:
        r *= storm.burst_x
    return max(0.0, r)


def forecast_peak_qps(storm, t_start: float, horizon_s: float,
                      samples: int = 32) -> float:
    """Peak of the rate envelope over ``[t_start, t_start+horizon_s]``
    (dense deterministic sampling — the envelope is piecewise smooth
    with burst edges, so a fixed grid bounds the error at
    ``horizon_s/samples``)."""
    if horizon_s <= 0:
        return storm_rate_qps(storm, t_start)
    step = horizon_s / max(1, samples)
    return max(storm_rate_qps(storm, t_start + i * step)
               for i in range(max(1, samples) + 1))


# --------------------------------------------------------------- quarantine


class TierQuarantine:
    """Quarantine registry for the KV tiers (storage/handoff/fabric).

    ``quarantine()`` flips the tier's enforcers (store flags + placement
    gates) to degraded-local; ``note_probe()`` counts consecutive
    healthy probes and lifts after ``healthy_probes`` in a row — one
    flaky probe resets the streak, so recovery is gated on sustained
    health, not a lucky sample.  Thread-safe: the remediator thread
    drives it while HTTP handler threads read ``active()`` at placement
    time.  Bounded by construction: keys are drawn from the fixed
    ``QUARANTINE_TIERS`` tuple."""

    def __init__(self, healthy_probes: int = 2):
        self.healthy_probes = max(1, int(healthy_probes))
        self._lock = threading.Lock()
        self._active: dict = {}     # tier -> record  # guarded-by: _lock
        self._enforcers: dict = {}  # tier -> fn(bool)  # guarded-by: _lock
        self._probes: dict = {}     # tier -> fn()->bool  # guarded-by: _lock
        self.quarantines = 0
        self.lifts = 0

    def register(self, tier: str,
                 enforce: Optional[Callable[[bool], None]] = None,
                 probe: Optional[Callable[[], bool]] = None) -> None:
        """Wire one tier's enforcement callback (called with True on
        quarantine, False on lift — e.g. ``FabricStore.set_quarantined``)
        and optionally a health probe overriding the remediator's
        default (tier cause has no open incident)."""
        if tier not in QUARANTINE_TIERS:
            raise ValueError(f"unknown quarantine tier {tier!r}")
        with self._lock:
            if enforce is not None:
                self._enforcers[tier] = enforce
            if probe is not None:
                self._probes[tier] = probe

    def active(self, tier: str) -> bool:
        with self._lock:
            return tier in self._active

    def quarantine(self, tier: str, reason: str = "") -> bool:
        """Quarantine ``tier``; False when already quarantined (the
        playbook treats that as an idempotent hit, not a failure)."""
        if tier not in QUARANTINE_TIERS:
            return False
        with self._lock:
            if tier in self._active:
                return False
            self._active[tier] = {"reason": reason,
                                  "since_wall": time.time(),
                                  "ok_streak": 0, "probes": 0}
            enforce = self._enforcers.get(tier)
            self.quarantines += 1
        REMEDIATION_QUARANTINED.set(1.0, tier=tier)
        if enforce is not None:
            try:
                enforce(True)
            except Exception:  # noqa: BLE001 — enforcement is best-effort
                pass
        return True

    def lift(self, tier: str, reason: str = "") -> bool:
        with self._lock:
            rec = self._active.pop(tier, None)
            enforce = self._enforcers.get(tier)
            if rec is not None:
                self.lifts += 1
        if rec is None:
            return False
        REMEDIATION_QUARANTINED.remove(tier=tier)
        if enforce is not None:
            try:
                enforce(False)
            except Exception:  # noqa: BLE001
                pass
        return True

    def probe_for(self, tier: str) -> Optional[Callable[[], bool]]:
        with self._lock:
            return self._probes.get(tier)

    def note_probe(self, tier: str, healthy: bool) -> bool:
        """Record one probe outcome; returns True when this probe LIFTED
        the quarantine (``healthy_probes`` consecutive healthy reads)."""
        with self._lock:
            rec = self._active.get(tier)
            if rec is None:
                return False
            rec["probes"] += 1
            rec["ok_streak"] = rec["ok_streak"] + 1 if healthy else 0
            if rec["ok_streak"] < self.healthy_probes:
                return False
        return self.lift(tier, reason="health probe streak")

    def list(self) -> dict:
        with self._lock:
            return {t: dict(r) for t, r in self._active.items()}


# --------------------------------------------------------------- controller


@dataclasses.dataclass(frozen=True)
class RemediatorConfig:
    """Frozen remediation knobs.  The rails are deliberately
    conservative: a remediator that under-acts degrades to PR 13's
    page-a-human world; one that over-acts is a new outage source."""

    poll_interval_s: float = 0.25
    # dry-run: every playbook computes and ANNOTATES the action it would
    # take, the rails advance identically, zero actuator calls are made
    dry_run: bool = False
    # per-playbook cooldown between executed actions
    cooldown_s: float = 5.0
    # global action-rate budget: at most rate_budget executed actions
    # per rate_window_s across ALL playbooks
    rate_budget: int = 8
    rate_window_s: float = 60.0
    # flap guard: the same (cause, target) executed flap_max times
    # inside flap_window_s escalates to needs_human
    flap_max: int = 3
    flap_window_s: float = 60.0
    # cooldown/budget deferrals per incident before escalating (a budget
    # that never frees must not leave the bundle silently open)
    defer_max: int = 64
    # quarantine health probing
    probe_interval_s: float = 1.0
    healthy_probes: int = 2
    # replica_death pre-warm: proposed floor = current + prewarm_extra
    prewarm_extra: int = 1
    # every autoscaler proposal expires after this TTL
    proposal_ttl_s: float = 30.0
    # predictive prescale: look this far ahead in the storm envelope,
    # pad the forecast by this headroom factor
    forecast_horizon_s: float = 2.0
    forecast_headroom: float = 1.2
    # bounded action log served via /fleet/remediation
    max_recent_actions: int = 128
    # bounded per-incident tracking
    max_tracked: int = 256


class FleetRemediator:
    """The fleet remediation controller.  ``attach()`` it to incident
    managers (the proxy's ingress-scope one and/or engine-scope ones —
    they push ids via ``IncidentManager.subscribe``), hand it the
    ``ConcurrencyAutoscaler`` (proposals) and the ``APIServer`` (role
    flips), and ``start()`` its thread.  Tests drive ``_process(now)``
    with an explicit clock, exactly like the incident plane."""

    def __init__(self, api=None, autoscaler=None,
                 config: Optional[RemediatorConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.api = api
        self.autoscaler = autoscaler
        self.config = config or RemediatorConfig()
        self.quarantine = TierQuarantine(
            healthy_probes=self.config.healthy_probes)
        self._clock = clock
        self._lock = threading.Lock()
        self._managers: list = []  # guarded-by: _lock
        # subscription intake: (manager, incident_id), O(1) append from
        # manager threads; drained (and deduped against the rescan) on
        # the remediator thread
        self._queue: collections.deque = \
            collections.deque(maxlen=1024)  # guarded-by: _lock
        # incident id -> {playbook, cause, status, deferrals}; pruned
        # oldest-first past max_tracked
        self._tracked: collections.OrderedDict = \
            collections.OrderedDict()  # guarded-by: _lock
        self._last_fired: dict = {}  # playbook -> mono t  # guarded-by: _lock
        self._action_times: collections.deque = \
            collections.deque(maxlen=512)  # guarded-by: _lock
        # flap guard: (cause, target) -> deque of executed-action times;
        # escalations stay sticky for flap_window_s
        self._flap_hist: dict = {}  # guarded-by: _lock
        self._escalated_keys: dict = {}  # guarded-by: _lock
        self._recent: collections.deque = collections.deque(
            maxlen=self.config.max_recent_actions)  # guarded-by: _lock
        # predictive prescale state: (storm_cfg, t0, per_replica_qps,
        # deployment) + last proposed floor (dedup — propose on change)
        self._forecast: Optional[tuple] = None  # guarded-by: _lock
        self._last_floor: dict = {}  # guarded-by: _lock
        self._probe_at: dict = {}   # tier -> next probe t (thread-local)
        self._fleet_view: Optional[Callable[[], list]] = None
        self.escalations = 0
        # the campaign's zero-human gate reads this: nothing in this
        # module ever increments it — any manual intervention a bench or
        # operator script performs must count itself here
        self.human_actions = 0
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- wiring

    def attach(self, manager) -> None:
        """Watch one ``IncidentManager`` (and annotate its bundles).
        Subscribes when the manager supports it; either way the manager
        is rescanned every pass, so cooldown-deferred incidents retry."""
        with self._lock:
            if any(m is manager for m in self._managers):
                return
            if len(self._managers) >= 64:
                return  # a fleet watches dozens of managers, not thousands
            self._managers.append(manager)
        sub = getattr(manager, "subscribe", None)
        if sub is not None:
            sub(lambda inc, _m=manager: self._on_incident(_m, inc))

    def set_fleet_view(self, fn: Callable[[], list]) -> None:
        """Optional fleet-merged incident source (the ``/fleet/
        incidents`` merge): open entries whose id no attached manager
        holds still get playbooks run (quarantine, proposals); bundle
        annotation is attempted on every attached manager and skipped
        gracefully for truly remote origins."""
        self._fleet_view = fn

    def set_forecast(self, storm, per_replica_qps: float,
                     deployment: str, t0: Optional[float] = None) -> None:
        """Arm predictive prescale: ``storm`` is the seeded
        ``faults.StormFaultConfig`` (its rate envelope is deterministic),
        ``per_replica_qps`` the calibrated sustainable rate of one
        replica, ``t0`` the monotonic time the storm starts (defaults to
        now)."""
        with self._lock:
            self._forecast = (storm, self._clock() if t0 is None else t0,
                              max(1e-9, float(per_replica_qps)),
                              str(deployment))

    def clear_forecast(self) -> None:
        with self._lock:
            self._forecast = None
            self._last_floor.clear()

    # ---------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="remediator")
        self._thread.start()

    def stop(self) -> None:
        """Stop the thread after one final pass so already-classified
        incidents still get their annotation before shutdown."""
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
            self._thread = None
        try:
            self._process(self._clock())
        except Exception:  # noqa: BLE001 — shutdown must not raise
            pass

    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(timeout=self.config.poll_interval_s)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self._process(self._clock())
            except Exception:  # noqa: BLE001 — the loop must not crash
                pass

    def _on_incident(self, manager, inc: dict) -> None:
        """Subscription callback — runs on the MANAGER's thread, so it
        must stay O(1): enqueue the id, wake the remediator."""
        try:
            with self._lock:
                self._queue.append((manager, inc.get("id")))
            self._wake.set()
        except Exception:  # noqa: BLE001 — pragma: no cover (defensive)
            pass

    # ------------------------------------------------------------ readers

    def status(self) -> dict:
        """The ``GET /fleet/remediation`` body: recent decisions,
        quarantine state, rails accounting."""
        with self._lock:
            recent = [dict(a) for a in self._recent]
            tracked = len(self._tracked)
            managers = len(self._managers)
            forecast_on = self._forecast is not None
        return {"dry_run": self.config.dry_run,
                "managers": managers,
                "tracked_incidents": tracked,
                "escalations": self.escalations,
                "human_actions": self.human_actions,
                "forecast_armed": forecast_on,
                "quarantine": self.quarantine.list(),
                "actions": recent}

    # ------------------------------------------------------------ processing

    def _process(self, now: float) -> None:
        """One remediation pass: drain the subscription queue, rescan
        every attached manager (retries after cooldown; catches
        incidents classified before attach), sweep the fleet-merged
        view, probe quarantined tiers, run the predictive forecast,
        prune guard state.  Tests call this with an explicit clock."""
        with self._lock:
            self._queue.clear()  # the rescan below covers every id
            managers = list(self._managers)
        seen_ids = set()
        for mgr in managers:
            try:
                incs = mgr.list()
            except Exception:  # noqa: BLE001 — a dead manager must not
                continue       # take the controller down
            for inc in incs:
                if inc.get("state") != "open":
                    continue
                seen_ids.add(inc.get("id"))
                self._consider(mgr, inc, now)
        fleet = self._fleet_view
        if fleet is not None:
            try:
                entries = fleet() or []
            except Exception:  # noqa: BLE001
                entries = []
            for inc in entries:
                if (inc.get("state") == "open"
                        and inc.get("id") not in seen_ids):
                    self._consider(None, inc, now)
        self._probe_tiers(now)
        self._forecast_tick(now)
        self._prune(now)

    def _consider(self, mgr, inc: dict, now: float) -> None:
        inc_id = inc.get("id") or ""
        cause = inc.get("cause") or "unknown"
        playbook = CAUSE_PLAYBOOK.get(cause, "observe")
        target = self._target_of(inc, cause)
        key = (cause, target)
        with self._lock:
            rec = self._tracked.get(inc_id)
            if (rec is not None and rec.get("cause") == cause
                    and rec.get("status") in ("done", "escalated")):
                return  # already answered under this classification
            # flap guard: sticky escalation for the window, and a fresh
            # escalation when the executed-action history crosses the bar
            esc_at = self._escalated_keys.get(key)
            sticky = (esc_at is not None
                      and now - esc_at <= self.config.flap_window_s)
            hist = self._flap_hist.get(key) or ()
            recent_n = sum(1 for t in hist
                           if now - t <= self.config.flap_window_s)
            if not sticky and recent_n >= self.config.flap_max:
                self._escalated_keys[key] = now
                sticky = True
        if sticky:
            self._escalate(mgr, inc_id, cause, playbook, target)
            return
        with self._lock:
            # per-playbook cooldown + global rate budget: deferred, not
            # dropped — the rescan retries next pass, and sustained
            # starvation escalates instead of leaving the bundle open
            cooling = (now - self._last_fired.get(playbook, -1e18)
                       < self.config.cooldown_s)
            budget_spent = sum(1 for t in self._action_times
                               if now - t <= self.config.rate_window_s)
            throttled = cooling or budget_spent >= self.config.rate_budget
            if throttled:
                rec = self._tracked.setdefault(
                    inc_id, {"playbook": playbook, "cause": cause,
                             "status": "deferred", "deferrals": 0})
                rec["deferrals"] = rec.get("deferrals", 0) + 1
                over = rec["deferrals"] > self.config.defer_max
                first_defer = rec["deferrals"] == 1
                self._tracked.move_to_end(inc_id)
        if throttled:
            if over:
                with self._lock:
                    self._escalated_keys[key] = now
                self._escalate(mgr, inc_id, cause, playbook, target,
                               why="action rails starved this incident")
            elif first_defer:
                # name the PLANNED action in the bundle immediately: an
                # incident can resolve on its own while the rails hold
                # the playbook back, and a postmortem bundle with no
                # remediation record at all reads as "nobody looked"
                self._record(mgr, inc_id, cause, target, playbook,
                             "deferred", "deferred",
                             {"reason": "cooldown/rate budget holding "
                                        "the playbook; retried next "
                                        "pass"})
            return
        outcome, status, detail = self._execute(playbook, inc, target, now)
        with self._lock:
            self._last_fired[playbook] = now
            self._action_times.append(now)
            dq = self._flap_hist.setdefault(
                key, collections.deque(maxlen=32))
            dq.append(now)
            self._tracked[inc_id] = {"playbook": playbook, "cause": cause,
                                     "status": "done", "deferrals": 0}
            self._tracked.move_to_end(inc_id)
        self._record(mgr, inc_id, cause, target, playbook, outcome,
                     status, detail)

    def _escalate(self, mgr, inc_id: str, cause: str, playbook: str,
                  target: str, why: str = "") -> None:
        self.escalations += 1
        INCIDENTS_ESCALATED.inc(cause=cause)
        with self._lock:
            self._tracked[inc_id] = {"playbook": "needs_human",
                                     "cause": cause,
                                     "status": "escalated", "deferrals": 0}
            self._tracked.move_to_end(inc_id)
        detail = {"instead_of": playbook,
                  "reason": why or (f"flap guard: {playbook} repeated on "
                                    f"({cause}, {target}) within "
                                    f"{self.config.flap_window_s:g}s")}
        self._record(mgr, inc_id, cause, target, "needs_human",
                     "escalated", "escalated", detail)

    def _record(self, mgr, inc_id: str, cause: str, target: str,
                playbook: str, outcome: str, status: str,
                detail: dict) -> None:
        REMEDIATION_ACTIONS.inc(playbook=playbook, outcome=outcome)
        action = {"wall": time.time(), "incident": inc_id, "cause": cause,
                  "target": target, "playbook": playbook,
                  "outcome": outcome, "detail": detail,
                  "dry_run": self.config.dry_run}
        with self._lock:
            self._recent.append(action)
            managers = list(self._managers)
        annotate = getattr(mgr, "annotate_remediation", None)
        if annotate is not None:
            annotate(inc_id, action, status=status)
            return
        # fleet-view entry: the origin manager is unknown — offer the
        # annotation to every attached manager; remote origins simply
        # decline (the action still lives in the /fleet/remediation log)
        for m in managers:
            fn = getattr(m, "annotate_remediation", None)
            if fn is not None and fn(inc_id, action, status=status):
                return

    # ------------------------------------------------------------ playbooks

    def _execute(self, playbook: str, inc: dict, target: str,
                 now: float) -> tuple:
        """-> (outcome, bundle status, detail).  Dry-run resolves the
        full plan (targets, floors, roles) and stops short of every
        actuator call."""
        try:
            if playbook == "replace_replica":
                return self._pb_replace_replica(inc, target)
            if playbook == "split_roles":
                return self._pb_split_roles(inc, target)
            if playbook == "prescale":
                return self._pb_prescale(inc, target)
            if playbook == "quarantine_tier":
                return self._pb_quarantine(inc, now)
            return ("executed", "observing",
                    {"note": "unknown cause: watch, act on nothing"})
        except Exception as e:  # noqa: BLE001 — a playbook crash is a
            # skipped action, never a dead controller
            return ("skipped", "failed", {"error": str(e)[:200]})

    def _pb_replace_replica(self, inc: dict, target: str) -> tuple:
        ejected = sorted({str(s.get("backend"))
                          for s in (inc.get("symptoms") or ())
                          if s.get("kind") == "breaker_open"
                          and s.get("backend") is not None})
        detail: dict = {"ejected_backends": ejected,
                        "ejection_confirmed": bool(ejected)}
        deploys = self._owned_deployments(target)
        if not deploys:
            detail["reason"] = f"no deployment resolved for {target!r}"
            return "skipped", "failed", detail
        if self.autoscaler is None:
            detail["reason"] = "no autoscaler attached"
            return "skipped", "failed", detail
        plans = []
        for d in deploys:
            current = int((d.get("spec") or {}).get("replicas", 1))
            floor = current + max(1, self.config.prewarm_extra)
            plans.append({"deployment": d["metadata"]["name"],
                          "current": current, "proposed_floor": floor})
        detail["proposals"] = plans
        if self.config.dry_run:
            return "dry_run", "dry_run", detail
        for p in plans:
            self.autoscaler.propose_floor(
                p["deployment"], p["proposed_floor"],
                ttl_s=self.config.proposal_ttl_s,
                reason=f"replace_replica:{inc.get('id')}")
        return "executed", "in_flight", detail

    def _pb_split_roles(self, inc: dict, target: str) -> tuple:
        if self.api is None:
            return "skipped", "failed", {"reason": "no api attached"}
        if not self._disagg_routed():
            # the router only sends traffic to prefill-role pods through
            # the disagg split path — on a fleet with no disagg-routed
            # Service, flipping roles just removes replicas from the
            # unified pool (measured by the --campaign bench: the storm
            # tail rode one replica).  Refusing IS the remediation here.
            return ("skipped", "failed",
                    {"reason": "no disagg-routed Service (annotation "
                               "auto/all): flipping roles would only "
                               "shrink the unified pool"})
        unified = []
        for p in self.api.list("Pod"):
            if not pod_is_ready(p):
                continue
            if pod_role(p) == "unified":
                unified.append(p)
        unified.sort(key=lambda p: p["metadata"]["name"])
        if len(unified) < 2:
            # flipping the last unified replica would leave NO pool able
            # to serve the complementary phase — decode capacity survives
            # or the split does not happen
            return ("skipped", "failed",
                    {"reason": "insufficient unified pool",
                     "unified": len(unified)})
        flips = [{"pod": unified[0]["metadata"]["name"], "role": "prefill"},
                 {"pod": unified[1]["metadata"]["name"], "role": "decode"}]
        detail = {"flips": flips}
        if self.config.dry_run:
            return "dry_run", "dry_run", detail
        for f, pod in zip(flips, unified[:2]):
            self.api.patch(
                "Pod", f["pod"],
                {"metadata": {"annotations": {ROLE_ANNOTATION: f["role"]}}},
                pod["metadata"].get("namespace", "default"))
        return "executed", "in_flight", detail

    def _disagg_routed(self) -> bool:
        """True when some Service routes the disagg split (annotation
        auto/all) — the precondition for prefill-role pods to receive
        any traffic at all."""
        for svc in self.api.list("Service"):
            ann = (svc.get("metadata") or {}).get("annotations") or {}
            if ann.get(DISAGG_ANNOTATION, "off") in ("auto", "all"):
                return True
        return False

    def _pb_prescale(self, inc: dict, target: str) -> tuple:
        deploys = self._owned_deployments(target)
        if not deploys:
            return ("skipped", "failed",
                    {"reason": f"no deployment resolved for {target!r}"})
        if self.autoscaler is None:
            return "skipped", "failed", {"reason": "no autoscaler attached"}
        plans = []
        for d in deploys:
            current = int((d.get("spec") or {}).get("replicas", 1))
            plans.append({"deployment": d["metadata"]["name"],
                          "current": current,
                          "proposed_floor": current + 1})
        detail = {"proposals": plans, "mode": "reactive"}
        if self.config.dry_run:
            return "dry_run", "dry_run", detail
        for p in plans:
            self.autoscaler.propose_floor(
                p["deployment"], p["proposed_floor"],
                ttl_s=self.config.proposal_ttl_s,
                reason=f"prescale:{inc.get('id')}")
        return "executed", "in_flight", detail

    def _pb_quarantine(self, inc: dict, now: float) -> tuple:
        tier = TIER_FOR_CAUSE.get(inc.get("cause") or "")
        if tier is None:
            return "skipped", "failed", {"reason": "no tier for cause"}
        detail = {"tier": tier}
        if self.quarantine.active(tier):
            detail["note"] = "tier already quarantined (idempotent)"
            return "executed", "in_flight", detail
        if self.config.dry_run:
            return "dry_run", "dry_run", detail
        self.quarantine.quarantine(tier, reason=str(inc.get("id")))
        self._probe_at[tier] = now + self.config.probe_interval_s
        return "executed", "in_flight", detail

    # ----------------------------------------------------- background duties

    def _probe_tiers(self, now: float) -> None:
        """Health-probe-gated un-quarantine: each active tier is probed
        on its own cadence; ``healthy_probes`` consecutive healthy reads
        lift it.  Default probe (when none is registered): every
        attached manager is quiet for the tier's cause — the fault's own
        incident resolving IS the recovery signal."""
        for tier in list(self.quarantine.list()):
            if now < self._probe_at.get(tier, 0.0):
                continue
            self._probe_at[tier] = now + self.config.probe_interval_s
            probe = self.quarantine.probe_for(tier)
            if probe is None:
                probe = lambda _t=tier: self._tier_quiet(_t)
            try:
                healthy = bool(probe())
            except Exception:  # noqa: BLE001 — a crashing probe reads
                healthy = False  # as unhealthy, never as recovered
            if self.quarantine.note_probe(tier, healthy):
                self._record(None, "", "", tier, "quarantine_tier",
                             "lifted", "in_flight",
                             {"tier": tier,
                              "healthy_probes": self.quarantine
                              .healthy_probes})

    def _tier_quiet(self, tier: str) -> bool:
        cause = {v: k for k, v in TIER_FOR_CAUSE.items()}.get(tier)
        with self._lock:
            managers = list(self._managers)
        for mgr in managers:
            try:
                incs = mgr.list()
            except Exception:  # noqa: BLE001
                continue
            for inc in incs:
                if (inc.get("state") == "open"
                        and inc.get("cause") == cause):
                    return False
        return True

    def _forecast_tick(self, now: float) -> None:
        """Predictive prescale: propose the floor the NEXT
        ``forecast_horizon_s`` of the seeded storm envelope needs,
        re-proposed only when the forecast floor CHANGES (the dedup is
        this path's damper; incident-response rails stay untouched —
        this is a standing control signal, not a reaction)."""
        with self._lock:
            fc = self._forecast
        if fc is None or self.autoscaler is None:
            return
        storm, t0, per_replica_qps, deployment = fc
        elapsed = now - t0
        if elapsed < 0 or elapsed > float(storm.duration_s):
            return
        peak = forecast_peak_qps(storm, elapsed,
                                 self.config.forecast_horizon_s)
        floor = max(1, math.ceil(
            peak * self.config.forecast_headroom / per_replica_qps))
        with self._lock:
            prev = self._last_floor.get(deployment)
            changed = prev != floor
            if changed:
                self._last_floor[deployment] = floor
        if not changed:
            return
        detail = {"mode": "forecast", "deployment": deployment,
                  "t_s": round(elapsed, 3),
                  "peak_qps": round(peak, 3),
                  "proposed_floor": floor}
        if not self.config.dry_run:
            self.autoscaler.propose_floor(
                deployment, floor, ttl_s=self.config.proposal_ttl_s,
                reason=f"forecast@{elapsed:.2f}s")
        self._record(None, "", "capacity", deployment, "prescale",
                     "dry_run" if self.config.dry_run else "proposed",
                     "dry_run" if self.config.dry_run else "in_flight",
                     detail)

    def _prune(self, now: float) -> None:
        with self._lock:
            for key in list(self._flap_hist):
                dq = self._flap_hist[key]
                while dq and now - dq[0] > self.config.flap_window_s:
                    dq.popleft()
                if not dq:
                    del self._flap_hist[key]
            for key in list(self._escalated_keys):
                if now - self._escalated_keys[key] \
                        > self.config.flap_window_s:
                    del self._escalated_keys[key]
            while len(self._tracked) > self.config.max_tracked:
                self._tracked.popitem(last=False)

    # ------------------------------------------------------------- helpers

    @staticmethod
    def _target_of(inc: dict, cause: str) -> str:
        tier = TIER_FOR_CAUSE.get(cause)
        if tier is not None:
            return tier
        scope = str(inc.get("scope") or "")
        _, _, name = scope.partition(":")
        return name or scope or "fleet"

    def _owned_deployments(self, target: str) -> list:
        """Resolve the Deployments a playbook proposes floors for: the
        service's owned-deployments annotation when ``target`` names a
        Service, a Deployment by name, else — for engine-scope incidents
        that carry no service identity — every autoscaled Deployment
        (the safe over-approximation: proposals are floors, clamped by
        maxReplicas, and expire)."""
        if self.api is None:
            return []
        deploys = {d["metadata"]["name"]: d
                   for d in self.api.list("Deployment")}
        if target in deploys:
            return [deploys[target]]
        svc = None
        for s in self.api.list("Service"):
            if s["metadata"]["name"] == target:
                svc = s
                break
        if svc is not None:
            ann = svc["metadata"].get("annotations", {})
            try:
                names = json.loads(
                    ann.get(DEPLOYMENT_FOR_SERVICE_ANNOTATION, "[]"))
            except (ValueError, TypeError):
                names = []
            owned = [deploys[n] for n in names if n in deploys]
            if owned:
                return owned
        from .api import TARGET_CONCURRENCY_ANNOTATION
        return [d for d in deploys.values()
                if TARGET_CONCURRENCY_ANNOTATION
                in d["metadata"].get("annotations", {})]
