"""Concurrency autoscaler — the in-process Knative KPA.

A copy of ``kubeflow_tpu/serving/autoscaler.py``.

Upstream analogue (UNVERIFIED, SURVEY.md §3.4): Knative's pod autoscaler,
which scrapes queue-proxy concurrency metrics and drives the revision's
Deployment, including scale-to-zero.  Here the model server itself exposes the
``inflight_requests`` gauge (serving/server.py /metrics); this ticker scrapes
ready pods, computes desired = ceil(total_inflight / target), and patches
``spec.replicas`` within [minReplicas, maxReplicas].

Scale-down is damped (a stability window) and scale-to-zero additionally
waits for `grace` seconds of zero traffic; the router's activator path
(router.py) un-zeroes on the next request.

Fleet robustness (README "Fleet robustness"): the scrape timeout is
configurable (constructor arg + per-deployment annotation) and a scrape
that times out is a STALE SAMPLE — the last known-good reading is reused
inside a short staleness window, and beyond it the pod counts as
"unscraped", which vetoes every scale-down decision (missing data can hide
load, never invent it).  Replicas whose engine reports non-SERVING health
also veto scale-down: shrinking the fleet while part of it is sick would
cut below SLO-safe capacity.  Draining pods (controllers.DRAINING_
ANNOTATION) are exiting and count toward neither capacity nor load.
"""

from __future__ import annotations

import collections
import math
import re
import threading
import time
import urllib.request
from typing import Optional

from ..core.api import APIServer, Obj
from . import transport
from .api import (
    GROUP,
    MAX_REPLICAS_ANNOTATION,
    MIN_REPLICAS_ANNOTATION,
    SCALE_TO_ZERO_GRACE_ANNOTATION,
    TARGET_CONCURRENCY_ANNOTATION,
)
from .controllers import (DRAINING_ANNOTATION, SCALED_TO_ZERO_ANNOTATION,
                          pod_is_ready, pod_port)

DEFAULT_SCALE_TO_ZERO_GRACE = 1.5  # seconds (simulator timescale)
SCALE_DOWN_WINDOW = 1.0
ACTIVATED_AT_ANNOTATION = "serving.kubeflow.org/activated-at"
SCRAPE_TIMEOUT_ANNOTATION = f"{GROUP}/scrape-timeout"
DEFAULT_SCRAPE_TIMEOUT_S = 0.25
# ---- SLO-driven scaling (the engine's read-only slo_view becomes an
# actuator).  Opt-in per deployment via the slo-scaling
# annotation — the concurrency policy stays the default.  The governing
# metric follows the pool's disaggregation role (disagg.ROLE_ANNOTATION on
# the pod template): a PREFILL pool is judged on TTFT attainment (its
# whole job is first tokens), a DECODE pool on TPOT attainment (steady
# inter-token latency is what it protects), unified pools on TTFT.  A
# worst-replica attainment below the objective scales the pool UP one
# replica per sync (and vetoes scale-down); recovery hands control back
# to the concurrency policy, whose normal damped path scales back down.
SLO_SCALING_ANNOTATION = f"{GROUP}/slo-scaling"
SLO_OBJECTIVE_ANNOTATION = f"{GROUP}/slo-objective"
DEFAULT_SLO_OBJECTIVE = 0.99
_ROLE_SLO_METRIC = {"prefill": "ttft", "decode": "tpot",
                    "unified": "ttft"}
# how long a cached last-known-good sample may stand in for a timed-out
# scrape before the pod counts as unscraped (scale-down veto)
STALE_SAMPLE_WINDOW_S = 2.0
# how long persistent replica unhealthiness keeps vetoing scale-down: the
# veto protects SLO capacity through TRANSIENT sickness (watchdog restart,
# degraded retry), but a terminally dead engine on a still-ready pod must
# not pin the fleet size forever — past this window scaling resumes
UNHEALTHY_VETO_WINDOW_S = 30.0
# ---- incident plane (README "Incident plane") ----------------------------
# flap detection: this many scale-DIRECTION flips inside the window feeds a
# ``flap`` event into the incident manager (classified "capacity" — an
# oscillating scaler is a capacity-control fault, and the postmortem bundle
# cites the scale history a responder otherwise greps logs for); edge-
# triggered once per window so a sustained oscillation is one incident
FLAP_WINDOW_S = 10.0
FLAP_FLIPS = 3
# how long the open-incident scale-down veto may hold before scaling
# resumes anyway (README "Self-driving fleet"): the veto protects
# capacity through a fault story, but an incident nobody can remediate
# (and that refuses to resolve) must not pin the fleet size forever —
# the same bounded-veto posture as UNHEALTHY_VETO_WINDOW_S
INCIDENT_VETO_MAX_HOLD_S = 60.0

# slo_attainment_ratio{class="...",metric="...",model="..."} sample keys in
# a scraped exposition (the engine registry's per-class SLO gauges,
# serving/slo.py) — collected READ-ONLY into the autoscaler's slo_view for
# now: ROADMAP item 4 scales replicas on p99-TTFT attainment per class,
# and this is that exact input signal; the scaling decision itself is a
# later PR, deliberately decoupled from landing the signal plane.
# The lookahead regex is safe here ONLY because both label values are
# engine-controlled identifiers (normalized priority classes and the
# fixed slo.SLO_METRICS names) that can never contain quotes/escapes;
# free-form label values need core.metrics.parse_exposition instead.
_SLO_SAMPLE_RE = re.compile(
    r'^slo_attainment_ratio\{(?=[^}]*class="(?P<cls>[^"]*)")'
    r'(?=[^}]*metric="(?P<metric>[^"]*)")[^}]*\}$')


def scrape_metrics(port: int, timeout: float = DEFAULT_SCRAPE_TIMEOUT_S) -> Optional[dict]:
    try:
        # pooled keepalive scrape (README "Ingress data plane"): the
        # load/health scrape loops reuse one persistent socket per
        # replica instead of a TCP dial per poll
        text = transport.get(port, "/metrics", timeout=timeout).decode()
    except Exception:  # noqa: BLE001
        return None
    out = {}
    for line in text.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        # split on the LAST space: the value never contains one, but a
        # label VALUE can (model names ride in via add_const_labels), and
        # truncating the key there would silently drop the series
        k, _, v = line.rpartition(" ")
        try:
            out[k] = float(v)
        except ValueError:
            pass
    return out


class ConcurrencyAutoscaler:
    def __init__(self, api: APIServer,
                 scrape_timeout: float = DEFAULT_SCRAPE_TIMEOUT_S,
                 incidents=None):
        self.api = api
        self.scrape_timeout = scrape_timeout
        # incident plane (README "Incident plane"), both directions:
        # the scaler FEEDS flap events into this manager (usually the
        # service proxy's ingress-scope one), and READS its open-incident
        # state — scale-down is vetoed while any incident is open, the
        # same "missing/bad data must not shrink capacity" posture as the
        # unscraped and unhealthy vetoes.  None = plane off.
        self.incidents = incidents
        self._scale_dirs: dict[str, collections.deque] = {}
        self._flap_fired: dict[str, float] = {}
        # per-deployment uid: time the current lower desired value was first seen
        self._downscale_since: dict[str, tuple[int, float]] = {}
        self._last_traffic: dict[str, float] = {}
        # pod UID -> (monotonic scrape time, sample): last known-good
        # readings, reused for STALE_SAMPLE_WINDOW_S on a scrape timeout.
        # Keyed by uid, not name: a recreated pod must NOT inherit its
        # predecessor's reading and dodge the unscraped veto.  Pruned to
        # live pods every sync.
        self._samples: dict[str, tuple[float, dict]] = {}
        self._live_uids: set = set()
        # deployment uid -> monotonic time unhealthiness was first seen
        # (bounds the unhealthy scale-down veto)
        self._unhealthy_since: dict[str, float] = {}
        # deployment uid -> {(class, metric): worst attainment across
        # replicas} — the SLO signal plane, read-only for now (see
        # _SLO_SAMPLE_RE); surfaced via slo_view()
        self._slo_view: dict[str, dict] = {}
        # deployment uid -> {pod uid: last engine_requests_rejected
        # total}: a GROWING count means the pool is refusing admissions
        # (EngineOverloaded / ingress shedding downstream of it) — demand
        # the inflight gauge cannot see, because refused requests never
        # become inflight.  Tracked PER POD so a pod dropping out of one
        # scrape and back in (timeout blip — exactly when the fleet is
        # loaded) doesn't read its whole cumulative history as fresh
        # growth and ratchet replicas up.  README "Overload control".
        self._rejected_last: dict[str, dict] = {}
        # deployment uid -> wall time every replica was first seen ready (the
        # scale-to-zero grace counts from it too, so a request the
        # activator holds for a pod that took longer than the grace to
        # start still reaches it); dropped while a replica is not ready
        self._ready_since: dict[str, float] = {}
        # ---- single-writer arbitration (README "Self-driving fleet"):
        # the remediator PROPOSES replica floors here (remediator.py);
        # _autoscale folds unexpired proposals into desired exactly like
        # the rejected-counter and SLO actuators, and _scale() stays the
        # ONLY writer of spec.replicas — the two controllers can never
        # duel.  Proposals expire (TTL) and are pruned per sync, so a
        # dead remediator cannot pin fleet size.  Written from the
        # remediator thread, read on the sync thread.
        self._prop_lock = threading.Lock()
        self._proposals: dict = {}  # guarded-by: _prop_lock
        # deployment uid -> monotonic time the open-incident veto first
        # held (bounds the veto at INCIDENT_VETO_MAX_HOLD_S)
        self._incident_hold_since: dict[str, float] = {}

    def sync(self) -> bool:
        changed = False
        self._live_uids = set()
        deploy_uids = set()
        live_names = set()
        for deploy in self.api.list("Deployment"):
            live_names.add(deploy["metadata"]["name"])
            ann = deploy["metadata"].get("annotations", {})
            if TARGET_CONCURRENCY_ANNOTATION not in ann:
                continue
            deploy_uids.add(deploy["metadata"]["uid"])
            if self._autoscale(deploy, ann):
                changed = True
        # drop cached samples for pods that no longer exist (recreated pods
        # get fresh uids; deleted deployments stop accumulating entries);
        # same pruning for the SLO view — a deleted deployment must not
        # haunt slo_view() as a phantom violator
        for uid in list(self._samples):
            if uid not in self._live_uids:
                del self._samples[uid]
        for uid in list(self._slo_view):
            if uid not in deploy_uids:
                del self._slo_view[uid]
        # flap-detector state follows the same churn rule: a recreated
        # deployment gets a fresh uid, and dead uids must not accumulate
        for uid in list(self._scale_dirs):
            if uid not in deploy_uids:
                del self._scale_dirs[uid]
                self._flap_fired.pop(uid, None)
        for uid in list(self._rejected_last):
            if uid not in deploy_uids:
                del self._rejected_last[uid]
        for uid in list(self._ready_since):
            if uid not in deploy_uids:
                del self._ready_since[uid]
        for uid in list(self._incident_hold_since):
            if uid not in deploy_uids:
                del self._incident_hold_since[uid]
        # drop expired / orphaned remediation proposals
        now_mono = time.monotonic()
        with self._prop_lock:
            for name in list(self._proposals):
                if (self._proposals[name][1] <= now_mono
                        or name not in live_names):
                    del self._proposals[name]
        return changed

    # ---- remediation proposals (single-writer arbitration) ----------------

    def propose_floor(self, deployment: str, replicas: int,
                      ttl_s: float = 30.0, reason: str = "") -> None:
        """The remediator's ONLY way to move replica counts: propose a
        floor for one Deployment.  The next sync folds it into desired
        (never above maxReplicas, never below what load already wants)
        and ``_scale()`` — this class — applies it; the proposal expires
        after ``ttl_s``.  Idempotent per deployment: the newest proposal
        wins."""
        with self._prop_lock:
            self._proposals[str(deployment)] = (
                int(replicas), time.monotonic() + float(ttl_s),
                str(reason))

    def proposals(self) -> dict:
        """Unexpired remediation proposals, for status surfaces:
        ``{deployment: {"floor": n, "expires_in_s": t, "reason": r}}``."""
        now = time.monotonic()
        with self._prop_lock:
            return {name: {"floor": floor,
                           "expires_in_s": round(exp - now, 3),
                           "reason": reason}
                    for name, (floor, exp, reason)
                    in self._proposals.items() if exp > now}

    def _proposal_floor(self, deployment: str) -> Optional[int]:
        now = time.monotonic()
        with self._prop_lock:
            prop = self._proposals.get(deployment)
            if prop is None or prop[1] <= now:
                return None
            return prop[0]

    def _autoscale(self, deploy: Obj, ann: dict) -> bool:
        target = max(1.0, float(ann[TARGET_CONCURRENCY_ANNOTATION]))
        min_r = int(ann.get(MIN_REPLICAS_ANNOTATION, 1))
        max_r = int(ann.get(MAX_REPLICAS_ANNOTATION, 3)) or 10**9
        grace = float(ann.get(SCALE_TO_ZERO_GRACE_ANNOTATION, DEFAULT_SCALE_TO_ZERO_GRACE))
        ns = deploy["metadata"].get("namespace", "default")
        uid = deploy["metadata"]["uid"]
        current = int(deploy["spec"].get("replicas", 1))

        scrape_timeout = float(ann.get(SCRAPE_TIMEOUT_ANNOTATION,
                                       self.scrape_timeout))
        selector = (deploy["spec"].get("selector") or {}).get("matchLabels") or {}
        pods = self.api.list("Pod", namespace=ns, label_selector=selector)
        inflight = 0.0
        engine_load = 0.0
        ready = 0
        unscraped = 0
        unhealthy = 0
        rejected_by_pod: dict = {}
        slo_worst: dict = {}
        last_traffic = self._last_traffic.get(uid, 0.0)
        now_mono = time.monotonic()
        for p in pods:
            if DRAINING_ANNOTATION in p["metadata"].get("annotations", {}):
                continue  # exiting: neither capacity nor load
            if not pod_is_ready(p):
                continue
            ready += 1
            pod_uid = p["metadata"]["uid"]
            self._live_uids.add(pod_uid)
            port = pod_port(p)
            m = scrape_metrics(port, timeout=scrape_timeout) if port else None
            if m is None:
                # scrape timed out: a STALE SAMPLE, not a zero reading —
                # reuse the last known-good scrape inside the staleness
                # window; past it the pod's traffic state is UNKNOWN.
                # Scale-UP must still work (overload is exactly when
                # scrapes fail); only scale-DOWN is vetoed below.
                cached = self._samples.get(pod_uid)
                if cached is None or now_mono - cached[0] > STALE_SAMPLE_WINDOW_S:
                    unscraped += 1
                    continue
                m = cached[1]
            else:
                self._samples[pod_uid] = (now_mono, m)
            inflight += m.get("inflight_requests", 0.0)
            # engine replicas (VERDICT r2 #7): queued + active generation
            # requests are the true demand — one HTTP predict can carry many
            # prompts, so HTTP inflight alone under-reports engine backlog
            engine_load += (m.get("engine_queue_depth", 0.0)
                            + m.get("engine_active_slots", 0.0))
            if "engine_requests_rejected" in m:
                rejected_by_pod[pod_uid] = m["engine_requests_rejected"]
            # engine health surface: a ready pod whose engine is not
            # SERVING (watchdog-dead, degraded-restarting) is not SLO-safe
            # capacity — it vetoes scale-down below
            if "engine_serving" in m and m["engine_serving"] < 1.0:
                unhealthy += 1
            # SLO attainment per (class, metric), worst replica wins —
            # collected only; scaling stays concurrency-driven this PR
            for k, v in m.items():
                sm = _SLO_SAMPLE_RE.match(k)
                if sm is not None:
                    key = (sm.group("cls"), sm.group("metric"))
                    slo_worst[key] = min(slo_worst.get(key, 1.0), v)
            last_traffic = max(last_traffic, m.get("last_request_timestamp", 0.0))
        self._last_traffic[uid] = last_traffic
        self._slo_view[uid] = slo_worst

        if current > 0 and ready == current:
            self._ready_since.setdefault(uid, time.time())
        else:
            self._ready_since.pop(uid, None)
        if current == 0:
            return False  # activation is the router's job

        now = time.time()
        ready_since = self._ready_since.get(uid, now)
        effective = max(inflight, engine_load)
        desired = math.ceil(effective / target) if effective > 0 else 0
        desired = max(desired, min_r, 0)
        desired = min(desired, max_r)

        # overload-pressure actuator (README "Overload control"): growing
        # engine_requests_rejected totals mean admissions are being
        # REFUSED — demand the inflight/backlog gauges structurally
        # under-report (a rejected request never becomes load).  Growth
        # is judged per pod against that pod's OWN last reading, so a
        # pod absent from one scrape (timeout blip — exactly when the
        # fleet is loaded) contributes nothing when it returns instead
        # of replaying its whole cumulative history as fresh growth.
        # One replica per sync, same damped shape as the SLO actuator;
        # the counters going quiet hand control straight back.
        prev_rejected = self._rejected_last.get(uid, {})
        self._rejected_last[uid] = rejected_by_pod
        if any(total > prev_rejected[p]
               for p, total in rejected_by_pod.items()
               if p in prev_rejected):
            desired = max(desired, min(current + 1, max_r))

        # SLO actuator (opt-in): worst-replica attainment of the pool's
        # role metric below the objective raises desired one replica above
        # current — and, below, vetoes scale-down while the burn lasts.
        slo_violated = False
        if (str(ann.get(SLO_SCALING_ANNOTATION, "")).strip().lower()
                in ("1", "true", "yes", "on")):
            tmpl_ann = (((deploy["spec"].get("template") or {})
                         .get("metadata") or {}).get("annotations") or {})
            from .disagg import ROLE_ANNOTATION

            role = tmpl_ann.get(ROLE_ANNOTATION) \
                or ann.get(ROLE_ANNOTATION) or "unified"
            metric = _ROLE_SLO_METRIC.get(role, "ttft")
            try:
                objective = float(ann.get(SLO_OBJECTIVE_ANNOTATION,
                                          DEFAULT_SLO_OBJECTIVE))
            except ValueError:
                objective = DEFAULT_SLO_OBJECTIVE
            vals = [v for (cls, m), v in slo_worst.items() if m == metric]
            if vals and min(vals) < objective:
                slo_violated = True
                desired = max(desired, min(current + 1, max_r))

        # remediation proposal fold (single-writer arbitration, README
        # "Self-driving fleet"): an unexpired floor proposed by the
        # remediator raises desired — clamped to maxReplicas, never
        # lowered below what load already wants — and the _scale() call
        # below remains the ONLY spec.replicas writer in the fleet
        prop = self._proposal_floor(deploy["metadata"]["name"])
        if prop is not None:
            desired = max(desired, min(prop, max_r))

        if desired > current:
            self._downscale_since.pop(uid, None)
            return self._scale(deploy, desired, zero=False)

        if slo_violated:
            # already at max_r (or a single-replica floor): hold — a pool
            # burning its error budget must never shrink, and the damped
            # downscale window must not keep counting through the burn
            self._downscale_since.pop(uid, None)
            return False

        if self.incidents is not None and desired < current:
            # an OPEN incident means the fleet is mid-fault (failover
            # burst, degradation storm, burn): shrinking capacity while
            # the story is still unfolding is how outages compound.
            # Refined by the remediation plane (README "Self-driving
            # fleet"): only incidents with NO remediation in flight
            # veto — one whose playbook is already executing is being
            # handled, and holding capacity hostage to it would fight
            # the very remediation fixing it.  The veto is also bounded
            # at INCIDENT_VETO_MAX_HOLD_S: incidents auto-resolve after
            # their quiet window, but a pathologically re-firing one
            # must not pin the fleet size forever.
            count = getattr(self.incidents, "unremediated_open_count",
                            self.incidents.open_count)
            if count() > 0:
                first = self._incident_hold_since.setdefault(uid, now)
                if now - first < INCIDENT_VETO_MAX_HOLD_S:
                    self._downscale_since.pop(uid, None)
                    return False
            else:
                self._incident_hold_since.pop(uid, None)

        if unhealthy:
            # any UNHEALTHY replica means the fleet's real capacity is
            # below its replica count — shrinking it further would cut
            # below SLO-safe capacity, so scale-down is vetoed... but only
            # for UNHEALTHY_VETO_WINDOW_S: a terminally dead engine on a
            # still-ready pod (nothing here replaces pods) must not pin
            # the fleet size forever.
            first = self._unhealthy_since.setdefault(uid, now)
            if now - first < UNHEALTHY_VETO_WINDOW_S:
                self._downscale_since.pop(uid, None)
                return False
        else:
            self._unhealthy_since.pop(uid, None)
        if unscraped:
            # missing data can only hide load, never invent it: with any
            # unscraped pod the true desired can be higher but not lower,
            # so scale-down (incl. to zero) is off the table this round
            self._downscale_since.pop(uid, None)
            return False

        floor = max(min_r, 1)
        if desired < current:
            if current > floor:
                # damp: shrink toward floor after a stability window
                seen = self._downscale_since.get(uid)
                if seen is None or seen[0] != desired:
                    self._downscale_since[uid] = (desired, now)
                elif now - seen[1] >= SCALE_DOWN_WINDOW:
                    self._downscale_since.pop(uid, None)
                    return self._scale(deploy, max(desired, floor), zero=False)
            if (
                min_r == 0
                and inflight == 0
                and ready == current  # pods still starting: an activation is in flight
                and (last_traffic == 0.0 or now - last_traffic >= grace)
                and now - float(ann.get(ACTIVATED_AT_ANNOTATION, 0.0)) >= grace
                and now - ready_since >= grace  # the activated pod's request lands first
                and _age(deploy) >= grace
            ):
                return self._scale(deploy, 0, zero=True)
        return False

    def slo_view(self) -> dict:
        """Read-only per-deployment SLO attainment, worst replica per
        (class, metric): ``{deployment_uid: {(class, metric):
        attainment}}``.  This is ROADMAP item 4's autoscaling input —
        exposed now so dashboards/operators (and the eventual SLO-driven
        scaler) read one coherent view; no scaling decision consumes it
        yet."""
        return {uid: dict(v) for uid, v in self._slo_view.items()}

    def _note_scale(self, uid: str, name: str, direction: int) -> None:
        """Flap detector: record the scale direction and feed a ``flap``
        incident event when the direction flips FLAP_FLIPS times inside
        FLAP_WINDOW_S (up/down/up thrash — the autoscaler fighting
        itself or an oscillating load signal)."""
        now = time.monotonic()
        dq = self._scale_dirs.setdefault(uid,
                                         collections.deque(maxlen=16))
        dq.append((now, direction))
        recent = [d for t, d in dq if now - t <= FLAP_WINDOW_S]
        flips = sum(1 for a, b in zip(recent, recent[1:]) if a != b)
        if (flips >= FLAP_FLIPS
                and now - self._flap_fired.get(uid, -1e9) > FLAP_WINDOW_S):
            self._flap_fired[uid] = now
            if self.incidents is not None:
                self.incidents.feed("flap", deployment=name, flips=flips,
                                    window_s=FLAP_WINDOW_S, trace_ids=[])

    def _scale(self, deploy: Obj, replicas: int, zero: bool) -> bool:
        current = int(deploy["spec"].get("replicas", 1))
        if replicas != current:
            self._note_scale(deploy["metadata"]["uid"],
                             deploy["metadata"]["name"],
                             1 if replicas > current else -1)
        ann_patch = {SCALED_TO_ZERO_ANNOTATION: "true" if zero else None}
        self.api.patch(
            "Deployment",
            deploy["metadata"]["name"],
            {"spec": {"replicas": replicas}, "metadata": {"annotations": ann_patch}},
            deploy["metadata"].get("namespace", "default"),
        )
        return True


def _age(deploy: Obj) -> float:
    return time.time() - deploy["metadata"].get("creationTimestamp", 0.0)
