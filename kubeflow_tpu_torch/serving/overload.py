"""Ingress overload-control plane (README "Overload control").

A copy of ``kubeflow_tpu/serving/overload.py``, over the port's
``serving/slo.py``.

The fleet can *measure* a traffic storm (SLO burn rates, queue depth,
incident classification) and *react* to one (role scaling, failover),
but nothing stood between the storm and the engines: every request was
relayed, queued, prefilled — and then shed with ``EngineOverloaded`` or
``DeadlineExceeded`` after the work was already spent.  Sarathi-Serve
(PAPERS.md) shows the throughput-latency tradeoff must be actively
managed under load; JetStream's off-critical-path discipline says where
that management may run.  This module is the shed-at-ingress decision
layer the service proxy consults BEFORE relaying anything:

  * **Per-tenant token-bucket quotas** — tenant from ``X-Tenant-Id`` (or
    a ``tenant`` body field; legacy traffic lands on the default
    tenant).  Buckets refill at a *weighted fair share* of the global
    admission rate: the share is recomputed over the tenants active in
    the last ``active_window_s``, so a lone tenant gets the whole rate
    (work-conserving) and contending tenants split it by weight — the
    storm hog is throttled to its share, the small tenant keeps its.
  * **Adaptive concurrency limit (AIMD)** — additive-increase while the
    limit is actually in use, multiplicative-decrease when the overload
    signal trips: worst-replica SLO burn (fed from the router's existing
    replica scrapes — the same ``slo_burn_rate`` series the SloTracker
    exports), a queue-wait gradient (observed queue+TTFT p50 rising a
    multiple above its rolling floor), or engine-side 503s leaking
    through.  At the limit, requests shed **lowest SLO class first**:
    each class sheds at its own fraction of the limit (best_effort
    first, interactive last).
  * **Deadline-aware early rejection** — a request whose ``deadline_s``
    cannot cover the observed per-class p50 queue+TTFT is refused before
    any prefill is spent on it.  Guarded by a sample floor so it can
    never fire on a quiet service.
  * **Staged brownout** — degrade service *quality* before availability,
    entered/exited on pressure hysteresis (sustained above the stage
    threshold to enter, below half of it to exit): stage 1 clamps
    ``max_tokens``, stage 2 additionally disables speculation drafting
    and the ingress fabric/disagg optimizations, stage 3 additionally
    defers fleet-fabric publishes.  Stage changes and shed bursts feed
    the incident plane as a self-resolving ``capacity`` evidence source.

Every shed answers ``429`` with a jittered, load-proportional
``Retry-After`` and a machine-readable reason — never a hang, never a
doomed relay.  Everything here is host-side and O(1) per admission
(bucket refill + a few deque reads); the heavier AIMD/brownout update is
amortized to once per ``adjust_interval_s``.

Determinism: every public entry takes an explicit ``now`` so tests
drive quota refill, AIMD convergence and brownout hysteresis with
synthetic clocks; the Retry-After jitter draws from one seeded RNG.
"""

from __future__ import annotations

import dataclasses
import random
import threading
from typing import Optional

from .slo import RollingLatency

# deliberately import-light: the serving package's __init__ pulls the
# router, the router pulls this module, and every POD subprocess imports
# the serving package at startup — a numpy/engine import here adds ~1s
# to every pod's cold start, which is enough to blow the activation
# grace window on scale-from-zero (found by test_isvc_scale_to_zero).
# The class list mirrors engine/scheduler.py PRIORITY_CLASSES; the
# conformance assertion below keeps them from drifting without paying
# the import at module load (the scheduler pulls in the engine side).
PRIORITY_CLASSES = ("interactive", "batch", "best_effort")
PRIORITY_RANK = {name: i for i, name in enumerate(PRIORITY_CLASSES)}

# admission-refusal reasons (the 429 body's machine-readable ``reason``
# and the ``ingress_shed_total{reason}`` label)
SHED_REASONS = ("quota", "concurrency", "deadline")

# tenant id for requests that carry none — legacy traffic keeps working,
# it just shares one bucket
DEFAULT_TENANT = "default"

# brownout stage -> what degrades at that stage (README "Overload
# control"; the router applies 1-2 at the ingress, the engine honors the
# per-request ``parameters.brownout`` for 2-3)
BROWNOUT_STAGES = {
    0: "normal service",
    1: "max_tokens clamped",
    2: "+ speculation drafting off, fabric/disagg placement off",
    3: "+ fleet-fabric publishes deferred",
}
MAX_BROWNOUT_STAGE = 3

# What brownout must NEVER degrade, at any stage (README "Structured
# output"): the grammar mask of a constrained request.  Brownout sheds
# OPTIMIZATIONS — drafting, placement, publishes — and clamps budgets; a
# clamped constrained request ends "truncated" (a legal prefix), still
# never an invalid byte.  Dropping the mask would turn load into SILENT
# CONTRACT VIOLATIONS — a tool-call consumer cannot tell overload-shaped
# garbage from a model bug.  tests/test_constrain.py pins this list
# against the engine's behavior; extend it rather than special-casing.
BROWNOUT_NEVER_DEGRADES = ("grammar_mask",)


@dataclasses.dataclass(frozen=True)
class OverloadConfig:
    """Frozen overload-control knobs (one per Service, parsed from the
    ``serving.kubeflow.org/overload`` annotation's JSON value).

    ``rate`` <= 0 disables quotas; ``limit`` <= 0 disables the adaptive
    concurrency limiter; both off leaves only deadline early-rejection
    and brownout (which an explicit ``brownout: false`` disables too)."""

    # ---- per-tenant quotas ------------------------------------------
    rate: float = 0.0          # global admission rate, cost units/s
    burst_s: float = 2.0       # bucket capacity = fair-share rate * this
    weights: tuple = ()        # ((tenant, weight), ...); absent = 1.0
    active_window_s: float = 5.0  # tenant counts toward shares this long
    # ---- adaptive concurrency limiter (AIMD) ------------------------
    limit: int = 0             # initial concurrency limit (0 = off)
    min_limit: int = 1
    max_limit: int = 1024
    add_step: float = 1.0      # additive increase per adjust interval
    md_factor: float = 0.7     # multiplicative decrease on overload
    adjust_interval_s: float = 0.25
    burn_high: float = 2.0     # worst-replica burn above this = overload
    burn_ttl_s: float = 5.0    # scraped burn samples stay fresh this long
    # catastrophic-queueing backstop: observed queue+TTFT p50 this many
    # multiples above its rolling floor = overload.  The floor is the
    # UNQUEUED first-token time (prefill only), so healthy limiter-bound
    # queueing already reads several x — the primary overload signal is
    # the worst-replica SLO burn above; this one exists for fleets with
    # no SLO series configured
    queue_gradient_x: float = 20.0
    gradient_min_samples: int = 8
    # fraction of the limit at which each class sheds — lowest SLO class
    # first (best_effort gives way before batch before interactive)
    class_headroom: tuple = (("interactive", 1.0), ("batch", 0.9),
                             ("best_effort", 0.75))
    # ---- deadline-aware early rejection -----------------------------
    deadline_reject: bool = True
    deadline_min_samples: int = 8   # p50 over fewer samples never rejects
    deadline_safety_x: float = 1.0  # reject when deadline < p50 * this
    ttfb_window_s: float = 30.0     # rolling window for the p50/floor
    # ---- 429 Retry-After --------------------------------------------
    retry_after_base_s: float = 0.25
    retry_after_max_s: float = 10.0
    # ---- staged brownout --------------------------------------------
    brownout: bool = True
    brownout_max_tokens: int = 32   # stage >= 1 clamps max_tokens here
    # pressure thresholds entering stages 1..3 (pressure 1.0 = the AIMD
    # overload signal exactly at its trip point); exit at enter * exit_ratio
    brownout_enter: tuple = (1.0, 2.0, 4.0)
    brownout_exit_ratio: float = 0.5
    brownout_hold_s: float = 1.0    # sustain above/below before moving
    # ---- incident-plane event throttle ------------------------------
    incident_interval_s: float = 1.0  # shed events aggregate to 1/s
    seed: int = 0

    def __post_init__(self):
        for cls, _h in self.class_headroom:
            if cls not in PRIORITY_CLASSES:
                raise ValueError(
                    f"unknown class_headroom class {cls!r} "
                    f"(known: {PRIORITY_CLASSES})")
        if not 0.0 < self.md_factor < 1.0:
            raise ValueError(
                f"md_factor must be in (0, 1), got {self.md_factor}")
        if len(self.brownout_enter) != MAX_BROWNOUT_STAGE or any(
                b <= a for a, b in zip(self.brownout_enter,
                                       self.brownout_enter[1:])):
            raise ValueError(
                "brownout_enter must be 3 strictly-increasing pressure "
                f"thresholds, got {self.brownout_enter}")

    @classmethod
    def from_json(cls, raw: dict) -> "OverloadConfig":
        """Build from the annotation's JSON object.  Unknown keys raise —
        a typo'd knob silently left at default is how a storm finds the
        one service whose shedding was never actually configured."""
        if not isinstance(raw, dict):
            raise ValueError(f"overload config must be an object, "
                             f"got {raw!r}")
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(raw) - fields)
        if unknown:
            raise ValueError(f"unknown overload config keys {unknown} "
                             f"(known: {sorted(fields)})")
        kw = dict(raw)
        if isinstance(kw.get("weights"), dict):
            kw["weights"] = tuple(sorted(
                (str(t), float(w)) for t, w in kw["weights"].items()))
        if isinstance(kw.get("class_headroom"), dict):
            kw["class_headroom"] = tuple(sorted(
                (str(c), float(h))
                for c, h in kw["class_headroom"].items()))
        if isinstance(kw.get("brownout_enter"), list):
            kw["brownout_enter"] = tuple(
                float(x) for x in kw["brownout_enter"])
        return cls(**kw)


@dataclasses.dataclass
class Decision:
    """One admission verdict.  ``admitted`` False carries the 429
    surface (reason + retry_after_s); True carries the brownout stage
    the router must apply and a ticket for ``release()``."""

    admitted: bool
    reason: Optional[str] = None      # SHED_REASONS member when refused
    retry_after_s: float = 0.0
    stage: int = 0                    # brownout stage at admission
    tenant: str = DEFAULT_TENANT
    cls: str = "interactive"
    detail: str = ""
    # this tenant's bucket level after the verdict (None when quotas are
    # off) — the ingress_tenant_tokens gauge source, carried here so the
    # router never re-enters the controller lock just to read a gauge
    tokens_left: Optional[float] = None


class _Bucket:
    __slots__ = ("tokens", "refilled_at")

    def __init__(self, tokens: float, now: float):
        self.tokens = tokens
        self.refilled_at = now


class OverloadController:
    """One service's overload-control state (lives on the proxy's
    ``_ProxyState``; guarded by its own lock — admission must not
    contend with the relay's routing lock)."""

    def __init__(self, config: Optional[OverloadConfig] = None,
                 now: Optional[float] = None):
        import time

        self.config = config or OverloadConfig()
        now = time.monotonic() if now is None else now
        self._lock = threading.Lock()
        self._rng = random.Random(self.config.seed)
        self._weights = dict(self.config.weights)
        self._headroom = dict(self.config.class_headroom)
        self._buckets: dict[str, _Bucket] = {}
        self._last_seen: dict[str, float] = {}
        # AIMD limiter state
        self.limit = float(self.config.limit or 0)
        self.inflight = 0
        self._last_adjust = now
        self._burn: dict[int, tuple[float, float]] = {}  # port -> (t, burn)
        self._engine_overloads = 0  # 503s observed since last adjust
        # observed queue+TTFT (proxy-side, per class + aggregate) — the
        # deadline early-reject estimator AND the queue-wait gradient
        self._ttfb: dict[str, RollingLatency] = {
            c: RollingLatency(window_s=self.config.ttfb_window_s)
            for c in PRIORITY_CLASSES}
        self._ttfb_all = RollingLatency(
            window_s=max(60.0, self.config.ttfb_window_s))
        # per-class p50 queue+TTFT cache, refreshed once per amortized
        # adjust pass — the deadline gate reads THIS, not the rolling
        # window directly: a sort per admission under the lock would
        # serialize request threads at exactly the storm rates the
        # controller exists for.  {cls: (in_window_count, p50)}
        self._p50_cache: dict[str, tuple[int, Optional[float]]] = {}
        # brownout hysteresis
        self.stage = 0
        self.pressure = 0.0
        self._above_since: Optional[float] = None  # next stage's enter
        self._below_since: Optional[float] = None  # current stage's exit
        # counters + incident-event aggregation
        self.admitted_total = 0
        self.shed_total = 0
        self.shed_by: dict[tuple, int] = {}        # (cls, reason) -> n
        self.tenant_admitted: dict[str, int] = {}
        self.tenant_shed: dict[str, int] = {}
        self._events: list = []                    # drained by the proxy
        self._pruned_tenants: list = []            # gauge-series cleanup
        self._shed_since_event = 0
        self._last_shed_event = -1e9

    # ------------------------------------------------------------ signals

    def note_burn(self, port: int, burn: float, now: float) -> None:
        """Worst-replica SLO burn feed — the router calls this whenever
        its load scrape sees ``slo_burn_rate`` samples (one shared scrape,
        no extra fan-out; the series IS the SloTracker's export)."""
        with self._lock:
            self._burn[port] = (now, float(burn))

    def observe_ttfb(self, cls: str, seconds: float, now: float) -> None:
        """Observed queue+TTFT for one completed request (the engine's
        ``X-TTFT-S`` response surface, or the stream's final record)."""
        with self._lock:
            lat = self._ttfb.get(cls)
            if lat is not None:
                lat.observe(seconds, now)
            self._ttfb_all.observe(seconds, now)

    # ---------------------------------------------------------- admission

    def admit(self, tenant: Optional[str], cls: Optional[str], cost: float,  # graftlint: hot-path
              deadline_s: Optional[float], now: float) -> Decision:
        """The one hot-path entry: refill this tenant's bucket, run the
        three refusal gates (quota -> concurrency -> deadline), and
        either take an inflight slot or answer the 429 surface."""
        c = self.config
        tenant = tenant or DEFAULT_TENANT
        cls = cls if cls in PRIORITY_RANK else "interactive"
        with self._lock:
            self._maybe_adjust(now)
            self._last_seen[tenant] = now
            # 1. tenant quota ------------------------------------------
            if c.rate > 0:
                share = self._share_rate(tenant, now)
                # the cap is the SHARE's burst allowance, never inflated
                # by a request's own cost — and a request costing more
                # than the cap admits into DEBT (tokens go negative,
                # paid back at the share rate) instead of waiting for an
                # accumulation the cap would clamp away: without debt, a
                # mixed-size tenant's large prompts livelock behind its
                # own small traffic, shed with a Retry-After that can
                # never be honored
                cap = max(1.0, share * c.burst_s)
                b = self._buckets.get(tenant)
                if b is None:
                    b = self._buckets[tenant] = _Bucket(cap, now)
                else:
                    b.tokens = min(cap, b.tokens
                                   + (now - b.refilled_at) * share)
                    b.refilled_at = now
                need = min(cost, cap)
                if b.tokens < need:
                    wait = (need - b.tokens) / max(1e-9, share)
                    d = self._shed(
                        tenant, cls, "quota", now, base_wait=wait,
                        detail=f"tenant {tenant!r} over its fair-share "
                               f"rate {share:.1f}/s")
                    d.tokens_left = round(b.tokens, 2)
                    return d
            # 2. adaptive concurrency limit ----------------------------
            if self.limit > 0:
                eff = max(c.min_limit,
                          self.limit * self._headroom.get(cls, 1.0))
                if self.inflight >= eff:
                    return self._shed(
                        tenant, cls, "concurrency", now,
                        detail=f"inflight {self.inflight} >= "
                               f"{eff:.0f} ({cls} share of limit "
                               f"{self.limit:.0f})")
            # 3. deadline-aware early rejection (amortized estimator:
            # the per-class p50 comes from the cache _maybe_adjust
            # refreshed, at most adjust_interval_s stale)
            if (deadline_s is not None and c.deadline_reject
                    and deadline_s > 0):
                n, p50 = self._p50_cache.get(cls, (0, None))
                if (n >= c.deadline_min_samples and p50 is not None
                        and deadline_s < p50 * c.deadline_safety_x):
                    return self._shed(
                        tenant, cls, "deadline", now, base_wait=p50,
                        detail=f"deadline {deadline_s:.3f}s < "
                               f"observed p50 queue+TTFT {p50:.3f}s")
            # admitted --------------------------------------------------
            level = None
            if c.rate > 0:
                b = self._buckets[tenant]
                b.tokens -= cost
                level = round(b.tokens, 2)
            self.inflight += 1
            self.admitted_total += 1
            self.tenant_admitted[tenant] = \
                self.tenant_admitted.get(tenant, 0) + 1
            return Decision(admitted=True, stage=self.stage,
                            tenant=tenant, cls=cls, tokens_left=level)

    def release(self, decision: Decision, ok: bool,  # graftlint: hot-path
                ttfb_s: Optional[float], now: float,
                engine_overloaded: bool = False) -> None:
        """Finish one admitted request: free the inflight slot, feed the
        queue+TTFT estimator, and count engine-side 503s that leaked
        through (direct overload evidence for the next AIMD pass)."""
        with self._lock:
            self.inflight = max(0, self.inflight - 1)
            if engine_overloaded:
                self._engine_overloads += 1
            if ok and ttfb_s is not None and ttfb_s >= 0:
                lat = self._ttfb.get(decision.cls)
                if lat is not None:
                    lat.observe(ttfb_s, now)
                self._ttfb_all.observe(ttfb_s, now)

    # --------------------------------------------------- internal: shedding

    def _shed(self, tenant: str, cls: str, reason: str, now: float,
              base_wait: float = 0.0, detail: str = "") -> Decision:
        """Caller holds the lock.  Build the 429 surface: jittered,
        load-proportional Retry-After (more load -> back off longer) and
        an aggregated incident event at most once per interval."""
        c = self.config
        load = (self.inflight / self.limit) if self.limit > 0 else 1.0
        ra = max(c.retry_after_base_s * max(1.0, load), base_wait)
        ra = min(c.retry_after_max_s, ra)
        ra *= self._rng.uniform(0.7, 1.3)  # desynchronize retries
        self.shed_total += 1
        self.shed_by[(cls, reason)] = self.shed_by.get((cls, reason), 0) + 1
        self.tenant_shed[tenant] = self.tenant_shed.get(tenant, 0) + 1
        self._shed_since_event += 1
        if now - self._last_shed_event >= c.incident_interval_s:
            # capacity evidence (README "Incident plane"): ONE aggregated
            # event per interval — the manager's debounce coalesces the
            # storm into one incident, and this throttle keeps the
            # symptom chain from being one entry per refused request
            self._last_shed_event = now
            self._events.append({
                "kind": "shed", "reason": reason,
                "shed": self._shed_since_event,
                "shed_total": self.shed_total, "stage": self.stage,
                "inflight": self.inflight,
                "limit": round(self.limit, 1), "trace_ids": []})
            self._shed_since_event = 0
        return Decision(admitted=False, reason=reason,
                        retry_after_s=round(ra, 3), stage=self.stage,
                        tenant=tenant, cls=cls, detail=detail)

    # ------------------------------------------------ internal: fair shares

    def _share_rate(self, tenant: str, now: float) -> float:
        """This tenant's current fair share of the global rate: weight
        over the sum of ACTIVE tenants' weights (work-conserving — an
        idle fleet hands a lone tenant the whole rate)."""
        c = self.config
        cutoff = now - c.active_window_s
        active = sum(self._weights.get(t, 1.0)
                     for t, seen in self._last_seen.items()
                     if seen >= cutoff)
        w = self._weights.get(tenant, 1.0)
        if active <= 0:
            active = w
        return c.rate * w / active

    # --------------------------------------------- internal: AIMD + brownout

    def _overload_signal(self, now: float) -> tuple[float, list]:
        """Caller holds the lock.  The unified pressure score: 1.0 =
        exactly at the overload trip point.  Returns (pressure, causes)
        where causes name which signals contributed (evidence for the
        snapshot + incident bundles)."""
        c = self.config
        causes = []
        pressure = 0.0
        cutoff = now - c.burn_ttl_s
        burns = [b for t, b in self._burn.values() if t >= cutoff]
        if burns:
            worst = max(burns)
            pressure = max(pressure, worst / max(1e-9, c.burn_high))
            if worst > c.burn_high:
                causes.append(f"slo_burn {worst:.1f} > {c.burn_high:g}")
        # the queue-wait gradient is the FALLBACK for fleets with no SLO
        # series to burn: its floor is the unqueued first-token time, so
        # host noise inflates it far more easily than a burn computed
        # against operator targets — when fresh burn data exists, burn
        # is the signal and the gradient stays out of the vote
        if not burns and self._ttfb_all.count(
                now, window=c.ttfb_window_s) >= c.gradient_min_samples:
            p50 = self._ttfb_all.quantile(0.5, now,
                                          window=c.ttfb_window_s)
            floor = self._ttfb_all.minimum(now)
            if p50 is not None and floor is not None and floor > 0:
                grad = p50 / floor
                pressure = max(pressure, grad / c.queue_gradient_x)
                if grad > c.queue_gradient_x:
                    causes.append(f"queue_wait gradient {grad:.1f}x > "
                                  f"{c.queue_gradient_x:g}x floor")
        if self._engine_overloads:
            # an engine-side 503 means the limiter let too much through:
            # always past the trip point, scaled by how many leaked
            pressure = max(pressure, 1.0 + 0.1 * self._engine_overloads)
            causes.append(f"{self._engine_overloads} engine 503s "
                          "leaked through")
        return pressure, causes

    def _maybe_adjust(self, now: float) -> None:
        """Caller holds the lock.  The amortized control pass: AIMD the
        concurrency limit, walk the brownout stage machine."""
        c = self.config
        if now - self._last_adjust < c.adjust_interval_s:
            return
        self._last_adjust = now
        # refresh the deadline gate's per-class p50 cache (the one
        # O(samples log samples) read, paid here instead of per request)
        for cls, lat in self._ttfb.items():
            n = lat.count(now)
            self._p50_cache[cls] = (n, lat.quantile(0.5, now) if n else None)
        # bound the per-tenant state: buckets/activity for tenants idle
        # past several active windows contribute nothing to fair shares
        # (and an idle bucket refills to cap anyway) — without the sweep
        # a storm of unique X-Tenant-Ids grows the dicts forever and
        # every admission's share sum walks all of it under the lock
        cutoff = now - 10.0 * c.active_window_s
        for t in [t for t, seen in self._last_seen.items()
                  if seen < cutoff]:
            del self._last_seen[t]
            self._buckets.pop(t, None)
            # the router mirrors bucket levels into the
            # ingress_tenant_tokens gauge — it must drop those series
            # with the bucket or a unique-tenant storm leaks one
            # metric series per tenant forever (drained via
            # drain_pruned_tenants)
            self._pruned_tenants.append(t)
        if len(self.tenant_admitted) + len(self.tenant_shed) > 2048:
            # evidence counters for long-gone tenants fold into one
            # aggregate row — a unique-tenant-per-request storm must not
            # grow the snapshot without bound either
            live = set(self._last_seen)
            for d in (self.tenant_admitted, self.tenant_shed):
                for t in [t for t in d
                          if t not in live and t != "(pruned)"]:
                    d["(pruned)"] = d.get("(pruned)", 0) + d.pop(t)
        pressure, causes = self._overload_signal(now)
        self.pressure = round(pressure, 3)
        if self.limit > 0:
            if pressure > 1.0:
                self.limit = max(float(c.min_limit),
                                 self.limit * c.md_factor)
            elif self.inflight >= 0.8 * self.limit:
                # only grow a limit that is actually binding — an idle
                # service must not drift to max and lose its reflexes
                self.limit = min(float(c.max_limit),
                                 self.limit + c.add_step)
        self._engine_overloads = 0
        if c.brownout:
            self._walk_brownout(pressure, now)

    def _walk_brownout(self, pressure: float, now: float) -> None:
        """Caller holds the lock.  Hysteresis: enter stage N after
        ``brownout_hold_s`` sustained above its threshold, exit after
        the same hold below ``threshold * exit_ratio`` — a pressure
        blip neither browns out nor flaps a live brownout off."""
        c = self.config
        enter = c.brownout_enter
        # entering the NEXT stage up
        if self.stage < MAX_BROWNOUT_STAGE \
                and pressure >= enter[self.stage]:
            if self._above_since is None:
                self._above_since = now
            elif now - self._above_since >= c.brownout_hold_s:
                self._set_stage(self.stage + 1, pressure)
                self._above_since = None
        else:
            self._above_since = None
        # exiting the CURRENT stage
        if self.stage > 0 \
                and pressure < enter[self.stage - 1] * c.brownout_exit_ratio:
            if self._below_since is None:
                self._below_since = now
            elif now - self._below_since >= c.brownout_hold_s:
                self._set_stage(self.stage - 1, pressure)
                self._below_since = None
        else:
            self._below_since = None

    def _set_stage(self, stage: int, pressure: float) -> None:
        """Caller holds the lock.  Stage transitions always emit an
        incident event (they are rare by construction — the hysteresis
        hold bounds the rate)."""
        prev, self.stage = self.stage, stage
        self._events.append({
            "kind": "brownout", "stage": stage, "from_stage": prev,
            "pressure": round(pressure, 3),
            "action": BROWNOUT_STAGES[stage], "trace_ids": []})

    # ------------------------------------------------------------- readers

    def drain_events(self) -> list:
        """Incident-plane events accumulated since the last drain (the
        proxy feeds each into the service's IncidentManager)."""
        with self._lock:
            out, self._events = self._events, []
            return out

    def drain_pruned_tenants(self) -> list:
        """Tenants whose buckets were pruned since the last drain — the
        router removes their ingress_tenant_tokens series."""
        with self._lock:
            out, self._pruned_tenants = self._pruned_tenants, []
            return out

    def tenant_tokens(self) -> dict:
        """Current bucket levels per tenant — the
        ``ingress_tenant_tokens`` gauge source."""
        with self._lock:
            return {t: round(b.tokens, 2) for t, b in self._buckets.items()}

    def snapshot(self, now: Optional[float] = None) -> dict:
        """Evidence view for incident bundles and GET /fleet surfaces:
        the numbers a storm postmortem cites — shed counts by class and
        reason, brownout stage, the live limit, tenant pressure."""
        import time

        now = time.monotonic() if now is None else now
        with self._lock:
            pressure, causes = self._overload_signal(now)
            return {
                "stage": self.stage,
                "stage_action": BROWNOUT_STAGES[self.stage],
                "pressure": round(pressure, 3),
                "pressure_causes": causes,
                "limit": round(self.limit, 1),
                "inflight": self.inflight,
                "admitted_total": self.admitted_total,
                "shed_total": self.shed_total,
                "shed_by": {f"{cls}:{reason}": n
                            for (cls, reason), n
                            in sorted(self.shed_by.items())},
                # the deadline gate's per-class queue+TTFT p50 — the
                # latency attribution plane cross-checks this against
                # its waterfall-derived figure (GET /fleet/latency);
                # the two measure the same quantity independently
                "deadline_p50": {cls: round(p50, 6)
                                 for cls, (n, p50)
                                 in sorted(self._p50_cache.items())
                                 if p50 is not None},
                "tenants": {
                    t: {"admitted": self.tenant_admitted.get(t, 0),
                        "shed": self.tenant_shed.get(t, 0),
                        "tokens": round(self._buckets[t].tokens, 2)
                        if t in self._buckets else None}
                    for t in sorted(set(self.tenant_admitted)
                                    | set(self.tenant_shed))},
            }
