"""Serving telemetry: request lifecycle spans, engine histograms, the
flight recorder and the on-demand profiler.

Counterpart of ``kubeflow_tpu/serving/engine/telemetry.py``.
``EngineTelemetry``, ``RequestSpan`` and ``FlightRecorder`` are copies (the
same metric names, buckets and JSONL dump format); ``TickProfiler`` drives
``torch.profiler`` where the JAX package drives ``jax.profiler``.

  * ``EngineTelemetry`` — a per-engine ``core.metrics.Registry`` holding
    the serving histograms: TTFT, TPOT (inter-token), queue-wait,
    tick-duration, prefill-batch-size, plus KV-page-occupancy gauges and a
    requests-total counter by outcome.  The model server renders the
    registry into ``/metrics`` verbatim (Prometheus text exposition).
  * ``RequestSpan`` — one per request: monotonic (perf_counter) phase marks
    from queued through admitted/prefill/first_token to a terminal outcome.
    Exposed live via ``Engine.trace(rid)`` and, opt-in, as an
    ``X-Request-Trace`` response field on the generate surfaces.
  * ``FlightRecorder`` — a bounded ring buffer of structured tick events
    (phase, slots, dispatch shape, duration, outcome).  The engine dumps it
    as JSONL on TickFailure escalation, NaN-guard trips, and watchdog
    restarts, so a chaos-test failure or a production incident leaves a
    readable postmortem instead of nothing.
  * ``TickProfiler`` — ``Engine.trace_n_ticks(n, dir)`` captures a
    ``torch.profiler`` trace (CPU and CUDA activities) of exactly n live
    work ticks, started and stopped on the loop thread at tick boundaries,
    and writes it into ``dir`` as a Chrome trace.

Everything here is host-side, allocation-light, and lock-scoped so the
decode hot loop pays microseconds when telemetry is on and a boolean check
when it is off.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
import threading
import time
from typing import Optional

from ...core import tracing
from ...core.metrics import Registry

# Latency-class buckets (seconds).  TTFT/queue-wait span sub-ms CPU ticks up
# to cold-compile minutes; TPOT/tick-duration are per-step and an order of
# magnitude tighter.
LATENCY_BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                     0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
STEP_BUCKETS_S = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                  0.25, 0.5, 1.0, 2.5)
BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
# Inter-dispatch host gap (pipelined decode): the time the host
# spends between handing the device one decode dispatch and the next.  The
# whole point of the pipeline is to push this toward zero, so the buckets
# reach well below STEP_BUCKETS_S — a sync loop's gap includes the blocking
# sample readback (~device step time), a pipelined loop's is bookkeeping.
GAP_BUCKETS_S = (0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                 0.01, 0.025, 0.05, 0.1, 0.25, 1.0)

# Speculative accept-length histogram: accepted draft tokens per
# verify pass, 0..K — the distribution behind the headline accept rate
# (engine_spec_accepted_tokens_total / engine_spec_draft_tokens_total).
# Buckets reach the largest spec_max_draft anyone configures in practice.
SPEC_ACCEPT_BUCKETS = (0, 1, 2, 3, 4, 6, 8, 12, 16)

# Proxy-overhead histogram: wall the serving stack adds
# around the engine.  The floor reaches 10 µs — ROADMAP item 6 wants the
# proxy-added number in µs, and a wire-speed ingress refactor would be
# invisible under ms-scale buckets.
PROXY_OVERHEAD_BUCKETS_S = (0.00001, 0.000025, 0.00005, 0.0001, 0.00025,
                            0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                            0.05, 0.1, 0.25, 1.0)

# terminal span phases (everything else is a lifecycle waypoint)
TERMINAL_PHASES = ("done", "shed", "failed", "cancelled")


class RequestSpan:
    """Per-request lifecycle record: (phase, perf_counter) marks.

    Phases, in order: queued -> admitted -> prefill[xN] -> first_token ->
    done | shed | failed | cancelled.  A preempted request additionally
    cycles through preempted -> readmitted -> (resumed | prefill[xN])
    before its terminal phase.  Mutated only by the submitting thread
    (queued) and the engine loop (everything else), so marks need no lock;
    readers get a copying ``to_dict``.

    Fleet tracing: every span carries a trace identity — the
    ingress-minted W3C-style context when the request arrived with a
    ``traceparent`` header (so the engine span is a child of the relay
    hop that delivered it), a locally-minted trace otherwise.  ``links``
    connect spans across trace boundaries: a failover re-admission links
    the failed relay hop (``resumed_from``), a session's turn N+1 links
    turn N (``session_prev``).

    Latency attribution: ``hints`` accumulates per-request
    attribution seconds the phase marks alone cannot carry — the verify
    share of each decode dispatch, the serve-layer fabric/handoff pull
    walls measured before the span existed (``pre_*``).  ``cls`` is the
    request's priority class, the fleet latency-budget bucket key.
    """

    __slots__ = ("rid", "events", "outcome", "trace_id", "span_id",
                 "parent_id", "links", "hints", "cls")

    def __init__(self, rid: int, trace=None, links=None,
                 cls: Optional[str] = None):
        self.rid = rid
        self.events: list = [("queued", time.perf_counter())]
        self.outcome: Optional[str] = None
        if trace is not None:
            self.trace_id = trace.trace_id
            self.parent_id = trace.span_id
        else:
            self.trace_id = tracing.new_trace_id()
            self.parent_id = None
        self.span_id = tracing.new_span_id()
        self.links: list = list(links or ())
        self.hints: Optional[dict] = None
        self.cls = cls

    def hint(self, name: str, dur_s: float) -> None:  # graftlint: hot-path
        """Accumulate attribution seconds under ``name`` — O(1) dict
        upsert, called from the engine loop per dispatch (waterfall.py
        reads the total at assembly time, off the hot path)."""
        h = self.hints
        if h is None:
            h = self.hints = {}
        h[name] = h.get(name, 0.0) + dur_s

    def mark(self, phase: str) -> float:
        t = time.perf_counter()
        self.events.append((phase, t))
        if phase in TERMINAL_PHASES:
            self.outcome = phase
        return t

    def t(self, phase: str) -> Optional[float]:
        """First mark of ``phase`` (None if never reached)."""
        for p, ts in self.events:
            if p == phase:
                return ts
        return None

    def to_dict(self) -> dict:
        """JSON-safe trace: phases with timestamps relative to submit,
        plus the derived intervals dashboards actually plot."""
        events = list(self.events)
        t0 = events[0][1]
        out = {
            "rid": self.rid,
            "component": "engine",
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "outcome": self.outcome,
            "events": [{"phase": p, "t_s": round(ts - t0, 6)}
                       for p, ts in events],
        }
        if self.links:
            out["links"] = [dict(l) for l in self.links]
        if self.cls is not None:
            out["cls"] = self.cls
        if self.hints:
            out["hints"] = {k: round(v, 6) for k, v in self.hints.items()}
        by = {}
        for p, ts in events:  # first occurrence wins
            by.setdefault(p, ts)
        if "admitted" in by:
            out["queue_wait_s"] = round(by["admitted"] - t0, 6)
        if "first_token" in by:
            out["ttft_s"] = round(by["first_token"] - t0, 6)
        term = next((by[p] for p in TERMINAL_PHASES if p in by), None)
        if term is not None:
            out["latency_s"] = round(term - t0, 6)
        out["prefill_chunks"] = sum(1 for p, _ in events if p == "prefill")
        return out

    def nbytes(self) -> int:
        """Approximate retained size — the trace-history byte budget's
        accounting unit.  Deliberately a cheap closed form (not a real
        serialization): the budget needs proportionality, not precision,
        and this runs on every archive."""
        return (160 + 48 * len(self.events) + 96 * len(self.links)
                + 72 * len(self.hints or ()))


class FlightRecorder:
    """Bounded ring of structured tick events + JSONL postmortem dumps.

    ``record`` is called from the engine loop only; ``snapshot``/``dump``
    from any thread.  Dumps are capped per recorder so a chaos soak cannot
    fill a disk with identical postmortems."""

    def __init__(self, capacity: int = 256, dump_dir: Optional[str] = None,
                 max_dumps: int = 16):
        self._ring: collections.deque = collections.deque(maxlen=max(1, capacity))
        self._lock = threading.Lock()
        self._seq = 0
        self._dumps = 0
        self.max_dumps = max_dumps
        self.dump_dir = (dump_dir or os.environ.get("ENGINE_FLIGHT_DIR")
                         or os.path.join(tempfile.gettempdir(),
                                         "engine_flightrec"))
        self.last_dump_path: Optional[str] = None

    def record(self, **event) -> None:  # graftlint: hot-path
        with self._lock:
            self._seq += 1
            event["seq"] = self._seq
            event["t_s"] = round(time.perf_counter(), 6)
            self._ring.append(event)

    def snapshot(self) -> list:
        with self._lock:
            return list(self._ring)

    def dump(self, reason: str, extra: Optional[dict] = None) -> Optional[str]:
        """Write the ring as JSONL (header line first) and return the path;
        None once the per-recorder dump cap is hit or the write fails —
        postmortems must never take the serving path down with them."""
        with self._lock:
            if self._dumps >= self.max_dumps:
                return None
            self._dumps += 1  # reserve a slot (refunded if the write fails)
            n = self._dumps
            events = list(self._ring)
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            path = os.path.join(
                self.dump_dir, f"flightrec-{os.getpid()}-{n:03d}.jsonl")
            # reserved header keys win over extra (an extra "reason" must
            # not mask what triggered the dump)
            header = {**(extra or {}), "reason": reason,
                      "wall_time": time.time(), "events": len(events)}
            # graftlint: disable=atomic-write -- postmortem ring dump:
            # one-shot JSONL into a fresh per-pid path nothing reads
            # back programmatically; a torn tail is still a readable
            # prefix and the OSError path refunds the dump slot
            with open(path, "w") as f:
                f.write(json.dumps(header) + "\n")
                for e in events:
                    f.write(json.dumps(e) + "\n")
            self.last_dump_path = path
            return path
        except OSError:
            # refund the slot: a transiently full/unwritable disk must not
            # permanently exhaust the cap and silence later real incidents
            with self._lock:
                self._dumps -= 1
            return None


class EngineTelemetry:
    """The engine's metric surface: one Registry per engine (replicas are
    separate processes in production; separate engines in one test process
    must not pollute each other's distributions).  All observe paths no-op
    on ``enabled=False`` so the bench can measure the overhead honestly."""

    def __init__(self, enabled: bool = True,
                 registry: Optional[Registry] = None, slo=None):
        self.enabled = enabled
        self.registry = registry if registry is not None else Registry()
        # SLO attainment tracker (serving/slo.py): fed from the
        # same TTFT/TPOT/queue-wait hooks, exported at scrape time via
        # refresh_slo().  None = no tracking (telemetry-off benches).
        self.slo = slo
        r = self.registry
        self.ttft = r.histogram(
            "engine_ttft_seconds",
            "time from submit to first committed token", LATENCY_BUCKETS_S)
        self.tpot = r.histogram(
            "engine_tpot_seconds",
            "inter-token interval during decode (time per output token)",
            STEP_BUCKETS_S)
        self.queue_wait = r.histogram(
            "engine_queue_wait_seconds",
            "time from submit to slot admission", LATENCY_BUCKETS_S)
        self.tick_duration = r.histogram(
            "engine_tick_duration_seconds",
            "wall time of one engine tick that did work", STEP_BUCKETS_S)
        self.prefill_batch = r.histogram(
            "engine_prefill_batch_size",
            "prompt rows per fused prefill dispatch", BATCH_BUCKETS)
        self.requests_total = r.counter(
            "engine_requests_total", "terminal request outcomes")
        # QoS scheduler surface: preemption counts by reason
        # (priority/pages/pool/chaos) and mode (swap/recompute), KV bytes
        # moved through the host swap store, and queue wait broken out by
        # priority class (the unlabeled engine_queue_wait_seconds above
        # keeps the aggregate series stable for existing dashboards)
        self.preemptions = r.counter(
            "engine_preemptions_total",
            "decode-slot preemptions by reason and mode")
        self.swapped_bytes = r.counter(
            "engine_swapped_bytes_total",
            "KV bytes moved between the device pool and the host swap "
            "store, by direction")
        self.class_queue_wait = r.histogram(
            "engine_class_queue_wait_seconds",
            "time from submit to slot admission, by priority class",
            LATENCY_BUCKETS_S)
        self.kv_occupancy = r.gauge(
            "engine_kv_page_occupancy_ratio",
            "fraction of KV pool pages not free (in use or prefix-cached)")
        self.kv_pages = r.gauge(
            "engine_kv_pages", "KV pool pages by state (free/cached/used)")
        # Pipelined decode surface: the dispatch-gap histogram is
        # the overlap proof (sync mode's gap embeds the blocking sample;
        # pipelined mode's is host bookkeeping only), and the fence counter
        # shows how often roster changes force the pipeline to drain.
        self.dispatch_gap = r.histogram(
            "engine_dispatch_gap_seconds",
            "host-side gap between consecutive decode dispatches "
            "(device idle exposure between steps)", GAP_BUCKETS_S)
        self.pipeline_fences = r.counter(
            "engine_pipeline_fences_total",
            "decode-pipeline drains to a sync barrier, by reason")
        # Speculative decoding surface: drafted vs accepted token
        # totals (their ratio is the accept rate — the factor by which the
        # fused verify path divides per-token host overhead) and the
        # per-verify-pass accept-length distribution.  Counted identically
        # by the sync (depth-0 oracle) and pipelined speculative loops.
        self.spec_draft_tokens = r.counter(
            "engine_spec_draft_tokens_total",
            "prompt-lookup draft tokens proposed to the verify step")
        self.spec_accepted_tokens = r.counter(
            "engine_spec_accepted_tokens_total",
            "draft tokens accepted by greedy verification (excludes the "
            "per-pass bonus token)")
        self.spec_accept_len = r.histogram(
            "engine_spec_accept_len",
            "accepted draft tokens per verify pass with drafts proposed "
            "(0..spec_max_draft)", SPEC_ACCEPT_BUCKETS)
        # Tiered KV store / session surface: per-tier occupancy
        # (set at scrape time from the store's stats), an operations
        # counter labeled by tier and event (spill/evict/verify_fail/...),
        # and session-turn restore outcomes by source — "host" and "disk"
        # are warm hits, "cache" means the device prefix cache already
        # covered the prefix, "cold"/"degraded" are the re-prefill paths
        # (degraded = the store had the session but verification failed).
        self.kv_store_bytes = r.gauge(
            "engine_kv_store_bytes",
            "tiered KV store occupancy in bytes, by tier (host/disk)")
        self.kv_store_events = r.counter(
            "engine_kv_store_events_total",
            "tiered KV store operations by tier and event")
        self.session_restores = r.counter(
            "engine_session_restores_total",
            "session-turn KV restore outcomes by source "
            "(host/disk/cache/cold/degraded)")
        self.session_pins = r.counter(
            "engine_session_pins_total",
            "session pin attempts by outcome (pinned/durable/rejected)")
        # Disaggregated prefill/decode surface (README "Disaggregated
        # serving"): handoff lifecycle outcomes — export / export_failed
        # on the prefill side; pull / pull_refused / expired / miss as the
        # store answers pullers; import / degraded on the decode side
        # (degraded = the verified-KV fast path fell back to re-prefill,
        # which still completes the request) — and payload bytes by
        # direction (out = frames served to pullers, in = frames imported).
        self.kv_handoff = r.counter(
            "engine_kv_handoff_total",
            "disaggregation KV handoff operations by outcome "
            "(export/export_failed/pull/pull_refused/expired/miss/"
            "import/degraded)")
        self.kv_handoff_bytes = r.counter(
            "engine_kv_handoff_bytes_total",
            "disaggregation KV handoff payload bytes by direction "
            "(out=served to pullers, in=imported)")
        # Fleet KV fabric surface (README "Fleet KV fabric"): shared-
        # prefix lifecycle outcomes — publish / publish_skipped /
        # publish_failed on the owner side; pull / miss / expired as the
        # store answers remote pullers (multi-reader: no refused state);
        # import (a placement hint accepted at submit) / hit (remote
        # pages scattered into the local pool) / local (the device cache
        # or session restore already covered everything the frame held) /
        # degraded (any fabric failure fell back to plain re-prefill,
        # which still completes the request) — and payload bytes by
        # direction (out = frames served to pullers, in = frames
        # imported).
        self.kv_fabric = r.counter(
            "engine_kv_fabric_total",
            "fleet KV fabric operations by outcome "
            "(publish/publish_skipped/publish_failed/publish_deferred/"
            "pull/miss/expired/import/hit/local/degraded)")
        self.kv_fabric_bytes = r.counter(
            "engine_kv_fabric_bytes_total",
            "fleet KV fabric payload bytes by direction "
            "(out=frames served to pullers, in=frames imported)")
        # Mesh-sharded KV data plane: host bytes moved through
        # the per-shard snapshot/scatter path — each shard's OWN
        # addressable bytes, never a gathered pool — and the layout
        # outcome of every sharded restore (match = degree-aligned
        # shard-to-shard scatter; reshard = the explicit host-side
        # cross-degree slow path).
        self.kv_shard_bytes = r.counter(
            "engine_kv_shard_bytes_total",
            "per-shard KV snapshot/scatter host bytes by direction "
            "(export=device->host shard blocks, restore=host->device)")
        self.kv_reshard = r.counter(
            "engine_kv_reshard_total",
            "sharded KV restore layout outcomes (match=degree-aligned "
            "shard-to-shard, reshard=host-side cross-degree conversion)")
        # Fleet robustness surface: the engine's health state as a
        # one-hot labeled gauge so dashboards can plot state transitions —
        # the scrape-time complement of the router's active /engine/health
        # probe (refreshed in JetStreamModel.metrics_text).
        self.health_state = r.gauge(
            "engine_health_state",
            "engine health state machine, one-hot by state "
            "(SERVING/DEGRADED/DRAINING/DEAD)")
        # Fleet observability surface: per-class SLO attainment
        # over rolling windows (refreshed at scrape from the SloTracker),
        # multi-window burn rate, and the trace-history eviction counter
        # (RequestSpan history is byte/entry budgeted; evictions here mean
        # the budget is working, a flat 0 on a long run means it's sized
        # right).
        self.slo_attainment = r.gauge(
            "slo_attainment_ratio",
            "fraction of in-window requests meeting their latency target, "
            "by priority class and metric (ttft/tpot/queue_wait)")
        self.slo_burn = r.gauge(
            "slo_burn_rate",
            "error-budget burn rate (1-attainment)/(1-objective), by "
            "class, metric and rolling window")
        self.trace_evictions = r.counter(
            "engine_trace_evictions_total",
            "request spans evicted from the bounded trace history "
            "(entry or byte budget)")
        # Performance introspection plane (perf.py): analytical
        # model FLOPs charged at dispatch time by kind, the waste share by
        # attribution reason (goodput + waste == dispatched by the
        # ledger's construction), and the scrape-time derived gauges —
        # windowed MFU against the platform peak-FLOPs table, windowed
        # goodput ratio, and KV internal fragmentation.  Cache analytics:
        # prefix-cache page outcomes per admission lookup.
        self.flops_total = r.counter(
            "engine_model_flops_total",
            "analytical model FLOPs charged at dispatch, by kind "
            "(prefill/decode/verify)")
        self.wasted_flops = r.counter(
            "engine_wasted_flops_total",
            "dispatched FLOPs attributed to waste, by reason "
            "(spec_reject/preempt_recompute/handoff_degraded/"
            "fabric_degraded/failover_reprefill/tick_retry/pipeline_drop)")
        self.mfu_ratio = r.gauge(
            "engine_mfu_ratio",
            "rolling-window analytical model-FLOPs utilization vs the "
            "platform peak (perf.platform_peak_flops), by platform label")
        self.goodput_ratio = r.gauge(
            "engine_goodput_ratio",
            "rolling-window goodput FLOPs / dispatched FLOPs "
            "(1.0 = nothing wasted)")
        self.kv_fragmentation = r.gauge(
            "engine_kv_fragmentation_ratio",
            "internal fragmentation of live KV pages: 1 - committed "
            "tokens / (owned pages * page_size), set at scrape")
        self.prefix_cache_pages = r.counter(
            "engine_prefix_cache_pages_total",
            "prefix-cache page lookup outcomes at admission "
            "(hit/miss_cold/miss_partial)")
        # Incident plane (README "Incident plane", serving/incidents.py):
        # open incidents right now (set at scrape, right-when-read like
        # the KV gauges), terminal incident count by FINAL classified
        # root cause (counted at resolution, the engine_requests_total
        # terminal-outcome analogy), and raw detector firings (a coalesced
        # burst fires many times but opens ONE incident — the ratio is
        # the debounce working).  The router registers the same three
        # names in the shared core registry for its ingress-scope manager.
        self.incidents_open = r.gauge(
            "incidents_open",
            "open (unresolved) incidents held by this component's "
            "incident manager")
        self.incidents_total = r.counter(
            "incidents_total",
            "resolved incidents by classified root cause "
            "(replica_death/prefill_interference/storage_degradation/"
            "handoff_degradation/fabric_degradation/capacity/unknown)")
        self.incident_firings = r.counter(
            "incident_detector_firings_total",
            "incident detector firings by detector (many firings "
            "coalesce into one incident inside the debounce window)")
        # Overload control (README "Overload control", serving/overload.py):
        # requests this engine served under an ingress brownout stage —
        # the engine-side receipt that degraded-quality admission is
        # actually reaching the hot loop (stage 2 disables speculation
        # drafting, stage 3 defers fabric publishes).
        self.brownout_requests = r.counter(
            "engine_brownout_requests_total",
            "requests served under an ingress brownout stage, by stage")
        # Latency attribution plane (serving/waterfall.py):
        # wall the serving stack ADDED around the engine — here the
        # model-server scope (HTTP handling + tokenize/detokenize +
        # serve-layer pulls around one engine run, observed per unary
        # request in server.py).  The router registers the same name in
        # the shared core registry for its ingress scope (relay wall
        # minus engine-attributed wall — ROADMAP item 6's "proxy-added
        # latency in µs", measured per-request, not inferred from paired
        # benches).  One metric contract, two scopes, like incidents.
        self.proxy_overhead = r.histogram(
            "ingress_proxy_overhead_seconds",
            "serving-stack wall added around the engine per request "
            "(engine scope: model server; ingress scope: service proxy)",
            PROXY_OVERHEAD_BUCKETS_S)
        # Structured output (README "Structured output"): constrained
        # requests by terminal outcome — "valid" (finished with the
        # automaton accepting), "truncated" (max_new_tokens/deadline cut
        # generation mid-grammar; the emitted prefix is still legal),
        # "stall" (zero legal tokens — engine bug, the slot failed),
        # "recompile" (a corrupted token-map cache degraded to a counted
        # rebuild; the request itself still lands in another outcome) —
        # and per-tick host wall spent building grammar masks (automaton
        # advance + trie walk; the waterfall's grammar_advance segment is
        # the per-request view of the same cost).
        self.constrained_requests = r.counter(
            "engine_constrained_requests_total",
            "constrained (grammar/schema) requests, by terminal outcome")
        self.grammar_mask = r.histogram(
            "engine_grammar_mask_seconds",
            "host wall per tick spent advancing grammar automata and "
            "building token masks for constrained slots",
            PROXY_OVERHEAD_BUCKETS_S)

    # Observe methods stay branch-cheap: one attribute check, then a dict
    # op under the metric's own lock.

    def observe_ttft(self, s: float, priority: Optional[str] = None) -> None:
        if self.enabled:
            self.ttft.observe(s)
            if self.slo is not None and priority is not None:
                self.slo.observe(priority, "ttft", s)

    def observe_tpot(self, s: float, priority: Optional[str] = None) -> None:
        if self.enabled:
            self.tpot.observe(s)
            if self.slo is not None and priority is not None:
                self.slo.observe(priority, "tpot", s)

    def observe_queue_wait(self, s: float,
                           priority: Optional[str] = None) -> None:
        if self.enabled:
            self.queue_wait.observe(s)
            if priority is not None:
                self.class_queue_wait.observe(s, priority=priority)
                if self.slo is not None:
                    self.slo.observe(priority, "queue_wait", s)

    def count_trace_evictions(self, n: int) -> None:
        if self.enabled and n:
            self.trace_evictions.inc(n)

    def observe_proxy_overhead(self, s: float) -> None:
        if self.enabled:
            self.proxy_overhead.observe(s)

    def refresh_slo(self) -> None:
        """Recompute the SLO gauges from the tracker's rolling windows —
        scrape-time only (a gauge needs to be right when read, and the
        window math is O(samples), not O(1))."""
        if self.enabled and self.slo is not None:
            self.slo.export(self.slo_attainment, self.slo_burn)

    def count_preemption(self, reason: str, mode: str) -> None:
        if self.enabled:
            self.preemptions.inc(reason=reason, mode=mode)

    def count_flops(self, kind: str, flops: float,
                    reason: Optional[str] = None) -> None:
        """PerfLedger charge hook: dispatched FLOPs by kind, waste share
        by reason.  Exposition mirrors the ledger exactly because the
        ledger CALLS this per charge — the /metrics counters and the
        /engine/perf snapshot can never disagree."""
        if self.enabled:
            self.flops_total.inc(flops, kind=kind)
            if reason is not None:
                self.wasted_flops.inc(flops, reason=reason)

    def count_cache_pages(self, requested: int, hit: int) -> None:
        if not self.enabled or requested <= 0:
            return
        if hit > 0:
            self.prefix_cache_pages.inc(hit, outcome="hit")
        if hit < requested:
            outcome = "miss_partial" if hit > 0 else "miss_cold"
            self.prefix_cache_pages.inc(requested - hit, outcome=outcome)

    def set_perf(self, mfu: float, goodput: float, fragmentation: float,
                 platform: str) -> None:
        """Scrape-time derived gauges (serve.metrics_text refreshes them
        alongside the KV/SLO gauges — right when read, not per tick)."""
        if self.enabled:
            self.mfu_ratio.set(mfu, platform=platform)
            self.goodput_ratio.set(goodput)
            self.kv_fragmentation.set(fragmentation)

    def count_swap(self, direction: str, nbytes: int) -> None:
        if self.enabled:
            self.swapped_bytes.inc(nbytes, direction=direction)

    def observe_tick(self, s: float) -> None:
        if self.enabled:
            self.tick_duration.observe(s)

    def observe_dispatch_gap(self, s: float) -> None:
        if self.enabled:
            self.dispatch_gap.observe(s)

    def count_fence(self, reason: str) -> None:
        if self.enabled:
            self.pipeline_fences.inc(reason=reason)

    def observe_spec(self, drafted: int, accepted: int) -> None:
        """One verify pass that PROPOSED drafts: ``drafted`` tokens offered,
        ``accepted`` of them kept (bonus token excluded).  No-draft passes
        are not observed — they would swamp the accept-length histogram
        with structural zeros during index-miss phases."""
        if self.enabled and drafted:
            self.spec_draft_tokens.inc(drafted)
            if accepted:
                self.spec_accepted_tokens.inc(accepted)
            self.spec_accept_len.observe(accepted)

    def count_handoff(self, outcome: str) -> None:
        if self.enabled:
            self.kv_handoff.inc(outcome=outcome)

    def count_handoff_bytes(self, direction: str, nbytes: int) -> None:
        if self.enabled and nbytes:
            self.kv_handoff_bytes.inc(nbytes, direction=direction)

    def count_fabric(self, outcome: str) -> None:
        if self.enabled:
            self.kv_fabric.inc(outcome=outcome)

    def count_fabric_bytes(self, direction: str, nbytes: int) -> None:
        if self.enabled and nbytes:
            self.kv_fabric_bytes.inc(nbytes, direction=direction)

    def count_kv_shard_bytes(self, direction: str, nbytes: int) -> None:
        if self.enabled and nbytes:
            self.kv_shard_bytes.inc(nbytes, direction=direction)

    def count_reshard(self, outcome: str) -> None:
        if self.enabled:
            self.kv_reshard.inc(outcome=outcome)

    def count_kv_event(self, tier: str, event: str) -> None:
        if self.enabled:
            self.kv_store_events.inc(tier=tier, event=event)

    def count_session_restore(self, source: str) -> None:
        if self.enabled:
            self.session_restores.inc(source=source)

    def count_session_pin(self, outcome: str) -> None:
        if self.enabled:
            self.session_pins.inc(outcome=outcome)

    def count_brownout(self, stage: int) -> None:
        if self.enabled and stage > 0:
            self.brownout_requests.inc(stage=str(stage))

    def count_constrain(self, outcome: str) -> None:
        if self.enabled:
            self.constrained_requests.inc(outcome=outcome)

    def observe_grammar_mask(self, s: float) -> None:
        if self.enabled:
            self.grammar_mask.observe(s)

    def count_incident_firing(self, detector: str) -> None:
        if self.enabled:
            self.incident_firings.inc(detector=detector)

    def count_incident(self, cause: str) -> None:
        if self.enabled:
            self.incidents_total.inc(cause=cause)

    def set_incidents_open(self, n: int) -> None:
        if self.enabled:
            self.incidents_open.set(n)

    def set_kv_store_bytes(self, host: int, disk: int) -> None:
        if self.enabled:
            self.kv_store_bytes.set(host, tier="host")
            self.kv_store_bytes.set(disk, tier="disk")

    def observe_prefill_batch(self, rows: int) -> None:
        if self.enabled:
            self.prefill_batch.observe(rows)

    def count_outcome(self, outcome: str) -> None:
        if self.enabled:
            self.requests_total.inc(outcome=outcome)

    def set_health(self, state: str) -> None:
        if not self.enabled:
            return
        for s in ("SERVING", "DEGRADED", "DRAINING", "DEAD"):
            self.health_state.set(1.0 if s == state else 0.0, state=s)

    def set_kv_pages(self, free: int, cached: int, total: int) -> None:
        if not self.enabled or total <= 0:
            return
        used = max(0, total - free - cached)
        self.kv_pages.set(free, state="free")
        self.kv_pages.set(cached, state="cached")
        self.kv_pages.set(used, state="used")
        self.kv_occupancy.set((total - free) / total)

    def render(self) -> str:
        return self.registry.render()


class TickProfiler:
    """torch.profiler glue for ``Engine.trace_n_ticks``: the engine loop
    calls the two hooks at tick boundaries; start/stop happen ON the loop
    thread so the captured trace brackets whole ticks, never a
    half-dispatch.

    The n-tick window counts WORK ticks only: a capture armed on an idle
    engine starts recording immediately (so the first dispatch is in the
    trace) but stays open until ``n`` ticks that actually dispatched have
    elapsed — idle 20ms waits must not run the window down to an empty
    profile.  Corollary: a capture on an engine that never receives work
    stays active until work arrives or the engine stops (``abort``).

    Device records: CUDA launches are asynchronous, so when the window's
    last tick ends its kernels may still be queued on the device.  A
    profiler stopped then loses their records; ``sync`` (the engine passes
    a synchronize of its device) runs before ``stop()`` so every kernel the
    window launched has finished and been recorded, and before ``start()``
    so no kernel of the tick before the window runs inside it.  ``window``
    is the (first, last) tick of the last capture.

    Each capture counts the host launch calls it bracketed and the device
    records it lost (``launch_calls``, ``lost_records``: the port's
    ``parallel.profiling.Capture``).  A capture that lost any still writes
    its trace, but ends with ``last_error`` saying how many, passes that
    error to ``on_complete``, and is not counted in ``captures``.

    One profiler can be active per process: a capture armed while another
    (the engine's or anyone's) is recording fails to start, and the failure
    is ``last_error`` — never a silent empty trace.  State transitions are
    lock-guarded (request() runs on a caller thread), and profiler failures
    degrade to a recorded error string — a broken profiler install must not
    take the decode loop down."""

    def __init__(self, sync=None):
        self._lock = threading.Lock()
        self._pending: Optional[tuple] = None  # (n_work_ticks, dir)
        self._remaining: Optional[int] = None
        self.last_error: Optional[str] = None
        self.captures = 0
        # path of the last capture's Chrome trace
        self.last_trace: Optional[str] = None
        # called (loop thread) when a capture finishes or fails to start,
        # as ``on_complete(error_or_None, ctx)`` where ``ctx`` is the
        # opaque value the arming ``request`` carried — the engine's
        # ProfileStore sizes and caps the artifacts from here.  Carrying
        # the ctx THROUGH the profiler (instead of a side field on the
        # engine) closes the race where a capture completes on the loop
        # thread before the arming thread records which run it was.
        self.on_complete = None
        self._ctx = None
        self._sync = sync
        self._prof = None
        self._dir: Optional[str] = None
        self._first_tick = -1
        self.window: Optional[tuple] = None
        # the last capture's host launch calls and device records lost
        self.launch_calls = 0
        self.lost_records = 0

    def request(self, n_ticks: int, trace_dir: str, ctx=None) -> None:
        if n_ticks <= 0:
            raise ValueError("n_ticks must be positive")
        with self._lock:
            if self._pending is not None or self._remaining is not None:
                raise RuntimeError("a profiler capture is already in flight")
            self._pending = (n_ticks, trace_dir)
            self._ctx = ctx

    @property
    def active(self) -> bool:
        with self._lock:
            return self._pending is not None or self._remaining is not None

    def on_tick_start(self, tick: int) -> None:
        with self._lock:
            if self._pending is None:
                return
            n, d = self._pending
            self._pending = None
            self._remaining = n
            self.launch_calls = self.lost_records = 0
        try:
            import torch

            from ...parallel.profiling import Capture

            # torch.profiler sets this process-wide flag while any session
            # records (its own thread-local state does not see another
            # thread's session); a second session started over it would
            # tear the first one down
            if getattr(torch.autograd.profiler, "_is_profiler_enabled", False):
                raise RuntimeError("another torch.profiler session is active "
                                   "in this process")
            os.makedirs(d, exist_ok=True)
            # the sync before start keeps the previous tick's kernels outside
            cap = Capture(sync=self._sync or (lambda: None)).start()
            self._prof, self._dir, self._first_tick = cap, d, tick
        except Exception as e:  # noqa: BLE001 — profiling is best-effort
            self.last_error = f"{type(e).__name__}: {e}"
            with self._lock:
                self._remaining = None
                ctx, self._ctx = self._ctx, None
            if self.on_complete is not None:
                self.on_complete(self.last_error, ctx)

    def on_tick_end(self, tick: int, did_work: bool) -> None:
        with self._lock:
            if self._remaining is None:
                return
            if did_work:
                self._remaining -= 1
            if self._remaining > 0:
                return
        self._finish(tick)

    def abort(self) -> None:
        """Close a capture still open (the engine is stopping): the window
        ends short, and what it recorded is still written."""
        with self._lock:
            self._pending = None
            if self._remaining is None:
                return
        self._finish(-1)

    def _finish(self, tick: int) -> None:
        err = None
        cap, self._prof = self._prof, None
        try:
            cap.stop()  # after the sync: the window's last kernels finish first
            self.launch_calls, self.lost_records = cap.launch_calls, cap.lost_records
            path = os.path.join(self._dir, f"trace-{os.getpid()}-{tick}.json")
            cap.export(path)
            self.last_trace = path
            self.window = (self._first_tick, tick)
            if cap.error is None:
                self.captures += 1
            else:
                err = self.last_error = cap.error
        except Exception as e:  # noqa: BLE001
            err = self.last_error = f"{type(e).__name__}: {e}"
        finally:
            # deactivate only AFTER the trace is written: `active` going
            # False is the caller-visible "capture finished" signal
            with self._lock:
                self._remaining = None
                ctx, self._ctx = self._ctx, None
            if self.on_complete is not None:
                self.on_complete(err, ctx)
