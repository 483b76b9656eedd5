"""Latency attribution plane: request waterfalls, critical
path, fleet latency budgets.

A copy of ``kubeflow_tpu/serving/waterfall.py``, behind the port's
``Engine.waterfall`` and ``Engine.latency_budget``.

The repo records five independent timing sources for one request —
ingress relay hop spans (router.py), the engine's ``RequestSpan`` phase
marks (engine/telemetry.py), per-dispatch phase durations and the tick
timeline (engine/perf.py), fabric/handoff pull walls (engine/serve.py),
and the perf ledger — but none of them answers "where did this
request's 300 ms go?".  This module is the pure assembly layer that
stitches them into a single end-to-end **waterfall** of non-overlapping
attributed segments.

Invariants (the whole point):

  * **segment sum == wall, by construction.**  ``seal()`` lays every
    attributed interval onto the ``[0, wall)`` axis as a contiguous
    partition: gaps become explicit ``unaccounted`` segments, overlaps
    are clipped (the clipped parts are returned separately — they are
    the *overlapped* work the critical-path computation consumes).  The
    sum of segment durations telescopes to the wall exactly; nothing is
    ever silently absorbed.
  * **no cross-process clock arithmetic without an offset estimate.**
    Ingress and engine are separate processes with independent
    ``perf_counter`` origins.  The relay hop span brackets the engine
    span (send before submit, return after the terminal mark), so an
    NTP-style midpoint estimate places the engine interval inside the
    hop; every segment whose endpoints crossed the estimate is marked
    ``skew_adjusted`` and the per-backend offset rides the waterfall.
  * **assembly is read-path only.**  Everything here is pure functions
    over already-recorded span dicts — called from HTTP handler /
    manager threads, never from the engine loop or the relay hot path.
    The producers (span marks, ``RequestSpan.hint``) stay O(1).
"""

from __future__ import annotations

from typing import Iterable, Optional

# ---------------------------------------------------------------- taxonomy

#: segment name -> glossary line (mirrored in the README "Latency
#: attribution" section; tests pin that every emitted segment is listed).
SEGMENTS = {
    "ingress_parse": "proxy body read + JSON parse, before any decision",
    "admission": "overload-control gates (tenant quota / AIMD / deadline)",
    "placement": "backend choice: disagg classification, fabric view "
                 "scoring, pick — between admission and the first hop "
                 "(and between hops after a successful phase hop)",
    "relay_connect": "ingress-side half of a relay hop the engine span "
                     "does not cover: connect + request write (the part "
                     "transport timing could not attribute further)",
    "pool_wait": "waiting for a pooled backend connection checkout "
                 "(transport-measured; carved off the relay lead-in)",
    "connect": "fresh backend dial + request write when the pool had no "
               "warm connection (transport-measured; zero on reuse)",
    "first_byte": "request sent to first response byte on an opaque hop "
                  "(no engine span) — backend queue+compute the ingress "
                  "can only see as time-to-first-byte",
    "engine_queue": "submit to slot admission (includes preempt re-queue)",
    "session_restore": "tiered-store session KV restore before prefill",
    "fabric_pull": "fleet KV fabric prefix pull + verified scatter",
    "handoff_import": "disagg handoff KV pull + verified scatter",
    "prefill": "one prefill chunk dispatch (per-chunk segments)",
    "decode": "token generation after first_token (minus carve-outs)",
    "spec_verify": "speculative verify dispatches carved out of decode",
    "grammar_advance": "host-side automaton advance + token-mask build "
                       "for constrained decoding, carved out of decode",
    "preempt_restore": "swap-resume KV restore after a preemption",
    "stream_flush": "backend-to-client response relay after the engine "
                    "span ended (SSE flush, headers, proxy bookkeeping)",
    "retry_gap": "ingress backoff between a failed hop and its retry",
    "failover": "a relay attempt that failed (connect error, 5xx, stall, "
                "mid-stream death) — wall spent on a backend that died",
    "relay_backend": "an opaque successful hop: backend time with no "
                     "engine span to attribute (telemetry off / evicted)",
    "unaccounted": "wall not covered by any attributed segment",
}

# engine tick-timeline phases that are host-side bookkeeping overlapped
# with device compute when the decode pipeline is on — the raw material
# of the critical-path computation (perf.TickTimeline phase names)
OVERLAPPED_TIMELINE_PHASES = ("drain", "readback", "commit_behind")

# pre-submit hint names (serve-layer pulls measured before the engine
# span exists) -> the waterfall segment they carve out of the ingress
# lead-in; see RequestSpan.hint / engine pre_hints
PRE_HINT_SEGMENTS = {
    "pre_fabric_pull": "fabric_pull",
    "pre_handoff_import": "handoff_import",
}

_TERMINAL = ("done", "shed", "failed", "cancelled")

_EPS = 1e-9


# ------------------------------------------------------------------- seal


def seal(intervals: Iterable[tuple], wall: float) -> tuple:
    """Lay attributed ``(start, end, name, meta)`` intervals onto the
    ``[0, wall)`` axis as a contiguous partition.

    Returns ``(segments, overlapped)`` where ``segments`` is a list of
    ``{"name", "start_s", "dur_s", ...meta}`` dicts whose durations sum
    to ``wall`` BY CONSTRUCTION (every gap becomes an explicit
    ``unaccounted`` segment; intervals beyond ``wall`` are clipped), and
    ``overlapped`` is the list of clipped interval parts — work that
    happened concurrently with an earlier-laid interval (hedged hops,
    pipelined phases), which belongs to the critical-path computation,
    not the sum.
    """
    wall = max(0.0, float(wall))
    ivs = sorted(((float(s), float(e), n, m or {})
                  for s, e, n, m in intervals if e - s > _EPS),
                 key=lambda iv: (iv[0], iv[1]))
    out: list = []
    overlapped: list = []
    cursor = 0.0
    for s, e, name, meta in ivs:
        if s >= wall - _EPS:
            overlapped.append({"name": name, "start_s": round(s, 6),
                               "dur_s": round(e - s, 6),
                               "reason": "beyond_wall"})
            continue
        e = min(e, wall)
        if e <= cursor + _EPS:
            # fully under an earlier interval: concurrent work
            overlapped.append({"name": name, "start_s": round(s, 6),
                               "dur_s": round(e - s, 6),
                               "reason": "overlap"})
            continue
        if s < cursor:
            overlapped.append({"name": name, "start_s": round(s, 6),
                               "dur_s": round(cursor - s, 6),
                               "reason": "overlap"})
            s = cursor
        elif s > cursor + _EPS:
            out.append({"name": "unaccounted", "start_s": cursor,
                        "dur_s": s - cursor})
            cursor = s
        else:
            s = cursor  # snap sub-eps seams shut: the partition stays exact
        seg = {"name": name, "start_s": s, "dur_s": e - s}
        seg.update(meta)
        out.append(seg)
        cursor = e
    if cursor < wall - _EPS:
        out.append({"name": "unaccounted", "start_s": cursor,
                    "dur_s": wall - cursor})
    elif out:
        # close the last seam so the telescoped sum hits wall exactly
        out[-1]["dur_s"] += wall - cursor
    for seg in out:
        seg["start_s"] = round(seg["start_s"], 9)
        seg["dur_s"] = round(seg["dur_s"], 9)
    return out, overlapped


def totals(segments: list) -> dict:
    """Per-name duration sums over a sealed segment list."""
    out: dict = {}
    for seg in segments:
        out[seg["name"]] = out.get(seg["name"], 0.0) + seg["dur_s"]
    return {k: round(v, 9) for k, v in out.items()}


# --------------------------------------------------- engine-span partition


def _gap_label(nxt: str, saw_token: bool, saw_work: bool) -> str:
    """Attribute the gap ENDING at event ``nxt`` (the mark records when
    the phase's work finished or the state was entered)."""
    if nxt in ("admitted", "readmitted"):
        return "engine_queue"
    if nxt == "prefill":
        return "prefill"
    if nxt == "first_token":
        return "decode" if saw_token else "prefill"
    if nxt == "session_restore":
        return "session_restore"
    if nxt == "fabric_restore":
        return "fabric_pull"
    if nxt == "handoff_import":
        return "handoff_import"
    if nxt == "resumed":
        return "preempt_restore"
    if nxt == "preempted":
        return "decode" if saw_token else "prefill"
    # terminal (or unknown forward-compat phase): decode once a token
    # exists, prefill once any work started, else it died in the queue
    return ("decode" if saw_token
            else "prefill" if saw_work else "engine_queue")


def engine_segments(span: dict) -> tuple:
    """Partition one engine ``RequestSpan`` dict (``to_dict`` shape) into
    attributed intervals on the engine clock (0 = submit).

    Every inter-mark gap gets exactly one label from the phase
    transition table, so the intervals are contiguous over
    ``[0, last_mark]`` by construction.  The ``verify`` dispatch hint
    (accumulated per-request by the engine's isolation boundary) carves
    ``spec_verify`` out of the decode intervals proportionally — the
    carve is clamped to the decode time, so the partition stays exact.

    Returns ``(intervals, wall, pre_s)`` where ``pre_s`` maps waterfall
    segment names to serve-layer pre-submit walls (fabric/handoff pulls
    that happened BEFORE the engine clock started — the fleet assembler
    carves them out of the ingress lead-in; the engine-local waterfall
    reports them alongside, never inside, its own axis).
    """
    events = span.get("events") or []
    hints = dict(span.get("hints") or {})
    intervals: list = []
    saw_token = saw_work = False
    chunk = 0
    prev_t = 0.0
    for ev in events[1:]:
        phase, t = ev["phase"], float(ev["t_s"])
        if t < prev_t:
            t = prev_t  # non-monotonic mark: clamp, never go backwards
        name = _gap_label(phase, saw_token, saw_work)
        meta: dict = {}
        if name == "prefill":
            meta = {"chunk": chunk}
            chunk += 1
        if t - prev_t > _EPS:
            intervals.append((prev_t, t, name, meta))
        prev_t = t
        if phase == "first_token":
            saw_token = True
        if phase in ("prefill", "first_token", "session_restore",
                     "fabric_restore", "handoff_import", "resumed"):
            saw_work = True
    wall = prev_t
    # ---- decode carve-outs: split each decode interval so its tail
    # holds this request's share of (a) the verify-dispatch wall and
    # (b) the grammar-automaton wall (README "Structured output") —
    # carved SEQUENTIALLY, each from what decode time remains, and
    # clamped there, so the partition stays exact even when the hints
    # also accumulated outside decode (a prefill-tick mask build)
    for hint, seg in (("verify", "spec_verify"),
                      ("grammar_advance", "grammar_advance")):
        amount = float(hints.pop(hint, 0.0) or 0.0)
        decode_total = sum(e - s for s, e, n, _ in intervals
                           if n == "decode")
        if amount <= _EPS or decode_total <= _EPS:
            continue
        frac = min(1.0, amount / decode_total)
        carved: list = []
        for s, e, n, meta in intervals:
            if n != "decode":
                carved.append((s, e, n, meta))
                continue
            cut = e - (e - s) * frac
            if cut - s > _EPS:
                carved.append((s, cut, "decode", meta))
            carved.append((cut, e, seg, {"carved_from": "decode"}))
        intervals = carved
    pre_s = {PRE_HINT_SEGMENTS[k]: round(float(v), 9)
             for k, v in hints.items()
             if k in PRE_HINT_SEGMENTS and float(v) > _EPS}
    return intervals, wall, pre_s


def overlays_from_timeline(records: Iterable[dict], t0: float,
                           t_end: float) -> list:
    """Overlap intervals (engine-relative clock) from tick-timeline
    records: the pipelined loop's host phases (drain/readback/
    commit-behind) run while the device computes, so their wall inside
    this request's window is latency the pipeline HID — off the critical
    path.  ``t0``/``t_end`` are the span's absolute perf_counter bounds;
    record ``t_s`` is the absolute stamp perf.TickTimeline recorded."""
    out = []
    for rec in records or ():
        t = float(rec.get("t_s", 0.0))
        if not t0 <= t <= t_end:
            continue
        cursor = t - t0
        for phase in OVERLAPPED_TIMELINE_PHASES:
            dur = float((rec.get("segments") or {}).get(phase, 0.0))
            if dur > _EPS:
                out.append({"name": f"pipeline_{phase}",
                            "start_s": round(cursor, 9),
                            "dur_s": round(dur, 9)})
                cursor += dur
    return out


def critical_path(segments: list, overlays: list, wall: float) -> dict:
    """The path that actually bounds latency: wall minus the measure of
    the overlay-interval union (work that ran concurrently with the
    partition's segments — pipelined host phases, hedged hops, clipped
    overlaps from ``seal``).  ``path`` lists, in order, the segments
    with any un-hidden portion."""
    ivs = sorted((max(0.0, o["start_s"]),
                  min(wall, o["start_s"] + o["dur_s"]))
                 for o in overlays or ()
                 if o["start_s"] + o["dur_s"] > _EPS)
    merged: list = []
    for s, e in ivs:
        if e - s <= _EPS:
            continue
        if merged and s <= merged[-1][1] + _EPS:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    hidden = sum(e - s for s, e in merged)

    def covered(s: float, e: float) -> float:
        return sum(max(0.0, min(e, me) - max(s, ms)) for ms, me in merged)

    path = []
    for seg in segments:
        s, e = seg["start_s"], seg["start_s"] + seg["dur_s"]
        if (e - s) - covered(s, e) > _EPS and seg["name"] != "unaccounted":
            if not path or path[-1] != seg["name"]:
                path.append(seg["name"])
    return {"critical_path_s": round(max(0.0, wall - hidden), 9),
            "hidden_s": round(hidden, 9), "path": path}


# ------------------------------------------------------------ clock offset


def estimate_offset(hop_start: float, hop_dur: float,
                    engine_wall: float) -> tuple:
    """NTP-style midpoint estimate of where the engine span's clock zero
    sits on the ingress clock.  The hop interval brackets the engine
    span (request written before submit, hop closed after the terminal
    mark), so centering the engine wall inside the hop splits the
    residual symmetrically between the send and receive halves.

    Returns ``(offset, residual)``: ``offset`` maps engine-relative time
    ``t`` to ingress-relative ``offset + t``; ``residual`` is
    ``hop_dur - engine_wall`` — non-negative in the bracketing regime,
    negative when the clocks drifted or the hop closed early (then the
    engine interval is pinned to the hop start and ``seal`` clips the
    overrun; the negative residual rides the waterfall as the skew
    evidence)."""
    residual = hop_dur - engine_wall
    if residual >= 0:
        return hop_start + residual / 2.0, residual
    return hop_start, residual


# --------------------------------------------------------- engine-local view


def build_engine_waterfall(span: dict,
                           overlays: Optional[list] = None) -> dict:
    """Engine-local waterfall for one request (clock zero = submit).
    ``overlays``: pre-computed overlap intervals (the engine converts
    its tick timeline via ``overlays_from_timeline`` — only it knows the
    span's absolute clock)."""
    intervals, wall, pre_s = engine_segments(span)
    segments, clipped = seal(intervals, wall)
    overlays = list(overlays or ()) + clipped
    out = {
        "rid": span.get("rid"),
        "trace_id": span.get("trace_id"),
        "span_id": span.get("span_id"),
        "outcome": span.get("outcome"),
        "cls": span.get("cls"),
        "clock": "engine",
        "wall_s": round(wall, 9),
        "segments": segments,
        "totals": totals(segments),
        "unaccounted_s": round(sum(
            s["dur_s"] for s in segments if s["name"] == "unaccounted"), 9),
    }
    if pre_s:
        out["pre_s"] = pre_s  # serve-layer pulls before the engine clock
    out["critical_path"] = critical_path(segments, overlays, wall)
    if overlays:
        out["overlapped"] = overlays
    return out


# --------------------------------------------------------------- fleet view


def dedupe_spans(spans: Iterable[dict]) -> list:
    """Fleet trace-merge hygiene: one span per ``(trace_id, span_id)``
    (a failover request's engine span can surface from both the live
    table and the history ring, or from a double-polled replica), first
    occurrence wins."""
    seen: set = set()
    out = []
    for s in spans:
        key = (s.get("trace_id"), s.get("span_id"))
        if s.get("span_id") is not None and key in seen:
            continue
        seen.add(key)
        out.append(s)
    return out


def order_spans(spans: list) -> list:
    """Order assembled spans by skew-adjusted start time, so a failover
    request's two engine spans read in causal order instead of scrape
    order.  Engine spans get an ``t_start_adj_s`` field — their clock
    zero mapped onto the ingress axis via the parent hop's bracket (the
    raw hop ``t_start_s`` when no estimate is possible)."""
    hops = {s.get("span_id"): s for s in spans
            if s.get("component") == "ingress"
            and s.get("name") == "relay_attempt"}
    keyed = []
    for s in spans:
        if s.get("component") == "engine":
            hop = hops.get(s.get("parent_id"))
            if hop is not None:
                off, _ = estimate_offset(
                    float(hop.get("t_start_s", 0.0)),
                    float(hop.get("duration_s", 0.0)),
                    _engine_wall(s))
                s["t_start_adj_s"] = round(off, 6)
            key = s.get("t_start_adj_s", 0.0)
        else:
            key = float(s.get("t_start_s", 0.0))
        keyed.append((key, s))
    keyed.sort(key=lambda kv: kv[0])
    return [s for _, s in keyed]


def _engine_wall(span: dict) -> float:
    if isinstance(span.get("latency_s"), (int, float)):
        return float(span["latency_s"])
    events = span.get("events") or []
    return float(events[-1]["t_s"]) if events else 0.0


def build_fleet_waterfall(trace: dict) -> Optional[dict]:
    """End-to-end waterfall for one distributed trace: the ingress root
    span's wall partitioned across parse/admission/placement, every
    relay hop (failed ones become ``failover``, inter-attempt backoff
    becomes ``retry_gap``), and — inside each successful hop — the
    engine span's own partition placed via the per-backend clock-offset
    estimate, with the serve-layer pull hints carved out of the
    ingress-side lead-in.  Returns None when the trace has no root
    request span (nothing to anchor a wall to)."""
    spans = order_spans(dedupe_spans(trace.get("spans") or ()))
    root = next((s for s in spans if s.get("component") == "ingress"
                 and s.get("name") == "request"), None)
    if root is None:
        return None
    pre = dict(root.get("pre_s") or {})
    pre_wall = sum(float(v) for v in pre.values())
    wall = pre_wall + float(root.get("duration_s", 0.0))
    engines = {}
    for s in spans:
        if s.get("component") == "engine":
            engines.setdefault(s.get("parent_id"), s)
    hops = [s for s in spans if s.get("component") == "ingress"
            and s.get("name") == "relay_attempt"]

    def _carve_transport(h0, budget, hop, meta,
                         names=("pool_wait", "connect")):
        """Split the head of a relay lead-in using the hop's transport
        timing (``pool_wait_s``/``connect_s``/``first_byte_s`` measured
        by the pooled transport, serving/transport.py).  Returns
        ``(intervals, consumed)``; legacy-core hops carry no timing and
        consume nothing, keeping the whole lead in relay_connect."""
        tr = hop.get("transport") or {}
        out, cur = [], h0
        for name in names:
            dur = min(float(tr.get(name + "_s") or 0.0),
                      budget - (cur - h0))
            if dur > _EPS:
                out.append((cur, cur + dur, name, dict(meta)))
                cur += dur
        return out, cur - h0

    intervals: list = []
    overlays: list = []
    cursor = 0.0
    for name in ("ingress_parse", "admission"):
        dur = float(pre.get(name, 0.0))
        if dur > _EPS:
            intervals.append((cursor, cursor + dur, name, {}))
            cursor += dur
    clock_offsets: dict = {}
    engine_attr = 0.0
    prev_end, prev_ok = cursor, True
    for hop in hops:
        h0 = pre_wall + float(hop.get("t_start_s", 0.0))
        h1 = h0 + float(hop.get("duration_s", 0.0))
        if h0 - prev_end > _EPS:
            # between attempts: backoff after a failure, re-planning
            # (disagg decode rewrite, re-pick) after a successful phase
            intervals.append((prev_end, h0,
                              "retry_gap" if not prev_ok else "placement",
                              {}))
        ok = hop.get("outcome") == "ok"
        meta = {"backend": hop.get("backend"), "kind": hop.get("kind")}
        if not ok:
            if hop.get("error"):
                meta["error"] = hop["error"]
            meta["outcome"] = hop.get("outcome")
            intervals.append((h0, h1, "failover", meta))
        else:
            eng = engines.get(hop.get("span_id"))
            if eng is None:
                # opaque hop: transport timing is the only attribution
                # available — pool_wait/connect/first_byte off the head,
                # the remainder stays relay_backend
                carved, used = _carve_transport(
                    h0, h1 - h0, hop, meta,
                    names=("pool_wait", "connect", "first_byte"))
                intervals.extend(carved)
                if h1 - (h0 + used) > _EPS:
                    intervals.append((h0 + used, h1, "relay_backend",
                                      meta))
            else:
                ewall = _engine_wall(eng)
                off, residual = estimate_offset(h0, h1 - h0, ewall)
                backend = str(eng.get("replica") or hop.get("backend"))
                clock_offsets[backend] = {
                    "offset_s": round(off, 6),
                    "residual_s": round(residual, 6)}
                lead = max(0.0, residual) / 2.0
                sub, _w, pre_hints = engine_segments(eng)
                # serve-layer pulls happened inside the lead-in, right
                # before submit: carve them off its tail
                pull = min(lead, sum(pre_hints.values()))
                # transport-measured checkout/dial time carves the head
                # of the lead-in; what neither the transport nor the
                # pre-submit hints explain stays relay_connect
                carved, used = _carve_transport(h0, lead - pull, hop,
                                                meta)
                intervals.extend(carved)
                if lead - pull - used > _EPS:
                    intervals.append((h0 + used, h0 + lead - pull,
                                      "relay_connect", dict(meta)))
                pc = h0 + lead - pull
                for pname, pdur in pre_hints.items():
                    take = min(pdur, h0 + lead - pc)
                    if take > _EPS:
                        intervals.append((pc, pc + take, pname,
                                          {**meta, "pre_submit": True}))
                        pc += take
                for s, e, n, m in sub:
                    intervals.append((off + s, off + e, n,
                                      {**m, **meta, "skew_adjusted": True}))
                    engine_attr += e - s
                tail0 = off + ewall
                if h1 - tail0 > _EPS:
                    intervals.append((tail0, h1, "stream_flush",
                                      dict(meta)))
        prev_end, prev_ok = max(prev_end, h1), ok
    if wall - prev_end > _EPS:
        # after the last hop closed: final client flush + proxy
        # bookkeeping (overload release, metrics, root-span write)
        intervals.append((prev_end, wall, "stream_flush", {}))
    segments, clipped = seal(intervals, wall)
    overlays += clipped
    out = {
        "trace_id": trace.get("trace_id") or root.get("trace_id"),
        "clock": "ingress",
        "wall_s": round(wall, 9),
        "segments": segments,
        "totals": totals(segments),
        "unaccounted_s": round(sum(
            s["dur_s"] for s in segments if s["name"] == "unaccounted"), 9),
        "clock_offsets": clock_offsets,
        # ROADMAP item 6: proxy-added latency, measured per-request —
        # the ingress wall minus every engine-attributed second
        "proxy_overhead_s": round(max(0.0, wall - engine_attr), 9),
        "attempts": len(hops),
        "status": root.get("status"),
        "critical_path": critical_path(segments, overlays, wall),
    }
    if overlays:
        out["overlapped"] = overlays
    return out


# ------------------------------------------------------------ fleet budgets

# bounded per-class sample retention for budget quantiles: enough for a
# stable p95, small enough to ship in a fan-out response
BUDGET_SAMPLE_CAP = 256

# the segments a TTFT budget decomposes into (queue vs restore/pull vs
# prefill — the "where does interactive p95 TTFT go" question)
_TTFT_SEGMENTS = ("engine_queue", "session_restore", "fabric_pull",
                  "handoff_import", "preempt_restore", "prefill")


def quantile(samples: list, q: float) -> Optional[float]:
    """Linear-interpolation quantile over a small sample list (the
    fan-out merge path; O(n log n) on <= a few thousand floats)."""
    if not samples:
        return None
    xs = sorted(samples)
    if len(xs) == 1:
        return xs[0]
    pos = q * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def span_budget_sample(span: dict) -> Optional[dict]:
    """One request's contribution to the per-class budget: its TTFT,
    end-to-end wall, and per-segment walls clipped to the TTFT window
    (the budget question is what the time-to-first-token is made of)."""
    intervals, wall, pre_s = engine_segments(span)
    if wall <= _EPS:
        return None
    ttft = span.get("ttft_s")
    ttft = float(ttft) if isinstance(ttft, (int, float)) else wall
    seg_ttft: dict = {}
    for s, e, name, _meta in intervals:
        take = max(0.0, min(e, ttft) - s)
        if take > _EPS and name in _TTFT_SEGMENTS:
            seg_ttft[name] = seg_ttft.get(name, 0.0) + take
    for name, v in pre_s.items():  # pre-submit pulls are TTFT too
        seg_ttft[name] = seg_ttft.get(name, 0.0) + v
        ttft += v
    return {"cls": span.get("cls") or "unknown",
            "ttft_s": round(ttft, 9), "wall_s": round(wall, 9),
            "segments": {k: round(v, 9) for k, v in seg_ttft.items()}}


def class_budgets(samples_by_class: dict) -> dict:
    """Per-SLO-class p50/p95 TTFT budget breakdown from raw budget
    samples (``span_budget_sample`` dicts grouped by class): for each
    class, the TTFT quantiles and each segment's quantiles plus its
    fraction of the p95 TTFT — the "interactive p95 TTFT is 60% queue"
    headline."""
    out: dict = {}
    for cls, samples in samples_by_class.items():
        if not samples:
            continue
        ttfts = [s["ttft_s"] for s in samples]
        p95 = quantile(ttfts, 0.95) or 0.0
        names: set = set()
        for s in samples:
            names.update(s["segments"])
        segs = {}
        for name in sorted(names):
            vals = [s["segments"].get(name, 0.0) for s in samples]
            sp95 = quantile(vals, 0.95) or 0.0
            segs[name] = {
                "p50_s": round(quantile(vals, 0.5) or 0.0, 6),
                "p95_s": round(sp95, 6),
                "frac_of_p95_ttft": round(sp95 / p95, 4) if p95 else None,
            }
        out[cls] = {
            "n": len(samples),
            "ttft_p50_s": round(quantile(ttfts, 0.5) or 0.0, 6),
            "ttft_p95_s": round(p95, 6),
            "wall_p50_s": round(quantile(
                [s["wall_s"] for s in samples], 0.5) or 0.0, 6),
            "segments": segs,
        }
    return out


def merge_budget_samples(replica_payloads: Iterable[dict]) -> dict:
    """Merge per-replica ``{"samples": {cls: [...]}}`` payloads (the
    ``GET /engine/latency`` fan-out) into one bounded samples-by-class
    dict — raw samples merge exactly where per-replica quantiles would
    not."""
    merged: dict = {}
    for payload in replica_payloads:
        for cls, samples in (payload.get("samples") or {}).items():
            merged.setdefault(cls, []).extend(samples)
    for cls in merged:
        merged[cls] = merged[cls][-BUDGET_SAMPLE_CAP * 4:]
    return merged


def dominant_segment(samples: list) -> Optional[dict]:
    """The segment that dominates a class's TTFT at p95 — the
    quantitative evidence an SLO-burn incident cites (is the burn queue
    pressure, pull time, or prefill interference?)."""
    budget = class_budgets({"_": samples}).get("_")
    if not budget or not budget["segments"]:
        return None
    name, rec = max(budget["segments"].items(),
                    key=lambda kv: kv[1]["p95_s"])
    return {"segment": name, "p95_s": rec["p95_s"],
            "frac_of_p95_ttft": rec["frac_of_p95_ttft"],
            "n": budget["n"]}
