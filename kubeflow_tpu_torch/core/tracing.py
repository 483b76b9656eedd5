"""Distributed trace context + bounded span storage.

A copy of ``kubeflow_tpu/core/tracing.py``: the port's engine spans and the
reference's ingress speak the same trace ids and ``traceparent`` headers.

A fleet request crosses ingress, N engine replicas (retries, hedges,
mid-stream failovers), and — across session turns — time.  This module is
the correlation currency: a W3C-traceparent-style context minted at
ingress, propagated hop by hop, and adopted by the engine's RequestSpan so
one trace id names the whole journey.

  * ``TraceContext`` — (trace_id, span_id, parent_id).  ``mint()`` starts a
    trace; ``child()`` derives the next hop (same trace, fresh span, parent
    = the deriving span).  ``traceparent()``/``parse_traceparent`` speak
    the W3C header format (``00-<32 hex>-<16 hex>-01``) so external
    tracers interoperate.
  * ``TraceStore`` — bounded (entries AND bytes) store of finished span
    dicts keyed by trace id.  Whole traces evict oldest-first; the
    ``on_evict`` hook feeds the eviction counters
    (``ingress_trace_evictions_total`` / ``engine_trace_evictions_total``)
    so a long-lived fleet run can watch its own history pressure instead
    of growing without bound.
  * ``build_tree`` — nests a flat span list by ``parent_id`` into the hop
    tree the ``GET /debug/trace/<id>`` endpoint returns.

Span dicts are schema-light on purpose (component/name/outcome plus
whatever annotations the hop found interesting); the only structural keys
the tree builder needs are ``span_id`` and ``parent_id``.
"""

from __future__ import annotations

import json
import os
import re
import threading
from typing import Callable, Optional

TRACEPARENT_HEADER = "traceparent"

_TRACEPARENT_RE = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$")

# a bare span id (e.g. the X-Resume-From header value): surfaces that
# store client-supplied ids must reject anything else, or budget
# accounting that assumes fixed-size ids undercounts
SPAN_ID_RE = re.compile(r"^[0-9a-f]{16}$")


class TraceContext:
    """One hop's identity inside a trace: ids only, no timing state."""

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id

    @classmethod
    def mint(cls) -> "TraceContext":
        """Start a new trace (the ingress does this when no inbound
        traceparent exists; the engine does it for direct API callers)."""
        return cls(new_trace_id(), new_span_id())

    def child(self) -> "TraceContext":
        """The next hop: same trace, fresh span id, this span as parent."""
        return TraceContext(self.trace_id, new_span_id(), self.span_id)

    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return (f"TraceContext({self.trace_id[:8]}…, {self.span_id}, "
                f"parent={self.parent_id})")


def new_trace_id() -> str:
    return os.urandom(16).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


def parse_traceparent(value) -> Optional[TraceContext]:
    """Parse a W3C traceparent header; None on anything malformed (a bad
    header must degrade to a fresh trace, never fail the request).  The
    all-zero trace/span ids are invalid per the spec."""
    if not isinstance(value, str):
        return None
    m = _TRACEPARENT_RE.match(value.strip().lower())
    if m is None:
        return None
    trace_id, span_id = m.group(1), m.group(2)
    if set(trace_id) == {"0"} or set(span_id) == {"0"}:
        return None
    return TraceContext(trace_id, span_id)


def span_nbytes(span: dict) -> int:
    """Budget-accounting size of one span dict.  json.dumps is the honest
    estimator (these spans are served as JSON anyway) with a cheap floor
    for the unserializable-degenerate case."""
    try:
        return len(json.dumps(span, default=str))
    except (TypeError, ValueError):  # pragma: no cover - defensive
        return 256


class TraceStore:
    """Bounded trace-id -> [span dicts] store.

    Budgeted in BOTH entries (distinct traces) and bytes (sum of span
    sizes): a fleet soak with many short traces hits the entry cap, a few
    huge traces (long retries, deep session chains) hit the byte cap.
    Whole traces evict least-recently-WRITTEN-first (every ``put`` touches
    its trace to the back): insertion-order eviction made a long-lived
    trace that keeps receiving spans — a multi-turn session, a mid-stream
    failover, exactly the traces an incident bundle cites — the "oldest"
    entry, evicted while still actively written, while idle one-shot
    traces survived behind it.  Whole traces, never spans — a half-evicted
    trace would assemble into a tree that silently lies.  A trace
    STILL BEING WRITTEN when it was evicted (another thread's long stream
    under churn) re-creates with a synthetic ``evicted_history`` marker
    span, so the partial tree reads as "history truncated", never as "one
    clean attempt".  ``on_evict(n_traces)`` fires outside any per-span hot
    path."""

    def __init__(self, max_traces: int = 256, max_bytes: int = 1_000_000,
                 on_evict: Optional[Callable[[int], None]] = None):
        self.max_traces = max(1, int(max_traces))
        self.max_bytes = max(1, int(max_bytes))
        self.on_evict = on_evict
        self._traces: dict[str, list] = {}
        self._sizes: dict[str, int] = {}
        # tombstones of recently evicted trace ids (bounded FIFO): a put
        # landing on one means earlier spans of that trace were dropped
        self._tombstones: dict[str, None] = {}
        self._bytes = 0
        self._evicted = 0
        self._lock = threading.Lock()

    _TOMBSTONE_CAP = 4096

    def put(self, trace_id: str, span: dict) -> None:
        nb = span_nbytes(span)
        evicted = 0
        with self._lock:
            spans = self._traces.get(trace_id)
            if spans is not None:
                # LRU by last write: an actively-written trace moves to
                # the back so the eviction loop's next(iter(...)) finds
                # the trace that stopped receiving spans longest ago
                self._traces[trace_id] = self._traces.pop(trace_id)
            if spans is None:
                spans = self._traces[trace_id] = []
                self._sizes[trace_id] = 0
                if self._tombstones.pop(trace_id, "miss") is None:
                    marker = {"trace_id": trace_id, "span_id": None,
                              "parent_id": None, "name": "evicted_history",
                              "note": "earlier spans of this trace were "
                                      "evicted by the store budget"}
                    spans.append(marker)
                    mb = span_nbytes(marker)
                    self._sizes[trace_id] += mb
                    self._bytes += mb
            spans.append(span)
            self._sizes[trace_id] += nb
            self._bytes += nb
            while ((len(self._traces) > self.max_traces
                    or self._bytes > self.max_bytes)
                   and len(self._traces) > 1):
                # never evict the trace being written (it would make the
                # store lose the span it was just handed); the >1 guard
                # means a single over-budget trace is kept whole
                oldest = next(iter(self._traces))
                if oldest == trace_id:
                    oldest = next(i for i in self._traces if i != trace_id)
                self._traces.pop(oldest)
                self._bytes -= self._sizes.pop(oldest)
                self._tombstones[oldest] = None
                evicted += 1
            while len(self._tombstones) > self._TOMBSTONE_CAP:
                self._tombstones.pop(next(iter(self._tombstones)))
            self._evicted += evicted
        if evicted and self.on_evict is not None:
            self.on_evict(evicted)

    def get(self, trace_id: str) -> list:
        with self._lock:
            return list(self._traces.get(trace_id, ()))

    def __len__(self) -> int:
        with self._lock:
            return len(self._traces)

    def stats(self) -> dict:
        with self._lock:
            return {"traces": len(self._traces), "bytes": self._bytes,
                    "evicted": self._evicted}


def build_tree(spans: list) -> list:
    """Nest a flat span list into the hop tree: each node is the span dict
    plus a ``children`` list, ordered by start time where present.  Spans
    whose parent is absent (the root, or a parent evicted/unreachable)
    surface at the top level — a partial trace still renders."""
    by_id = {}
    for s in spans:
        node = dict(s)
        node["children"] = []
        sid = node.get("span_id")
        if sid is not None:
            by_id[sid] = node
        else:  # pragma: no cover - defensive: keep malformed spans visible
            by_id[id(node)] = node
    roots = []
    for node in by_id.values():
        parent = by_id.get(node.get("parent_id"))
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)
    def order(nodes):
        nodes.sort(key=lambda n: (n.get("t_start_s") or 0.0,
                                  str(n.get("span_id"))))
        for n in nodes:
            order(n["children"])
    order(roots)
    return roots
