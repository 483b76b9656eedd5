"""Disaggregated prefill/decode serving: replica roles and the handoff store.

A copy of ``kubeflow_tpu/serving/disagg.py``.  Replicas declare a **role**
— ``prefill`` | ``decode`` | ``unified`` — and the service proxy splits
eligible requests into two phases:

  1. **prefill phase** — the request lands on a prefill-role replica with
     ``parameters.kv_handoff: true``; the engine runs the existing
     (chunked-)prefill machinery, samples the FIRST token exactly as a
     unified engine would, then exports the request's committed KV pages as
     one KVPG-framed, CRC-verified blob (kvstore.py's versioned page-file
     format doubles as the wire format, so torn/corrupt transfers are
     detected for free) registered in the replica's ``HandoffStore`` under
     a one-shot, TTL'd handle.
  2. **decode phase** — the proxy re-dispatches the original request to a
     decode-role (or unified) replica with ``parameters.handoff =
     {handle, source_port, token_ids}``; that replica PULLS the blob over
     ``GET /engine/kv_handoff/<handle>``, verifies it, scatters the pages
     into a fresh slot row (the same ``_resume_swapped`` path session
     restore and preemption swap already use) and decodes from the first
     token WITHOUT re-prefilling.

Degradation contract: ANY handoff failure — torn transfer, slow link,
decode replica dying mid-pull, handle expiry, double pull, budget
rejection, shape mismatch — degrades to a plain re-prefill of prompt +
first token on the decode replica (a prefix-cache hit when those pages
exist), never a failed request.  Under greedy decoding the degraded path
re-derives the identical byte sequence.

The frames are the JAX package's bytes (kvstore.py), so a frame either
package exports imports into the other.
"""

from __future__ import annotations

import secrets
import threading
import time
from typing import Callable, Optional

from ..core.metrics import REGISTRY
# the platform's API group (kubeflow_tpu/serving/api.py GROUP)
GROUP = "serving.kubeflow.org"

# pod-template annotation declaring the replica's role; mirrored by the
# engine.json "role" key (serve.py validates it) so the pod and its engine
# cannot silently disagree in a hand-rolled deployment
ROLE_ANNOTATION = f"{GROUP}/role"
ROLES = ("prefill", "decode", "unified")

# service-level policy annotations (read by the proxy per relay)
DISAGG_ANNOTATION = f"{GROUP}/disagg"                # "auto" | "all" | "off"
DISAGG_MIN_PROMPT_ANNOTATION = f"{GROUP}/disagg-min-prompt"
DISAGG_RATIO_ANNOTATION = f"{GROUP}/disagg-ratio"
DEFAULT_MIN_PROMPT_CHARS = 64
DEFAULT_PROMPT_DECODE_RATIO = 1.0

# Placement decisions the ingress makes beyond plain load balancing.
# Disaggregation (README "Disaggregated serving"): one prefill + one
# decode increment per split request; a "unified" increment when a
# planned split degraded to the unified path (prefill phase failed / no
# prefill replica routable).  Fleet KV fabric (README "Fleet KV fabric"):
# a reason="cache" increment when global cache-aware placement landed a
# request on the replica holding its deepest published prefix.  Services
# without role-split replicas or fabric publishes never touch this
# counter.
PLACEMENTS = REGISTRY.counter(
    "ingress_placements_total",
    "ingress placement decisions: role=prefill/decode/unified for "
    "disaggregated splits, reason=\"cache\" for fabric cache-aware picks")


def normalize_role(role) -> str:
    """Validate an engine/pod role declaration ('' / None = unified)."""
    if role in (None, ""):
        return "unified"
    if role not in ROLES:
        raise ValueError(f"role must be one of {ROLES}, got {role!r}")
    return role


def pod_role(pod) -> str:
    """A pod's declared role (unknown/absent values read as unified, so a
    typo'd annotation degrades to taking all traffic, never to taking
    none)."""
    r = (pod.get("metadata", {}).get("annotations", {}) or {}).get(
        ROLE_ANNOTATION)
    return r if r in ROLES else "unified"


def eligible_path(path: str) -> bool:
    """Disaggregation covers the V2 generate surface (unary + stream) —
    the paths whose payloads carry a text prompt the proxy can classify."""
    p = path.split("?")[0].rstrip("/")
    return p.endswith("/generate") or p.endswith("/generate_stream")


def model_from_path(path: str) -> Optional[str]:
    """The model name out of ``/v2/models/<name>/generate[_stream]``."""
    p = path.split("?")[0].rstrip("/")
    prefix = "/v2/models/"
    if not p.startswith(prefix):
        return None
    rest = p[len(prefix):]
    name = rest.split("/")[0]
    return name or None


def should_disaggregate(payload, mode: str, min_prompt: int,
                        ratio: float) -> bool:
    """Classify one request: split it into prefill + decode phases?

    Only plain text requests qualify: sessions stay with their pinned
    replica, failover re-admissions (resume_token_ids) already carry
    generated state, and requests that ARE a disagg phase (kv_handoff /
    handoff parameters) must not recurse.  ``mode="all"`` forces every
    eligible request (deterministic tests/bench); ``"auto"`` splits when
    the prompt is long in absolute terms AND relative to the expected
    decode length — short-prompt/long-decode traffic is exactly what the
    decode pool exists to protect, not to burden with handoffs."""
    if not isinstance(payload, dict):
        return False
    prompt = payload.get("text_input")
    if not isinstance(prompt, str) or not prompt:
        return False
    params = payload.get("parameters")
    params = params if isinstance(params, dict) else {}
    if (params.get("session_id") is not None
            or params.get("resume_token_ids") is not None
            or params.get("kv_handoff")
            or params.get("handoff") is not None):
        return False
    try:
        max_tokens = int(params.get("max_tokens", 32))
    except (TypeError, ValueError):
        return False
    if max_tokens <= 1:
        return False  # the prefill phase already produces the only token
    if mode == "all":
        return True
    # chars stand in for tokens (exact for the byte tokenizer; a constant
    # factor otherwise — this is a routing heuristic, not accounting)
    return (len(prompt) >= min_prompt
            and len(prompt) >= ratio * max_tokens)


class HandoffStore:
    """One engine's exported-KV registry: handle -> serialized KVPG frame.

    Handles are unguessable (``secrets``), **one-shot** (a second pull is
    refused — after a failover re-dispatch the frame may already be
    scattered into another replica's pool, and serving it twice would let
    two slots diverge from one blob) and **TTL'd** (an orphaned export —
    decode replica died before pulling — must not pin pool-sized blobs in
    host RAM forever).  Consumed handles leave a byte-free tombstone until
    their TTL so a double pull reads as "refused", not "unknown".  A byte
    budget evicts oldest-first when exports outrun pulls; the engine
    degrades that export to the unified path.  Thread-safe: the engine
    loop exports while HTTP handler threads pull."""

    def __init__(self, ttl_s: float = 60.0, max_bytes: int = 256 << 20,
                 clock: Callable[[], float] = time.monotonic):
        self.ttl_s = float(ttl_s)
        self.max_bytes = int(max_bytes)
        self._clock = clock
        self._lock = threading.Lock()
        # handle -> {data|None, nbytes, meta, expires}; insertion-ordered
        # (eviction is oldest-first); _used is the running live-byte
        # total so the eviction loop never re-sums the whole store
        self._entries: dict = {}
        self._used = 0
        # tier quarantine (README "Self-driving fleet"): while set, the
        # store refuses new exports and answers pulls as misses — the
        # engine's existing degradation contract (unified-path fallback /
        # re-prefill) becomes the tier's serving mode until lifted
        self._quarantined = False
        self.quarantine_refusals = 0
        self.exports = 0
        self.pulls = 0
        self.refused = 0      # second pull of a consumed handle
        self.expired = 0      # pull after TTL (or a chaos-expired export)
        self.misses = 0       # pull of a handle never exported here
        self.evictions = 0    # budget evictions (export degraded)

    def _sweep_locked(self, now: float) -> None:
        for h in [h for h, e in self._entries.items()
                  if e["expires"] <= now]:
            self._used -= self._entries[h]["nbytes"]
            del self._entries[h]

    def put(self, data: bytes, meta: dict,
            ttl_s: Optional[float] = None) -> Optional[str]:
        """Register one export; returns the handle, or None when the byte
        budget cannot fit it even after evicting every other entry (the
        caller degrades the export)."""
        now = self._clock()
        n = len(data)
        with self._lock:
            if self._quarantined:
                self.quarantine_refusals += 1
                return None
            self._sweep_locked(now)
            if n > self.max_bytes:
                return None
            while self._used + n > self.max_bytes:
                victim = next(iter(self._entries), None)
                if victim is None:
                    return None
                self._used -= self._entries[victim]["nbytes"]
                del self._entries[victim]
                self.evictions += 1
            handle = secrets.token_hex(16)
            ttl = self.ttl_s if ttl_s is None else float(ttl_s)
            self._entries[handle] = {"data": data, "nbytes": n,
                                     "meta": dict(meta),
                                     "expires": now + ttl}
            self._used += n
            self.exports += 1
            return handle

    def pull(self, handle: str, count_miss: bool = True):
        """-> (outcome, data|None): outcome in {"ok", "refused",
        "expired", "miss"}.  An "ok" pull consumes the handle (tombstone
        kept until TTL).  ``count_miss=False`` leaves the miss counter
        alone — a multi-model server probing every engine for a handle
        must not inflate the stores that simply don't own it."""
        now = self._clock()
        with self._lock:
            if self._quarantined:
                # quarantined tier: every pull reads as a miss (stable
                # outcome vocabulary) and the decode side re-prefills
                self.quarantine_refusals += 1
                return "miss", None
            e = self._entries.get(handle)
            if e is not None and e["expires"] <= now:
                self._used -= e["nbytes"]
                del self._entries[handle]
                self.expired += 1
                return "expired", None
            if e is None:
                if count_miss:
                    self.misses += 1
                return "miss", None
            if e["data"] is None:
                self.refused += 1
                return "refused", None
            data = e["data"]
            e["data"] = None  # consumed tombstone: frees the bytes now
            self._used -= e["nbytes"]
            e["nbytes"] = 0
            self.pulls += 1
            return "ok", data

    def drop(self, handle: str) -> bool:
        """Discard one export outright (no pull accounting): the prefill
        phase learned the generation is already COMPLETE, so nobody will
        ever pull this frame — free its bytes now instead of at TTL."""
        with self._lock:
            e = self._entries.pop(handle, None)
            if e is not None:
                self._used -= e["nbytes"]
            return e is not None

    def sweep(self, now: Optional[float] = None) -> int:
        """Drop expired entries; returns how many LIVE (unconsumed,
        unexpired) exports remain pending — the bench's leak signal."""
        with self._lock:
            self._sweep_locked(self._clock() if now is None else now)
            return sum(1 for e in self._entries.values()
                       if e["data"] is not None)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._used = 0

    def set_quarantined(self, quarantined: bool) -> None:
        """Tier quarantine switch (remediator.TierQuarantine enforcer):
        pending exports stay resident — a lift resumes pulls without
        losing frames exported just before the quarantine."""
        with self._lock:
            self._quarantined = bool(quarantined)

    def quarantined(self) -> bool:
        with self._lock:
            return self._quarantined

    def stats(self) -> dict:
        with self._lock:
            live = [e for e in self._entries.values()
                    if e["data"] is not None]
            return {
                "pending": len(live),
                "pending_bytes": self._used,
                "exports": self.exports,
                "pulls": self.pulls,
                "refused": self.refused,
                "expired": self.expired,
                "misses": self.misses,
                "evictions": self.evictions,
                "quarantined": self._quarantined,
                "quarantine_refusals": self.quarantine_refusals,
            }
