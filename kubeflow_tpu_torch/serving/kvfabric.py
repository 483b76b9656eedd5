"""Fleet-wide KV fabric: shared prefix memory with global cache-aware
placement.

A copy of ``kubeflow_tpu/serving/kvfabric.py``: the fingerprints and keys
are the JAX package's, so the reference router places on a port
replica's published prefixes.

Before this module, every KV reuse mechanism was scoped to one replica
or one transfer: the device prefix cache is local, sessions pin
per-replica, and the ``HandoffStore`` moves a KV image exactly once,
prefill→decode.  The fabric generalizes all three into one
distributed prefix tier — the Mooncake/vLLM-lineage KV-centric design
(PagedAttention prefix sharing, PAPERS.md) lifted to fleet scope, with
orchestration kept off the engine's critical path per JetStream:

  * **publish** — when a request finishes, the engine snapshots its
    committed full-page prefix (the same geometry a session pin uses,
    keyed by the existing context chain hashes) into its local
    :class:`FabricStore` as one KVPG/CRC frame (a sharded version-2
    frame from a tensor-parallel replica, carried as opaque bytes like a
    version-1 one).  The frame is fleet-addressable via
    ``GET /engine/kv_fabric/<key>`` (server.py).
  * **place** — the service proxy scores replicas from the ``/fleet/cache``
    view (each replica's published prefixes ride in its cache analytics
    block): deepest-matched-prefix wins, load-balanced tiebreak,
    staleness-tolerant (router.py).
  * **pull** — when placement lands a request AWAY from the prefix's
    owner (load, stickiness, failover), the chosen replica faults the
    remote prefix into its local page pool: the serve layer pulls the
    frame, the KVPG verifier checks it (magic/length/CRC — torn and
    bit-flipped transfers are caught for free), and the engine's
    admission path scatters the verified pages exactly like a session
    restore, re-prefilling only the uncovered tail.

Unlike the handoff store, fabric entries are **multi-reader** (a popular
system prompt is pulled by every replica that needs it — no one-shot
tombstones), **TTL'd** (an unused prefix ages out instead of pinning
pool-sized bytes forever; a pull refreshes the clock, so hot prefixes
stay live) and **byte-budgeted** with least-recently-used eviction.

Degradation contract (the session restore's): ANY fabric failure — torn
or bit-flipped transfer, slow link past the pull timeout, dead link, expired
or evicted entry, budget-refused publish, chain-hash mismatch, shape skew,
scatter failure — degrades to a plain (prefix-cache-assisted) re-prefill,
never a failed request, byte-identical under greedy.  The recomputed
prefill is attributed ``fabric_degraded`` in the perf ledger so
fleet-level recompute waste is visible, and remote-hit savings land as
goodput.

Placement fingerprints: the router cannot compute token chain hashes (it
has no tokenizer), so every published prefix also carries a ladder of
prompt-TEXT fingerprints (:func:`fingerprints` over the decoded prefix at
:data:`FP_LADDER` char lengths) that the router can recompute from any
request body.  For the byte tokenizer chars == tokens and the match is
exact; for other tokenizers it is a routing heuristic — a wrong match
costs one degraded pull, never correctness (the engine verifies the
actual chain hashes before scattering a single page).
"""

from __future__ import annotations

import hashlib
import re
import threading
import time
from typing import Callable, Optional

# char-prefix lengths the text fingerprint ladder covers.  Powers of two
# from "one short system-prompt line" up to "a long agent scaffold"; both
# the publisher (serve.py, over the decoded prefix) and the router (over
# the request prompt) compute the same ladder, and the match depth is the
# largest rung where the fingerprints agree.
FP_LADDER = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)

# fabric keys are the %016x rendering of the prefix's deepest chain hash
# (engine._page_hashes) — they interpolate into a localhost pull URL, so
# the shape is enforced wherever one crosses a trust boundary (serve.py
# request parsing, the server route)
KEY_RE = re.compile(r"[0-9a-f]{16}")


def fabric_key(chain_hash: int) -> str:
    """The store key for a published prefix: its deepest chain hash."""
    return f"{int(chain_hash) & 0xFFFFFFFFFFFFFFFF:016x}"


def fingerprints(text: str) -> list:
    """Text fingerprint ladder for placement matching: one 16-hex digest
    per :data:`FP_LADDER` rung the text reaches (index-aligned, so depth
    comparison is a pairwise walk).  Deliberately over CHARS, not tokens —
    the one prompt representation the router and the serve layer share."""
    out = []
    for n in FP_LADDER:
        if len(text) < n:
            break
        out.append(hashlib.blake2b(text[:n].encode("utf-8", "replace"),
                                   digest_size=8).hexdigest())
    return out


def match_depth(request_fps: list, published_fps: list) -> int:
    """Chars of prefix two fingerprint ladders agree on: the LADDER value
    at the deepest rung where both sides match (0 = no match).  A single
    mismatched rung ends the walk — fingerprints chain over strictly
    growing prefixes, so a deeper accidental collision cannot be real."""
    depth = 0
    for i, (a, b) in enumerate(zip(request_fps, published_fps)):
        if a != b:
            break
        depth = FP_LADDER[i]
    return depth


class FabricStore:
    """One replica's published-prefix registry: key -> KVPG frame.

    The multi-reader generalization of disagg.HandoffStore's one-shot
    registry: entries are pulled any number of times (``pull`` never
    consumes — the whole point is N replicas warming from one publish),
    TTL'd with refresh-on-pull (hot prefixes stay; orphans age out), and
    byte-budgeted with least-recently-USED eviction (the handoff store
    evicts oldest-first because its entries are one-shot and short-lived;
    fabric entries live as long as they are useful).  Thread-safe: the
    engine loop publishes while HTTP handler threads serve pulls."""

    def __init__(self, ttl_s: float = 120.0, max_bytes: int = 256 << 20,
                 clock: Callable[[], float] = time.monotonic):
        self.ttl_s = float(ttl_s)
        self.max_bytes = int(max_bytes)
        self._clock = clock
        self._lock = threading.Lock()
        # key -> {data, nbytes, meta, expires, touched, pulls}
        self._entries: dict = {}
        self._used = 0
        self._seq = 0  # LRU clock (monotonic touch counter)
        # tier quarantine (README "Self-driving fleet"): while set, the
        # store refuses publishes and answers every pull as a miss — the
        # callers' existing degradation contract (local re-prefill)
        # becomes the tier's serving mode until the probe lifts it
        self._quarantined = False
        self.quarantine_refusals = 0
        self.publishes = 0
        self.republishes = 0   # publish of a key already present (refresh)
        self.rejected = 0      # budget could not fit the frame
        self.pulls = 0
        self.misses = 0        # pull of a key not present (incl. evicted)
        self.expired = 0       # pull found the entry past its TTL
        self.evictions = 0     # LRU budget evictions

    def _sweep_locked(self, now: float) -> None:
        for k in [k for k, e in self._entries.items()
                  if e["expires"] <= now]:
            self._used -= self._entries[k]["nbytes"]
            del self._entries[k]

    def publish(self, key: str, data: bytes, meta: dict,
                ttl_s: Optional[float] = None) -> bool:
        """Register (or refresh) one prefix frame under ``key``.  False
        when the byte budget cannot fit it even after evicting everything
        else — the caller counts a failed publish and moves on (the
        prefix still lives in the local device cache; only the FLEET
        loses the share)."""
        now = self._clock()
        n = len(data)
        ttl = self.ttl_s if ttl_s is None else float(ttl_s)
        with self._lock:
            if self._quarantined:
                self.quarantine_refusals += 1
                return False
            self._sweep_locked(now)
            if n > self.max_bytes:
                self.rejected += 1
                return False
            old = self._entries.get(key)
            if old is not None:
                # refresh in place: same prefix re-published (another
                # request finished on it) — newer frame + fresh TTL
                self._used -= old["nbytes"]
            while self._used + n > self.max_bytes:
                cands = [k for k in self._entries if k != key]
                if not cands:
                    self.rejected += 1
                    if old is not None:  # keep the old frame live
                        self._used += old["nbytes"]
                    return False
                victim = min(cands,
                             key=lambda k: self._entries[k]["touched"])
                self._used -= self._entries[victim]["nbytes"]
                del self._entries[victim]
                self.evictions += 1
            self._seq += 1
            self._entries[key] = {"data": data, "nbytes": n,
                                  "meta": dict(meta),
                                  "expires": now + ttl,
                                  "touched": self._seq,
                                  "pulls": (old or {}).get("pulls", 0),
                                  "published_at": now}
            self._used += n
            if old is not None:
                self.republishes += 1
            else:
                self.publishes += 1
            return True

    def covers(self, key: str, pages: int) -> bool:
        """True when a live entry under ``key`` already spans at least
        ``pages`` pages — the publisher's cheap skip check (snapshotting
        device pages per finish is the expensive half, not this)."""
        with self._lock:
            if self._quarantined:
                return False
            e = self._entries.get(key)
            return (e is not None and e["expires"] > self._clock()
                    and int(e["meta"].get("pages") or 0) >= pages)

    def set_quarantined(self, quarantined: bool) -> None:
        """Tier quarantine switch (remediator.TierQuarantine enforcer):
        entries stay resident — serving resumes the moment the health
        probe lifts the quarantine, no re-publish storm needed."""
        with self._lock:
            self._quarantined = bool(quarantined)

    def quarantined(self) -> bool:
        with self._lock:
            return self._quarantined

    def pull(self, key: str, count_miss: bool = True):
        """-> (outcome, data|None): outcome in {"ok", "expired", "miss"}.
        MULTI-READER: an "ok" pull leaves the entry live, touches its LRU
        clock, and refreshes its TTL — every reader after the first is
        exactly the traffic the fabric exists for.  ``count_miss=False``:
        a multi-model server probing every engine for the owner must not
        inflate the stores that never published it."""
        now = self._clock()
        with self._lock:
            if self._quarantined:
                # a quarantined tier answers every pull as a miss: the
                # puller's existing contract degrades it to re-prefill,
                # and the outcome vocabulary stays stable for callers
                self.quarantine_refusals += 1
                return "miss", None
            e = self._entries.get(key)
            if e is None:
                if count_miss:
                    self.misses += 1
                return "miss", None
            if e["expires"] <= now:
                self._used -= e["nbytes"]
                del self._entries[key]
                self.expired += 1
                return "expired", None
            self._seq += 1
            e["touched"] = self._seq
            e["expires"] = now + self.ttl_s
            e["pulls"] += 1
            self.pulls += 1
            return "ok", e["data"]

    def sweep(self, now: Optional[float] = None) -> int:
        """Drop expired entries; returns how many live entries remain."""
        with self._lock:
            self._sweep_locked(self._clock() if now is None else now)
            return len(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._used = 0

    _VIEW_CAP = 64  # published prefixes listed per /fleet/cache snapshot

    def view(self) -> list:
        """The placement-facing listing of live published prefixes —
        most-recently-used first, capped (a replica with thousands of
        published prefixes ships its hot set, not its long tail): key,
        page/byte sizes so the scorer can weigh bytes saved, pull reuse
        counts, and the text fingerprint ladder the router matches on."""
        now = self._clock()
        with self._lock:
            if self._quarantined:
                return []  # stop advertising: placement must not score
                # a tier that will refuse the pull
            live = [(k, e) for k, e in self._entries.items()
                    if e["expires"] > now]
            live.sort(key=lambda ke: -ke[1]["touched"])
            return [{"key": k,
                     "pages": int(e["meta"].get("pages") or 0),
                     "nbytes": e["nbytes"],
                     "pulls": e["pulls"],
                     "age_s": round(now - e["published_at"], 3),
                     "fps": list(e["meta"].get("fps") or ())}
                    for k, e in live[:self._VIEW_CAP]]

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._used,
                "publishes": self.publishes,
                "republishes": self.republishes,
                "rejected": self.rejected,
                "pulls": self.pulls,
                "misses": self.misses,
                "expired": self.expired,
                "evictions": self.evictions,
                "quarantined": self._quarantined,
                "quarantine_refusals": self.quarantine_refusals,
            }
