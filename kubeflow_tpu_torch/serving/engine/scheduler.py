"""QoS scheduler: priority classes, SLO-aware admission, preemption.

Counterpart of ``kubeflow_tpu/serving/engine/scheduler.py``: the host-side
scheduling layer between ``generate_async`` and the C++ batcher.  Admission
decisions are made PER TICK, between iterations, not per request at submit
time.

  * ``QosScheduler`` — the admission queue the engine drains each tick.
    Policy "priority": strict priority classes (``interactive`` >
    ``batch`` > ``best_effort``), earliest-deadline-first within a class,
    and weighted fair share across adapters (stride scheduling over a
    per-adapter virtual time charged in KV pages).  Policy "fifo"
    reproduces submission order — the baseline.
  * ``SchedulerConfig`` — frozen knobs riding inside ``EngineConfig``
    (preemption on/off, swap-vs-recompute policy, host swap budget).

Preemption itself lives in the engine (it touches slots, pools and the C++
core); this module supplies the decisions: what to admit next, what has
expired.  The swap backing store is ``kvstore.TieredKVStore``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

from ..errors import RequestError

# rank 0 admits first; preemption only ever evicts a STRICTLY larger rank
PRIORITY_CLASSES = ("interactive", "batch", "best_effort")
PRIORITY_RANK = {name: i for i, name in enumerate(PRIORITY_CLASSES)}


def normalize_priority(priority) -> str:
    """Validate a request ``priority`` param (None = interactive).  Raises
    RequestError — the HTTP layer maps it to 400 — on anything outside the
    class set."""
    if priority is None:
        return "interactive"
    if not isinstance(priority, str) or priority not in PRIORITY_RANK:
        raise RequestError(
            f"priority must be one of {list(PRIORITY_CLASSES)}, "
            f"got {priority!r}")
    return priority


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Frozen scheduling knobs (rides in the frozen/hashable EngineConfig)."""

    # "priority": classes + EDF + adapter fair share.  "fifo": submission
    # order, preemption typically off — the baseline
    policy: str = "priority"
    # ((adapter_name, weight), ...): fair-share weight per adapter (absent
    # adapters and the base model weigh 1.0); the engine refuses a name it
    # has not loaded
    adapter_weights: Tuple[Tuple[str, float], ...] = ()
    # allow evicting a decoding slot for a blocked higher-priority request
    # (and for pool pressure).  Off = admission-only QoS.
    preemption: bool = True
    # at most this many evictions per engine tick — a storm limiter
    max_preemptions_per_tick: int = 1
    # what to do with a victim's KV pages: "swap" moves them to the host
    # store and restores byte-identically on resume; "recompute" drops them
    # into the prefix cache and re-prefills the uncovered tail; "auto"
    # swaps when the committed context is at least swap_min_tokens
    swap_policy: str = "auto"
    swap_min_tokens: int = 256
    # host-RAM budget for swapped KV when no KVStoreConfig is given; a put
    # past it falls back to recompute
    swap_max_bytes: int = 1 << 30
    # pool-pressure relief: when free+reclaimable pages drop below this
    # watermark and a strictly lower-priority decode slot exists, preempt
    # it (0 = off).  Also an admission reserve: a request only admits when
    # its prompt fits with min_free_pages left over, so an evicted slot
    # stays queued until the pressure clears
    min_free_pages: int = 0


@dataclasses.dataclass
class QueueEntry:
    """One queued (or preempted-and-requeued) request, as the scheduler
    sees it.  ``seq`` is the submission tiebreak (the rid — monotonic);
    ``pages`` the prompt's page cost, the fair-share charge unit."""

    rid: int
    rank: int
    deadline: Optional[float]  # absolute perf_counter, None = none
    submitted_at: float
    adapter_id: int
    pages: int

    @property
    def seq(self) -> int:
        return self.rid


class QosScheduler:
    """Per-tick admission queue.  Thread-safe: submit threads push, the
    engine loop peeks/pops, cancel paths remove, scrapes snapshot."""

    def __init__(self, config: SchedulerConfig,
                 adapter_weights: Optional[Dict[int, float]] = None):
        if config.policy not in ("priority", "fifo"):
            raise ValueError(f"unknown scheduler policy {config.policy!r}")
        if config.swap_policy not in ("auto", "swap", "recompute"):
            raise ValueError(
                f"unknown swap_policy {config.swap_policy!r} "
                "(auto | swap | recompute)")
        self.config = config
        self._lock = threading.Lock()
        self._entries: Dict[int, QueueEntry] = {}
        # stride scheduling: virtual time per adapter id, advanced by
        # pages/weight at each admission; the adapter with the smallest
        # vtime among those queued in the winning class goes next
        self._vtime: Dict[int, float] = {}
        self._weights: Dict[int, float] = dict(adapter_weights or {})
        self.admitted = 0
        self.reaped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def push(self, entry: QueueEntry) -> None:
        with self._lock:
            self._entries[entry.rid] = entry
            if entry.adapter_id not in self._vtime:
                # a joining adapter starts at the floor of the tenants it
                # will compete with: floor over adapters with QUEUED work
                # when any exist, else over every recorded vtime (an idle
                # tenant must not bank unbounded credit)
                queued = {e.adapter_id for e in self._entries.values()
                          if e.rid != entry.rid
                          and e.adapter_id in self._vtime}
                pool = ([self._vtime[a] for a in queued]
                        or list(self._vtime.values()))
                self._vtime[entry.adapter_id] = min(pool) if pool else 0.0

    def remove(self, rid: int) -> bool:
        with self._lock:
            return self._entries.pop(rid, None) is not None

    def peek(self) -> Optional[QueueEntry]:
        """The entry the policy would admit next (not removed).  peek/pop
        are split so a blocked head can trigger preemption without losing
        its place."""
        with self._lock:
            if not self._entries:
                return None
            if self.config.policy == "fifo":
                return min(self._entries.values(), key=lambda e: e.seq)
            best_rank = min(e.rank for e in self._entries.values())
            in_class = [e for e in self._entries.values()
                        if e.rank == best_rank]
            # fair share across adapters: smallest virtual time first
            aid = min({e.adapter_id for e in in_class},
                      key=lambda a: (self._vtime.get(a, 0.0), a))
            mine = [e for e in in_class if e.adapter_id == aid]
            # EDF within the adapter; no deadline = latest; seq tiebreak
            return min(mine, key=lambda e: (
                e.deadline if e.deadline is not None else float("inf"),
                e.seq))

    def pop(self, entry: QueueEntry) -> None:
        """Commit an admission: remove the entry and charge its adapter's
        virtual time (pages / weight)."""
        with self._lock:
            if self._entries.pop(entry.rid, None) is None:
                return
            w = max(1e-6, self._weights.get(entry.adapter_id, 1.0))
            self._vtime[entry.adapter_id] = (
                self._vtime.get(entry.adapter_id, 0.0)
                + max(1, entry.pages) / w)
            self.admitted += 1

    def expired(self, now: float) -> List[QueueEntry]:
        """Queued entries whose deadline has lapsed.  The engine decides
        per entry (a preempted request past its first token is never shed)
        and calls ``remove`` on the ones it reaps."""
        with self._lock:
            return [e for e in self._entries.values()
                    if e.deadline is not None and now > e.deadline]

    def clear(self) -> List[QueueEntry]:
        with self._lock:
            out = list(self._entries.values())
            self._entries.clear()
            return out

    def snapshot(self) -> dict:
        with self._lock:
            by_class = {name: 0 for name in PRIORITY_CLASSES}
            for e in self._entries.values():
                by_class[PRIORITY_CLASSES[e.rank]] += 1
            return {"policy": self.config.policy, "queued": by_class,
                    "admitted": self.admitted, "reaped": self.reaped}
