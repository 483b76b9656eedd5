"""Deterministic chaos injection for the serving engine.

Counterpart of ``kubeflow_tpu/serving/engine/faults.py``, in two scopes:

* Dispatch scope: a frozen, seeded ``FaultConfig`` rides inside
  ``EngineConfig`` and a ``ChaosInjector`` built from it fires faults at
  the engine loop's hook points, exactly as the JAX package's does (the
  same seed draws the same numbers, so the same rows are poisoned and the
  same requests fail in both packages):

  * ``on_tick``          — slow ticks (watchdog/hang exercise) and loop
                           thread death (supervisor/restart exercise)
  * ``maybe_dispatch_error`` — raises inside an isolation boundary, as a
                           failed prefill/decode dispatch would
  * ``nan_rows``         — picks logits rows to poison with NaN, as a
                           numerically-diverged model would (the engine
                           poisons them: the sync paths set the rows to
                           NaN, the fused pipelined dispatches take them
                           as their poison mask)
  * ``should_preempt``   — forced preemption storms

  ``ChaosThreadDeath`` deliberately subclasses ``BaseException``: the tick
  isolation boundaries catch ``Exception``, and simulated thread death must
  sail through them and actually kill the loop thread, the way a real
  un-catchable failure would.  ``EXPECTED_INCIDENT_CAUSES`` names the root
  cause the incident plane must classify each chaos class as.

* Storage scope: torn writes, bit flips, slow reads and writes, and ENOSPC,
  provoked deterministically on the tiered KV store's disk tier
  (kvstore.py).

* Handoff and fabric scopes: torn, flipped, slow and dead-link pulls of a
  KVPG frame, and pre-expired exports and publishes, on the disaggregated
  handoff (disagg.py) and the fleet KV fabric (kvfabric.py), counted as
  the JAX package counts them.  Their ``shard_*`` fields corrupt one
  sub-frame of a sharded (version 2) frame, which this port does not read
  (ROADMAP item 1.8): a config that sets one off its default is refused.

The constrain, storm and fleet fault families come with the slices that
port those subsystems.
"""

from __future__ import annotations

import dataclasses
import errno
import threading
import time
from typing import Tuple

import numpy as np


class ChaosDispatchError(RuntimeError):
    """An injected dispatch failure (stands in for a thrown prefill/decode)."""


# Chaos class -> the root cause the incident plane must name for it
# (serving/incidents.py CAUSES).  Keys are "<scope>:<class>" so the fleet
# "slow" replica and the storage "slow" disk stay distinct entries.
EXPECTED_INCIDENT_CAUSES = {
    # fleet scope (FleetFaultConfig): the ingress sees failover retries /
    # breaker opens for every one of these
    "fleet:kill": "replica_death",
    "fleet:hang": "replica_death",
    "fleet:slow": "replica_death",
    "fleet:cut": "replica_death",
    # engine scope: loop death / hang is the engine-local replica death
    "engine:die_on_tick": "replica_death",
    "engine:slow_tick": "replica_death",
    # storage scope (StorageFaultConfig): every verification failure
    # degrades a session restore to recompute
    "storage:torn_write": "storage_degradation",
    "storage:bit_flip": "storage_degradation",
    "storage:enospc": "storage_degradation",
    # handoff scope (HandoffFaultConfig): every pull/export fault
    # degrades the disaggregated import to re-prefill
    "handoff:torn_pull": "handoff_degradation",
    "handoff:slow_pull": "handoff_degradation",
    "handoff:dead_link": "handoff_degradation",
    "handoff:expired_export": "handoff_degradation",
    # sharded-frame chaos (README "Sharded serving"): ONE corrupted
    # sub-frame of a tensor-parallel frame degrades the whole import —
    # exactly like a torn unified frame, caught by the per-shard verifier
    "handoff:shard_torn_pull": "handoff_degradation",
    "handoff:shard_flip_pull": "handoff_degradation",
    "handoff:shard_drop_pull": "handoff_degradation",
    # fabric scope (FabricFaultConfig): every pull/publish fault degrades
    # the prefix fault-in to plain re-prefill
    "fabric:torn_pull": "fabric_degradation",
    "fabric:flip_pull": "fabric_degradation",
    "fabric:slow_pull": "fabric_degradation",
    "fabric:dead_link": "fabric_degradation",
    "fabric:expired_publish": "fabric_degradation",
    "fabric:shard_torn_pull": "fabric_degradation",
    "fabric:shard_flip_pull": "fabric_degradation",
    "fabric:shard_drop_pull": "fabric_degradation",
    # storm scope (StormFaultConfig): a traffic storm against the ingress
    # overload controller surfaces as aggregated shed bursts + brownout
    # stage transitions — ONE self-resolving capacity incident, not an
    # alert storm (README "Overload control")
    "storm:overload": "capacity",
    # constrain scope (ConstrainFaultConfig): a constrained slot whose
    # mask has ZERO legal tokens is an engine-side grammar-compile or
    # token-map bug — NEVER the client's fault (their schema compiled;
    # admission already validated it).  The corrupt-cache injection does
    # NOT appear here: a corrupted token-map cache must degrade to a
    # counted re-compile with no incident at all.
    "constrain:stall": "constraint_stall",
}

# Root cause -> the remediation playbook the self-driving fleet runs for
# it (the JAX package's serving/remediator.py CAUSE_PLAYBOOK, kept as a
# literal here as it is there).
_CAUSE_PLAYBOOK = {
    "replica_death": "replace_replica",
    "prefill_interference": "split_roles",
    "capacity": "prescale",
    "storage_degradation": "quarantine_tier",
    "handoff_degradation": "quarantine_tier",
    "fabric_degradation": "quarantine_tier",
    # a grammar/token-map bug needs a code fix, not an actuator: the
    # playbook observes (bundle + postmortem), it does not auto-heal
    "constraint_stall": "observe",
    "unknown": "observe",
}

# Chaos class -> {cause, playbook}: the full expected-remediation
# contract (README "Self-driving fleet").  A new injector class must
# declare not just what NAMES it (EXPECTED_INCIDENT_CAUSES) but what
# FIXES it — the fleet's remediation contract, whose control plane is
# the JAX package's (JAX-free) router and remediator.
EXPECTED_REMEDIATIONS = {
    key: {"cause": cause, "playbook": _CAUSE_PLAYBOOK[cause]}
    for key, cause in EXPECTED_INCIDENT_CAUSES.items()
}


class ChaosThreadDeath(BaseException):
    """Injected loop-thread death; BaseException so isolation boundaries
    (which catch Exception) cannot contain it — only the watchdog can."""


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Seeded fault plan. Frozen (rides in the frozen/hashable EngineConfig);
    all-defaults == inject nothing."""

    seed: int = 0
    # probability that any single guarded dispatch (one prefill group / one
    # decode tick) raises ChaosDispatchError
    dispatch_error_rate: float = 0.0
    # probability, per decode row per tick, that the row's logits are
    # poisoned with NaN before sampling
    nan_logit_rate: float = 0.0
    # restrict NaN poisoning to these request ids (empty = any row)
    target_rids: Tuple[int, ...] = ()
    # restrict NaN poisoning to one sample phase: "" = any, "prefill" =
    # only the fused first-token sample, "decode" = only plain decode
    # ticks, "verify" = only speculative verify passes (sync AND the fused
    # pipelined dispatch).  "decode" is how the pipelined-loop
    # tests aim a NaN at a row that has already LEFT the synchronous
    # prefill path — the poison then rides the fused decode dispatch and
    # is detected at the commit-behind fence, one tick after injection
    # (engine.py "Tick pipelining"); "verify" does the same for the
    # speculative path, where the guard must also discard every
    # not-yet-committed accepted token of the poisoned pass (no phantom
    # multi-token commit from NaN logits)
    nan_phase: str = ""
    # sleep slow_tick_s at the top of every Nth tick (0 = off), or exactly
    # once at tick slow_tick_on (1-based; -1 = off): makes the loop look
    # hung to the watchdog without actually deadlocking pytest
    slow_tick_every: int = 0
    slow_tick_on: int = -1
    slow_tick_s: float = 0.0
    # raise ChaosThreadDeath at the top of this tick number (1-based;
    # -1 = off): the loop thread dies and the supervisor must notice
    die_on_tick: int = -1
    # force-preempt the engine's lowest-priority decode slot every Nth tick
    # (0 = off): the preemption-storm substrate for the QoS scheduler's
    # swap/resume byte-identity and page-leak tests (engine/scheduler.py)
    preempt_every: int = 0


class ChaosInjector:
    """Runtime half of FaultConfig: owns the RNG, the tick counter, and the
    injected-fault counters the tests/bench assert against."""

    def __init__(self, config: FaultConfig):
        self.config = config
        self.rng = np.random.default_rng(config.seed)
        self.tick = 0
        self.injected_dispatch_errors = 0
        self.injected_nan_rows = 0
        self.injected_slow_ticks = 0
        self.injected_deaths = 0
        self.injected_preempt_signals = 0
        # externally-armed one-shot slow tick (fleet chaos "hang"): set by
        # arm_slow from any thread, consumed by the loop at its next tick
        self._armed_slow_s = 0.0

    def arm_slow(self, duration_s: float) -> None:
        """Arm ONE slow tick of ``duration_s`` from outside the loop — the
        fleet harness's mid-decode hang: the replica keeps its sockets open
        but its engine loop goes silent, exactly the failure the ingress
        stall detector (relay timeout) exists for."""
        self._armed_slow_s = float(duration_s)

    def on_tick(self) -> None:
        """Called once at the top of every engine tick (idle ticks too)."""
        self.tick += 1
        c = self.config
        if c.die_on_tick > 0 and self.tick == c.die_on_tick:
            self.injected_deaths += 1
            raise ChaosThreadDeath(f"injected loop death at tick {self.tick}")
        armed, self._armed_slow_s = self._armed_slow_s, 0.0
        if armed > 0:
            self.injected_slow_ticks += 1
            time.sleep(armed)
        if ((c.slow_tick_every > 0 and self.tick % c.slow_tick_every == 0)
                or (c.slow_tick_on > 0 and self.tick == c.slow_tick_on)):
            self.injected_slow_ticks += 1
            time.sleep(c.slow_tick_s)

    def should_preempt(self) -> bool:
        """Called once per tick by the engine's preemption hook: True on
        every ``preempt_every``-th tick.  Counts SIGNALS — the engine may
        find no eligible decode slot to evict that tick."""
        c = self.config
        if c.preempt_every > 0 and self.tick % c.preempt_every == 0:
            self.injected_preempt_signals += 1
            return True
        return False

    def maybe_dispatch_error(self, phase: str) -> None:
        """Called inside each isolation boundary, before the real dispatch."""
        c = self.config
        if c.dispatch_error_rate > 0 and self.rng.random() < c.dispatch_error_rate:
            self.injected_dispatch_errors += 1
            raise ChaosDispatchError(
                f"injected {phase} dispatch fault (tick {self.tick})")

    def nan_rows(self, row_rids, phase: str = "decode") -> list:
        """Rows (indices into ``row_rids``) whose logits should be poisoned
        this tick.  ``row_rids``: request id per logits row (-1 = inactive
        row, never poisoned).  ``phase`` is the sample site asking
        ("prefill" | "decode" | "verify"); draws happen only when the
        config's ``nan_phase`` matches (empty matches all), so phase
        filtering does not perturb the RNG stream of the phase under
        test."""
        c = self.config
        if c.nan_logit_rate <= 0:
            return []
        if c.nan_phase and phase != c.nan_phase:
            return []
        rows = []
        for i, rid in enumerate(row_rids):
            if rid < 0:
                continue
            if c.target_rids and rid not in c.target_rids:
                continue
            if self.rng.random() < c.nan_logit_rate:
                rows.append(i)
        if rows:
            self.injected_nan_rows += len(rows)
        return rows

    def stats(self) -> dict:
        return {
            "ticks_seen": self.tick,
            "injected_dispatch_errors": self.injected_dispatch_errors,
            "injected_nan_rows": self.injected_nan_rows,
            "injected_slow_ticks": self.injected_slow_ticks,
            "injected_deaths": self.injected_deaths,
            "injected_preempt_signals": self.injected_preempt_signals,
        }


# ------------------------------------------------------------- storage scope


@dataclasses.dataclass(frozen=True)
class StorageFaultConfig:
    """Seeded storage-fault plan for the tiered KV store's disk tier.
    Frozen (rides inside the frozen KVStoreConfig / EngineConfig);
    all-defaults == inject nothing.  ``*_on`` fields are 1-based operation
    ordinals (-1 = off); ``*_every`` fire on every Nth operation (0 = off)
    — writes and reads are counted separately."""

    seed: int = 0
    # truncate the Nth disk write's byte stream to half before it lands
    # (a write the filesystem acknowledged but never fully persisted);
    # the file-level length/magic checks must catch it on read
    torn_write_on: int = -1
    torn_write_every: int = 0
    # flip one payload byte of the Nth disk read (silent media corruption);
    # the CRC32 verifier must catch it
    bit_flip_on: int = -1
    bit_flip_every: int = 0
    # chronically slow media: sleep this long on matching reads/writes
    slow_read_s: float = 0.0
    slow_read_every: int = 1   # every Nth read sleeps (when slow_read_s > 0)
    slow_write_s: float = 0.0
    slow_write_every: int = 1
    # raise OSError(ENOSPC) on the Nth disk write — the mid-spill
    # out-of-space case; the store must degrade (reject/non-durable pin),
    # never crash or half-write
    enospc_on: int = -1
    enospc_every: int = 0


class StorageChaos:
    """Runtime half of StorageFaultConfig: wraps the store's two byte
    streams.  ``on_write(data) -> data`` may truncate (torn) or raise
    OSError(ENOSPC); ``on_read(data) -> data`` may sleep (slow disk) or
    flip a payload byte (checksum exercise).  Deterministic: one seeded
    RNG picks flip offsets, ordinal counters pick victims."""

    def __init__(self, config: StorageFaultConfig):
        self.config = config
        self.rng = np.random.default_rng(config.seed)
        self._lock = threading.Lock()
        self.writes = 0
        self.reads = 0
        self.injected_torn_writes = 0
        self.injected_bit_flips = 0
        self.injected_enospc = 0
        self.injected_slow_reads = 0
        self.injected_slow_writes = 0

    @staticmethod
    def _hit(n: int, on: int, every: int) -> bool:
        return (on > 0 and n == on) or (every > 0 and n % every == 0)

    def on_write(self, data: bytes) -> bytes:
        c = self.config
        with self._lock:
            self.writes += 1
            n = self.writes
            if self._hit(n, c.enospc_on, c.enospc_every):
                self.injected_enospc += 1
                raise OSError(errno.ENOSPC,
                              f"injected ENOSPC (chaos, write {n})")
            slow = (c.slow_write_s > 0
                    and n % max(1, c.slow_write_every) == 0)
            if slow:
                self.injected_slow_writes += 1
            torn = self._hit(n, c.torn_write_on, c.torn_write_every)
            if torn:
                self.injected_torn_writes += 1
        if slow:
            time.sleep(c.slow_write_s)
        if torn:
            return data[:max(8, len(data) // 2)]
        return data

    def on_read(self, data: bytes) -> bytes:
        c = self.config
        with self._lock:
            self.reads += 1
            n = self.reads
            slow = c.slow_read_s > 0 and n % max(1, c.slow_read_every) == 0
            if slow:
                self.injected_slow_reads += 1
            flip = self._hit(n, c.bit_flip_on, c.bit_flip_every) and len(data) > 16
            if flip:
                self.injected_bit_flips += 1
                # bias into the back half: the payload region, so the flip
                # lands in KV bytes (checksum territory), not the header
                i = int(self.rng.integers(len(data) // 2, len(data)))
        if slow:
            time.sleep(c.slow_read_s)
        if flip:
            b = bytearray(data)
            b[i] ^= 0x40
            return bytes(b)
        return data

    def stats(self) -> dict:
        with self._lock:
            return {
                "disk_writes": self.writes,
                "disk_reads": self.reads,
                "injected_torn_writes": self.injected_torn_writes,
                "injected_bit_flips": self.injected_bit_flips,
                "injected_enospc": self.injected_enospc,
                "injected_slow_reads": self.injected_slow_reads,
                "injected_slow_writes": self.injected_slow_writes,
            }


# ----------------------------------------------------- handoff, fabric scopes

_SHARD_FIELDS = ("shard_torn_pull_on", "shard_torn_pull_every",
                 "shard_flip_pull_on", "shard_flip_pull_every",
                 "shard_drop_pull_on", "shard_drop_pull_every")


def _refuse_shard_faults(config) -> None:
    """The ``shard_*`` injectors corrupt one sub-frame of a sharded
    (version 2) KVPG frame; this port reads no such frame, so a plan that
    arms one would inject nothing.  Refused, never dropped."""
    armed = [f for f in _SHARD_FIELDS
             if getattr(config, f) != (-1 if f.endswith("_on") else 0)]
    if armed:
        raise ValueError(
            f"{type(config).__name__}: {armed} corrupt sharded (format "
            "version 2) KVPG frames, which this port does not support yet "
            "(ROADMAP item 1.8 brings them)")


@dataclasses.dataclass(frozen=True)
class HandoffFaultConfig:
    """Seeded fault plan for the disaggregated prefill/decode KV handoff
    (serving/disagg.py).  Frozen (rides in the frozen EngineConfig as
    ``handoff_chaos``); all-defaults == inject nothing.  ``*_on`` are
    1-based pull/export ordinals (-1 = off); ``*_every`` fire on every Nth
    (0 = off).  Every injection must leave the request COMPLETED via the
    degraded re-prefill path with zero leaked KV pages on both replicas."""

    seed: int = 0
    # truncate the Nth pulled frame to half (a transfer the socket closed
    # mid-body); the KVPG magic/length/CRC verifier must catch it
    torn_pull_on: int = -1
    torn_pull_every: int = 0
    # chronically slow handoff link: sleep this long on matching pulls
    slow_pull_s: float = 0.0
    slow_pull_every: int = 0
    # raise ConnectionError on the Nth pull — the decode replica's link
    # (or the prefill replica) dying mid-pull
    dead_link_on: int = -1
    dead_link_every: int = 0
    # the Nth EXPORT registers with an already-lapsed TTL, so the decode
    # replica's pull finds the handle expired
    expire_export_on: int = -1
    expire_export_every: int = 0
    # sharded frames: refused off their defaults (_refuse_shard_faults)
    shard_torn_pull_on: int = -1
    shard_torn_pull_every: int = 0
    shard_flip_pull_on: int = -1
    shard_flip_pull_every: int = 0
    shard_drop_pull_on: int = -1
    shard_drop_pull_every: int = 0

    def __post_init__(self):
        _refuse_shard_faults(self)


class HandoffChaos:
    """Runtime half of HandoffFaultConfig: ``on_pull(data) -> data`` wraps
    the decode replica's pulled bytes (may truncate, sleep, or raise);
    ``expire_export()`` is consulted by the exporting engine per export
    (True = register the handle pre-expired).  Thread-safe: HTTP handler
    threads pull while the engine loop exports."""

    def __init__(self, config: HandoffFaultConfig):
        self.config = config
        self._lock = threading.Lock()
        self.pulls = 0
        self.exports = 0
        self.injected_torn_pulls = 0
        self.injected_slow_pulls = 0
        self.injected_dead_links = 0
        self.injected_expired_exports = 0

    @staticmethod
    def _hit(n: int, on: int, every: int) -> bool:
        return (on > 0 and n == on) or (every > 0 and n % every == 0)

    def on_pull(self, data: bytes) -> bytes:
        c = self.config
        with self._lock:
            self.pulls += 1
            n = self.pulls
            if self._hit(n, c.dead_link_on, c.dead_link_every):
                self.injected_dead_links += 1
                raise ConnectionError(
                    f"injected dead handoff link (chaos, pull {n})")
            slow = (c.slow_pull_s > 0 and c.slow_pull_every > 0
                    and n % c.slow_pull_every == 0)
            if slow:
                self.injected_slow_pulls += 1
            torn = self._hit(n, c.torn_pull_on, c.torn_pull_every)
            if torn:
                self.injected_torn_pulls += 1
        if slow:
            time.sleep(c.slow_pull_s)
        if torn:
            return data[:max(8, len(data) // 2)]
        return data

    def expire_export(self) -> bool:
        c = self.config
        with self._lock:
            self.exports += 1
            hit = self._hit(self.exports, c.expire_export_on,
                            c.expire_export_every)
            if hit:
                self.injected_expired_exports += 1
            return hit

    def stats(self) -> dict:
        with self._lock:
            return {
                "handoff_pulls": self.pulls,
                "handoff_exports": self.exports,
                "injected_torn_pulls": self.injected_torn_pulls,
                "injected_slow_pulls": self.injected_slow_pulls,
                "injected_dead_links": self.injected_dead_links,
                "injected_expired_exports": self.injected_expired_exports,
                # sharded frames are refused at config time
                "injected_shard_faults": 0,
            }


@dataclasses.dataclass(frozen=True)
class FabricFaultConfig:
    """Seeded fault plan for the fleet KV fabric (serving/kvfabric.py).
    Frozen (rides in the frozen EngineConfig as ``fabric_chaos``);
    all-defaults == inject nothing.  ``*_on`` are 1-based pull/publish
    ordinals (-1 = off); ``*_every`` fire on every Nth (0 = off).  Every
    injection must leave the request COMPLETED via the degraded re-prefill
    path with zero leaked KV pages on both replicas."""

    seed: int = 0
    # truncate the Nth pulled frame to half (socket closed mid-body); the
    # KVPG magic/length verifier must catch it
    torn_pull_on: int = -1
    torn_pull_every: int = 0
    # flip one payload bit in the Nth pulled frame; the CRC32 must catch it
    flip_pull_on: int = -1
    flip_pull_every: int = 0
    # chronically slow fabric link: sleep this long on matching pulls (a
    # sleep past the serve layer's pull timeout degrades to re-prefill)
    slow_pull_s: float = 0.0
    slow_pull_every: int = 0
    # raise ConnectionError on the Nth pull — the owner replica (or the
    # link) dying mid-pull
    dead_link_on: int = -1
    dead_link_every: int = 0
    # the Nth PUBLISH registers with an already-lapsed TTL, so a later
    # pull finds the entry expired
    expire_publish_on: int = -1
    expire_publish_every: int = 0
    # sharded frames: refused off their defaults (_refuse_shard_faults)
    shard_torn_pull_on: int = -1
    shard_torn_pull_every: int = 0
    shard_flip_pull_on: int = -1
    shard_flip_pull_every: int = 0
    shard_drop_pull_on: int = -1
    shard_drop_pull_every: int = 0

    def __post_init__(self):
        _refuse_shard_faults(self)


class FabricChaos:
    """Runtime half of FabricFaultConfig: ``on_pull(data) -> data`` wraps
    a pulling replica's fetched bytes (may truncate, flip a bit, sleep,
    or raise); ``expire_publish()`` is consulted by the publishing engine
    per publish (True = register the entry pre-expired).  Thread-safe:
    HTTP handler threads pull while the engine loop publishes."""

    def __init__(self, config: FabricFaultConfig):
        self.config = config
        self._lock = threading.Lock()
        self.pulls = 0
        self.publishes = 0
        self.injected_torn_pulls = 0
        self.injected_flipped_pulls = 0
        self.injected_slow_pulls = 0
        self.injected_dead_links = 0
        self.injected_expired_publishes = 0

    @staticmethod
    def _hit(n: int, on: int, every: int) -> bool:
        return (on > 0 and n == on) or (every > 0 and n % every == 0)

    def on_pull(self, data: bytes) -> bytes:
        c = self.config
        with self._lock:
            self.pulls += 1
            n = self.pulls
            if self._hit(n, c.dead_link_on, c.dead_link_every):
                self.injected_dead_links += 1
                raise ConnectionError(
                    f"injected dead fabric link (chaos, pull {n})")
            slow = (c.slow_pull_s > 0 and c.slow_pull_every > 0
                    and n % c.slow_pull_every == 0)
            if slow:
                self.injected_slow_pulls += 1
            torn = self._hit(n, c.torn_pull_on, c.torn_pull_every)
            if torn:
                self.injected_torn_pulls += 1
            flip = self._hit(n, c.flip_pull_on, c.flip_pull_every)
            if flip:
                self.injected_flipped_pulls += 1
        if slow:
            time.sleep(c.slow_pull_s)
        if torn:
            return data[:max(8, len(data) // 2)]
        if flip and len(data) > 16:
            # flip a PAYLOAD bit (past magic + lengths + a header margin)
            # so the CRC verifier — not the JSON parser — is what catches
            # it, the bit-rot case the checksum exists for
            out = bytearray(data)
            out[-3] ^= 0x20
            return bytes(out)
        return data

    def expire_publish(self) -> bool:
        c = self.config
        with self._lock:
            self.publishes += 1
            hit = self._hit(self.publishes, c.expire_publish_on,
                            c.expire_publish_every)
            if hit:
                self.injected_expired_publishes += 1
            return hit

    def stats(self) -> dict:
        with self._lock:
            return {
                "fabric_pulls": self.pulls,
                "fabric_publishes": self.publishes,
                "injected_torn_pulls": self.injected_torn_pulls,
                "injected_flipped_pulls": self.injected_flipped_pulls,
                "injected_slow_pulls": self.injected_slow_pulls,
                "injected_dead_links": self.injected_dead_links,
                "injected_expired_publishes":
                    self.injected_expired_publishes,
                # sharded frames are refused at config time
                "injected_shard_faults": 0,
            }
