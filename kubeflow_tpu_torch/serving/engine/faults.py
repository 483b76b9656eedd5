"""Deterministic chaos injection for the serving engine.

Counterpart of ``kubeflow_tpu/serving/engine/faults.py``, in these scopes:

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
  the JAX package counts them.  Their ``shard_*`` fields corrupt exactly
  one sub-frame of a sharded (version 2, tensor-parallel) frame, leaving
  the outer stream intact so only the per-shard verifier can catch it.

* Constrain scope: corrupted token-map cache reads of the constrained-
  decoding registry (serving/constrain.py) and forced zero-legal-token
  masks, which must fail only the stalled slot with ConstraintStall.

* Storm scope: ``StormFaultConfig`` / ``storm_schedule``, a seeded
  open-loop traffic storm (diurnal baseline, bursts, Zipf tenants,
  lognormal prompts) that draws the JAX package's arrival list for the
  same config; the ingress's overload controller and the fleet remediator
  (serving/remediator.py) must turn it into one remediated capacity
  incident.

* Fleet scope: ``FleetFaultConfig`` / ``FleetChaos``, the ingress's chaos
  hooks (``ServiceProxy.chaos``, serving/router.py): replicas killed or
  hung after an exact count of relayed tokens, slowed, or their relayed
  streams cut, on the JAX package's schedule for the same plan.
"""

from __future__ import annotations

import dataclasses
import errno
import json
import struct
import threading
import time
from typing import Optional, Tuple

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
# it (serving/remediator.py CAUSE_PLAYBOOK — kept as a LITERAL here, not
# an import: faults.py is engine-side and must not pull the serving
# control plane; tests/test_torch_remediation.py pins the two tables equal).
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
# FIXES it — the fleet's remediation contract, which the remediator
# (serving/remediator.py) acts on.
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


def _shard_regions(data: bytes) -> list:
    """``(offset, length)`` of each sub-frame in a version-2 sharded KVPG
    frame; ``[]`` for legacy frames and torn streams.  A minimal local
    parser of the outer header's shard table (kvstore.py imports this
    module, so the real parser cannot be imported here), used by the
    shard-level injectors to corrupt exactly ONE sub-frame while leaving
    the outer stream length intact (so only the per-shard verifier, not
    the outer length check, can catch it)."""
    if len(data) < 12 or data[:4] != b"KVPG":
        return []
    ver, hlen = struct.unpack("<II", data[4:12])
    if ver != 2 or len(data) < 12 + hlen:
        return []
    try:
        shards = json.loads(data[12:12 + hlen]).get("shards") or []
    except (ValueError, AttributeError):
        return []
    out, off = [], 12 + hlen
    for n in shards:
        out.append((off, int(n)))
        off += int(n)
    return out if out and off <= len(data) else []


def _corrupt_shard(data: bytes, n: int, torn: bool, flip: bool,
                   drop: bool) -> bytes:
    """Corrupt one sub-frame of a sharded frame (pull ordinal ``n`` picks
    which, deterministically): torn zeroes the tail half (its length/CRC
    verifier fails exactly like a torn unified frame), flip flips one
    payload bit (CRC32 catches it), drop zeroes the whole sub-frame (its
    magic fails).  Legacy frames pass through untouched — the unified
    injectors cover those."""
    regions = _shard_regions(data)
    if not regions:
        return data
    off, ln = regions[n % len(regions)]
    out = bytearray(data)
    if torn:
        out[off + ln // 2:off + ln] = bytes(ln - ln // 2)
    elif flip:
        out[off + ln - 3] ^= 0x20
    elif drop:
        out[off:off + ln] = bytes(ln)
    return bytes(out)


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
    # sharded frames: corrupt ONE sub-frame of the Nth pulled version-2
    # frame — torn (tail half zeroed), flipped (one payload bit), or
    # dropped (whole sub-frame zeroed) — leaving the outer stream intact,
    # so ONLY the per-shard verifier can catch it; legacy frames pass
    # through untouched
    shard_torn_pull_on: int = -1
    shard_torn_pull_every: int = 0
    shard_flip_pull_on: int = -1
    shard_flip_pull_every: int = 0
    shard_drop_pull_on: int = -1
    shard_drop_pull_every: int = 0


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
        self.injected_shard_faults = 0

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
            s_torn = self._hit(n, c.shard_torn_pull_on,
                               c.shard_torn_pull_every)
            s_flip = self._hit(n, c.shard_flip_pull_on,
                               c.shard_flip_pull_every)
            s_drop = self._hit(n, c.shard_drop_pull_on,
                               c.shard_drop_pull_every)
            if s_torn or s_flip or s_drop:
                self.injected_shard_faults += 1
        if slow:
            time.sleep(c.slow_pull_s)
        if torn:
            return data[:max(8, len(data) // 2)]
        if s_torn or s_flip or s_drop:
            return _corrupt_shard(data, n, s_torn, s_flip, s_drop)
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
                "injected_shard_faults": self.injected_shard_faults,
            }


@dataclasses.dataclass(frozen=True)
class FabricFaultConfig:
    """Seeded fault plan for the fleet KV fabric (serving/kvfabric.py).
    Frozen (rides in the frozen EngineConfig as ``fabric_chaos``); all-defaults == inject nothing.  ``*_on`` are
    1-based pull/publish ordinals (-1 = off); ``*_every`` fire on every
    Nth (0 = off).  Every injection must leave the request COMPLETED via
    the degraded re-prefill path with zero leaked KV pages on both
    replicas."""

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
    # sharded frames: corrupt ONE sub-frame of the Nth pulled version-2
    # frame — torn / flipped / dropped — leaving the outer stream intact,
    # so ONLY the per-shard verifier can catch it; legacy frames pass
    # through untouched
    shard_torn_pull_on: int = -1
    shard_torn_pull_every: int = 0
    shard_flip_pull_on: int = -1
    shard_flip_pull_every: int = 0
    shard_drop_pull_on: int = -1
    shard_drop_pull_every: int = 0


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
        self.injected_shard_faults = 0

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
            s_torn = self._hit(n, c.shard_torn_pull_on,
                               c.shard_torn_pull_every)
            s_flip = self._hit(n, c.shard_flip_pull_on,
                               c.shard_flip_pull_every)
            s_drop = self._hit(n, c.shard_drop_pull_on,
                               c.shard_drop_pull_every)
            if s_torn or s_flip or s_drop:
                self.injected_shard_faults += 1
        if slow:
            time.sleep(c.slow_pull_s)
        if torn:
            return data[:max(8, len(data) // 2)]
        if s_torn or s_flip or s_drop:
            return _corrupt_shard(data, n, s_torn, s_flip, s_drop)
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
                "injected_shard_faults": self.injected_shard_faults,
            }


# ------------------------------------------------------------ constrain scope


@dataclasses.dataclass(frozen=True)
class ConstrainFaultConfig:
    """Seeded constrained-decoding fault plan (serving/constrain.py).
    Frozen (rides in the frozen EngineConfig); all-defaults == inject
    nothing.  ``*_on`` fields are 1-based operation ordinals (-1 = off);
    ``*_every`` fire on every Nth operation (0 = off) — cache reads and
    mask builds count separately."""

    seed: int = 0
    # flip one payload byte of the Nth token-map cache READ (silent
    # corruption of the durable ``tokmap-<sig>.json`` artifact): the
    # registry's payload CRC must catch it and degrade to a counted
    # re-compile — NEVER an invalid output, because the rebuilt table is
    # byte-identical to a cold build
    corrupt_cache_on: int = -1
    corrupt_cache_every: int = 0
    # force the Nth constrained mask build to report ZERO legal tokens
    # (stands in for a grammar-compile or token-mapping bug): the engine
    # must fail ONLY that slot with ConstraintStall and feed the incident
    # plane's ``constraint_stall`` detector — it must never "recover" by
    # emitting a token the grammar forbids
    stall_on: int = -1
    stall_every: int = 0


class ConstrainChaos:
    """Runtime half of ConstrainFaultConfig.  ``on_cache_read(data) ->
    data`` wraps the registry's token-map cache reads (may flip one
    payload byte — the CRC verifier's territory); ``stall_mask() ->
    bool`` is consulted by the engine's mask builder once per constrained
    mask (True = zero the mask).  Counters are the test surface: injected
    faults vs counted degradations must match exactly."""

    def __init__(self, config: ConstrainFaultConfig):
        self.config = config
        self.rng = np.random.default_rng(config.seed)
        self._lock = threading.Lock()
        self.cache_reads = 0
        self.masks = 0
        self.injected_corrupt_reads = 0
        self.injected_stalls = 0

    @staticmethod
    def _hit(n: int, on: int, every: int) -> bool:
        return (on > 0 and n == on) or (every > 0 and n % every == 0)

    def on_cache_read(self, data: bytes) -> bytes:
        c = self.config
        with self._lock:
            self.cache_reads += 1
            n = self.cache_reads
            flip = (self._hit(n, c.corrupt_cache_on, c.corrupt_cache_every)
                    and len(data) > 16)
            if flip:
                self.injected_corrupt_reads += 1
                # bias into the back half: the hex token payload, so the
                # flip lands in CRC-covered bytes, not the JSON scaffold
                i = int(self.rng.integers(len(data) // 2, len(data)))
        if flip:
            b = bytearray(data)
            b[i] ^= 0x40
            return bytes(b)
        return data

    def stall_mask(self) -> bool:
        c = self.config
        with self._lock:
            self.masks += 1
            if self._hit(self.masks, c.stall_on, c.stall_every):
                self.injected_stalls += 1
                return True
            return False

    def stats(self) -> dict:
        with self._lock:
            return {
                "constrain_cache_reads": self.cache_reads,
                "constrain_masks": self.masks,
                "injected_corrupt_reads": self.injected_corrupt_reads,
                "injected_stalls": self.injected_stalls,
            }


# --------------------------------------------------------------- storm scope


@dataclasses.dataclass(frozen=True)
class StormArrival:
    """One request of a storm schedule: WHEN it arrives (seconds from
    schedule start), WHO sends it, and its shape."""

    t_s: float
    tenant: str
    priority: str
    prompt_len: int
    max_tokens: int


@dataclasses.dataclass(frozen=True)
class StormFaultConfig:
    """Seeded open-loop traffic-storm plan (README "Overload control"):
    the SAME config + seed replays the SAME arrival schedule, request by
    request, and the JAX package's schedule for the same config.

    The arrival process is a non-homogeneous Poisson: a diurnal sinusoid
    on the baseline rate, bursts multiplying it on a fixed cadence
    (``burst_x`` at every ``burst_every_s`` for ``burst_len_s``), drawn
    by thinning.  Prompt lengths are lognormal (heavy-tailed — the
    handful of giant prompts is what makes naive FIFO admission
    collapse); tenants are Zipf-skewed (the storm hog is tenant 0);
    priority classes draw from ``classes`` weights."""

    seed: int = 0
    duration_s: float = 4.0
    base_qps: float = 20.0
    # diurnal baseline: rate(t) = base * (1 + depth * sin(2*pi*t/period))
    diurnal_period_s: float = 8.0
    diurnal_depth: float = 0.3
    # bursts on top: rate *= burst_x while (t mod burst_every_s) < burst_len_s
    burst_every_s: float = 2.0
    burst_len_s: float = 0.5
    burst_x: float = 4.0
    # tenants: share of tenant i is (i+1)^-skew, normalized (tenant 0 hogs)
    tenants: int = 4
    tenant_skew: float = 1.2
    # heavy-tailed prompt lengths: lognormal(median, sigma), clipped
    prompt_len_median: int = 48
    prompt_len_sigma: float = 0.6
    prompt_len_max: int = 512
    max_tokens: int = 16
    # (class, weight) draw table for per-request priority
    classes: tuple = (("interactive", 0.5), ("batch", 0.3),
                      ("best_effort", 0.2))


def storm_schedule(config: StormFaultConfig) -> list:
    """Materialize the storm's arrival schedule -> [StormArrival, ...]
    sorted by ``t_s``.  Pure function of the config (one seeded RNG, no
    wall clock), so two arms of a comparison — and a test re-run — drive
    the IDENTICAL storm."""
    c = config
    rng = np.random.default_rng(c.seed)
    peak = c.base_qps * (1.0 + abs(c.diurnal_depth)) * max(1.0, c.burst_x)

    def rate(t: float) -> float:
        r = c.base_qps
        if c.diurnal_period_s > 0:
            r *= 1.0 + c.diurnal_depth * np.sin(
                2.0 * np.pi * t / c.diurnal_period_s)
        if c.burst_every_s > 0 and (t % c.burst_every_s) < c.burst_len_s:
            r *= c.burst_x
        return max(0.0, r)

    shares = np.array([(i + 1.0) ** -c.tenant_skew
                       for i in range(max(1, c.tenants))])
    shares /= shares.sum()
    cls_names = [n for n, _ in c.classes]
    cls_w = np.array([w for _, w in c.classes], dtype=float)
    cls_w /= cls_w.sum()
    out = []
    t = 0.0
    while True:
        # Poisson thinning: draw at the peak rate, keep with p=rate(t)/peak
        t += float(rng.exponential(1.0 / max(1e-9, peak)))
        if t >= c.duration_s:
            break
        if rng.random() >= rate(t) / peak:
            continue
        plen = int(np.clip(rng.lognormal(np.log(c.prompt_len_median),
                                         c.prompt_len_sigma),
                           4, c.prompt_len_max))
        out.append(StormArrival(
            t_s=round(t, 4),
            tenant=f"tenant{int(rng.choice(len(shares), p=shares))}",
            priority=str(rng.choice(cls_names, p=cls_w)),
            prompt_len=plen,
            max_tokens=c.max_tokens))
    return out


# --------------------------------------------------------------- fleet scope


@dataclasses.dataclass(frozen=True)
class FleetFaultConfig:
    """Seeded fault plan over N in-process replicas: which
    replicas get killed / hung / slowed, and when — measured in TOKENS THE
    INGRESS HAS RELAYED from the victim, so the injection lands exactly
    mid-decode, deterministically, independent of host speed.  All-defaults
    == inject nothing.  The runtime half is ``FleetChaos``, which the
    service proxy's resumable relay feeds (``ServiceProxy.chaos``)."""

    seed: int = 0
    # replica indices whose engine is hard-stopped mid-decode (in-flight
    # work fails, health goes DEAD, the router must fail over + re-admit)
    kill: Tuple[int, ...] = ()
    kill_after_tokens: int = 6
    # replica indices whose engine loop goes silent for hang_s mid-decode
    # (sockets stay open — only the ingress stall detector can catch it)
    hang: Tuple[int, ...] = ()
    hang_after_tokens: int = 6
    hang_s: float = 5.0
    # chronically slow replicas: every engine tick sleeps slow_tick_s
    slow: Tuple[int, ...] = ()
    slow_tick_s: float = 0.02
    # ingress-side flaky network: cut every Nth relayed stream (0 = off)
    # after it has relayed cut_after_events events — the replica survives,
    # the CONNECTION dies, and re-admission must still be token-exact
    cut_stream_every: int = 0
    cut_after_events: int = 4


class FleetChaos:
    """Runtime half of FleetFaultConfig: owns per-backend token counters,
    fires one-shot kill/hang callbacks at exact token counts, and decides
    which relayed streams get their connection cut.  Thread-safe (relay
    workers feed it concurrently); callbacks run SYNCHRONOUSLY in the
    relay that crossed the threshold — "kill after N tokens" is a causal
    ordering contract (token N+1 must not be relayed before the fault
    lands), and a detached thread loses that race on a fast data plane.
    Callbacks must therefore be bounded (``Engine.stop(drain=False)``,
    ``arm_slow``), which every harness callback is."""

    def __init__(self, config: FleetFaultConfig):
        self.config = config
        self._lock = threading.Lock()
        self._by_port: dict = {}      # port -> (replica idx, kill_cb, hang_cb)
        self._tokens: dict = {}       # port -> relayed token events
        self._fired: set = set()      # ports whose one-shot action fired
        self._stream_no: dict = {}    # stream key -> 1-based stream number
        self._stream_events: dict = {}
        self._cut_done: set = set()
        self.kills_fired = 0
        self.hangs_fired = 0
        self.streams_cut = 0

    def engine_faults(self, idx: int) -> FaultConfig:
        """The per-engine FaultConfig replica ``idx`` should be built with:
        slow replicas tick with a per-tick sleep; every other replica gets
        an inert injector (so hang's ``arm_slow`` has a target)."""
        c = self.config
        if idx in c.slow:
            return FaultConfig(seed=c.seed + idx, slow_tick_every=1,
                               slow_tick_s=c.slow_tick_s)
        return FaultConfig(seed=c.seed + idx)

    def register_replica(self, idx: int, port: int,
                         kill_cb=None, hang_cb=None) -> None:
        with self._lock:
            self._by_port[port] = (idx, kill_cb, hang_cb)

    def on_relay_event(self, port: int, stream_key) -> Optional[str]:
        """Called by the ingress relay after each relayed stream event.
        Returns "cut" when THIS stream's connection should drop now; fires
        the port's one-shot kill/hang callback when its token count is
        reached."""
        c = self.config
        with self._lock:
            self._tokens[port] = self._tokens.get(port, 0) + 1
            n = self._tokens[port]
            if stream_key not in self._stream_no:
                self._stream_no[stream_key] = len(self._stream_no) + 1
            self._stream_events[stream_key] = \
                self._stream_events.get(stream_key, 0) + 1
            info = self._by_port.get(port)
            cb = None
            if info is not None and port not in self._fired:
                idx, kill_cb, hang_cb = info
                if idx in c.kill and n >= c.kill_after_tokens:
                    self._fired.add(port)
                    self.kills_fired += 1
                    cb = kill_cb
                elif idx in c.hang and n >= c.hang_after_tokens:
                    self._fired.add(port)
                    self.hangs_fired += 1
                    cb = hang_cb
            cut = (c.cut_stream_every > 0
                   and self._stream_no[stream_key] % c.cut_stream_every == 0
                   and stream_key not in self._cut_done
                   and self._stream_events[stream_key] >= c.cut_after_events)
            if cut:
                self._cut_done.add(stream_key)
                self.streams_cut += 1
        if cb is not None:
            cb()
        return "cut" if cut else None

    def stats(self) -> dict:
        with self._lock:
            return {
                "kills_fired": self.kills_fired,
                "hangs_fired": self.hangs_fired,
                "streams_cut": self.streams_cut,
                "tokens_relayed_by_port": dict(self._tokens),
            }
