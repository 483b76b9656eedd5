"""Deterministic storage-fault injection for the tiered KV store.

The storage scope of ``kubeflow_tpu/serving/engine/faults.py``: torn
writes, bit flips, slow reads and writes, and ENOSPC, provoked
deterministically on the disk tier's two byte streams (kvstore.py).  The
dispatch, handoff, fabric, constrain, storm and fleet fault families come
with the slices that port those subsystems.
"""

from __future__ import annotations

import dataclasses
import errno
import threading
import time

import numpy as np


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
