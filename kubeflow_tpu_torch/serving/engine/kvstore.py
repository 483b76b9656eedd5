"""Tiered, durable KV store: host RAM -> disk, with crash-recoverable
sessions.

Counterpart of ``kubeflow_tpu/serving/engine/kvstore.py``.  The engine's
preemption swap blobs and pinned session KV live here, off the device:

  * **host** — raw numpy blobs (pytrees of KV page slabs), the fast path.
    Over budget, the least-recently-used entry ages to disk ("spill") and
    its host copy is dropped; if it cannot be made durable the incoming
    put is REJECTED instead (the engine degrades to recompute — the store
    never drops bytes it already accepted to make room).
  * **disk** — checksummed, versioned page files (format below).  Over
    budget, unpinned (swap) entries are evicted first; pinned (session)
    entries are evicted LRU-last and only to make room for another pinned
    entry, so a swap flood cannot silently destroy conversations.

Every restore is verified (magic/length checks catch torn writes, a CRC32
over the payload catches bit flips, a missing file is a miss) and any
failure returns a degraded outcome, never an exception: a lying tier costs
latency, never a failed request.  Page files land tmp-then-``os.replace``;
pinned sessions are written through at pin time and recorded in an atomic
``manifest.json`` that a fresh store on the same ``disk_dir`` replays at
boot, re-adopting each session's bytes lazily on first touch.

Page-file format (KVPG version 1, byte-for-byte the JAX package's)::

    b"KVPG" | u32 format_version | u32 header_len | header JSON | payload

where the header carries {v, key, spec, meta, nbytes, crc, version} and
the payload is the concatenated C-order bytes of the blob's array leaves
in ``spec`` order.  ``spec`` is a minimal pytree schema (dict/tuple/list/
ndarray) so int8 pools (dict-of-arrays) round-trip without pickle.

bfloat16 without ``ml_dtypes``: numpy has no bf16 of its own, so the port
carries bf16 leaves as :class:`BF16Bits`, a uint16 array of the raw bit
patterns.  The spec still names them ``"bfloat16"`` and their bytes are
the same, so frames are byte-identical to the JAX package's and each side
reads the other's; the engine turns them back into ``torch.bfloat16`` by a
``view``, never by a float conversion.  An ``ml_dtypes`` bf16 array handed
in by a caller also packs as ``"bfloat16"`` (its dtype's own name).

Sharded frame format (KVPG version 2, tensor-parallel KV, byte-for-byte
the JAX package's)::

    b"KVPG" | u32 2 | u32 header_len | outer JSON | sub0 | ... | subN-1

where each sub-frame is a complete version-1 frame holding one shard's
``(k, v)`` pytree (its kv heads, in kv-head order) with its own CRC32, and
the outer header's shard-length table catches a truncated stream.  A blob
of degree N > 1 is a LIST of N per-shard pytrees (``blob_degree``);
``reshard_blob`` converts between degrees by re-cutting the kv-head axis,
bit for bit.  Degree-1 blobs keep the version-1 layout byte for byte.

Synchronous by design: puts/gets run on the engine loop thread at slot
admission/release, after the pipeline fence.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import struct
import tempfile
import threading
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..errors import RequestError
from .faults import StorageChaos, StorageFaultConfig

MAGIC = b"KVPG"
FORMAT_VERSION = 1
# the tensor-parallel layout: a table of per-shard version-1 sub-frames
SHARDED_FORMAT_VERSION = 2
MANIFEST = "manifest.json"

# visible ASCII only: session ids are echoed into HTTP response headers
# (X-Session-Id), where CR/LF would split the response and non-latin-1
# would crash send_header mid-reply — and they key manifest records
_SID_OK = frozenset(chr(c) for c in range(0x21, 0x7f))


def normalize_session_id(session_id) -> str:
    """Validate a request ``session_id``: non-empty, <=256 chars, visible
    ASCII (the id is echoed into response headers and recorded in the
    on-disk manifest).  Raises RequestError — the HTTP layer maps it to
    400 — on anything else.  Session ids are bearer capabilities: deploy
    behind an authenticating ingress and use unguessable ids."""
    if (not isinstance(session_id, str) or not session_id
            or len(session_id) > 256
            or not all(c in _SID_OK for c in session_id)):
        raise RequestError(
            "session_id must be 1-256 visible-ASCII characters "
            f"(no spaces/control chars), got {session_id!r}")
    return session_id


@dataclasses.dataclass(frozen=True)
class KVStoreConfig:
    """Frozen tier budgets + placement (rides in the frozen EngineConfig).

    ``disk_dir=None`` creates a fresh private directory under the system
    tempdir — functional tiering but no cross-restart durability.  Point
    it somewhere stable to make sessions survive a full engine restart."""

    host_max_bytes: int = 1 << 30
    disk_max_bytes: int = 1 << 32
    disk_dir: Optional[str] = None
    # deterministic storage-fault injection (faults.StorageFaultConfig)
    chaos: Optional[StorageFaultConfig] = None


class KVStoreCorrupt(Exception):
    """A page file failed verification (torn/flipped/truncated/missing), or
    is a layout this port does not read.  Internal — callers of the store
    see a degraded return value, never this exception."""


# ------------------------------------------------------- blob serialization


class BF16Bits(np.ndarray):
    """A uint16 array whose elements are bfloat16 bit patterns: how the
    port's KV blobs carry bf16 leaves without ``ml_dtypes``.  Build one
    with :func:`bf16_bits`; ``_flatten`` names it ``"bfloat16"``."""


def bf16_bits(arr: np.ndarray) -> BF16Bits:
    """Tag a 16-bit array (uint16/int16 bit patterns, or an ml_dtypes
    bfloat16 array) as bfloat16 bits, without copying."""
    return np.asarray(arr).view(np.uint16).view(BF16Bits)


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if isinstance(arr, BF16Bits) else str(arr.dtype)


def _flatten(obj, leaves: list):
    """Pytree -> JSON-able spec + ordered array leaves.  Supports only what
    KV blobs are made of (ndarray / dict / tuple / list) — no pickle, so a
    corrupted file can never execute anything."""
    if isinstance(obj, np.ndarray):
        name = _dtype_name(obj)
        arr = np.ascontiguousarray(obj)
        leaves.append(arr)
        return {"t": "a", "dtype": name, "shape": list(arr.shape),
                "i": len(leaves) - 1}
    if isinstance(obj, dict):
        return {"t": "d", "k": {str(k): _flatten(obj[k], leaves)
                                for k in sorted(obj)}}
    if isinstance(obj, (tuple, list)):
        return {"t": "t" if isinstance(obj, tuple) else "l",
                "v": [_flatten(v, leaves) for v in obj]}
    raise TypeError(f"unsupported blob leaf type {type(obj).__name__}")


def _leaf_from_buffer(buf, name: str, shape: list) -> np.ndarray:
    """One payload leaf as an array: bfloat16 as :class:`BF16Bits`, any
    other dtype by its numpy name."""
    dt = np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)
    arr = np.frombuffer(buf, dtype=dt).reshape(shape)
    return arr.view(BF16Bits) if name == "bfloat16" else arr


def _unflatten(spec: dict, leaves: list):
    t = spec["t"]
    if t == "a":
        return leaves[spec["i"]]
    if t == "d":
        return {k: _unflatten(v, leaves) for k, v in spec["k"].items()}
    vals = [_unflatten(v, leaves) for v in spec["v"]]
    return tuple(vals) if t == "t" else vals


def _crc_leaves_view(leaves) -> Tuple[int, int]:
    """(payload_bytes, crc32) over array leaves without materializing byte
    copies: contiguous arrays re-view as uint8.  The warm-restore path runs
    this per turn, so a large session must not pay a transient copy."""
    crc, total = 0, 0
    for a in leaves:
        b = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
        crc = zlib.crc32(b, crc)
        total += b.nbytes
    return total, crc


def _crc_blob(blob) -> Tuple[dict, list, int, int]:
    """-> (spec, leaves, payload_bytes, crc32), computed leaf by leaf in
    spec order — exactly the bytes a page file's payload holds — so host-
    and disk-resident copies verify against the same checksum."""
    leaves: list = []
    spec = _flatten(blob, leaves)
    total, crc = _crc_leaves_view(leaves)
    return spec, leaves, total, crc


def _frame_bytes(header_fields: dict, leaves: list) -> bytes:
    """Assemble one KVPG frame: magic | format version | header length |
    header JSON | concatenated leaf payload."""
    header = json.dumps(header_fields).encode()
    return (MAGIC + struct.pack("<II", FORMAT_VERSION, len(header))
            + header + b"".join(a.tobytes() for a in leaves))


def pack_frame(key: str, blob, meta: dict, version: int = 1) -> tuple:
    """Serialize a KV blob into a standalone KVPG frame ->
    ``(data, nbytes, crc)``; the disk tier builds the identical bytes via
    :func:`_frame_bytes` from its entry bookkeeping."""
    spec, leaves, total, crc = _crc_blob(blob)
    data = _frame_bytes({
        "v": FORMAT_VERSION, "key": key, "spec": spec, "meta": dict(meta),
        "nbytes": total, "crc": crc, "version": version,
    }, leaves)
    return data, total, crc


def pack_sharded_frame(key: str, shard_blobs: list, meta: dict,
                       version: int = 1) -> tuple:
    """Serialize a tensor-parallel KV blob (a list of per-shard pytrees, one
    per mesh position in kv-head order) into a sharded KVPG frame ->
    ``(data, nbytes, crc)``, byte for byte the JAX package's.

    The outer header carries {v, key, meta, shards: [len0..lenN-1],
    nbytes, version}; each sub-frame is a complete version-1 frame (own
    magic, header, CRC32) whose meta records {shard: i, degree: N}.  A
    torn or flipped single-shard transfer fails ITS verifier, while the
    outer length table catches a truncated stream.  ``nbytes`` sums the
    per-shard payload bytes; ``crc`` is a CRC32 over the sub-frame
    region."""
    degree = len(shard_blobs)
    subs = []
    total = 0
    for i, blob in enumerate(shard_blobs):
        sub, n, _ = pack_frame(f"{key}#{i}", blob,
                               {"shard": i, "degree": degree}, version)
        subs.append(sub)
        total += n
    body = b"".join(subs)
    header = json.dumps({
        "v": SHARDED_FORMAT_VERSION, "key": key, "meta": dict(meta),
        "shards": [len(s) for s in subs], "nbytes": total,
        "version": version,
    }).encode()
    data = (MAGIC + struct.pack("<II", SHARDED_FORMAT_VERSION, len(header))
            + header + body)
    return data, total, zlib.crc32(body)


def _unpack_sharded(data: bytes, header: dict):
    """Verify + parse the sub-frames of a version-2 frame's body ->
    ``(shard_blobs, header)``; the degree is ``len(header["shards"])``."""
    shards = header.get("shards")
    if not isinstance(shards, list) or not shards:
        raise KVStoreCorrupt("corrupt sharded header: no shard table")
    degree = len(shards)
    blobs, off = [], 0
    for i, n in enumerate(shards):
        sub = data[off:off + n]
        if len(sub) != n:
            raise KVStoreCorrupt(
                f"torn write: shard {i} truncated ({len(sub)} != {n})")
        try:
            blob, sub_header = unpack_frame(sub)
        except KVStoreCorrupt as exc:
            raise KVStoreCorrupt(f"shard {i}: {exc}") from exc
        sm = sub_header.get("meta", {})
        if sm.get("shard") != i or sm.get("degree") != degree:
            raise KVStoreCorrupt(
                f"shard {i}: layout mismatch (shard={sm.get('shard')} "
                f"degree={sm.get('degree')} expected {i}/{degree})")
        blobs.append(blob)
        off += n
    if off != len(data):
        raise KVStoreCorrupt(
            f"torn write: {len(data) - off} trailing bytes after shards")
    return blobs, header


def blob_degree(blob) -> int:
    """Mesh degree of a KV blob: a list is per-shard (one entry per mesh
    position), anything else is a unified degree-1 blob."""
    return len(blob) if isinstance(blob, list) else 1


def _like(arr: np.ndarray, parts) -> np.ndarray:
    """``arr`` tagged as bf16 bits when its source leaves were."""
    return bf16_bits(arr) if isinstance(parts[0], BF16Bits) else arr


def reshard_blob(blob, degree: int):
    """Host-side layout conversion between mesh degrees, the EXPLICIT slow
    path of a cross-degree import (the caller counts it): concatenate the
    per-shard blocks along the kv-head axis (axis 2 of every pool leaf,
    scales included) and re-split into ``degree`` blocks.  Pure
    reindexing, so bit-exact.  Returns a unified pytree for
    ``degree <= 1``, else a per-shard list.  Raises ValueError when the
    kv-head axis does not divide."""
    shards = blob if isinstance(blob, list) else [blob]
    if len(shards) == degree > 1:
        return shards
    unified = shards[0] if len(shards) == 1 else _tree_zip(
        lambda *parts: _like(np.concatenate(parts, axis=2), parts), *shards)
    if degree <= 1:
        return unified

    def cut(i):
        def f(a):
            if a.shape[2] % degree:
                raise ValueError(
                    f"kv-head axis {a.shape[2]} not divisible by "
                    f"degree {degree}")
            h = a.shape[2] // degree
            return _like(np.ascontiguousarray(a[:, :, i * h:(i + 1) * h]), (a,))
        return f
    return [_tree_zip(cut(i), unified) for i in range(degree)]


def _tree_zip(fn, *trees):
    """Map ``fn`` over aligned leaves of same-structure KV blob pytrees
    (the ``_flatten`` subset: ndarray / dict / tuple / list)."""
    t0 = trees[0]
    if isinstance(t0, np.ndarray):
        return fn(*trees)
    if isinstance(t0, dict):
        return {k: _tree_zip(fn, *[t[k] for t in trees]) for k in sorted(t0)}
    if isinstance(t0, (tuple, list)):
        out = [_tree_zip(fn, *[t[i] for t in trees]) for i in range(len(t0))]
        return tuple(out) if isinstance(t0, tuple) else out
    raise TypeError(f"unsupported blob leaf type {type(t0).__name__}")


def unpack_frame(data: bytes):
    """Parse + VERIFY one KVPG frame -> ``(blob, header)``.  Raises
    :class:`KVStoreCorrupt` on any verification failure — bad magic /
    truncated header (torn transfer), payload length mismatch, CRC32
    mismatch (bit flip), an unknown format version or leaf dtype.
    Version-2 (sharded) frames return ``(shard_blobs, header)``, a LIST of
    per-shard pytrees, each sub-frame verified by its own CRC."""
    if len(data) < 12 or data[:4] != MAGIC:
        raise KVStoreCorrupt("bad magic (torn write?)")
    ver, hlen = struct.unpack("<II", data[4:12])
    if ver not in (FORMAT_VERSION, SHARDED_FORMAT_VERSION):
        raise KVStoreCorrupt(f"unsupported format version {ver}")
    if len(data) < 12 + hlen:
        raise KVStoreCorrupt("torn write: truncated header")
    try:
        header = json.loads(data[12:12 + hlen])
    except ValueError as exc:
        raise KVStoreCorrupt(f"corrupt header: {exc}") from exc
    if ver == SHARDED_FORMAT_VERSION:
        if not isinstance(header, dict):
            raise KVStoreCorrupt("corrupt sharded header: not an object")
        return _unpack_sharded(data[12 + hlen:], header)
    payload = data[12 + hlen:]
    try:
        if len(payload) != header["nbytes"]:
            raise KVStoreCorrupt(
                f"torn write: payload {len(payload)} != {header['nbytes']}")
        if zlib.crc32(payload) != header["crc"]:
            raise KVStoreCorrupt("checksum mismatch (bit flip?)")
        leaves, off = [], 0
        for leaf_spec in _iter_array_specs(header["spec"]):
            name, shape = leaf_spec["dtype"], leaf_spec["shape"]
            itemsize = 2 if name == "bfloat16" else np.dtype(name).itemsize
            n = int(np.prod(shape, dtype=np.int64)) * itemsize
            leaves.append(_leaf_from_buffer(payload[off:off + n], name, shape))
            off += n
        return _unflatten(header["spec"], leaves), header
    except (KeyError, TypeError, ValueError) as exc:
        raise KVStoreCorrupt(f"corrupt header: {type(exc).__name__}: {exc}") from exc


def _iter_array_specs(spec: dict):
    """Array leaf specs in index order (the payload's layout order)."""
    out: list = []

    def walk(s):
        if s["t"] == "a":
            out.append(s)
        elif s["t"] == "d":
            for v in s["k"].values():
                walk(v)
        else:
            for v in s["v"]:
                walk(v)

    walk(spec)
    out.sort(key=lambda s: s["i"])
    return out


@dataclasses.dataclass
class _Entry:
    key: str
    nbytes: int          # host-copy payload bytes (host budget charge unit)
    crc: int
    pinned: bool         # session entries: durable, eviction-protected
    seq: int             # LRU clock (monotonic touch counter)
    version: int = 1
    blob: object = None  # host-tier copy (None = aged out / never adopted)
    meta: dict = dataclasses.field(default_factory=dict)
    # False for opaque caller blobs (non-pytree): host-resident only,
    # unverifiable, never spillable (the HostSwapStore facade's contract)
    serializable: bool = True
    # durable snapshot {path, nbytes, crc, version, meta} — decoupled from
    # the host copy: a degraded re-pin keeps the PREVIOUS version's page
    # file here while the host tier serves the new one.  None = no disk
    # copy.  disk["nbytes"] is the disk budget charge unit.
    disk: Optional[dict] = None


class TieredKVStore:
    """The engine's KV backing store: swap (preemption) and session
    (cross-turn pinning) entries over a host-RAM tier aging to a disk tier
    of checksummed page files.  Thread-safe; every public method takes the
    store lock."""

    def __init__(self, config: KVStoreConfig = KVStoreConfig(),
                 on_event: Optional[Callable[[str, str], None]] = None):
        self.config = config
        self._lock = threading.Lock()
        self._entries: Dict[str, _Entry] = {}
        self._seq = 0
        self._on_event = on_event
        self.chaos = (StorageChaos(config.chaos)
                      if config.chaos is not None else None)
        self.host_used = 0
        self.disk_used = 0
        self._disk_enabled = config.disk_max_bytes > 0
        self._disk_dir: Optional[str] = None
        # a private auto-created dir is EPHEMERAL: created lazily on the
        # first disk write and deleted by close().  An explicit disk_dir is
        # the durability contract: created now, manifest replayed, and
        # always survives close().
        self._ephemeral = self._disk_enabled and config.disk_dir is None
        if self._disk_enabled and config.disk_dir is not None:
            self._disk_dir = config.disk_dir
            os.makedirs(self._disk_dir, exist_ok=True)
        # ---- swap accounting (reset by clear_swap)
        self.swapped_out = 0
        self.swapped_in = 0
        self.bytes_out = 0
        self.bytes_in = 0
        self.rejected = 0
        # ---- tier/session counters
        self.spills = 0            # host copies aged to disk
        self.host_evictions = 0    # host copies dropped (disk copy existed)
        self.disk_evictions = 0    # unpinned disk entries evicted for room
        self.session_evictions = 0  # pinned sessions evicted under pressure
        self.verify_failures = 0   # torn/flipped/missing at restore
        self.restores = {"host": 0, "disk": 0}
        self.pins = 0
        self.last_evicted_sessions: List[str] = []
        if self._disk_dir:
            self._load_manifest()

    # ------------------------------------------------------------ internals

    def _event(self, tier: str, event: str) -> None:
        if self._on_event is not None:
            try:
                self._on_event(tier, event)
            except Exception:  # noqa: BLE001 — metrics must not sink the store
                pass

    def _touch(self, e: _Entry) -> None:
        self._seq += 1
        e.seq = self._seq

    def _ensure_disk_dir(self) -> str:
        if self._disk_dir is None:
            self._disk_dir = tempfile.mkdtemp(prefix="engine_kvstore_")
        return self._disk_dir

    def _file_for(self, key: str, version: int) -> str:
        safe = hashlib.sha1(key.encode()).hexdigest()[:16]
        return os.path.join(self._ensure_disk_dir(),
                            f"{safe}-v{version}.kvpg")

    def _write_file(self, e: _Entry, spec: dict, leaves: list) -> None:
        """Serialize + atomically land one entry's CURRENT host state as a
        page file, then swing ``e.disk`` to the new snapshot (the old file
        is unlinked only after the new one is fully visible).  Raises
        OSError (incl. injected ENOSPC) on failure, leaving ``e.disk``
        untouched.  A chaos torn write truncates the byte stream BEFORE the
        atomic rename.  Caller owns disk_used accounting."""
        data = _frame_bytes({
            "v": FORMAT_VERSION, "key": e.key, "spec": spec, "meta": e.meta,
            "nbytes": e.nbytes, "crc": e.crc, "version": e.version,
        }, leaves)
        if self.chaos is not None:
            data = self.chaos.on_write(data)  # may truncate or raise ENOSPC
        path = self._file_for(e.key, e.version)
        tmp = path + ".tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        old = e.disk
        e.disk = {"path": path, "nbytes": e.nbytes, "crc": e.crc,
                  "version": e.version, "meta": dict(e.meta)}
        if old and old["path"] != path:
            try:
                os.unlink(old["path"])
            except OSError:
                pass

    def _read_file(self, e: _Entry):
        """Load + verify one entry's page file -> (blob, header).  Raises
        KVStoreCorrupt on ANY verification failure.  The header carries the
        file's OWN meta/nbytes/version."""
        if not e.disk:
            raise KVStoreCorrupt("no disk copy")
        try:
            with open(e.disk["path"], "rb") as f:
                data = f.read()
        except OSError as exc:
            raise KVStoreCorrupt(f"missing/unreadable file: {exc}") from exc
        if self.chaos is not None:
            data = self.chaos.on_read(data)  # may sleep or flip a bit
        return unpack_frame(data)

    def _drop(self, e: _Entry, unlink: bool = True) -> None:
        """Remove an entry entirely, releasing both tiers' budget."""
        if e.blob is not None:
            self.host_used -= e.nbytes
            e.blob = None
        if e.disk:
            self.disk_used -= e.disk["nbytes"]
            if unlink:
                try:
                    os.unlink(e.disk["path"])
                except OSError:
                    pass
            e.disk = None
        self._entries.pop(e.key, None)

    def _demote(self, e: _Entry) -> bool:
        """Age one entry's host copy to disk (write-if-absent-or-stale,
        then drop the RAM copy).  False when the CURRENT version cannot be
        made durable — the caller must then keep the host copy."""
        if e.disk is None or e.disk["version"] != e.version:
            if not self._disk_enabled or not e.serializable:
                return False
            old_charge = e.disk["nbytes"] if e.disk else 0
            if not self._make_disk_room(e.nbytes - old_charge,
                                        for_pinned=e.pinned, keep=e.key):
                return False
            spec, leaves, total, crc = _crc_blob(e.blob)
            e.crc, e.nbytes = crc, total  # recompute defensively
            try:
                self._write_file(e, spec, leaves)
            except OSError:
                return False
            self.disk_used += e.nbytes - old_charge
            self.spills += 1
            self._event("disk", "spill")
            if e.pinned:
                # a session that just became durable must reach the
                # recovery manifest too
                self._save_manifest()
        else:
            self.host_evictions += 1
            self._event("host", "evict")
        self.host_used -= e.nbytes
        e.blob = None
        return True

    def _make_host_room(self, n: int, keep: Optional[str] = None) -> bool:
        while self.host_used + n > self.config.host_max_bytes:
            cands = [e for e in self._entries.values()
                     if e.blob is not None and e.key != keep]
            if not cands:
                return False
            victim = min(cands, key=lambda e: e.seq)
            if not self._demote(victim):
                return False
        return True

    def _make_disk_room(self, n: int, for_pinned: bool,
                        keep: Optional[str] = None,
                        evicted_out: Optional[List[str]] = None) -> bool:
        """Evict disk entries until ``n`` bytes fit: unpinned (swap spill)
        LRU first; pinned sessions only yield to ANOTHER pinned entry, LRU
        among sessions.  ``keep`` (a key) is never a victim.  A pinned
        eviction rewrites the manifest immediately, so it never points at
        an unlinked file."""
        while self.disk_used + n > self.config.disk_max_bytes:
            cands = [e for e in self._entries.values()
                     if e.disk and e.key != keep]
            unpinned = [e for e in cands if not e.pinned]
            pool = unpinned or ([e for e in cands if e.pinned]
                                if for_pinned else [])
            if not pool:
                return False
            victim = min(pool, key=lambda e: e.seq)
            if victim.pinned:
                self.session_evictions += 1
                sid = victim.key.split("/", 1)[-1]
                if evicted_out is not None:
                    evicted_out.append(sid)
                self.last_evicted_sessions.append(sid)
                del self.last_evicted_sessions[:-16]
                self._event("disk", "session_evict")
                self._drop(victim)
                self._save_manifest()
            else:
                self.disk_evictions += 1
                self._event("disk", "evict")
                self._drop(victim)
        return True

    # -------------------------------------------------------------- manifest

    def _save_manifest(self) -> None:
        """Atomic session index for restart recovery (call with the lock
        held).  Not chaos-wrapped: it is the recovery index the injected
        page-file faults are measured against."""
        if not self._disk_enabled or self._disk_dir is None:
            return
        sessions = {}
        for e in self._entries.values():
            if e.pinned and e.disk:
                # the DURABLE snapshot: what a restart can actually read
                sessions[e.key] = {
                    "file": os.path.basename(e.disk["path"]),
                    "nbytes": e.disk["nbytes"], "crc": e.disk["crc"],
                    "version": e.disk["version"], "meta": e.disk["meta"],
                }
        path = os.path.join(self._disk_dir, MANIFEST)
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump({"v": 1, "sessions": sessions}, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def _load_manifest(self) -> None:
        """Replay the session index at boot: entries register disk-only
        (blob=None) and their bytes are read + verified lazily on first
        touch."""
        path = os.path.join(self._disk_dir, MANIFEST)
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return
        for key, rec in (data.get("sessions") or {}).items():
            try:
                path = os.path.join(self._disk_dir, rec["file"])
                if not os.path.exists(path):
                    continue  # wiped behind our back: a plain miss
                e = _Entry(key=key, nbytes=int(rec["nbytes"]),
                           crc=int(rec["crc"]), pinned=True, seq=0,
                           version=int(rec.get("version", 1)),
                           meta=dict(rec.get("meta") or {}),
                           disk={"path": path,
                                 "nbytes": int(rec["nbytes"]),
                                 "crc": int(rec["crc"]),
                                 "version": int(rec.get("version", 1)),
                                 "meta": dict(rec.get("meta") or {})})
            except (KeyError, TypeError, ValueError):
                continue  # one bad record must not sink recovery
            self._entries[key] = e
            self.disk_used += e.disk["nbytes"]

    # ------------------------------------------------------------- swap API

    def put_swap(self, rid: int, blob, nbytes: int,
                 count: bool = True) -> bool:
        """Host-tier insert for a preempted slot's KV (spilling LRU entries
        to disk for room).  False = could not fit anywhere; the engine
        falls back to drop-and-recompute.  ``nbytes`` is advisory; for
        array pytrees the serialized payload size is what the budgets
        charge.  Opaque (non-pytree) blobs are accepted at face value,
        host-resident and unspillable.  ``count=False`` skips the
        swap-traffic counters."""
        key = f"swap/{rid}"
        try:
            _, _, total, crc = _crc_blob(blob)
            serializable = True
        except TypeError:
            total, crc, serializable = int(nbytes), 0, False
        with self._lock:
            old = self._entries.get(key)
            if old is not None:
                self._drop(old)
            if not self._make_host_room(total, keep=key):
                self.rejected += 1
                self._event("host", "reject")
                return False
            self._seq += 1
            self._entries[key] = _Entry(
                key=key, nbytes=total, crc=crc, pinned=False,
                seq=self._seq, blob=blob, serializable=serializable)
            self.host_used += total
            if count:
                self.swapped_out += 1
                self.bytes_out += total
            self._event("host", "put")
            return True

    def pop_swap(self, rid: int, count: bool = True):
        """-> (blob, nbytes) or None; removes the entry and releases its
        budget.  A disk-resident blob is read + verified; verification
        failure returns None (the engine recomputes from the committed
        context)."""
        key = f"swap/{rid}"
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return None
            blob = e.blob
            if blob is None:
                try:
                    blob, _ = self._read_file(e)
                    self._event("disk", "hit")
                except KVStoreCorrupt:
                    self.verify_failures += 1
                    self._event("disk", "verify_fail")
                    self._drop(e)
                    return None
            else:
                self._event("host", "hit")
            nbytes = e.nbytes
            self._drop(e)
            if count:
                self.swapped_in += 1
                self.bytes_in += nbytes
            return blob, nbytes

    def discard_swap(self, rid: int) -> None:
        """Drop a swap blob without the swap-in accounting (terminal
        request)."""
        with self._lock:
            e = self._entries.get(f"swap/{rid}")
            if e is not None:
                self._drop(e)

    def clear_swap(self) -> None:
        """Drop every swap blob and reset the swap counters; pinned
        sessions are untouched (durable state)."""
        with self._lock:
            for e in [e for e in self._entries.values() if not e.pinned]:
                self._drop(e)
            self.swapped_out = 0
            self.swapped_in = 0
            self.bytes_out = 0
            self.bytes_in = 0
            self.rejected = 0

    # ---------------------------------------------------------- session API

    def pin_session(self, sid: str, blob, nbytes: int, meta: dict) -> dict:
        """Pin one finished turn's KV pages under ``sid``: host-tier copy
        for the fast next turn plus a write-through page file + manifest
        record for durability.  Replaces any previous pin crash-safely (the
        new version lands in its OWN file first).  Degrades, never raises:
        when the new disk write fails the new context is served from the
        host tier while the PREVIOUS version's durable snapshot is carried
        over (``durable: False``, ``stale_durable: True``); with no host
        room either the previous pin is kept and this turn reports
        ``pinned: False``."""
        key = f"session/{sid}"
        spec, leaves, total, crc = _crc_blob(blob)
        with self._lock:
            evicted: List[str] = []
            old = self._entries.get(key)
            version = (old.version + 1) if old is not None else 1
            self._seq += 1
            e = _Entry(key=key, nbytes=total, crc=crc, pinned=True,
                       seq=self._seq, version=version, blob=None,
                       meta=dict(meta))
            error = None
            durable = False
            # the old version's charges are released moments from now, so
            # room-making discounts them
            old_disk_charge = old.disk["nbytes"] if (old and old.disk) else 0
            old_host_charge = (old.nbytes
                               if (old and old.blob is not None) else 0)
            if not self._disk_enabled:
                error = "disk tier disabled"
            elif not self._make_disk_room(total - old_disk_charge,
                                          for_pinned=True, keep=key,
                                          evicted_out=evicted):
                error = "disk budget exhausted"
            else:
                try:
                    self._write_file(e, spec, leaves)  # sets e.disk
                    durable = True
                except OSError as exc:
                    error = f"{type(exc).__name__}: {exc}"
            host = self._make_host_room(total - old_host_charge, keep=key)
            if not host and not durable:
                self._event("host", "reject")
                return {"pinned": False, "durable": False,
                        "evicted": evicted,
                        "error": error or "host budget exhausted"}
            stale_durable = False
            if old is not None:
                if not durable and old.disk is not None:
                    # carry the previous version's durable snapshot
                    e.disk, old.disk = old.disk, None
                    stale_durable = True
                self._drop(old)
            if durable:
                self.disk_used += total
            if host:
                e.blob = blob
                self.host_used += total
            self._entries[key] = e
            self.pins += 1
            self._event("host" if host else "disk", "pin")
            self._save_manifest()
            return {"pinned": True, "durable": durable,
                    "stale_durable": stale_durable, "evicted": evicted,
                    "error": error, "nbytes": total, "version": version}

    def restore_session(self, sid: str):
        """-> (outcome, payload): outcome in {"host", "disk", "miss",
        "corrupt"}; payload = (blob, nbytes, meta) on a hit, else None.
        The entry STAYS pinned.  A disk hit serves the FILE's own meta and
        re-adopts the blob into the host tier only when it fits without
        displacing anything and matches the entry's current version."""
        key = f"session/{sid}"
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self._event("host", "miss")
                return "miss", None
            self._touch(e)
            if e.blob is not None:
                # "every restore is verified" includes the RAM copy
                leaves: list = []
                _flatten(e.blob, leaves)
                total, crc = _crc_leaves_view(leaves)
                if total == e.nbytes and crc == e.crc:
                    self.restores["host"] += 1
                    self._event("host", "hit")
                    return "host", (e.blob, e.nbytes, dict(e.meta))
                self.verify_failures += 1
                self._event("host", "verify_fail")
                self.host_used -= e.nbytes
                e.blob = None  # fall through to the disk copy, if any
            try:
                blob, header = self._read_file(e)
            except KVStoreCorrupt:
                self.verify_failures += 1
                self._event("disk", "verify_fail")
                self._drop(e)
                self._save_manifest()
                return "corrupt", None
            if (header["version"] == e.version
                    and self.host_used + e.nbytes
                    <= self.config.host_max_bytes):
                e.blob = blob
                self.host_used += e.nbytes
            self.restores["disk"] += 1
            self._event("disk", "hit")
            return "disk", (blob, header["nbytes"], dict(header["meta"]))

    def drop_session(self, sid: str) -> bool:
        with self._lock:
            e = self._entries.get(f"session/{sid}")
            if e is None:
                return False
            self._drop(e)
            self._save_manifest()
            return True

    def session_list(self) -> dict:
        with self._lock:
            out = {}
            for e in self._entries.values():
                if not e.pinned:
                    continue
                sid = e.key.split("/", 1)[-1]
                out[sid] = {
                    "nbytes": e.nbytes, "version": e.version,
                    "tiers": [t for t, ok in (("host", e.blob is not None),
                                              ("disk", bool(e.disk)))
                              if ok],
                    "context_len": e.meta.get("context_len"),
                    "pages": e.meta.get("pages"),
                }
            return out

    # -------------------------------------------------------------- surface

    @property
    def disk_dir(self) -> Optional[str]:
        return self._disk_dir

    def close(self) -> None:
        """Release the store (Engine.stop calls this): host memory is
        freed; an EPHEMERAL private disk dir is deleted outright.  An
        explicit ``disk_dir`` keeps its page files and manifest: that path
        IS the durability contract a restarted engine recovers from."""
        with self._lock:
            for e in list(self._entries.values()):
                e.blob = None
            self._entries.clear()
            self.host_used = 0
            if self._ephemeral and self._disk_dir:
                shutil.rmtree(self._disk_dir, ignore_errors=True)
                self._disk_dir = None
                self.disk_used = 0

    def stats(self) -> dict:
        with self._lock:
            pinned = [e for e in self._entries.values() if e.pinned]
            swap_bytes = sum(e.nbytes for e in self._entries.values()
                             if not e.pinned)
            return {
                "swap_used_bytes": swap_bytes,
                "swapped_out": self.swapped_out,
                "swapped_in": self.swapped_in,
                "swap_bytes_out": self.bytes_out,
                "swap_bytes_in": self.bytes_in,
                "swap_rejected": self.rejected,
                "kv_host_used_bytes": self.host_used,
                "kv_disk_used_bytes": self.disk_used,
                "kv_spills": self.spills,
                "kv_host_evictions": self.host_evictions,
                "kv_disk_evictions": self.disk_evictions,
                "kv_verify_failures": self.verify_failures,
                "sessions_pinned": len(pinned),
                "session_bytes": sum(e.nbytes for e in pinned),
                "session_evictions": self.session_evictions,
                "session_pins": self.pins,
                "session_restores": dict(self.restores),
                **({"storage_chaos": self.chaos.stats()}
                   if self.chaos is not None else {}),
            }


class HostSwapStore:
    """The flat host-RAM swap interface, backed by a host-only
    ``TieredKVStore`` (disk tier disabled, so a put past the budget
    rejects)."""

    def __init__(self, max_bytes: int = 1 << 30):
        self._kv = TieredKVStore(
            KVStoreConfig(host_max_bytes=max_bytes, disk_max_bytes=0))
        self.max_bytes = max_bytes

    @property
    def used_bytes(self) -> int:
        return self._kv.host_used

    @property
    def rejected(self) -> int:
        return self._kv.rejected

    def put(self, rid: int, blob, nbytes: int) -> bool:
        return self._kv.put_swap(rid, blob, nbytes)

    def pop(self, rid: int):
        return self._kv.pop_swap(rid)

    def discard(self, rid: int) -> None:
        self._kv.discard_swap(rid)

    def clear(self) -> None:
        self._kv.clear_swap()

    def stats(self) -> dict:
        s = self._kv.stats()
        return {k: s[k] for k in ("swap_used_bytes", "swapped_out",
                                  "swapped_in", "swap_bytes_out",
                                  "swap_bytes_in", "swap_rejected")}
