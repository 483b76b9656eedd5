"""Python client for the C++ metadata store core (metadata_core.cc).

A copy of ``kubeflow_tpu/pipelines/metadata.py`` over the port's
``metadata_core.cc`` (byte-identical to the reference's), built at first use
into ``kubeflow_tpu_torch/_build/``.  The WAL format is the reference's, so a
store written by either package replays in the other.

Upstream analogue (UNVERIFIED, SURVEY.md §2b/§3.5): the ``ml-metadata`` client
API the KFP v2 driver uses — artifacts, executions, contexts, events,
associations/attributions, plus the cache lookup by execution fingerprint
(`[U:pipelines/backend/src/v2/cacheutils]`).  The native core owns storage,
indexes and WAL durability; this client owns JSON property encoding and the
query/read-buffer pairing (serialized under one lock).
"""

from __future__ import annotations

import ctypes
import json
import os
import struct
import threading
from dataclasses import dataclass, field
from typing import Optional

from ..utils.native_build import load_native

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "metadata_core.cc")
_LIB = None
_BIND_LOCK = threading.Lock()

# execution states (MLMD-equivalent lifecycle)
NEW, RUNNING, COMPLETE, FAILED, CACHED = 0, 1, 2, 3, 4
STATE_NAMES = {NEW: "NEW", RUNNING: "RUNNING", COMPLETE: "COMPLETE", FAILED: "FAILED", CACHED: "CACHED"}
# artifact states
PENDING, LIVE = 0, 1
# event types
INPUT, OUTPUT = 0, 1


def _load() -> ctypes.CDLL:
    global _LIB
    with _BIND_LOCK:
        if _LIB is None:
            lib = load_native(_SRC, "metadata")
            i32, i64, p, c = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p, ctypes.c_char_p
            lib.mds_open.restype = p
            lib.mds_open.argtypes = [c]
            lib.mds_close.argtypes = [p]
            lib.mds_put_artifact.restype = i64
            lib.mds_put_artifact.argtypes = [p, i64, c, c, i32, c, i32]
            lib.mds_put_execution.restype = i64
            lib.mds_put_execution.argtypes = [p, i64, c, i32, c, c, i32]
            lib.mds_put_context.restype = i64
            lib.mds_put_context.argtypes = [p, c, c, c, i32]
            lib.mds_put_event.restype = i32
            lib.mds_put_event.argtypes = [p, i64, i64, i32, c]
            lib.mds_put_association.restype = i32
            lib.mds_put_association.argtypes = [p, i64, i64]
            lib.mds_put_attribution.restype = i32
            lib.mds_put_attribution.argtypes = [p, i64, i64]
            for fn in ("mds_get_artifact", "mds_get_execution", "mds_get_context"):
                getattr(lib, fn).restype = i64
                getattr(lib, fn).argtypes = [p, i64]
            lib.mds_context_id_by_name.restype = i64
            lib.mds_context_id_by_name.argtypes = [p, c, c]
            for fn in (
                "mds_artifacts_by_type",
                "mds_executions_by_type",
                "mds_executions_by_fingerprint",
                "mds_contexts_by_type",
            ):
                getattr(lib, fn).restype = i64
                getattr(lib, fn).argtypes = [p, c]
            for fn in (
                "mds_executions_by_context",
                "mds_artifacts_by_context",
                "mds_events_by_execution",
                "mds_events_by_artifact",
            ):
                getattr(lib, fn).restype = i64
                getattr(lib, fn).argtypes = [p, i64]
            lib.mds_read_buffer.restype = i64
            lib.mds_read_buffer.argtypes = [p, ctypes.c_char_p, i64]
            lib.mds_count.restype = i64
            lib.mds_count.argtypes = [p, i32]
            _LIB = lib
    return _LIB


@dataclass
class ArtifactRecord:
    id: int
    type: str
    uri: str
    state: int
    properties: dict = field(default_factory=dict)


@dataclass
class ExecutionRecord:
    id: int
    type: str
    state: int
    fingerprint: str = ""
    properties: dict = field(default_factory=dict)


@dataclass
class ContextRecord:
    id: int
    type: str
    name: str
    properties: dict = field(default_factory=dict)


@dataclass
class EventRecord:
    execution_id: int
    artifact_id: int
    type: int  # INPUT | OUTPUT
    path: str  # input/output key name


def _lp(buf: bytes, off: int) -> tuple[bytes, int]:
    (n,) = struct.unpack_from("<I", buf, off)
    off += 4
    return buf[off : off + n], off + n


class MetadataStore:
    """One handle on the native store; all methods are thread-safe."""

    def __init__(self, path: Optional[str] = None):
        self._lib = _load()
        self._h = self._lib.mds_open((path or "").encode())
        if not self._h:
            raise OSError(f"cannot open metadata store at {path!r}")
        self._lock = threading.Lock()  # pairs query + read_buffer atomically

    def close(self) -> None:
        if self._h:
            self._lib.mds_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - defensive
        try:
            self.close()
        except Exception:
            pass

    # ------------------------------------------------------------------ util

    def _read(self, n: int) -> bytes:
        if n <= 0:
            return b""
        buf = ctypes.create_string_buffer(n)
        got = self._lib.mds_read_buffer(self._h, buf, n)
        return buf.raw[:got]

    @staticmethod
    def _props(blob: bytes) -> dict:
        return json.loads(blob.decode()) if blob else {}

    # ------------------------------------------------------------------ puts

    def put_artifact(
        self,
        type: str,
        uri: str = "",
        state: int = LIVE,
        properties: Optional[dict] = None,
        artifact_id: int = -1,
    ) -> int:
        blob = json.dumps(properties or {}, sort_keys=True).encode()
        rid = self._lib.mds_put_artifact(self._h, artifact_id, type.encode(), uri.encode(), state, blob, len(blob))
        if rid < 0:
            raise KeyError(f"artifact id {artifact_id} not found")
        return rid

    def put_execution(
        self,
        type: str,
        state: int = RUNNING,
        fingerprint: str = "",
        properties: Optional[dict] = None,
        execution_id: int = -1,
    ) -> int:
        blob = json.dumps(properties or {}, sort_keys=True).encode()
        rid = self._lib.mds_put_execution(
            self._h, execution_id, type.encode(), state, fingerprint.encode(), blob, len(blob)
        )
        if rid < 0:
            raise KeyError(f"execution id {execution_id} not found")
        return rid

    def put_context(self, type: str, name: str, properties: Optional[dict] = None) -> int:
        """Create-or-update; (type, name) is the unique key."""
        blob = json.dumps(properties or {}, sort_keys=True).encode()
        return self._lib.mds_put_context(self._h, type.encode(), name.encode(), blob, len(blob))

    def put_event(self, execution_id: int, artifact_id: int, type: int, path: str = "") -> None:
        if self._lib.mds_put_event(self._h, execution_id, artifact_id, type, path.encode()) != 0:
            raise KeyError(f"event references unknown execution {execution_id} or artifact {artifact_id}")

    def put_association(self, context_id: int, execution_id: int) -> None:
        if self._lib.mds_put_association(self._h, context_id, execution_id) != 0:
            raise KeyError(f"association references unknown context {context_id} or execution {execution_id}")

    def put_attribution(self, context_id: int, artifact_id: int) -> None:
        if self._lib.mds_put_attribution(self._h, context_id, artifact_id) != 0:
            raise KeyError(f"attribution references unknown context {context_id} or artifact {artifact_id}")

    # ------------------------------------------------------------------ gets

    def get_artifact(self, artifact_id: int) -> ArtifactRecord:
        with self._lock:
            n = self._lib.mds_get_artifact(self._h, artifact_id)
            buf = self._read(n)
        if not buf:
            raise KeyError(f"artifact {artifact_id} not found")
        (aid, state) = struct.unpack_from("<qI", buf, 0)
        t, off = _lp(buf, 12)
        uri, off = _lp(buf, off)
        props, _ = _lp(buf, off)
        return ArtifactRecord(aid, t.decode(), uri.decode(), state, self._props(props))

    def get_execution(self, execution_id: int) -> ExecutionRecord:
        with self._lock:
            n = self._lib.mds_get_execution(self._h, execution_id)
            buf = self._read(n)
        if not buf:
            raise KeyError(f"execution {execution_id} not found")
        (eid, state) = struct.unpack_from("<qI", buf, 0)
        t, off = _lp(buf, 12)
        fp, off = _lp(buf, off)
        props, _ = _lp(buf, off)
        return ExecutionRecord(eid, t.decode(), state, fp.decode(), self._props(props))

    def get_context(self, context_id: int) -> ContextRecord:
        with self._lock:
            n = self._lib.mds_get_context(self._h, context_id)
            buf = self._read(n)
        if not buf:
            raise KeyError(f"context {context_id} not found")
        (cid, _pad) = struct.unpack_from("<qI", buf, 0)
        t, off = _lp(buf, 12)
        name, off = _lp(buf, off)
        props, _ = _lp(buf, off)
        return ContextRecord(cid, t.decode(), name.decode(), self._props(props))

    def get_context_by_name(self, type: str, name: str) -> Optional[ContextRecord]:
        cid = self._lib.mds_context_id_by_name(self._h, type.encode(), name.encode())
        return None if cid < 0 else self.get_context(cid)

    # ---------------------------------------------------------------- queries

    def _id_query(self, fn_name: str, arg) -> list[int]:
        with self._lock:
            n = getattr(self._lib, fn_name)(self._h, arg)
            buf = self._read(n)
        return list(struct.unpack(f"<{len(buf) // 8}q", buf))

    def artifacts_by_type(self, type: str) -> list[ArtifactRecord]:
        return [self.get_artifact(i) for i in self._id_query("mds_artifacts_by_type", type.encode())]

    def executions_by_type(self, type: str) -> list[ExecutionRecord]:
        return [self.get_execution(i) for i in self._id_query("mds_executions_by_type", type.encode())]

    def contexts_by_type(self, type: str) -> list[ContextRecord]:
        return [self.get_context(i) for i in self._id_query("mds_contexts_by_type", type.encode())]

    def executions_by_fingerprint(self, fingerprint: str) -> list[ExecutionRecord]:
        return [
            self.get_execution(i)
            for i in self._id_query("mds_executions_by_fingerprint", fingerprint.encode())
        ]

    def executions_by_context(self, context_id: int) -> list[ExecutionRecord]:
        return [self.get_execution(i) for i in self._id_query("mds_executions_by_context", context_id)]

    def artifacts_by_context(self, context_id: int) -> list[ArtifactRecord]:
        return [self.get_artifact(i) for i in self._id_query("mds_artifacts_by_context", context_id)]

    def _event_query(self, fn_name: str, arg) -> list[EventRecord]:
        with self._lock:
            n = getattr(self._lib, fn_name)(self._h, arg)
            buf = self._read(n)
        out, off = [], 0
        while off < len(buf):
            rec, off = _lp(buf, off)
            (eid, aid, etype) = struct.unpack_from("<qqI", rec, 0)
            path, _ = _lp(rec, 20)
            out.append(EventRecord(eid, aid, etype, path.decode()))
        return out

    def events_by_execution(self, execution_id: int) -> list[EventRecord]:
        return self._event_query("mds_events_by_execution", execution_id)

    def events_by_artifact(self, artifact_id: int) -> list[EventRecord]:
        return self._event_query("mds_events_by_artifact", artifact_id)

    def counts(self) -> dict:
        return {
            "artifacts": self._lib.mds_count(self._h, 0),
            "executions": self._lib.mds_count(self._h, 1),
            "contexts": self._lib.mds_count(self._h, 2),
            "events": self._lib.mds_count(self._h, 3),
        }

    # ------------------------------------------------- cache lookup (driver)

    def find_cached_execution(self, fingerprint: str) -> Optional[ExecutionRecord]:
        """Latest COMPLETE/CACHED execution with this fingerprint, if any."""
        hits = [
            e
            for e in self.executions_by_fingerprint(fingerprint)
            if e.state in (COMPLETE, CACHED)
        ]
        return hits[-1] if hits else None
