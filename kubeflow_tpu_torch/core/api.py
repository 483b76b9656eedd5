"""In-process Kubernetes-compatible API machinery.

A copy of ``kubeflow_tpu/core/api.py`` (the port imports nothing of the
JAX package, JAX-free modules included).

This is the L0 substrate of the platform (SURVEY.md §1, §7 phase 1): a typed
object store with the semantics controllers rely on upstream —
``resourceVersion`` optimistic concurrency, list/watch streams, labels and
selectors, ownerReference cascade deletion, namespaces, and Events.

Design notes (a rebuild of the upstream semantics, not of its code):
  * Objects are plain dicts shaped exactly like Kubernetes resources
    (``apiVersion``/``kind``/``metadata``/``spec``/``status``) so specs written
    as YAML/JSON round-trip unmodified; typed dataclass builders live in each
    component's ``api.py``.
  * The server is deliberately synchronous and thread-safe.  Controllers run on
    a deterministic single-threaded manager (see controller.py) which makes
    reconcile-driven tests reproducible — the upstream analogue is
    controller-runtime's envtest, but here the "cluster" is in-process.
  * Upstream analogue (UNVERIFIED, reference mount empty — see SURVEY.md):
    k8s apiserver + etcd; controller-runtime client.
"""

from __future__ import annotations

import copy
import fnmatch
import queue
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Optional

Obj = dict  # a Kubernetes-shaped resource body


class ApiError(Exception):
    """Base class for API errors."""

    code = 500


class NotFound(ApiError):
    code = 404


class AlreadyExists(ApiError):
    code = 409


class Conflict(ApiError):
    """resourceVersion mismatch on update."""

    code = 409


class Invalid(ApiError):
    code = 422


@dataclass(frozen=True)
class CRD:
    """A registered resource type (built-ins are registered the same way)."""

    group: str
    version: str
    kind: str
    plural: str
    namespaced: bool = True
    validator: Optional[Callable[[Obj], None]] = None   # raise Invalid on bad spec
    defaulter: Optional[Callable[[Obj], None]] = None   # mutate obj in place

    @property
    def api_version(self) -> str:
        return f"{self.group}/{self.version}" if self.group else self.version


@dataclass(frozen=True)
class GVK:
    group: str
    kind: str

    @staticmethod
    def of(obj: Obj) -> "GVK":
        api_version = obj.get("apiVersion", "")
        group = api_version.split("/")[0] if "/" in api_version else ""
        return GVK(group, obj["kind"])


def _split_api_version(api_version: str) -> tuple[str, str]:
    if "/" in api_version:
        g, v = api_version.split("/", 1)
        return g, v
    return "", api_version


def match_labels(labels: Optional[dict], selector: Optional[dict]) -> bool:
    """Equality-based selector match (the subset upstream controllers use)."""
    if not selector:
        return True
    labels = labels or {}
    return all(labels.get(k) == v for k, v in selector.items())


class WatchEvent:
    ADDED = "ADDED"
    MODIFIED = "MODIFIED"
    DELETED = "DELETED"

    __slots__ = ("type", "object")

    def __init__(self, type_: str, object_: Obj):
        self.type = type_
        self.object = object_

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        m = self.object.get("metadata", {})
        return (
            f"WatchEvent({self.type}, {self.object.get('kind')} "
            f"{m.get('namespace')}/{m.get('name')} rv={m.get('resourceVersion')})"
        )


class Watcher:
    """A watch stream: a queue of WatchEvents for one (kind, namespace) scope."""

    def __init__(self, kind: str, namespace: Optional[str], label_selector: Optional[dict]):
        self.kind = kind
        self.namespace = namespace
        self.label_selector = label_selector
        self._q: "queue.Queue[WatchEvent]" = queue.Queue()
        self.closed = False

    def _offer(self, ev: WatchEvent) -> None:
        if self.closed:
            return
        meta = ev.object.get("metadata", {})
        if self.namespace is not None and meta.get("namespace") != self.namespace:
            return
        if not match_labels(meta.get("labels"), self.label_selector):
            return
        self._q.put(ev)

    def poll(self) -> Optional[WatchEvent]:
        """Non-blocking: next event or None."""
        try:
            return self._q.get_nowait()
        except queue.Empty:
            return None

    def get(self, timeout: Optional[float] = None) -> Optional[WatchEvent]:
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def stop(self) -> None:
        self.closed = True


class APIServer:
    """The in-process apiserver + store.

    Storage model: ``self._objects[kind][(namespace, name)] = obj``.  All
    returned objects are deep copies — mutating a returned object never
    touches the store (same value semantics a REST roundtrip gives you).
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._crds: dict[str, CRD] = {}          # by kind
        self._objects: dict[str, dict[tuple, Obj]] = {}
        self._watchers: dict[str, list[Watcher]] = {}
        self._mutating_webhooks: dict[str, list[Callable[[Obj], None]]] = {}
        # resources installed components want released at cluster shutdown
        # (e.g. the Katib db-manager's listening socket) — Cluster.shutdown
        # runs these; installers register via add_teardown
        self._teardowns: list[Callable[[], None]] = []
        self._rv = 0
        self.register_crd(CRD(group="", version="v1", kind="Namespace", plural="namespaces", namespaced=False))
        self.register_crd(CRD(group="", version="v1", kind="Pod", plural="pods"))
        self.register_crd(CRD(group="", version="v1", kind="Service", plural="services"))
        self.register_crd(CRD(group="", version="v1", kind="ConfigMap", plural="configmaps"))
        self.register_crd(CRD(group="", version="v1", kind="Secret", plural="secrets"))
        self.register_crd(CRD(group="", version="v1", kind="Event", plural="events"))
        self.register_crd(CRD(group="", version="v1", kind="Node", plural="nodes", namespaced=False))
        self.register_crd(CRD(group="", version="v1", kind="PersistentVolumeClaim", plural="persistentvolumeclaims"))
        self.register_crd(CRD(group="apps", version="v1", kind="Deployment", plural="deployments"))
        self.register_crd(CRD(group="apps", version="v1", kind="StatefulSet", plural="statefulsets"))
        self.ensure_namespace("default")
        self.ensure_namespace("kubeflow")

    # ------------------------------------------------------------------ CRDs

    def register_crd(self, crd: CRD) -> None:
        with self._lock:
            self._crds[crd.kind] = crd
            self._objects.setdefault(crd.kind, {})
            self._watchers.setdefault(crd.kind, [])

    def crd_for(self, kind: str) -> CRD:
        try:
            return self._crds[kind]
        except KeyError:
            raise NotFound(f"no resource type registered for kind {kind!r}")

    def add_teardown(self, fn: Callable[[], None]) -> None:
        """Register a cleanup hook run by Cluster.shutdown (idempotence is
        the hook's responsibility)."""
        with self._lock:
            self._teardowns.append(fn)

    def run_teardowns(self) -> None:
        with self._lock:
            hooks, self._teardowns = list(self._teardowns), []
        for fn in reversed(hooks):
            try:
                fn()
            except Exception:  # noqa: BLE001 — teardown must not mask teardown
                import traceback

                traceback.print_exc()

    def register_mutating_webhook(self, kind: str, fn: Callable[[Obj], None]) -> None:
        """Admission-webhook equivalent: fn mutates the object at create time
        (after defaulting, before validation) — upstream analogue is the
        PodDefaults mutating webhook (SURVEY.md §2a)."""
        with self._lock:
            self.crd_for(kind)
            self._mutating_webhooks.setdefault(kind, []).append(fn)

    # ------------------------------------------------------------- namespaces

    def ensure_namespace(self, name: str) -> None:
        with self._lock:
            if ("", name) not in self._objects["Namespace"]:
                self.create({"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": name}})

    # ------------------------------------------------------------------ CRUD

    def _next_rv(self) -> str:
        self._rv += 1
        return str(self._rv)

    def store_version(self) -> int:
        """Monotonic write counter: bumps on every create/update/status
        write/delete.  Read-heavy callers (the ingress relay path reads
        the Service and ready-pod list per request) key snapshot caches
        on this — an unchanged version guarantees list()/get() would
        return byte-identical objects, so the per-call deepcopy can be
        skipped entirely."""
        with self._lock:
            return self._rv

    def _key(self, crd: CRD, meta: dict) -> tuple:
        ns = meta.get("namespace", "default") if crd.namespaced else ""
        return (ns, meta["name"])

    def create(self, obj: Obj) -> Obj:
        with self._lock:
            obj = copy.deepcopy(obj)
            kind = obj.get("kind")
            if not kind:
                raise Invalid("object has no kind")
            crd = self.crd_for(kind)
            obj.setdefault("apiVersion", crd.api_version)
            meta = obj.setdefault("metadata", {})
            if "name" not in meta and "generateName" in meta:
                meta["name"] = meta["generateName"] + uuid.uuid4().hex[:8]
            if "name" not in meta:
                raise Invalid(f"{kind} has no metadata.name")
            if crd.namespaced:
                meta.setdefault("namespace", "default")
                self.ensure_namespace(meta["namespace"])
            key = self._key(crd, meta)
            if key in self._objects[kind]:
                raise AlreadyExists(f"{kind} {key[0]}/{key[1]} already exists")
            meta["uid"] = uuid.uuid4().hex
            meta["creationTimestamp"] = time.time()
            meta["resourceVersion"] = self._next_rv()
            meta.setdefault("labels", {})
            meta.setdefault("annotations", {})
            if crd.defaulter:
                crd.defaulter(obj)
            for hook in self._mutating_webhooks.get(kind, []):
                hook(obj)
            if crd.validator:
                crd.validator(obj)
            self._objects[kind][key] = obj
            self._notify(WatchEvent(WatchEvent.ADDED, copy.deepcopy(obj)), kind)
            return copy.deepcopy(obj)

    def get(self, kind: str, name: str, namespace: str = "default") -> Obj:
        with self._lock:
            crd = self.crd_for(kind)
            key = (namespace if crd.namespaced else "", name)
            try:
                return copy.deepcopy(self._objects[kind][key])
            except KeyError:
                raise NotFound(f"{kind} {key[0]}/{key[1]} not found")

    def try_get(self, kind: str, name: str, namespace: str = "default") -> Optional[Obj]:
        try:
            return self.get(kind, name, namespace)
        except NotFound:
            return None

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[dict] = None,
        field_selector: Optional[Callable[[Obj], bool]] = None,
    ) -> list[Obj]:
        with self._lock:
            out = []
            for (ns, _), obj in sorted(self._objects[kind].items()):
                if namespace is not None and ns != namespace:
                    continue
                if not match_labels(obj["metadata"].get("labels"), label_selector):
                    continue
                if field_selector is not None and not field_selector(obj):
                    continue
                out.append(copy.deepcopy(obj))
            return out

    def update(self, obj: Obj) -> Obj:
        """Full-object update with resourceVersion optimistic concurrency."""
        with self._lock:
            obj = copy.deepcopy(obj)
            kind = obj["kind"]
            crd = self.crd_for(kind)
            meta = obj["metadata"]
            key = self._key(crd, meta)
            current = self._objects[kind].get(key)
            if current is None:
                raise NotFound(f"{kind} {key[0]}/{key[1]} not found")
            if meta.get("resourceVersion") != current["metadata"]["resourceVersion"]:
                raise Conflict(
                    f"{kind} {key[1]}: resourceVersion {meta.get('resourceVersion')} "
                    f"!= {current['metadata']['resourceVersion']}"
                )
            # immutable fields
            meta["uid"] = current["metadata"]["uid"]
            meta["creationTimestamp"] = current["metadata"]["creationTimestamp"]
            meta["resourceVersion"] = self._next_rv()
            if crd.validator:
                crd.validator(obj)
            self._objects[kind][key] = obj
            self._notify(WatchEvent(WatchEvent.MODIFIED, copy.deepcopy(obj)), kind)
            return copy.deepcopy(obj)

    def update_status(self, obj: Obj) -> Obj:
        """Status-subresource style update: only .status (+rv bump) is applied."""
        with self._lock:
            kind = obj["kind"]
            crd = self.crd_for(kind)
            meta = obj["metadata"]
            key = self._key(crd, meta)
            current = self._objects[kind].get(key)
            if current is None:
                raise NotFound(f"{kind} {key[0]}/{key[1]} not found")
            if meta.get("resourceVersion") != current["metadata"]["resourceVersion"]:
                raise Conflict(f"{kind} {key[1]}: stale resourceVersion on status update")
            updated = copy.deepcopy(current)
            updated["status"] = copy.deepcopy(obj.get("status", {}))
            updated["metadata"]["resourceVersion"] = self._next_rv()
            self._objects[kind][key] = updated
            self._notify(WatchEvent(WatchEvent.MODIFIED, copy.deepcopy(updated)), kind)
            return copy.deepcopy(updated)

    def patch(self, kind: str, name: str, patch: dict, namespace: str = "default") -> Obj:
        """Strategic-merge-ish patch: recursive dict merge; None deletes a key."""
        with self._lock:
            current = self.get(kind, name, namespace)
            merged = _merge(current, patch)
            merged["metadata"]["resourceVersion"] = current["metadata"]["resourceVersion"]
            return self.update(merged)

    def delete(self, kind: str, name: str, namespace: str = "default") -> None:
        with self._lock:
            crd = self.crd_for(kind)
            key = (namespace if crd.namespaced else "", name)
            obj = self._objects[kind].get(key)
            if obj is None:
                raise NotFound(f"{kind} {key[0]}/{key[1]} not found")
            uid = obj["metadata"]["uid"]
            del self._objects[kind][key]
            # deletions must advance the store version too, or
            # store_version()-keyed snapshot caches would keep serving
            # the deleted object
            self._next_rv()
            self._notify(WatchEvent(WatchEvent.DELETED, copy.deepcopy(obj)), kind)
            # ownerReference cascade (synchronous "background" GC)
            self._cascade_delete(uid)

    def try_delete(self, kind: str, name: str, namespace: str = "default") -> bool:
        try:
            self.delete(kind, name, namespace)
            return True
        except NotFound:
            return False

    def _cascade_delete(self, owner_uid: str) -> None:
        doomed: list[tuple[str, str, str]] = []
        for kind, objs in self._objects.items():
            for (ns, name), obj in objs.items():
                for ref in obj["metadata"].get("ownerReferences", []):
                    if ref.get("uid") == owner_uid:
                        doomed.append((kind, name, ns))
        for kind, name, ns in doomed:
            try:
                self.delete(kind, name, ns)
            except NotFound:
                pass

    # ----------------------------------------------------------------- watch

    def watch(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[dict] = None,
        send_initial: bool = False,
    ) -> Watcher:
        with self._lock:
            self.crd_for(kind)
            w = Watcher(kind, namespace, label_selector)
            if send_initial:
                for obj in self.list(kind, namespace, label_selector):
                    w._offer(WatchEvent(WatchEvent.ADDED, obj))
            self._watchers[kind].append(w)
            return w

    def _notify(self, ev: WatchEvent, kind: str) -> None:
        live = []
        for w in self._watchers[kind]:
            if w.closed:
                continue
            w._offer(ev)
            live.append(w)
        self._watchers[kind] = live


def _merge(base: dict, patch: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in patch.items():
        if v is None:
            out.pop(k, None)
        elif isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def owner_reference(owner: Obj, controller: bool = True) -> dict:
    return {
        "apiVersion": owner["apiVersion"],
        "kind": owner["kind"],
        "name": owner["metadata"]["name"],
        "uid": owner["metadata"]["uid"],
        "controller": controller,
    }


def is_owned_by(obj: Obj, owner: Obj) -> bool:
    return any(
        r.get("uid") == owner["metadata"]["uid"]
        for r in obj["metadata"].get("ownerReferences", [])
    )
