"""Deterministic reconcile machinery.

A copy of ``kubeflow_tpu/core/controller.py``: the Manager, its
reconcilers' workqueues and tickers, over the port's ``core/metrics.py``.

Upstream analogue (UNVERIFIED): controller-runtime's manager/controller/
workqueue.  The crucial design departure (SURVEY.md §4 "implication for the
rebuild"): instead of N goroutines and eventual consistency, a *single-threaded*
manager pumps all watch streams and drains a deduplicating workqueue, so tests
drive the full reconcile path deterministically.  Real concurrency lives only
in pod subprocesses (see kubelet.py) — the same place the real cluster has it.
"""

from __future__ import annotations

import heapq
import time
import traceback
from dataclasses import dataclass
from typing import Callable, Optional, Protocol

from .api import APIServer, Obj, Watcher
from .metrics import RECONCILE_ERRORS, RECONCILE_TOTAL


@dataclass(frozen=True)
class Request:
    name: str
    namespace: str = "default"


@dataclass
class Result:
    requeue_after: Optional[float] = None


class Reconciler(Protocol):
    #: primary kind this reconciler owns
    kind: str

    def reconcile(self, req: Request) -> Optional[Result]: ...


class Controller:
    """Watches a primary kind plus owned kinds, maps events to Requests."""

    def __init__(
        self,
        api: APIServer,
        reconciler: Reconciler,
        owns: tuple[str, ...] = (),
        watches: tuple[tuple[str, Callable[[Obj], Optional[Request]]], ...] = (),
    ):
        self.api = api
        self.reconciler = reconciler
        self.kind = reconciler.kind
        self._primary: Watcher = api.watch(self.kind, send_initial=True)
        self._owned: list[tuple[Watcher, str]] = [
            (api.watch(kind, send_initial=True), kind) for kind in owns
        ]
        self._mapped: list[tuple[Watcher, Callable[[Obj], Optional[Request]]]] = [
            (api.watch(kind, send_initial=True), fn) for kind, fn in watches
        ]
        self._queue: list[Request] = []
        self._queued: set[Request] = set()
        self._delayed: list[tuple[float, int, Request]] = []  # heap
        self._seq = 0
        self.errors: list[tuple[Request, BaseException]] = []

    # ------------------------------------------------------------------ queue

    def _enqueue(self, req: Request) -> None:
        if req not in self._queued:
            self._queued.add(req)
            self._queue.append(req)

    def _enqueue_after(self, req: Request, delay: float) -> None:
        self._seq += 1
        heapq.heappush(self._delayed, (time.monotonic() + delay, self._seq, req))

    def _owner_request(self, obj: Obj) -> Optional[Request]:
        for ref in obj["metadata"].get("ownerReferences", []):
            if ref.get("controller") and ref.get("kind") == self.kind:
                return Request(ref["name"], obj["metadata"].get("namespace", "default"))
        return None

    def pump(self) -> int:
        """Drain watch streams into the workqueue. Returns #events consumed."""
        n = 0
        while (ev := self._primary.poll()) is not None:
            m = ev.object["metadata"]
            self._enqueue(Request(m["name"], m.get("namespace", "default")))
            n += 1
        for w, _kind in self._owned:
            while (ev := w.poll()) is not None:
                req = self._owner_request(ev.object)
                if req is not None:
                    self._enqueue(req)
                n += 1
        for w, fn in self._mapped:
            while (ev := w.poll()) is not None:
                req = fn(ev.object)
                if req is not None:
                    self._enqueue(req)
                n += 1
        now = time.monotonic()
        while self._delayed and self._delayed[0][0] <= now:
            _, _, req = heapq.heappop(self._delayed)
            self._enqueue(req)
        return n

    def process(self, max_items: Optional[int] = None) -> int:
        """Reconcile queued requests. Returns #requests processed."""
        n = 0
        while self._queue and (max_items is None or n < max_items):
            req = self._queue.pop(0)
            self._queued.discard(req)
            try:
                result = self.reconciler.reconcile(req)
            except Exception as e:  # noqa: BLE001 — controller loop must survive
                self.errors.append((req, e))
                RECONCILE_TOTAL.inc(controller=self.kind, result="error")
                RECONCILE_ERRORS.inc(controller=self.kind)
                traceback.print_exc()
                self._enqueue_after(req, 0.2)
            else:
                RECONCILE_TOTAL.inc(
                    controller=self.kind,
                    result="requeue_after" if result and result.requeue_after else "success",
                )
                if result is not None and result.requeue_after is not None:
                    self._enqueue_after(req, result.requeue_after)
            n += 1
        return n

    @property
    def idle(self) -> bool:
        return not self._queue and self._primary._q.empty() and all(
            w._q.empty() for w, _ in self._owned
        ) and all(w._q.empty() for w, _ in self._mapped)

    def next_deadline(self) -> Optional[float]:
        return self._delayed[0][0] if self._delayed else None


class Manager:
    """Runs controllers + tickers (kubelet/scheduler sync fns) to quiescence."""

    def __init__(self, api: APIServer):
        self.api = api
        self.controllers: list[Controller] = []
        self.tickers: list[Callable[[], bool]] = []

    def add(
        self,
        reconciler: Reconciler,
        owns: tuple[str, ...] = (),
        watches: tuple[tuple[str, Callable[[Obj], Optional[Request]]], ...] = (),
    ) -> Controller:
        c = Controller(self.api, reconciler, owns=owns, watches=watches)
        self.controllers.append(c)
        return c

    def add_ticker(self, fn: Callable[[], bool]) -> None:
        """A ticker is a sync function returning True if it changed anything."""
        self.tickers.append(fn)

    def step(self) -> bool:
        """One scheduling round. Returns True if any work happened."""
        worked = False
        for t in self.tickers:
            if t():
                worked = True
        for c in self.controllers:
            if c.pump():
                worked = True
            if c.process():
                worked = True
        return worked

    def run_until(
        self,
        predicate: Callable[[], bool],
        timeout: float = 60.0,
        poll: float = 0.02,
    ) -> bool:
        """Drive the world until predicate() is true (or timeout). Returns
        whether the predicate was met."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if predicate():
                return True
            if not self.step():
                # nothing to do right now: honor the nearest delayed requeue,
                # else nap briefly to let pod subprocesses make progress.
                deadlines = [d for c in self.controllers if (d := c.next_deadline())]
                if deadlines:
                    time.sleep(max(0.0, min(min(deadlines) - time.monotonic(), poll * 5)))
                else:
                    time.sleep(poll)
        return predicate()

    def settle(self, quiet: float = 0.2, timeout: float = 30.0) -> None:
        """Run until nothing has happened for `quiet` seconds."""
        deadline = time.monotonic() + timeout
        last_work = time.monotonic()
        while time.monotonic() < deadline:
            if self.step():
                last_work = time.monotonic()
            elif time.monotonic() - last_work > quiet:
                return
            else:
                time.sleep(0.01)

    def raise_errors(self) -> None:
        errs = [e for c in self.controllers for e in c.errors]
        if errs:
            req, e = errs[0]
            raise RuntimeError(f"{len(errs)} reconcile error(s); first at {req}: {e}") from e
