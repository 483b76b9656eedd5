"""KServe agent equivalents: the request batcher and the payload logger.

A copy of part of ``kubeflow_tpu/serving/agent.py`` (the port imports
nothing from the JAX package).  Each is a wrapper around the Python
``Model`` host, which is where the agent sidecar's boundary lands in the
in-process design: ``runtime_main`` applies them from the
``BATCHER_*`` and ``LOGGER_*`` environment variables the controller
injects.  ``ChatSession`` and ``ModelPuller`` need the control plane's
``APIServer`` and ``storage`` and are not part of the port yet.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Optional

from .server import Model


class RequestBatcher(Model):
    """Coalesce concurrent single predicts into one batched model call.

    kserve's agent batcher semantics: requests wait at most ``max_latency``
    for the batch to fill to ``max_batch_size``; the batch is then predicted
    in ONE call to the wrapped model, which must accept
    ``{"instances": [...]}`` and return a list of predictions in order.
    """

    def __init__(self, inner: Model, max_batch_size: int = 8,
                 max_latency: float = 0.02, wait_timeout: float = 30.0):
        super().__init__(inner.name)
        self.inner = inner
        self.max_batch_size = max_batch_size
        self.max_latency = max_latency
        self.wait_timeout = wait_timeout
        self._lock = threading.Lock()
        self._queue: list[tuple[Any, threading.Event, dict]] = []
        self._flusher: Optional[threading.Timer] = None
        self.batches_predicted = 0

    def load(self) -> None:
        self.inner.load()
        self.ready = self.inner.ready

    def health(self) -> dict:
        # the wrapped model owns the replica-health truth (an engine model
        # reports its SERVING/DRAINING/DEAD machine through the batcher)
        return self.inner.health()

    def predict(self, payload: Any, headers: Optional[dict] = None) -> Any:
        instances = payload.get("instances") if isinstance(payload, dict) else None
        if not instances or len(instances) != 1:
            # already batched (or free-form): pass straight through
            return self.inner.predict(payload, headers)
        done = threading.Event()
        slot: dict = {}
        batch = None
        with self._lock:
            self._queue.append((instances[0], done, slot))
            if len(self._queue) >= self.max_batch_size:
                batch = self._take_locked()
            elif self._flusher is None:
                self._flusher = threading.Timer(self.max_latency, self._flush)
                self._flusher.daemon = True
                self._flusher.start()
        if batch is not None:
            # the filling request runs the batch itself, OUTSIDE the lock, so
            # new requests keep enqueueing while the model call is in flight
            self._run_batch(batch)
        if not done.wait(timeout=self.wait_timeout):
            raise TimeoutError(f"batched predict did not complete in {self.wait_timeout}s")
        if "error" in slot:
            raise slot["error"]
        return {"predictions": [slot["result"]]}

    def _take_locked(self) -> list:
        if self._flusher is not None:
            self._flusher.cancel()
            self._flusher = None
        batch, self._queue = self._queue, []
        return batch

    def _flush(self) -> None:
        with self._lock:
            batch = self._take_locked()
        self._run_batch(batch)

    def _run_batch(self, batch: list) -> None:
        if not batch:
            return
        try:
            out = self.inner.predict({"instances": [b[0] for b in batch]})
            preds = out.get("predictions") if isinstance(out, dict) else out
            if len(preds) != len(batch):
                raise ValueError(
                    f"batched model returned {len(preds)} predictions for "
                    f"{len(batch)} instances")
            self.batches_predicted += 1
            for (_, done, slot), pred in zip(batch, preds):
                slot["result"] = pred
                done.set()
        except Exception as e:  # propagate to EVERY waiter
            for _, done, slot in batch:
                slot["error"] = e
                done.set()


class PayloadLogger(Model):
    """Log request/response pairs around the wrapped model.

    kserve agent logger semantics (CloudEvents to a URL sink); here the sink
    is a callable or a JSONL file — the observable contract (every predict
    produces a request AND a response record with a shared id) is the same.
    """

    def __init__(self, inner: Model, sink: Optional[Callable[[dict], None]] = None,
                 path: Optional[str] = None, log_mode: str = "all"):
        super().__init__(inner.name)
        self.inner = inner
        self.log_mode = log_mode  # all | request | response
        self._sink = sink
        self._path = path
        self._lock = threading.Lock()
        self._n = 0

    def load(self) -> None:
        self.inner.load()
        self.ready = self.inner.ready

    def health(self) -> dict:
        return self.inner.health()

    def _emit(self, record: dict) -> None:
        if self._sink:
            self._sink(record)
        if self._path:
            with self._lock, open(self._path, "a") as f:
                f.write(json.dumps(record) + "\n")

    def predict(self, payload: Any, headers: Optional[dict] = None) -> Any:
        with self._lock:
            self._n += 1
            rid = f"{self.name}-{self._n}"
        if self.log_mode in ("all", "request"):
            self._emit({"id": rid, "type": "request", "model": self.name,
                        "time": time.time(), "payload": payload})
        out = self.inner.predict(payload, headers)
        if self.log_mode in ("all", "response"):
            self._emit({"id": rid, "type": "response", "model": self.name,
                        "time": time.time(), "payload": out})
        return out
