"""KServe agent equivalents: request batcher, payload logger, chat
sessions and the model puller.

A copy of ``kubeflow_tpu/serving/agent.py`` (the port imports nothing from
the JAX package).  Each is a wrapper or sidecar object around the Python
``Model`` host, which is where the agent sidecar's boundary lands in the
in-process design: ``runtime_main`` applies the batcher and the logger from
the ``BATCHER_*`` and ``LOGGER_*`` environment variables the controller
injects; ``ModelPuller`` syncs TrainedModel objects from any object with
the control plane's ``list(kind, namespace=)`` through the port's copy of
the storage initializer (``serving/storage.py``).

``ChatSession`` is the multi-turn driver on top: it holds a ``session_id``
and the accumulated context ids, so every turn rides the engine's
tiered-KV session pin — the prior turns' KV restores from host RAM or disk
instead of re-prefilling the whole conversation.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import Any, Callable, Optional

from .server import Model
from .storage import download


# ---------------------------------------------------------------- batcher


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


# ---------------------------------------------------------------- sessions


class ChatSession:
    """A multi-turn conversation or agent loop over an engine-backed
    model (engine/serve.JetStreamModel).

    Each ``turn(text)`` sends the FULL accumulated context plus the new
    text, tagged with this session's ``session_id`` — so the engine
    restores the prior turns' pinned KV from the tiered store (host RAM,
    or disk after a restart) and prefills only the new tail, instead of
    re-paying the whole conversation's prefill every turn.

    The context is carried as TOKEN IDS, not re-tokenized text: the
    engine pins chain hashes over the previous turn's exact id sequence,
    and a subword tokenizer re-encoding ``transcript + reply + text`` may
    merge tokens across the seams — every hash would then mismatch and
    each turn would silently restore cold.  Appending
    ``encode(new text)`` to the carried ids keeps the pinned prefix
    byte-stable by construction.  (Corollary for remote HTTP clients:
    send id-stable prompts, or accept that seam merges cost the warm
    restore, never correctness.)

    After a process restart, rebuilding a ChatSession with the same
    ``session_id`` and carried ``context_ids`` resumes warm from the
    engine's disk manifest.  The per-turn ``restore`` history ("host"/
    "disk"/"cache"/"cold"/"degraded") is kept for tests and capacity
    dashboards."""

    def __init__(self, model, session_id: Optional[str] = None,
                 max_tokens: int = 64, context_ids: Optional[list] = None):
        if getattr(model, "engine", None) is None:
            raise ValueError("ChatSession requires an engine-backed model")
        self.model = model
        self.session_id = session_id or f"chat-{uuid.uuid4().hex[:16]}"
        self.max_tokens = max_tokens
        self.context_ids: list[int] = list(context_ids or [])
        self.transcript = (model.tokenizer.decode(self.context_ids)
                           if self.context_ids else "")
        self.turns = 0
        self.restore_history: list[str] = []

    def turn(self, text: str, max_tokens: Optional[int] = None) -> dict:
        """One conversation turn: returns a generate-shaped record
        (``text_output``, ``ttft_s``, ``session`` block, ...) and folds
        prompt + reply ids into the carried context for the next turn."""
        ids = self.context_ids + self.model.tokenizer.encode(text)
        if not ids:
            # the engine refuses empty prompts; the substitute token must
            # ALSO enter the carried context, or every later turn's hash
            # chain would mismatch the pinned pages from position 0
            ids = [0]
        r = self.model.engine.generate(
            ids, max_tokens or self.max_tokens,
            session_id=self.session_id)
        reply = self.model.tokenizer.decode(r["tokens"])
        self.context_ids = ids + r["tokens"]
        self.transcript += text + reply
        self.turns += 1
        self.restore_history.append(
            (r.get("session") or {}).get("restore", "cold"))
        return {"text_output": reply, "token_ids": r["tokens"],
                "tokens": r["num_tokens"], "prompt_tokens": len(ids),
                "ttft_s": round(r["ttft_s"], 4),
                "latency_s": round(r["latency_s"], 4),
                "session": r.get("session")}

    def end(self) -> bool:
        """Drop the session's pinned KV from the engine's tiered store
        (best-effort; returns False when the model has no engine or the
        session was never pinned)."""
        eng = getattr(self.model, "engine", None)
        if eng is None:
            return False
        try:
            return bool(eng.drop_session(self.session_id))
        except Exception:  # noqa: BLE001 — cleanup is best-effort
            return False


# ----------------------------------------------------------------- logger


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


# ----------------------------------------------------------------- puller


class ModelPuller:
    """Multi-model serving: sync TrainedModel objects into a model registry.

    kserve agent puller semantics: watch TrainedModel specs attached to an
    InferenceService, download each model's ``storageUri`` into the local
    model repo, register it with the running server via ``add_model``, and
    unload on deletion.  ``sync()`` is level-triggered like a reconcile.
    ``api`` is the control plane's API server, or any object whose
    ``list(kind, namespace=)`` returns its objects as dicts.
    """

    def __init__(self, api: Any, isvc_name: str, repo_dir: str,
                 add_model: Callable[[str, str], None],
                 remove_model: Callable[[str], None],
                 namespace: str = "default"):
        self.api = api
        self.isvc_name = isvc_name
        self.repo_dir = repo_dir
        self.add_model = add_model
        self.remove_model = remove_model
        self.namespace = namespace
        self.loaded: dict[str, str] = {}  # name -> storageUri

    def sync(self) -> bool:
        """One reconcile pass; returns True if anything changed."""
        want = {}
        for tm in self.api.list("TrainedModel", namespace=self.namespace):
            if tm["spec"].get("inferenceService") != self.isvc_name:
                continue
            want[tm["metadata"]["name"]] = tm["spec"]["model"]["storageUri"]
        changed = False
        for name, uri in want.items():
            if self.loaded.get(name) == uri:
                continue
            dest = os.path.join(self.repo_dir, name)
            download(uri, dest)
            self.add_model(name, dest)
            self.loaded[name] = uri
            changed = True
        for name in list(self.loaded):
            if name not in want:
                self.remove_model(name)
                del self.loaded[name]
                changed = True
        return changed
