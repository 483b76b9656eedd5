"""Checkpointing on ``torch.save``: async save, latest-step resume.

Counterpart of ``kubeflow_tpu/train/checkpoint.py`` (Orbax there, which the
port does not use).  Each step lives in ``<directory>/<step>/state.pt``,
written under a temporary name and renamed into place, so a reader (or a
restart after a kill mid-write) sees whole steps only.  The newest
``MAX_TO_KEEP`` steps are kept.

In a job of several processes (``parallel/distributed.py``) every process
hands ``save`` the whole state (the Trainer gathers it), process 0 alone
writes it, and ``restore_latest`` restores the step that process 0 reads as
the newest, broadcast to the others, so the members of a restarted gang
resume from the same step.
"""

from __future__ import annotations

import os
import shutil
import threading
import uuid
from typing import Any, Optional

import torch

from ..parallel import distributed

MAX_TO_KEEP = 3


def _map(fn, tree):
    """Apply ``fn`` to every tensor of a nested dict/list/tuple."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return type(tree)((k, _map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def _place_like(state, like):
    """``state``'s tensors on the devices of the matching leaves of ``like``."""
    if isinstance(state, torch.Tensor):
        dev = like.device if isinstance(like, torch.Tensor) else "cpu"
        return state.to(dev)
    if isinstance(state, dict):
        like = like if isinstance(like, dict) else {}
        return type(state)((k, _place_like(v, like.get(k))) for k, v in state.items())
    if isinstance(state, (list, tuple)):
        like = like if isinstance(like, (list, tuple)) else [None] * len(state)
        return type(state)(_place_like(v, lk) for v, lk in zip(state, like))
    return state


class CheckpointManager:
    def __init__(self, directory: str, async_save: bool = True):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.async_save = async_save
        # one writer per job: process 0
        self.writer = distributed.process_index() == 0
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def all_steps(self) -> list[int]:
        return sorted(int(n) for n in os.listdir(self.directory) if n.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> bool:
        """Copy ``state`` to host memory, then write it (on a background
        thread when ``async_save``).  A step already saved is skipped and
        returns False, as Orbax's manager does; so does every process but
        the writer."""
        self.wait()  # one write in flight at a time
        if not self.writer or step in self.all_steps():
            return False
        host = _map(lambda t: t.detach().to("cpu", copy=True), state)
        if self.async_save:
            self._thread = threading.Thread(target=self._write_guarded,
                                            args=(step, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, host)
        return True

    def _write_guarded(self, step: int, host: Any) -> None:
        try:
            self._write(step, host)
        except Exception as e:  # noqa: BLE001 — the writer thread's boundary: wait() re-raises
            self._error = e

    def _write(self, step: int, host: Any) -> None:
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f".tmp-{step}-{uuid.uuid4().hex}")
        os.makedirs(tmp)
        try:
            path = os.path.join(tmp, "state.pt")
            with open(path, "wb") as f:
                torch.save(host, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)  # atomic: readers see whole steps only
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        for old in self.all_steps()[:-MAX_TO_KEEP]:
            shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)

    def restore_latest(self, like: Any) -> Optional[dict]:
        """Restore the newest step with its tensors on the devices of the
        matching leaves of ``like``: ``{"step", "state"}``, or None.  In a
        job of several processes the step is the writer's newest."""
        self.wait()
        step = self.latest_step() if self.writer else None
        if distributed.process_count() > 1:
            step = distributed.broadcast_object(step)
        if step is None:
            return None
        state = torch.load(os.path.join(self.directory, str(step), "state.pt"),
                           map_location="cpu", weights_only=True)
        return {"step": step, "state": _place_like(state, like)}

    def wait(self) -> None:
        """Join the write in flight; re-raise its error if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
