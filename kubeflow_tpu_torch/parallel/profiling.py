"""Workload-side profiler surfacing.

Counterpart of ``kubeflow_tpu/parallel/profiling.py`` on ``torch.profiler``.
The TPUJob controller injects ``TPU_PROFILE_DIR``/``TPU_PROFILE_STEPS`` when
``spec.profile.enabled``; a training loop wraps each step with
``maybe_trace`` and gets a trace of steps ``[0, TPU_PROFILE_STEPS)`` with
no workload code change to turn profiling on or off.  The trace starts at
step 0, each traced step is annotated ``train#step_num=<i>#`` (the name
``jax.profiler.StepTraceAnnotation("train", step_num=i)`` records), and at
the last traced step it is written to the directory as a Chrome trace,
``trace-<pid>.json``, holding the host's events and, where a card is
present, the device's.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

# the trace in flight between its first and last step
_active = None


def profile_dir(environ=None) -> Optional[str]:
    env = environ if environ is not None else os.environ
    return env.get("TPU_PROFILE_DIR") or None


def profile_steps(environ=None) -> int:
    env = environ if environ is not None else os.environ
    return int(env.get("TPU_PROFILE_STEPS", "5"))


def trace_path(directory: str) -> str:
    """The file ``maybe_trace`` writes in ``directory``."""
    return os.path.join(directory, f"trace-{os.getpid()}.json")


@contextlib.contextmanager
def maybe_trace(step: int, environ=None) -> Iterator[bool]:
    """Trace this step iff profiling is enabled and step < TPU_PROFILE_STEPS.

    Yields whether the step is being traced.  Steps after the window are
    zero-overhead (no context at all beyond the env check)."""
    global _active
    d = profile_dir(environ)
    if d is None or step >= profile_steps(environ):
        yield False
        return
    import torch

    os.makedirs(d, exist_ok=True)
    if step == 0:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        _active = torch.profiler.profile(activities=activities)
        _active.start()
    with torch.profiler.record_function(f"train#step_num={step}#"):
        yield True
    if step == profile_steps(environ) - 1 and _active is not None:
        prof, _active = _active, None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(trace_path(d))
