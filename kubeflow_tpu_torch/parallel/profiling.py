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

``Capture`` opens every torch.profiler capture the port makes (this
module's trace, the serving engine's ``TickProfiler``): with a card it
leads in with a primer and ``LEAD_IN_S`` of host time, and it counts the
host launch calls a capture brackets and the device records it lost, tied
by correlation id (``window_records``), so a capture that lost a record
says so where its caller reads the result.  ``maybe_trace`` puts both counts on
one line on stderr beside its trace.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Iterator, Optional

# the trace in flight between its first and last step
_active = None

# host calls that put one record on the device: kernel launches, copies, fills
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset")

# What a capture of device activity does after it starts and before the
# work it brackets (measured with profiler_probe.py on the H100).  Kineto
# drops as out of range the first device records of a capture, more of them
# the older the process (2-4 a capture a minute into a training process, up
# to ~60 after 15 minutes of chip_smoke.py), and now and then a capture's
# records come back stamped up to ~6 ms before the calls that launched
# them.  So a capture first makes PRIMER_LAUNCHES small launches of its own
# and waits for them (the dropped records are theirs), then lets LEAD_IN_S
# of host time pass, and counts only what follows.  Before it stops, with
# the device done, it waits again for LEAD_OUT_SHARE of its own length: now
# and then a capture's records come back stretched (one window of 63 in a
# chip_smoke.py run, ~15% busier than its neighbours, lost its last 189),
# and kineto drops those that end after the stop.
PRIMER_LAUNCHES = 256
LEAD_IN_S = 0.05
LEAD_OUT_SHARE = 0.25
# the mark a capture counts from when its caller names no span
CAPTURE_MARK = "profiling.capture"


def _tally(prof, span: Optional[str], to_stop: bool = False) -> tuple:
    """``window_records`` of a stopped capture, and the least time in ms
    from a launch call's host start to its record's device start (negative:
    the record was stamped before the call that made it; None without a
    record).  ``to_stop``: count from the start of ``span`` to the
    capture's stop."""
    import torch

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ev = list(prof.profiler.kineto_results.events())
    sp = None
    if span is not None:
        sp = next(((e.start_ns(), float("inf") if to_stop else e.end_ns()) for e in ev
                   if e.device_type() == cpu and e.name() == span), None)
    calls = {e.correlation_id(): e.start_ns() for e in ev
             if e.device_type() == cpu and e.name().startswith(LAUNCH_CALLS)
             and (sp is None or sp[0] <= e.start_ns() <= sp[1])}
    recs = [e for e in ev if e.device_type() == cuda and e.correlation_id() in calls]
    lead = min((e.start_ns() - calls[e.correlation_id()] for e in recs), default=None)
    return ([(e.name(), e.start_ns(), e.end_ns()) for e in recs], len(calls),
            len(calls.keys() - {e.correlation_id() for e in recs}),
            None if lead is None else lead / 1e6)


def window_records(prof, span: Optional[str] = None) -> tuple:
    """The device records (name, start ns, end ns) of the host launch calls
    made in a stopped capture (inside its ``record_function`` span named
    ``span``, when given), tied to them by correlation id in kineto's own
    results, the number of those calls, and the number of them without a
    record: records the capture lost."""
    return _tally(prof, span)[:3]


def _sync_device() -> None:
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Capture:
    """One torch.profiler capture: the host's activity and, where a card is
    present, the device's.  ``start()`` waits for the device (``sync``, by
    default every queued kernel of the current card) so no earlier kernel
    runs inside the capture, and with a card runs the primer and the
    lead-in above; ``stop()`` waits again so every kernel the capture
    launched has finished and been recorded, with a card lets the lead-out
    above pass, stops the profiler, and
    counts the host launch calls it bracketed after the primer (inside the
    caller's ``record_function`` span named ``span``, or else from a mark
    the capture leaves at the end of ``start()``) and the device records it
    lost.  ``error`` says how many were lost, or is None: a capture that
    lost any is not a whole one.  ``lead_ms`` is the least time from a
    launch call to its record's start (negative: stamped before the call).
    On the CPU both counts are 0, with no primer, lead-in, mark or
    lead-out.
    ``profile_kwargs`` go to ``torch.profiler.profile``."""

    def __init__(self, sync=None, span: Optional[str] = None, **profile_kwargs):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        self._device = torch.cuda.is_available()
        if self._device:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts, **profile_kwargs)
        self._sync = sync if sync is not None else _sync_device
        self.span = span
        self._to_stop = False
        self._t0 = 0.0
        self.records: list = []
        self.launch_calls = 0
        self.lost_records = 0
        self.lead_ms: Optional[float] = None

    def start(self) -> "Capture":
        import torch

        self._sync()
        self.prof.start()
        self._t0 = time.perf_counter()
        if self._device:
            x = torch.zeros(1, device=torch.device("cuda", torch.cuda.current_device()))
            for _ in range(PRIMER_LAUNCHES):
                x.add_(1)
            torch.cuda.synchronize(x.device)
            time.sleep(LEAD_IN_S)
            if self.span is None:
                with torch.profiler.record_function(CAPTURE_MARK):
                    pass
                self.span, self._to_stop = CAPTURE_MARK, True
        return self

    def stop(self) -> "Capture":
        self._sync()
        if self._device:
            time.sleep(LEAD_OUT_SHARE * (time.perf_counter() - self._t0))
        self.prof.stop()
        self.records, self.launch_calls, self.lost_records, self.lead_ms = _tally(
            self.prof, self.span, self._to_stop)
        return self

    @property
    def error(self) -> Optional[str]:
        if not self.lost_records:
            return None
        return (f"profiler capture lost {self.lost_records} of {self.launch_calls} "
                "device records")

    def export(self, path: str) -> None:
        self.prof.export_chrome_trace(path)


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
    zero-overhead (no context at all beyond the env check).  With the trace
    written, one line on stderr gives its launch calls and the device
    records it lost; training goes on either way."""
    global _active
    d = profile_dir(environ)
    if d is None or step >= profile_steps(environ):
        yield False
        return
    import torch

    os.makedirs(d, exist_ok=True)
    if step == 0:
        _active = Capture().start()
    with torch.profiler.record_function(f"train#step_num={step}#"):
        yield True
    if step == profile_steps(environ) - 1 and _active is not None:
        cap, _active = _active, None
        cap.stop()
        path = trace_path(d)
        cap.export(path)
        print(f"maybe_trace: {path}: {cap.launch_calls} launch calls, "
              f"{cap.lost_records} device records lost", file=sys.stderr, flush=True)
