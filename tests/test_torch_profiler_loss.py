"""The port's profiler captures count what they lost and say so.

``parallel.profiling.window_records`` ties each host launch call of a
capture to its device record by correlation id; ``Capture`` keeps the
counts, and the capture sites report a loss where their callers read the
result: ``TickProfiler`` (behind ``Engine.trace_n_ticks`` and ``POST
/engine/profile``) ends the capture with ``last_error``, passes it to
``on_complete`` and does not count it in ``captures``; ``maybe_trace`` puts
both counts on one line on stderr.  Here, on the CPU, kineto's results are
faked for the lossy cases (a window with every record, with some lost, with
none kept); a real CPU capture reports 0 launch calls and 0 lost and
behaves as before."""

import os
import re
import time

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.parallel import profiling
from kubeflow_tpu_torch.serving.engine.telemetry import TickProfiler

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
SPAN = "measured"


class FakeEvent:
    def __init__(self, device, name, corr, t0, t1):
        self._d, self._n, self._c, self._t = device, name, corr, (t0, t1)

    def device_type(self):
        return self._d

    def name(self):
        return self._n

    def correlation_id(self):
        return self._c

    def start_ns(self):
        return self._t[0]

    def end_ns(self):
        return self._t[1]


class FakeProf:
    """What ``window_records`` reads of a stopped ``torch.profiler.profile``."""

    def __init__(self, events):
        results = type("Results", (), {"events": lambda _self: list(events)})()
        self.profiler = type("Profiler", (), {"kineto_results": results})()


def _window(kept: int, launches: int = 4, outside: bool = True) -> FakeProf:
    """A window with ``launches`` launch calls inside the span (a kernel, a
    cluster launch, a driver-API launch and a copy, in turn), the first
    ``kept`` of them with a device record; a launch before the span (with
    its record); and the span's own device annotation, whose correlation
    id is no launch's."""
    calls = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx", "cudaMemcpyAsync")
    ev = [FakeEvent(CPU, SPAN, 0, 1_000, 9_000), FakeEvent(CUDA, SPAN, 0, 1_000, 9_000),
          FakeEvent(CPU, "aten::add_", 90, 1_100, 1_200)]
    if outside:
        ev += [FakeEvent(CPU, "cudaLaunchKernel", 99, 500, 600),
               FakeEvent(CUDA, "before_span_kernel", 99, 700, 800)]
    for i in range(launches):
        t = 2_000 + 1_000 * i
        ev.append(FakeEvent(CPU, calls[i % len(calls)], 100 + i, t, t + 50))
        if i < kept:
            ev.append(FakeEvent(CUDA, f"kernel_{i}", 100 + i, t + 100, t + 400))
    return FakeProf(ev)


@pytest.mark.parametrize("kept,lost", [(4, 0), (1, 3), (0, 4)], ids=["whole", "some", "none"])
def test_window_records_counts_the_launch_calls_and_lost_records(kept, lost):
    recs, calls, missing = profiling.window_records(_window(kept), SPAN)
    assert (calls, missing) == (4, lost)
    assert [r[0] for r in recs] == [f"kernel_{i}" for i in range(kept)]
    # each kept record starts 100 ns after its launch call
    assert profiling._tally(_window(kept), SPAN)[3] == (1e-4 if kept else None)
    # without a span every launch call of the window counts, the one before it too
    recs, calls, missing = profiling.window_records(_window(kept), None)
    assert (calls, missing) == (5, lost)
    assert "before_span_kernel" in [r[0] for r in recs]


def test_a_device_record_under_another_correlation_id_is_not_a_launchs_record():
    """The span's own device annotation, and a kernel filed under an id no
    launch call of the window holds, leave the launch they might belong to
    counted as lost: the rule ties records by correlation id only."""
    events = _window(kept=0, launches=1, outside=False).profiler.kineto_results.events()
    prof = FakeProf(events + [FakeEvent(CUDA, "kernel_0", 555, 2_100, 2_400)])
    recs, calls, missing = profiling.window_records(prof, SPAN)
    assert (recs, calls, missing) == ([], 1, 1)


def test_a_capture_without_a_span_counts_from_its_mark_to_its_stop():
    """The primer's launches come before the capture's mark: its records,
    the ones kineto drops, are not counted; every launch after the mark is,
    to the capture's stop."""
    mark = profiling.CAPTURE_MARK
    prof = FakeProf([FakeEvent(CPU, "cudaLaunchKernel", 1, 100, 110),  # the primer, lost
                     FakeEvent(CPU, mark, 0, 1_000, 1_001),
                     FakeEvent(CPU, "cudaLaunchKernel", 2, 2_000, 2_050),
                     FakeEvent(CUDA, "kernel_a", 2, 2_100, 2_300),
                     FakeEvent(CPU, "cuLaunchKernelEx", 3, 5_000, 5_050),
                     FakeEvent(CUDA, "kernel_b", 3, 5_200, 5_900)])
    assert profiling._tally(prof, mark, to_stop=True)[1:3] == (2, 0)
    assert profiling._tally(prof, mark)[1:3] == (0, 0)  # the mark alone spans no launch
    assert profiling.window_records(prof)[1:] == (3, 1)  # the whole capture: the primer's loss


def _lossy(monkeypatch, kept: int = 2, launches: int = 5):
    """Make every capture count as the fake window with ``kept`` of its
    ``launches`` records kept (the real CPU capture still runs and writes
    its trace)."""
    real = profiling._tally

    def fake(prof, span=None, to_stop=False):
        return real(_window(kept, launches, outside=False), SPAN)

    monkeypatch.setattr(profiling, "_tally", fake)


def test_tick_profiler_reports_a_lossy_capture(tmp_path, monkeypatch):
    _lossy(monkeypatch)
    tp = TickProfiler()
    seen = []
    tp.on_complete = lambda err, ctx: seen.append((err, ctx))
    tp.request(1, str(tmp_path), ctx="run-1")
    tp.on_tick_start(7)
    torch.ones(64).add_(1)
    tp.on_tick_end(7, True)
    want = "profiler capture lost 3 of 5 device records"
    assert tp.last_error == want and seen == [(want, "run-1")]
    assert (tp.launch_calls, tp.lost_records) == (5, 3)
    assert tp.captures == 0 and not tp.active  # not counted whole
    assert os.path.exists(tp.last_trace) and tp.window == (7, 7)  # the trace is still written


def test_maybe_trace_reports_a_lossy_trace_on_stderr(tmp_path, monkeypatch, capsys):
    _lossy(monkeypatch, kept=4, launches=5)
    env = {"TPU_PROFILE_DIR": str(tmp_path), "TPU_PROFILE_STEPS": "2"}
    for step in range(3):
        with profiling.maybe_trace(step, environ=env):
            torch.ones(64).add_(1)
    err = capsys.readouterr().err
    path = profiling.trace_path(str(tmp_path))
    assert re.findall(r"maybe_trace: (.*): (\d+) launch calls, (\d+) device records lost",
                      err) == [(path, "5", "1")]
    assert os.path.exists(path) and profiling._active is None


def test_engine_profile_record_shows_the_loss(monkeypatch):
    """Through the engine: the ProfileStore run and the perf snapshot's
    ``last_error`` carry the loss (what ``POST /engine/profile``'s caller
    reads back from ``/engine/perf``)."""
    from kubeflow_tpu_torch.serving.engine import model as TM
    from kubeflow_tpu_torch.serving.engine.engine import Engine, EngineConfig

    _lossy(monkeypatch)
    cfg = TM.DecoderConfig(vocab_size=64, d_model=32, n_layers=1, n_heads=2, n_kv_heads=1,
                           d_ff=64)
    params = TM.init(cfg, "cpu", seed=0)
    eng = Engine(params, cfg, EngineConfig(max_slots=2, num_pages=16, page_size=8,
                                           max_pages_per_slot=4), device="cpu")
    eng.start()
    try:
        eng.trace_n_ticks(2)
        eng.generate_async([1, 2, 3], 6).result(timeout=120)
        deadline = time.monotonic() + 60
        while eng.profiler_active and time.monotonic() < deadline:
            time.sleep(0.01)
        prof = eng.perf_snapshot()["profiler"]
    finally:
        eng.stop()
    run = prof["runs"][-1]
    assert prof["captures"] == 0 and "lost 3 of 5" in prof["last_error"]
    assert run["state"] == "error" and run["error"] == prof["last_error"]
    assert (run["launch_calls"], run["lost_records"]) == (5, 3)


def test_cpu_captures_report_zero_and_zero(tmp_path, capsys):
    a = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 64), dtype=np.float32))
    cap = profiling.Capture(span=SPAN).start()
    with torch.profiler.record_function(SPAN):
        (a @ a).relu().sum()
    cap.stop()
    assert (cap.launch_calls, cap.lost_records, cap.error, cap.records) == (0, 0, None, [])

    tp = TickProfiler()
    seen = []
    tp.on_complete = lambda err, ctx: seen.append(err)
    tp.request(1, str(tmp_path / "tick"))
    tp.on_tick_start(0)
    a @ a
    tp.on_tick_end(0, True)
    assert (tp.captures, tp.last_error, seen) == (1, None, [None])
    assert (tp.launch_calls, tp.lost_records) == (0, 0)

    env = {"TPU_PROFILE_DIR": str(tmp_path / "trace"), "TPU_PROFILE_STEPS": "1"}
    with profiling.maybe_trace(0, environ=env):
        a @ a
    assert capsys.readouterr().err.strip().endswith("0 launch calls, 0 device records lost")
