"""The port's profiler captures on the card keep a device record for every
launch they bracket.

Many windows in one process, each around one paged decode launch
(Llama-3-8B's 32/8 heads at head_dim 128), one flash forward (BERT-base,
ragged keys) and one cuBLAS GEMM (``profiler_probe.window_work``), opened
in turn through each of the port's three capture sites: the serving
engine's ``TickProfiler``, the training loop's ``maybe_trace`` and
``chip_smoke.py``'s ``profile_window``, with GEMMs keeping the card busy
between windows.  Every window counts its launch calls and must lose none
of their records.  Opened as plain ``torch.profiler`` sessions, without
the primer and lead-in of the port's ``parallel.profiling.Capture``, one
or two windows in a hundred lost some or all of them
(``profiler_probe.py``).

Every test here is marked ``cuda`` and skips without an NVIDIA GPU.  The
file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_profiler_cuda.py -s
"""

import json
import re

import pytest
import torch

WINDOWS = 150
GAP_S = 0.1
SITES = ("tick", "trace", "window")


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a profiler capture of device records")
    return torch.device("cuda", 0)


def _tick(work, trace_dir):
    from kubeflow_tpu_torch.serving.engine.telemetry import TickProfiler

    tp = TickProfiler(sync=torch.cuda.synchronize)
    tp.request(1, trace_dir)
    tp.on_tick_start(0)
    work()
    tp.on_tick_end(0, True)
    assert tp.last_trace is not None
    assert (tp.captures == 1) == (tp.lost_records == 0) == (tp.last_error is None)
    return tp.launch_calls, tp.lost_records


def _trace(work, trace_dir, capsys):
    from kubeflow_tpu_torch.parallel import profiling

    capsys.readouterr()
    with profiling.maybe_trace(0, {"TPU_PROFILE_DIR": trace_dir, "TPU_PROFILE_STEPS": "1"}):
        work()
    line = capsys.readouterr().err
    m = re.search(r"maybe_trace: .*: (\d+) launch calls, (\d+) device records lost", line)
    assert m, line
    return int(m.group(1)), int(m.group(2))


def _window(work):
    import chip_smoke

    with chip_smoke.profile_window() as cap:
        work()
        torch.cuda.synchronize()
    return cap.launch_calls, cap.lost_records


@pytest.mark.cuda
def test_every_capture_site_keeps_every_device_record(card, tmp_path, capsys):
    from profiler_probe import window_work

    work, filler = window_work(card)
    work()
    torch.cuda.synchronize()
    rows = []
    for i in range(WINDOWS):
        site = SITES[i % len(SITES)]
        filler(GAP_S)
        d = str(tmp_path / site)
        calls, lost = (_tick(work, d) if site == "tick" else
                       _trace(work, d, capsys) if site == "trace" else _window(work))
        rows.append((site, calls, lost))
    with capsys.disabled():
        print(json.dumps({"profiler_windows": {
            "windows": len(rows), "launch_calls": sum(r[1] for r in rows),
            "lost_by_index": [r[2] for r in rows]}}))
    # the paged, flash and GEMM launches at least, in every window
    assert all(calls >= 3 for _, calls, _ in rows), rows
    assert [lost for _, _, lost in rows] == [0] * WINDOWS, rows


@pytest.mark.cuda
def test_capture_counts_the_launches_it_brackets(card):
    """Five elementwise launches inside a capture's span, one outside it:
    five launch calls, five kernel records, none lost."""
    from kubeflow_tpu_torch.parallel.profiling import Capture

    x = torch.zeros(1 << 20, device=card)
    x.add_(1)
    cap = Capture(span="measured").start()
    x.mul_(2)
    with torch.profiler.record_function("measured"):
        for _ in range(5):
            x.add_(1)
    cap.stop()
    assert (cap.launch_calls, cap.lost_records, cap.error) == (5, 0, None)
    assert len(cap.records) == 5
    assert all(t1 >= t0 for _, t0, t1 in cap.records)
