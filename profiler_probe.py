"""Probe torch.profiler windows for lost device records on the card.

One process opens many profiler windows, each around the same work: one
paged decode launch (Llama-3-8B's 32/8 heads at head_dim 128, as phase 3
of ``chip_smoke.py``), one flash forward (BERT-base, ragged keys) and one
cuBLAS GEMM.  Between windows it keeps the card busy with GEMMs for
``--gap-s`` seconds, so the windows span a process's life.  Windows are
opened the way the port's three capture sites open them, in turn:

- ``tick``: ``TickProfiler``'s start/stop around the work, a synchronize
  before each, the Chrome trace written;
- ``trace``: ``maybe_trace``'s, the work inside a ``train#step_num=0#``
  annotation, the Chrome trace written;
- ``window``: ``chip_smoke.py``'s ``profile_window`` as it was before the
  port's ``Capture``, a 50 ms lead-in and the work inside a
  ``record_function`` span.

These are plain ``torch.profiler`` sessions, opened as the sites opened
them before the port's ``parallel.profiling.Capture``.  The ``port``
configuration opens its windows through the sites themselves
(``TickProfiler``, ``maybe_trace``, ``chip_smoke.profile_window``).

Each window's launch calls are tied to device records by correlation id
(``kubeflow_tpu_torch.parallel.profiling.window_records``); a call without
a record is a lost record.  For each window the probe also reports the
kernel, copy and fill records whose correlation id matches no launch call
in the window (``orphans``: a record filed under another id), where in the
window the lost calls were made, and the least gap between a launch call's
host start and its record's device start (``lead_us``; negative when the
two clocks disagree).  Before the first window and after the last it
times a run of small launches (``launch_us``, host microseconds a launch):
what an idle profiler subscription costs the program.

``--matrix`` runs each configuration in ``CONFIGS`` in a process of its
own (an environment setting of kineto's, a lead-out before ``stop``, the
port's sites with and without the capture's lead-in, or long windows of
100 flash calls through the port's ``Capture``), one after the other, and
writes every window's counts to ``--out``; each keeps its stderr beside it,
kineto's log where it is verbose, with kineto's own per-window record
counts (records out of the capture's range among them).  ``--phases`` runs
``chip_smoke.py``'s phase 7, 8 and 14 windows in one process, each
diagnosed, then phase 7's again with and without the lead-in.

    python3 profiler_probe.py --matrix [--configs NAME ...] [--windows N] [--gap-s S] --out probe.json
    KINETO_LOG_LEVEL=0 python3 profiler_probe.py --phases > phases.json 2> phases.log

Needs one card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

# (name, environment added to the child's, seconds slept after the last
# synchronize and before stop)
CONFIGS = [
    ("default", {}, 0.0),
    ("kineto_log", {"KINETO_LOG_LEVEL": "0"}, 0.0),
    ("teardown_off", {"TEARDOWN_CUPTI": "0"}, 0.0),
    ("lead_out", {}, 0.05),
    ("port", {}, 0.0),
    # the port's sites with the capture's primer but no lead-in
    ("port_no_lead_in", {}, 0.0),
    # long windows through the port's Capture: a burst of phase 7's 100
    # calls (an L2 flush, then a flash forward), kineto's log kept
    ("burst", {"KINETO_LOG_LEVEL": "0"}, 0.0),
    ("burst_lead_out", {"KINETO_LOG_LEVEL": "0"}, 0.05),
]
OPENERS = ("tick", "trace", "window")
# kineto log lines counted per configuration
LOG_PATTERNS = {"dropped": r"[Dd]ropped", "teardown": r"[Tt]eardown|cuptiFinalize",
                "out_of_range_windows": r"Out-of-range = [1-9]",
                "out_of_order_windows": r"CPU GPU out-of-order = [1-9]"}
MEASURED = "profiler_probe.measured"


def window_work(dev):
    """The window's work: a closure making one paged, one flash and one
    GEMM launch, and the filler run between windows."""
    import importlib

    import torch

    from kubeflow_tpu_torch.serving.engine import paged_attention as PA

    FA = importlib.import_module("kubeflow_tpu_torch.ops.flash_attention")
    g = torch.Generator().manual_seed(0)
    B, Hq, Hkv, hd, ps, pages, mp = 8, 32, 8, 128, 32, 512, 64
    q = torch.randn((B, 1, Hq, hd), generator=g).to(dev, torch.bfloat16)
    kp, vp = (torch.randn((pages, Hkv, ps, hd), generator=g).to(dev, torch.bfloat16)
              for _ in range(2))
    table = torch.randint(1, pages, (B, mp), generator=g, dtype=torch.int32).to(dev)
    lens = torch.randint(ps, mp * ps, (B,), generator=g, dtype=torch.int32).to(dev)
    fq, fk, fv = (torch.randn((32, 512, 12, 64), generator=g).to(dev, torch.bfloat16)
                  for _ in range(3))
    valid = torch.randint(128, 513, (32,), generator=g)
    mask = (torch.arange(512)[None, :] < valid[:, None]).float().to(dev)
    a, b = (torch.randn((4096, 4096), generator=g).to(dev, torch.bfloat16) for _ in range(2))

    def work():
        PA.paged_attention(q, kp, vp, table, lens, ps)
        with torch.no_grad():
            FA.flash_attention(fq, fk, fv, kv_mask=mask)
        return a @ b

    def filler(seconds):
        t_end = time.perf_counter() + seconds
        while time.perf_counter() < t_end:
            for _ in range(8):
                a @ b
            torch.cuda.synchronize()

    return work, filler


def _port_window(opener, work, trace_dir):
    """One window through the port's own capture site ``opener``: its
    (launch calls, lost records)."""
    import io

    import chip_smoke
    from kubeflow_tpu_torch.parallel import profiling
    from kubeflow_tpu_torch.serving.engine.telemetry import TickProfiler

    import torch

    if opener == "tick":
        tp = TickProfiler(sync=torch.cuda.synchronize)
        tp.request(1, trace_dir)
        tp.on_tick_start(0)
        work()
        tp.on_tick_end(0, True)
        return tp.launch_calls, tp.lost_records
    if opener == "trace":
        err, sys.stderr = sys.stderr, io.StringIO()
        try:
            with profiling.maybe_trace(0, {"TPU_PROFILE_DIR": trace_dir,
                                           "TPU_PROFILE_STEPS": "1"}):
                work()
            line = sys.stderr.getvalue()
        finally:
            sys.stderr = err
        m = re.search(r"(\d+) launch calls, (\d+) device records lost", line)
        return int(m.group(1)), int(m.group(2))
    with chip_smoke.profile_window() as cap:
        work()
        torch.cuda.synchronize()
    return cap.launch_calls, cap.lost_records


def _burst_window(work, flush, lead_out_s):
    """A window through the port's ``Capture`` around 100 calls of an L2
    flush and a flash forward (phase 7's ``profiled_ms``), ``lead_out_s``
    slept after the last synchronize and before ``stop``."""
    import importlib

    import torch

    from kubeflow_tpu_torch.parallel.profiling import Capture

    FA = importlib.import_module("kubeflow_tpu_torch.ops.flash_attention")
    g = torch.Generator().manual_seed(1)
    dev = flush.device
    q, k, v = (torch.randn((32 * 12, 512, 64), generator=g).to(dev, torch.bfloat16)
               for _ in range(3))

    def sync():
        torch.cuda.synchronize()
        time.sleep(lead_out_s)

    cap = Capture(sync=sync, span=MEASURED, acc_events=True).start()
    with torch.profiler.record_function(MEASURED):
        for _ in range(100):
            flush.zero_()
            FA._flash_fwd(q, k, v, None, 0.125, False, 128, 128, 12)
        torch.cuda.synchronize()
    cap.stop()
    return {**_diagnose(cap.prof, MEASURED), "capture_lost": cap.lost_records}


def _window(opener, work, trace_dir, lead_out_s):
    """One plain profiler window opened as ``opener`` opened it; the
    profiler and the record_function span its launches are counted in
    (None: all)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if opener == "window":
        with profile(activities=acts, acc_events=True) as prof:
            time.sleep(0.05)
            with record_function(MEASURED):
                work()
                torch.cuda.synchronize()
            time.sleep(lead_out_s)
        return prof, MEASURED
    prof = profile(activities=acts)
    torch.cuda.synchronize()
    prof.start()
    if opener == "trace":
        with record_function("train#step_num=0#"):
            work()
    else:
        work()
    torch.cuda.synchronize()
    time.sleep(lead_out_s)
    prof.stop()
    prof.export_chrome_trace(os.path.join(trace_dir, f"{opener}.json"))
    return prof, None


def _diagnose(prof, span):
    """The window's counts: launch calls, lost, orphans, where the lost
    calls lie, and the least launch-to-kernel lead."""
    import torch

    from kubeflow_tpu_torch.parallel.profiling import LAUNCH_CALLS, window_records

    recs, calls, lost = window_records(prof, span)
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ev = list(prof.profiler.kineto_results.events())
    sp = next(((e.start_ns(), e.end_ns()) for e in ev
               if span is not None and e.device_type() == cpu and e.name() == span), None)
    launches = sorted(((e.start_ns(), e.correlation_id(), e.name()) for e in ev
                       if e.device_type() == cpu and e.name().startswith(LAUNCH_CALLS)
                       and (sp is None or sp[0] <= e.start_ns() <= sp[1])))
    dev = {e.correlation_id(): (e.name(), e.start_ns()) for e in ev if e.device_type() == cuda
           and e.name() not in (span, "train#step_num=0#")
           and not getattr(e, "is_user_annotation", lambda: False)()}
    ids = {c for _, c, _ in launches}
    t0 = launches[0][0] if launches else 0
    t1 = launches[-1][0] if launches else 0
    lost_at = [{"call": n, "order": i, "ms_after_first": (t - t0) / 1e6,
                "ms_before_last": (t1 - t) / 1e6}
               for i, (t, c, n) in enumerate(launches) if c not in dev]
    leads = [(dev[c][1] - t) / 1e3 for t, c, _ in launches if c in dev]
    orphans = [n for c, (n, _) in dev.items() if c not in ids]
    by_call: dict = {}
    for a in lost_at:
        by_call[a["call"]] = by_call.get(a["call"], 0) + 1
    # where the capture's own start lies: kineto drops a record stamped
    # before it (or ending after its stop) as out of range
    ts = prof.profiler.kineto_results.trace_start_ns()
    ms = lambda t: None if t is None else (t - ts) / 1e6  # noqa: E731
    first_rec = min((t for _, t in dev.values()), default=None)
    lost_t = [t for t, c, _ in launches if c not in dev]
    clock = {"span_start_ms": ms(sp[0]) if sp else None,
             "first_launch_ms": ms(t0) if launches else None,
             "first_record_ms": ms(first_rec), "last_lost_launch_ms": ms(max(lost_t, default=None)),
             "first_kept_launch_ms": ms(min((t for t, c, _ in launches if c in dev),
                                           default=None))}
    return {"calls": calls, "lost": lost, "device_records": len(dev), "orphans": len(orphans),
            "orphan_names": sorted(set(o[:40] for o in orphans))[:6], "lost_at": lost_at[:6],
            "lost_last": lost_at[-3:], "lost_by_call": by_call, "clock": clock,
            "lead_us": min(leads) if leads else None,
            "kernels": len(recs)}


def child(args) -> int:
    import torch

    if not torch.cuda.is_available():
        print("profiler_probe: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    work, filler = window_work(dev)
    work()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    torch.cuda.synchronize()
    launch_us = [_launch_us(dev)]
    if args.config == "port_no_lead_in":
        from kubeflow_tpu_torch.parallel import profiling

        profiling.LEAD_IN_S = 0.0
    trace_dir = os.path.join(args.trace_dir, args.config)
    os.makedirs(trace_dir, exist_ok=True)
    t_start = time.perf_counter()
    rows = []
    for i in range(args.windows):
        opener = OPENERS[i % len(OPENERS)]
        filler(args.gap_s)
        print(f"PROBE-WINDOW {i} {opener} open", file=sys.stderr, flush=True)
        try:
            if args.config.startswith("burst"):
                row = _burst_window(work, flush, args.lead_out_s)
            elif args.config.startswith("port"):
                calls, lost = _port_window(opener, work, trace_dir)
                row = {"calls": calls, "lost": lost}
            else:
                prof, span = _window(opener, work, trace_dir, args.lead_out_s)
                row = _diagnose(prof, span)
        except Exception as e:  # noqa: BLE001 — a failing window is a finding
            row = {"error": f"{type(e).__name__}: {e}"}
        print(f"PROBE-WINDOW {i} {opener} closed lost={row.get('lost')}", file=sys.stderr,
              flush=True)
        rows.append({"i": i, "opener": opener, "t_s": round(time.perf_counter() - t_start, 3),
                     **row})
    launch_us.append(_launch_us(dev))
    print(json.dumps({"config": args.config, "launch_us": launch_us, "windows": rows}))
    return 0


def _launch_us(dev, n: int = 2000) -> float:
    """Host microseconds a small kernel launch takes, over ``n`` launches."""
    import torch

    x = torch.zeros(1024, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def summary(rows) -> dict:
    ok = [r for r in rows if "error" not in r]
    by = {}
    for o in OPENERS:
        rs = [r for r in ok if r["opener"] == o]
        by[o] = {"windows": len(rs), "lossy": sum(r["lost"] > 0 for r in rs),
                 "lost": sum(r["lost"] for r in rs), "calls": sum(r["calls"] for r in rs)}
    leads = [r["lead_us"] for r in ok if r.get("lead_us") is not None]
    return {"windows": len(rows), "errors": len(rows) - len(ok),
            "lossy": sum(r["lost"] > 0 for r in ok), "lost": sum(r["lost"] for r in ok),
            "calls": sum(r["calls"] for r in ok), "orphans": sum(r.get("orphans", 0) for r in ok),
            "lost_by_index": [r["lost"] if "lost" in r else None for r in rows],
            "lead_us_min": min(leads) if leads else None, "by_opener": by}


def matrix(args) -> int:
    out = {"torch": None, "configs": {}}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    only = set(args.configs or [c[0] for c in CONFIGS])
    for name, env, lead_out in CONFIGS:
        if name not in only:
            continue
        log = os.path.splitext(args.out)[0] + f".{name}.log"
        cmd = [sys.executable, os.path.abspath(__file__), "--config", name, "--windows",
               str(args.windows), "--gap-s", str(args.gap_s), "--lead-out-s", str(lead_out),
               "--trace-dir", args.trace_dir]
        t0 = time.perf_counter()
        with open(log, "w") as err:
            r = subprocess.run(cmd, env={**os.environ, **env}, stdout=subprocess.PIPE,
                               stderr=err, text=True)
        res = json.loads(r.stdout.strip().splitlines()[-1]) if r.returncode == 0 else {}
        with open(log) as f:
            text = f.read()
        counts = {k: len(re.findall(p, text)) for k, p in LOG_PATTERNS.items()}
        # kineto's own per-window counts, in window order (a verbose log)
        counts["record_counts"] = [
            dict((k.strip(), v.strip()) for k, v in (kv.split("=") for kv in m.split(",")))
            for m in re.findall(r"Record counts: (.*)", text)][:60]
        rows = res.get("windows", [])
        out["configs"][name] = {"env": env, "lead_out_s": lead_out, "rc": r.returncode,
                                "seconds": round(time.perf_counter() - t0, 1),
                                "launch_us": res.get("launch_us"),
                                "log_counts": counts, **summary(rows), "rows": rows}
        print(json.dumps({name: {k: v for k, v in out["configs"][name].items()
                                 if k != "rows"}}), flush=True)
    import torch

    out["torch"] = f"{torch.__version__} cuda {torch.version.cuda}"
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


def phases(args) -> int:
    """``chip_smoke.py``'s windows in one process: phase 7's flash cases,
    phase 8's step and phase 14's remat policies, then phase 7's cases
    again, every window diagnosed as ``_diagnose`` does (lost calls by
    name and place, records under an id no launch call holds, where the
    capture's start lies).  The later flash windows run with the
    capture's lead-in, without it, and with it again."""
    import contextlib

    import numpy as np
    import torch

    import chip_smoke as CS

    if not torch.cuda.is_available():
        print("profiler_probe: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    CS.FA.load_kernel()
    rows, window = [], CS.profile_window
    mode = {"stage": "start"}

    @contextlib.contextmanager
    def diagnosed():
        with window() as cap:
            yield cap
        print(f"PROBE-WINDOW {len(rows)} {mode['stage']} closed lost={cap.lost_records}",
              file=sys.stderr, flush=True)
        rows.append({"i": len(rows), "stage": mode["stage"],
                     "t_s": round(time.perf_counter() - t0, 1), **_diagnose(cap.prof, CS.MEASURED)})

    CS.profile_window = diagnosed
    t0 = time.perf_counter()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def flash(tag):
        mode["stage"] = tag
        rng = np.random.default_rng(0)
        for name, causal, key_mask in (("ragged", False, "ragged"), ("causal", True, None)):
            CS.flash_case(name, torch.bfloat16, CS.FS, causal, key_mask, rng, dev, flush)

    flash("flash_first")
    for tag, fn in (("train", CS.train), ("bert_remat", CS.bert_remat)):
        mode["stage"] = tag
        fn(dev)
    from kubeflow_tpu_torch.parallel import profiling

    for lead_in in (profiling.LEAD_IN_S, 0.0, profiling.LEAD_IN_S):
        profiling.LEAD_IN_S = lead_in
        flash(f"flash_after_lead_in_{lead_in}")
    print(json.dumps({"windows": rows}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--matrix", action="store_true")
    ap.add_argument("--phases", action="store_true",
                    help="chip_smoke.py's flash, train and remat windows, each diagnosed")
    ap.add_argument("--configs", nargs="*")
    ap.add_argument("--config", default="default")
    ap.add_argument("--windows", type=int, default=150)
    ap.add_argument("--gap-s", type=float, default=0.3)
    ap.add_argument("--lead-out-s", type=float, default=0.0)
    ap.add_argument("--trace-dir", default=os.path.join(tempfile.gettempdir(), "profiler_probe"))
    ap.add_argument("--out", default="profiler_probe.json")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.phases:
        return phases(args)
    return matrix(args) if args.matrix else child(args)


if __name__ == "__main__":
    sys.exit(main())
