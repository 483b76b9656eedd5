"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``workloads/<cell>.json``) names
its configuration, traffic mix and metrics; its driver sets the program up
from the seed, measures for ``--seconds``, checks what the timed path
produced against the plain reference, and the last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number compared beside its limit (also the last lines of
standard error).

It exits non-zero with no result when there is no CUDA card, fewer cards
than the cell asks for, no port to run (a checkout of the benchmark
alone), a capture that lost device records three times over, or when JAX,
Flax or the JAX package was loaded in the process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# a library the port uses must not load JAX behind its back
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

EXIT_NO_CARD, EXIT_TRACE, EXIT_BLOCKED = 2, 3, 4


def _metrics(run, names: list) -> dict:
    out = {}
    for name in names:
        mod = run.ctx.cell["readers"][name]
        v = mod.read(run)
        if v is not None and math.isfinite(v):
            out[name] = {"value": v, "unit": mod.UNIT}
    return out


def result(ctx, res: dict, smi_before: dict, smi_after: dict) -> dict:
    """The contract's result object from a driver's outcome."""
    import torch

    from . import arith, check

    run = res["run"]
    kind = torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda" else "cpu"
    run.peak = arith.peaks(kind)
    w = ctx.workload
    names = w["per_layer"] if ctx.trace else w["end_to_end"]
    device = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu", "kind": kind,
              "count": w["chips"], "memory_peak_bytes": res["memory_peak_bytes"]}
    for key in ("power_limit_w", "clocks_sm_mhz"):
        if key in smi_before:
            device[key] = smi_before[key]
            device[key + "_after"] = smi_after.get(key)
    out = {"correct": check.within(res["checks"]), "attempted": res["attempted"],
           "failed": res["failed"], "metrics": _metrics(run, names), "device": device}
    if ctx.trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    if res["failed"]:
        res["checks"]["failed_requests"] = {"value": res["failed"], "limit": 0}
        out["correct"] = False
    out["checks"] = res["checks"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import spec
    from .runtime import Context, blocked_modules, log, smi

    cell = spec.cell(args.workload)
    import torch

    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return EXIT_NO_CARD
    import kubeflow_tpu_torch  # noqa: F401 — no port, no run

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    ctx = Context(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                  device=device, t_start=T_START)
    before = smi(0)
    res = spec.driver(cell["config"]["driver"]).run(ctx)
    after = smi(0)
    if not res["trace_ok"]:
        log("every capture lost device records: no per-layer number from a broken window")
        return EXIT_TRACE
    out = result(ctx, res, before, after)
    blocked = blocked_modules()
    if blocked:
        log(f"modules loaded that the port must not use: {', '.join(blocked)}")
        return EXIT_BLOCKED
    d = out["device"]
    print(f"device: {d['kind']} x{d['count']}, power limit {d.get('power_limit_w')} W, "
          f"SM clock {d.get('clocks_sm_mhz')} MHz before and {d.get('clocks_sm_mhz_after')} after")
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
