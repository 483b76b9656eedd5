"""The controls of a cell's correctness check, read on the card at the
cell's own size: for each seed, one run of the cell (with a short window
at its own load) whose check also reads the controls, the reference in a
lower precision put in the program's place (and, for training, the fault
of half the batch left out).  The limits in ``workloads/<cell>.json`` lie
between the program's readings and these.

    python3 -m portbench.control --workload <cell> --seeds 11,12,13 --seconds 10

One JSON line a seed on standard output: the program's ``checks`` and the
``controls``.  Not part of a benchmark run.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)

    import torch

    from . import spec
    from .runtime import Context

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = Context(cell=cell, seed=seed, seconds=args.seconds, trace=False, device=device,
                      t_start=time.perf_counter(), control=True)
        res = spec.driver(cell["config"]["driver"]).run(ctx)
        print(json.dumps({"workload": args.workload, "seed": seed, "checks": res["checks"],
                          "controls": res["controls"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
