"""What every driver shares: the run's context, the card's readings and
the record the metric readers read."""

from __future__ import annotations

import dataclasses
import shutil
import subprocess
import sys
from typing import Any, Optional

# top-level module names that must not be loaded in the process that
# prints a result: JAX, its compiler, Flax, and the JAX package this port
# was made from (compared whole: the port's name begins with it)
BLOCKED = ("jax", "jaxlib", "flax", "kubeflow_tpu")


def blocked_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(BLOCKED))


def log(*parts) -> None:
    print("[portbench]", *parts, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Context:
    cell: dict            # spec.cell(name)
    seed: int
    seconds: float
    trace: bool
    device: Any           # torch.device
    t_start: float        # perf_counter at process start
    control: bool = False # also read the controls (control.py), never in a benchmark run

    @property
    def workload(self) -> dict:
        return self.cell["workload"]

    @property
    def config(self) -> dict:
        return self.cell["config"]

    @property
    def traffic(self) -> dict:
        return self.cell["traffic"]


@dataclasses.dataclass
class Run:
    """What a run leaves for the metric readers.  Host-clock times are
    ``time.perf_counter`` seconds; ``t0``/``t1`` bound the measured window."""
    ctx: Context
    setup_s: float
    t0: float
    t1: float
    peak: Optional[dict] = None         # arith.peaks(...) of the card, None off a known card
    trace: Optional[Any] = None         # trace.TraceView of the traced run's capture
    model: dict = dataclasses.field(default_factory=dict)
    steps: int = 0
    batch: int = 0
    seq_len: int = 0
    predictions: int = 0

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0


def smi(index: int = 0) -> dict:
    """The card's power limit and SM clock from ``nvidia-smi`` (empty
    where there is none)."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return {}
    fields = ("power.limit", "clocks.sm")
    try:
        r = subprocess.run([exe, f"--query-gpu={','.join(fields)}",
                            "--format=csv,noheader,nounits", "-i", str(index)],
                           capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return {}
    vals = [v.strip() for v in r.stdout.strip().split(",")]
    if r.returncode != 0 or len(vals) != len(fields):
        return {}
    out = {}
    for key, v in zip(("power_limit_w", "clocks_sm_mhz"), vals):
        try:
            out[key] = float(v)
        except ValueError:
            out[key] = v
    return out
