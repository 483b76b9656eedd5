"""Grid search (upstream: katib grid suggestion service).

A copy of ``kubeflow_tpu/katib/suggest/grid.py``
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import itertools

import numpy as np

from . import register
from .space import param_specs, settings_dict


def _axis(p: dict, default_steps: int) -> list:
    fs = p["feasibleSpace"]
    t = p["parameterType"]
    if t in ("categorical", "discrete"):
        return list(fs["list"])
    lo, hi = float(fs["min"]), float(fs["max"])
    if t == "int":
        step = int(float(fs.get("step", 1)) or 1)
        return list(range(int(lo), int(hi) + 1, step))
    if "step" in fs:
        n = int(round((hi - lo) / float(fs["step"]))) + 1
        return [lo + i * float(fs["step"]) for i in range(n)]
    return list(np.linspace(lo, hi, default_steps))


@register("grid")
class GridSuggester:
    def suggest(self, experiment, trials, count):
        default_steps = int(settings_dict(experiment).get("default_steps", 4))
        axes = [_axis(p, default_steps) for p in param_specs(experiment)]
        names = [p["name"] for p in param_specs(experiment)]
        full = [dict(zip(names, combo)) for combo in itertools.product(*axes)]
        seen = len(trials)  # grid is deterministic: skip already-issued points
        return full[seen : seen + count]
