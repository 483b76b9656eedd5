"""Shared search-space utilities for suggestion algorithms.

A copy of ``kubeflow_tpu/katib/suggest/space.py``
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import numpy as np

from ...core.api import Obj


def param_specs(experiment: Obj) -> list[dict]:
    return experiment["spec"]["parameters"]


def sample_one(rng: np.random.Generator, p: dict):
    fs = p["feasibleSpace"]
    t = p["parameterType"]
    if t == "double":
        return float(rng.uniform(float(fs["min"]), float(fs["max"])))
    if t == "int":
        return int(rng.integers(int(fs["min"]), int(fs["max"]) + 1))
    return rng.choice(list(fs["list"]))


def to_unit(p: dict, value) -> float:
    """Map a parameter value into [0, 1] for surrogate models."""
    fs = p["feasibleSpace"]
    t = p["parameterType"]
    if t in ("double", "int"):
        lo, hi = float(fs["min"]), float(fs["max"])
        return (float(value) - lo) / max(hi - lo, 1e-12)
    values = list(fs["list"])
    return values.index(value) / max(len(values) - 1, 1)


def from_unit(p: dict, u: float):
    fs = p["feasibleSpace"]
    t = p["parameterType"]
    u = float(np.clip(u, 0.0, 1.0))
    if t == "double":
        lo, hi = float(fs["min"]), float(fs["max"])
        return lo + u * (hi - lo)
    if t == "int":
        lo, hi = int(fs["min"]), int(fs["max"])
        return int(round(lo + u * (hi - lo)))
    values = list(fs["list"])
    return values[int(round(u * (len(values) - 1)))]


def observed(experiment: Obj, trials: list[Obj]) -> tuple[np.ndarray, np.ndarray, list[dict]]:
    """(X in unit cube, y objective values, raw assignment dicts) of succeeded
    trials. y is negated for 'minimize' so larger is always better."""
    specs = param_specs(experiment)
    metric = experiment["spec"]["objective"]["objectiveMetricName"]
    sign = 1.0 if experiment["spec"]["objective"]["type"] == "maximize" else -1.0
    xs, ys, raw = [], [], []
    for t in trials:
        obs = t.get("status", {}).get("observation", {})
        val = None
        for m in obs.get("metrics", []):
            if m["name"] == metric and m.get("latest") is not None:
                val = float(m["latest"])
        if val is None:
            continue
        assign = {a["name"]: a["value"] for a in t["spec"].get("parameterAssignments", [])}
        if not all(p["name"] in assign for p in specs):
            continue
        xs.append([to_unit(p, assign[p["name"]]) for p in specs])
        ys.append(sign * val)
        raw.append(assign)
    if not xs:
        return np.zeros((0, len(specs))), np.zeros((0,)), []
    return np.asarray(xs, float), np.asarray(ys, float), raw


def settings_dict(experiment: Obj) -> dict:
    return {
        s["name"]: s["value"]
        for s in experiment["spec"].get("algorithm", {}).get("algorithmSettings", [])
    }
