"""Finding a cell's pieces by name.

Everything that belongs to one configuration, one traffic mix, one cell or
one metric sits in files of its own under this folder, found by the name
the cell gives it, so a later change adds files and edits none:

* ``configs/<config>.json``: the model's published sizes, its source, what
  was cut (``reduced``), the deployment's settings (``assumed``), the
  driver that runs it (``train``), and its ``trainer`` block;
* ``traffic/<mix>.json``: the parameters the one generator
  (``generator.py``) reads: batch, lengths, masking, steps;
* ``workloads/<cell>.json``: the cell's configuration, mix, chips, the
  metrics it reports, the limits of its correctness comparison and why it
  exists;
* ``metrics/<metric>.py``, else ``metrics/<prefix>.py`` for the part of the
  name before its first dot (``idle_share.train`` -> ``idle_share.py``): a
  reader ``read(run) -> float | None`` and its ``UNIT``;
* ``drivers/<driver>.py``: the code that runs a kind of model (``run``).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re

ROOT = os.path.dirname(os.path.abspath(__file__))
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _check(name: str) -> str:
    if not isinstance(name, str) or not _NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def _json(kind: str, name: str) -> dict:
    path = os.path.join(ROOT, kind, _check(name) + ".json")
    if not os.path.exists(path):
        raise KeyError(f"no {kind[:-1]} named {name!r} ({os.path.relpath(path, ROOT)})")
    with open(path) as f:
        return json.load(f)


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def workload(name: str) -> dict:
    return _json("workloads", name)


def names(kind: str) -> list:
    """Every name of ``kind`` (``configs``, ``traffic``, ``workloads``)."""
    return sorted(f[:-5] for f in os.listdir(os.path.join(ROOT, kind)) if f.endswith(".json"))


def reader(metric: str):
    """The reader module of ``metric``: ``metrics/<metric>.py``, else the
    module named by the part before the first dot."""
    _check(metric)
    for stem in (metric, metric.split(".", 1)[0]):
        path = os.path.join(ROOT, "metrics", stem + ".py")
        if os.path.exists(path):
            key = "portbench.metrics." + re.sub(r"[^A-Za-z0-9_]", "_", stem)
            spec = importlib.util.spec_from_file_location(key, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise KeyError(f"no reader for metric {metric!r} under metrics/")


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{_check(name)}")


def cell(name: str) -> dict:
    """A cell with its configuration and mix resolved:
    ``{"name", "workload", "config", "traffic", "readers"}``."""
    w = workload(name)
    metrics = list(w["end_to_end"]) + list(w["per_layer"])
    return {"name": name, "workload": w, "config": config(w["config"]),
            "traffic": traffic(w["traffic"]),
            "readers": {m: reader(m) for m in metrics}}
