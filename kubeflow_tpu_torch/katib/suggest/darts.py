"""DARTS suggester: one trial carrying the differentiable-search settings.

A copy of ``kubeflow_tpu/katib/suggest/darts.py``
(the port imports nothing of the JAX package).

Upstream analogue (UNVERIFIED, SURVEY.md §2a suggestion-services row): unlike
ENAS (controller lives in the suggestion service — see enas.py), Katib's
DARTS runs the whole search INSIDE a single trial container; the suggestion
service emits exactly one suggestion whose parameters are the algorithm
settings the trial workload consumes (num layers, search steps, seed).  The
matching trial workload here is ``kubeflow_tpu_torch/examples/darts_worker.py``.
"""

from __future__ import annotations

import numpy as np

from . import register
from .space import param_specs, sample_one, settings_dict


@register("darts")
class DartsSuggester:
    def suggest(self, experiment, trials, count):
        settings = settings_dict(experiment)
        base = {
            "num_layers": str(settings.get("num_layers", 4)),
            "search_steps": str(settings.get("search_steps", 150)),
        }
        seed0 = int(settings.get("random_state", 0))
        rng = np.random.default_rng(seed0 + len(trials))
        out = []
        for i in range(count):
            arch = dict(base)
            arch["seed"] = str(seed0 + len(trials) + i)
            # any declared experiment parameters (e.g. lr) ride along
            for p in param_specs(experiment):
                if p["name"] not in arch:
                    arch[p["name"]] = sample_one(rng, p)
            out.append(arch)
        return out
