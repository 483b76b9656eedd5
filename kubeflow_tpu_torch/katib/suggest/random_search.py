"""Random search (upstream: katib random suggestion service).

A copy of ``kubeflow_tpu/katib/suggest/random_search.py``
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import numpy as np

from . import register
from .space import param_specs, sample_one, settings_dict


@register("random")
class RandomSuggester:
    def suggest(self, experiment, trials, count):
        raw = settings_dict(experiment).get("random_state")
        # fold in the number of existing trials so repeated calls differ
        # (0 is a valid, deterministic seed — only absence means entropy)
        rng = np.random.default_rng(None if raw is None else int(raw) + len(trials))
        return [
            {p["name"]: sample_one(rng, p) for p in param_specs(experiment)}
            for _ in range(count)
        ]
