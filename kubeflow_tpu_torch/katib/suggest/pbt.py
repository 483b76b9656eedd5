"""Population Based Training (upstream: katib `pbt` suggestion service).

A copy of ``kubeflow_tpu/katib/suggest/pbt.py``
(the port imports nothing of the JAX package).

Exploit/explore over a population: each new suggestion picks a parent from
the top quantile of finished trials and perturbs it — numeric parameters are
scaled by a random factor around 1 (clipped to the feasible space), while
categorical parameters resample with a small probability.  The population
walks toward good regions while keeping diversity, which beats independent
sampling when the objective drifts with training time.

Deviation from upstream, documented: Katib's PBT service also rewires trial
CHECKPOINT lineage (children warm-start from the parent's weights via
annotations). Here suggestions carry hyperparameters only — the platform's
checkpoint auto-resume (`spec.checkpoint`) is per-trial; weight inheritance
across trials is left to the workload.
"""

from __future__ import annotations

import numpy as np

from . import register
from .space import observed, param_specs, sample_one, settings_dict


@register("pbt")
class PBTSuggester:
    def suggest(self, experiment, trials, count):
        specs = param_specs(experiment)
        settings = settings_dict(experiment)
        quantile = float(settings.get("truncation_threshold", 0.25))
        resample_p = float(settings.get("resample_probability", 0.25))
        raw = settings.get("random_state")
        rng = np.random.default_rng(None if raw is None else int(raw) + len(trials))

        _, ys, raw_assignments = observed(experiment, trials)
        if len(ys) == 0:  # first generation: pure exploration
            return [{p["name"]: sample_one(rng, p) for p in specs}
                    for _ in range(count)]

        order = np.argsort(ys)[::-1]  # best first (observed() negates minimize)
        n_top = max(1, int(np.ceil(len(ys) * quantile)))
        top = [raw_assignments[i] for i in order[:n_top]]

        out = []
        for _ in range(count):
            parent = top[int(rng.integers(len(top)))]
            child = {}
            for p in specs:
                name = p["name"]
                if p["parameterType"] in ("double", "int"):
                    fs = p["feasibleSpace"]
                    lo, hi = float(fs["min"]), float(fs["max"])
                    # classic PBT jitter: scale the VALUE by ~[0.8, 1.2] (a
                    # parent at the lower bound still explores upward), plus
                    # a small absolute kick so exact-zero values can move
                    v = float(parent[name]) * float(rng.uniform(0.8, 1.2))
                    v += float(rng.normal(0, 0.02)) * (hi - lo)
                    v = min(max(v, lo), hi)
                    child[name] = int(round(v)) if p["parameterType"] == "int" else v
                else:
                    child[name] = (sample_one(rng, p)
                                   if rng.random() < resample_p else parent[name])
            out.append(child)
        return out
