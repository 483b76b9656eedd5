"""Hyperband-style successive halving (upstream: katib hyperband service).

A copy of ``kubeflow_tpu/katib/suggest/hyperband.py``
(the port imports nothing of the JAX package).

Simplified rung model: the budget parameter (``resource_name``, e.g. epochs)
is assigned per rung; survivors of each rung (top 1/eta by objective) are
re-suggested at eta× budget with the same hyperparameters.
"""

from __future__ import annotations

import math

import numpy as np

from . import register
from .space import observed, param_specs, sample_one, settings_dict


@register("hyperband")
class HyperbandSuggester:
    def suggest(self, experiment, trials, count):
        specs = param_specs(experiment)
        settings = settings_dict(experiment)
        resource = settings.get("resource_name", "epochs")
        eta = float(settings.get("eta", 3))
        min_r = float(settings.get("min_resource", 1))
        max_r = float(settings.get("max_resource", 9))
        rng = np.random.default_rng(int(settings.get("random_state", 0)) + len(trials))

        search_specs = [p for p in specs if p["name"] != resource]
        _, y, raw = observed(experiment, trials)

        def config_key(assign: dict) -> tuple:
            return tuple(sorted((k, str(v)) for k, v in assign.items() if k != resource))

        scores = {(config_key(a), str(a.get(resource, min_r))): yi for yi, a in zip(y, raw)}

        # rung state from ALL issued trials (running ones score -inf), so a
        # promotion issued last round but still running is visible and is
        # never re-issued
        by_rung: dict[float, list[tuple[float, dict]]] = {}
        for t in trials:
            assign = {a["name"]: a["value"] for a in t["spec"].get("parameterAssignments", [])}
            if not assign:
                continue
            r = float(assign.get(resource, min_r))
            s = scores.get((config_key(assign), str(assign.get(resource, min_r))), -np.inf)
            by_rung.setdefault(r, []).append((s, assign))

        out = []
        for _ in range(count):
            promoted = None
            for r in sorted(by_rung, reverse=True):
                nxt = r * eta
                if nxt > max_r:
                    continue
                rung = sorted(by_rung[r], key=lambda t: -t[0])
                # only EVALUATED configs are promotion candidates; keep is
                # computed over evaluated entries so placeholders can't pad it
                evaluated = [(s, a) for s, a in rung if np.isfinite(s)]
                keep = max(1, int(math.floor(len(evaluated) / eta))) if evaluated else 0
                issued_next = {config_key(a) for _, a in by_rung.get(nxt, [])}
                for _, assign in evaluated[:keep]:
                    if config_key(assign) not in issued_next:
                        promoted = {**{k: v for k, v in assign.items() if k != resource},
                                    resource: nxt}
                        by_rung.setdefault(nxt, []).append((-np.inf, promoted))
                        break
                if promoted:
                    break
            if promoted is None:
                fresh = {p["name"]: sample_one(rng, p) for p in search_specs}
                fresh[resource] = min_r
                by_rung.setdefault(min_r, []).append((-np.inf, fresh))
                out.append(fresh)
            else:
                out.append(promoted)
        return out
