"""ENAS-style neural-architecture-search suggester.

A copy of ``kubeflow_tpu/katib/suggest/enas.py``
(the port imports nothing of the JAX package).

Upstream analogue (UNVERIFIED, SURVEY.md §2a suggestion-services row): Katib's
ENAS suggestion service — an RL controller proposing architectures, updated
with REINFORCE from trial rewards.  Numpy-only reimplementation, same shape
as the other suggesters (no TF/torch controller — SURVEY.md §7 environment
reality): every categorical parameter is an edge in the cell, its feasible
list the candidate operations, and a per-(edge, op) logit table is the
controller policy.

Statelessness contract: suggesters are constructed per call, so the policy is
*replayed* deterministically from the completed-trial history — logits start
at zero and one REINFORCE step (moving-average baseline) is applied per
completed trial in creation order.  Sampling is seeded by ``random_state`` +
trial count, so repeated reconciles are idempotent.

Experiments may alternatively carry an upstream-style ``spec.nasConfig``
(``graphConfig.numLayers`` + ``operations``); the defaulter in katib/api.py
expands it into the equivalent categorical parameters.
"""

from __future__ import annotations

import numpy as np

from . import register
from .space import param_specs, settings_dict


def _reward(trial: dict, metric: str, sign: float):
    for m in trial.get("status", {}).get("observation", {}).get("metrics", []):
        if m["name"] == metric:
            return sign * float(m["latest"])
    return None


@register("enas")
class EnasSuggester:
    def suggest(self, experiment, trials, count):
        settings = settings_dict(experiment)
        lr = float(settings.get("learning_rate", 2.0))
        temp = float(settings.get("temperature", 1.0))
        seed = int(settings.get("random_state", 0))

        edges = [p for p in param_specs(experiment) if p["parameterType"] == "categorical"]
        if not edges:
            raise ValueError("enas needs categorical parameters (the cell edges)")
        ops = {p["name"]: list(p["feasibleSpace"]["list"]) for p in edges}
        logits = {p["name"]: np.zeros(len(ops[p["name"]])) for p in edges}

        metric = experiment["spec"]["objective"]["objectiveMetricName"]
        sign = 1.0 if experiment["spec"]["objective"]["type"] == "maximize" else -1.0

        # replay: one REINFORCE step per completed trial, in creation order
        baseline = None
        for t in trials:
            r = _reward(t, metric, sign)
            if r is None:
                continue
            advantage = r if baseline is None else r - baseline
            baseline = r if baseline is None else 0.7 * baseline + 0.3 * r
            assignments = {
                a["name"]: a["value"]
                for a in t.get("spec", {}).get("parameterAssignments", [])
            }
            for name, choices in ops.items():
                if assignments.get(name) not in choices:
                    continue
                chosen = choices.index(assignments[name])
                p = _softmax(logits[name] / temp)
                # d/dlogits log softmax[chosen] = onehot - p
                grad = -p
                grad[chosen] += 1.0
                logits[name] += lr * advantage * grad

        rng = np.random.default_rng(seed + len(trials))
        out = []
        for _ in range(count):
            arch = {}
            for name, choices in ops.items():
                p = _softmax(logits[name] / temp)
                arch[name] = choices[int(rng.choice(len(choices), p=p))]
            # non-edge parameters (e.g. lr) ride along with random samples
            for spec in param_specs(experiment):
                if spec["name"] not in arch:
                    from .space import sample_one

                    arch[spec["name"]] = sample_one(rng, spec)
            out.append(arch)
        return out


def _softmax(z: np.ndarray) -> np.ndarray:
    z = z - z.max()
    e = np.exp(z)
    return e / e.sum()
