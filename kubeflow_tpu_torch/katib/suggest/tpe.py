"""Tree-structured Parzen Estimator (upstream: katib TPE via hyperopt).

A copy of ``kubeflow_tpu/katib/suggest/tpe.py``
(the port imports nothing of the JAX package).

Numpy reimplementation of the TPE idea: split observations at the γ-quantile
into good/bad sets, model each with a Gaussian KDE in the unit cube, and pick
the candidate maximizing the density ratio l(x)/g(x).
"""

from __future__ import annotations

import numpy as np

from . import register
from .space import from_unit, observed, param_specs, sample_one, settings_dict


def _kde_logpdf(x: np.ndarray, data: np.ndarray, bw: float) -> np.ndarray:
    if len(data) == 0:
        return np.zeros(len(x))
    d2 = ((x[:, None, :] - data[None, :, :]) ** 2).sum(-1)
    k = np.exp(-0.5 * d2 / bw**2)
    return np.log(k.mean(1) + 1e-12)


@register("tpe")
class TPESuggester:
    def suggest(self, experiment, trials, count):
        specs = param_specs(experiment)
        settings = settings_dict(experiment)
        n_startup = int(settings.get("n_startup_trials", 5))
        gamma = float(settings.get("gamma", 0.25))
        n_candidates = int(settings.get("n_ei_candidates", 64))
        rng = np.random.default_rng(int(settings.get("random_state", 0)) + len(trials))

        X, y, _ = observed(experiment, trials)
        out = []
        for _ in range(count):
            if len(y) < n_startup:
                out.append({p["name"]: sample_one(rng, p) for p in specs})
                continue
            order = np.argsort(-y)  # descending: larger is better
            n_good = max(1, int(np.ceil(gamma * len(y))))
            good, bad = X[order[:n_good]], X[order[n_good:]]
            bw = max(0.1, 1.0 / max(len(y), 1) ** 0.5)
            cand = rng.uniform(0, 1, size=(n_candidates, len(specs)))
            # seed candidates near good points too
            if len(good):
                near = good[rng.integers(0, len(good), n_candidates // 2)]
                cand[: n_candidates // 2] = np.clip(
                    near + rng.normal(0, bw, near.shape), 0, 1
                )
            score = _kde_logpdf(cand, good, bw) - _kde_logpdf(cand, bad, bw)
            best = cand[int(np.argmax(score))]
            out.append({p["name"]: from_unit(p, u) for p, u in zip(specs, best)})
        return out
