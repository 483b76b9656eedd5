"""Bayesian optimization with a numpy Gaussian process + UCB acquisition
(upstream: katib bayesianoptimization via skopt — reimplemented, not ported).

A copy of ``kubeflow_tpu/katib/suggest/bayesian.py``
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import numpy as np

from . import register
from .space import from_unit, observed, param_specs, sample_one, settings_dict


def _rbf(a: np.ndarray, b: np.ndarray, ls: float) -> np.ndarray:
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return np.exp(-0.5 * d2 / ls**2)


@register("bayesianoptimization")
class BayesianSuggester:
    def suggest(self, experiment, trials, count):
        specs = param_specs(experiment)
        settings = settings_dict(experiment)
        n_startup = int(settings.get("n_initial_points", 5))
        kappa = float(settings.get("kappa", 2.0))
        ls = float(settings.get("length_scale", 0.25))
        noise = float(settings.get("noise", 1e-4))
        n_candidates = int(settings.get("n_candidates", 256))
        rng = np.random.default_rng(int(settings.get("random_state", 0)) + len(trials))

        X, y, _ = observed(experiment, trials)
        out = []
        for _ in range(count):
            if len(y) < n_startup:
                out.append({p["name"]: sample_one(rng, p) for p in specs})
                continue
            mu_y, std_y = y.mean(), max(y.std(), 1e-9)
            yn = (y - mu_y) / std_y
            K = _rbf(X, X, ls) + noise * np.eye(len(X))
            L = np.linalg.cholesky(K)
            alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))
            cand = rng.uniform(0, 1, size=(n_candidates, len(specs)))
            Ks = _rbf(cand, X, ls)
            mu = Ks @ alpha
            v = np.linalg.solve(L, Ks.T)
            var = np.clip(1.0 - (v**2).sum(0), 1e-12, None)
            ucb = mu + kappa * np.sqrt(var)
            best = cand[int(np.argmax(ucb))]
            out.append({p["name"]: from_unit(p, u) for p, u in zip(specs, best)})
        return out
