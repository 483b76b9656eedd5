"""CMA-ES suggester (upstream: katib cmaes via goptuna — reimplemented).

A copy of ``kubeflow_tpu/katib/suggest/cmaes.py``
(the port imports nothing of the JAX package).

Stateless-service form of (mu/mu_w, lambda)-CMA-ES: the evolution state
(mean, step size, covariance, paths) is reconstructed by replaying completed
generations from the trial history on every call — the same trick the other
suggesters use so the service stays crash-safe with no state of its own
(the contract of the gRPC GetSuggestions API).

Unit-cube parameterization: all params map to [0,1]^d via space.to_unit /
from_unit; ask points are clipped to the cube.
"""

from __future__ import annotations

import numpy as np

from . import register
from .space import from_unit, observed, param_specs, sample_one, settings_dict


def _weights(lam: int) -> tuple[np.ndarray, float]:
    mu = lam // 2
    w = np.log(mu + 0.5) - np.log(np.arange(1, mu + 1))
    w = w / w.sum()
    return w, 1.0 / (w ** 2).sum()  # (weights, mu_eff)


@register("cmaes")
class CmaEsSuggester:
    def suggest(self, experiment, trials, count):
        specs = param_specs(experiment)
        settings = settings_dict(experiment)
        d = len(specs)
        lam = int(settings.get("population_size", 4 + int(3 * np.log(max(d, 1)))))
        sigma0 = float(settings.get("sigma", 0.3))
        rng = np.random.default_rng(int(settings.get("random_state", 0)))

        X, y, _ = observed(experiment, trials)  # y already sign-fixed to maximize

        # --- replay full generations to rebuild (mean, sigma, C, paths)
        w, mu_eff = _weights(lam)
        mu = lam // 2
        cc = (4 + mu_eff / d) / (d + 4 + 2 * mu_eff / d)
        cs = (mu_eff + 2) / (d + mu_eff + 5)
        c1 = 2 / ((d + 1.3) ** 2 + mu_eff)
        cmu = min(1 - c1, 2 * (mu_eff - 2 + 1 / mu_eff) / ((d + 2) ** 2 + mu_eff))
        damps = 1 + 2 * max(0.0, np.sqrt((mu_eff - 1) / (d + 1)) - 1) + cs
        chi_n = np.sqrt(d) * (1 - 1 / (4 * d) + 1 / (21 * d * d))

        mean = np.full(d, 0.5)
        sigma = sigma0
        C = np.eye(d)
        ps = np.zeros(d)
        pc = np.zeros(d)

        n_gens = len(y) // lam
        for g in range(n_gens):
            Xg = X[g * lam:(g + 1) * lam]
            yg = y[g * lam:(g + 1) * lam]
            order = np.argsort(-yg)[:mu]                       # best first (maximize)
            old_mean = mean
            mean = w @ Xg[order]
            # covariance/step-size adaptation (standard CMA equations)
            C_half_inv = _inv_sqrt(C)
            delta = (mean - old_mean) / max(sigma, 1e-12)
            ps = (1 - cs) * ps + np.sqrt(cs * (2 - cs) * mu_eff) * (C_half_inv @ delta)
            hsig = float(np.linalg.norm(ps) / np.sqrt(1 - (1 - cs) ** (2 * (g + 1))) < (1.4 + 2 / (d + 1)) * chi_n)
            pc = (1 - cc) * pc + hsig * np.sqrt(cc * (2 - cc) * mu_eff) * delta
            steps = (Xg[order] - old_mean) / max(sigma, 1e-12)
            C = (
                (1 - c1 - cmu) * C
                + c1 * (np.outer(pc, pc) + (1 - hsig) * cc * (2 - cc) * C)
                + cmu * (steps.T * w) @ steps
            )
            sigma = sigma * np.exp((cs / damps) * (np.linalg.norm(ps) / chi_n - 1))
            sigma = float(np.clip(sigma, 1e-6, 1.0))

        # --- ask: sample `count` points from N(mean, sigma^2 C), clipped
        out = []
        L = np.linalg.cholesky(C + 1e-12 * np.eye(d))
        for _ in range(count):
            z = rng.standard_normal(d)
            u = np.clip(mean + sigma * (L @ z), 0.0, 1.0)
            out.append({p["name"]: from_unit(p, u[j]) for j, p in enumerate(specs)})
        return out


def _inv_sqrt(C: np.ndarray) -> np.ndarray:
    vals, vecs = np.linalg.eigh(C)
    vals = np.maximum(vals, 1e-12)
    return vecs @ np.diag(vals ** -0.5) @ vecs.T
