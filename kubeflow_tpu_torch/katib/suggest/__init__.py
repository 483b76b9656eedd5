"""Suggestion algorithm services.

A copy of ``kubeflow_tpu/katib/suggest/__init__.py``
(the port imports nothing of the JAX package).

Upstream analogue (UNVERIFIED, SURVEY.md §2a "Katib: suggestion services"):
one gRPC service per algorithm (random, grid, hyperband, bayesian-opt via
skopt, TPE via hyperopt, CMA-ES via goptuna…).  Here each algorithm is a
``Suggester`` with the same contract as the gRPC ``GetSuggestions``: given the
experiment spec and observed trials, emit the next parameter assignments.
They are numpy-only reimplementations, not ports — skopt/hyperopt/goptuna are
not in the image (SURVEY.md §7 environment reality).
"""

from __future__ import annotations

from typing import Protocol

from ...core.api import Obj


class Suggester(Protocol):
    def suggest(self, experiment: Obj, trials: list[Obj], count: int) -> list[dict]:
        """Return ``count`` assignments: [{param_name: value}, ...]."""
        ...


_REGISTRY: dict[str, type] = {}


def register(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls

    return deco


def get_suggester(name: str) -> Suggester:
    from . import bayesian, cmaes, darts, enas, grid, hyperband, pbt, random_search, sobol, tpe  # noqa: F401

    if name not in _REGISTRY:
        raise KeyError(f"unknown algorithm {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def algorithm_names() -> list[str]:
    from . import bayesian, cmaes, darts, enas, grid, hyperband, pbt, random_search, sobol, tpe  # noqa: F401

    return sorted(_REGISTRY)
