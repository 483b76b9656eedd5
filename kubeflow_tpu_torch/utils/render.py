"""Spec-tree rendering: apply a string transform to every leaf string.

A copy of ``kubeflow_tpu/utils/render.py``.

Shared by the serving controllers ({{pod_port}}), the ServingRuntime container
templates ({{model_dir}} etc.), and Katib trial templates
(${trialParameters.x}) — one walker instead of three.
"""

from __future__ import annotations

from typing import Callable


def deep_map_strings(node, fn: Callable[[str], str]):
    """Return a copy of `node` with `fn` applied to every string leaf."""
    if isinstance(node, str):
        return fn(node)
    if isinstance(node, list):
        return [deep_map_strings(x, fn) for x in node]
    if isinstance(node, dict):
        return {k: deep_map_strings(v, fn) for k, v in node.items()}
    return node


def deep_substitute(node, mapping: dict[str, str]):
    """Replace every occurrence of each mapping key in every string leaf."""

    def sub(s: str) -> str:
        for k, v in mapping.items():
            s = s.replace(k, v)
        return s

    return deep_map_strings(node, sub)
