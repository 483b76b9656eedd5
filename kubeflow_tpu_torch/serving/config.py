"""inferenceservice-config ConfigMap semantics.

A copy of ``kubeflow_tpu/serving/config.py``.

Upstream analogue (UNVERIFIED, SURVEY.md §5 config row): KServe's
``inferenceservice-config`` ConfigMap in the ``kubeflow`` namespace — JSON
blobs per subsystem (ingress, autoscaling, …) that operators edit to retune
the controller without redeploying it.  The controller re-reads it each
reconcile (level-triggered), merging over compiled-in defaults.
"""

from __future__ import annotations

import copy
import json

from ..core.api import APIServer

CONFIG_NAME = "inferenceservice-config"
CONFIG_NAMESPACE = "kubeflow"

DEFAULTS: dict = {
    "ingress": {
        "ingressDomain": "example.com",
        "urlScheme": "http",
    },
    "autoscaling": {
        "defaultMinReplicas": 1,
        "defaultMaxReplicas": 3,
        "defaultScaleTarget": 4,
    },
}


def isvc_config(api: APIServer) -> dict:
    """Effective config: ConfigMap JSON blobs merged over DEFAULTS."""
    out = copy.deepcopy(DEFAULTS)
    cm = api.try_get("ConfigMap", CONFIG_NAME, CONFIG_NAMESPACE)
    if cm is None:
        return out
    for key, blob in (cm.get("data") or {}).items():
        try:
            value = json.loads(blob)
        except (json.JSONDecodeError, TypeError):
            continue
        if isinstance(value, dict):
            out.setdefault(key, {}).update(value)
        else:
            out[key] = value
    return out


def external_url(config: dict, name: str, namespace: str) -> str:
    """Upstream-shaped status.url: {scheme}://{name}.{ns}.{ingressDomain}."""
    ing = config.get("ingress", {})
    return f"{ing.get('urlScheme', 'http')}://{name}.{namespace}.{ing.get('ingressDomain', 'example.com')}"
