"""ClusterServingRuntime catalog + runtime selection.

The port's copy of ``kubeflow_tpu/serving/runtimes.py``: the same catalog,
runtime names, model formats and priorities.  Every container runs
``python -m kubeflow_tpu_torch.serving.runtime_main``, and the runtimes
that request ``google.com/tpu: 1`` in the JAX catalog (``kserve-jetstream``,
``kserve-jax``, ``kserve-huggingface``) request ``nvidia.com/gpu: 1``.

Upstream analogue (UNVERIFIED, SURVEY.md §2a "KServe: serving runtimes"):
``kserve/config/runtimes/*.yaml`` — each runtime declares which model formats
it serves and a container template the controller renders.  The TPU-native
catalog replaces Triton/TF-Serving (C++ GPU servers) with the JetStream-style
engine (serving/engine/, PyTorch with hand-written CUDA kernels) and keeps the sklearn/xgboost/huggingface server
paths on the shared Python model server.

Template placeholders rendered by the controller: ``{{model_name}}``,
``{{model_dir}}``, ``{{port}}``, ``{{storage_uri}}``.
"""

from __future__ import annotations

import sys
from typing import Optional

from ..core.api import APIServer, Obj
from ..scheduler.topology import GPU_RESOURCE
from .api import GROUP, RUNTIME_VERSION

_PY = sys.executable


def _runtime(name: str, formats: list[dict], args: list[str], *, gpu: bool = False, priority: int = 1) -> Obj:
    container = {
        "name": "kserve-container",
        "command": [_PY, "-m", "kubeflow_tpu_torch.serving.runtime_main"],
        "args": args
        + ["--model-name", "{{model_name}}", "--model-dir", "{{model_dir}}", "--port", "{{port}}"],
    }
    if gpu:
        container["resources"] = {"requests": {GPU_RESOURCE: 1}}
    return {
        "apiVersion": f"{GROUP}/{RUNTIME_VERSION}",
        "kind": "ClusterServingRuntime",
        "metadata": {"name": name},
        "spec": {
            "supportedModelFormats": formats,
            "containers": [container],
            "priority": priority,
        },
    }


def default_runtimes() -> list[Obj]:
    return [
        # flagship: JetStream-style continuous-batching LLM engine on the card
        _runtime(
            "kserve-jetstream",
            [{"name": "jax-lm", "autoSelect": True, "priority": 2},
             {"name": "llama", "autoSelect": True, "priority": 2},
             {"name": "gemma", "autoSelect": True, "priority": 2}],
            ["--loader", "jetstream"],
            gpu=True,
            priority=2,
        ),
        # generic model server for a model.py's load_torch (non-LLM; the JAX
        # catalog's name and format, so a ``jax`` spec reaches a port pod)
        _runtime(
            "kserve-jax",
            [{"name": "jax", "autoSelect": True}],
            ["--loader", "jax"],
            gpu=True,
        ),
        # TF-Serving-equivalent SavedModel path (SURVEY.md §2b row)
        _runtime(
            "kserve-tensorflow",
            [{"name": "tensorflow", "autoSelect": True},
             {"name": "savedmodel", "autoSelect": True}],
            ["--loader", "tensorflow"],
        ),
        _runtime(
            "kserve-sklearn",
            [{"name": "sklearn", "autoSelect": True}],
            ["--loader", "sklearn"],
        ),
        _runtime(
            "kserve-xgboost",
            [{"name": "xgboost", "autoSelect": True}],
            ["--loader", "xgboost"],
        ),
        _runtime(
            "kserve-huggingface",
            [{"name": "huggingface", "autoSelect": True}],
            ["--loader", "huggingface"],
            gpu=True,
        ),
        # arbitrary user python: model dir contains model.py defining load()/predict()
        _runtime(
            "kserve-pyfunc",
            [{"name": "pyfunc", "autoSelect": True}],
            ["--loader", "pyfunc"],
        ),
        # explainer component runtime (Alibi-server analogue): shap over the
        # predictor HTTP hop, or white-box integrated gradients (explainers.py)
        _runtime(
            "kserve-explainer",
            [{"name": "explainer", "autoSelect": True}],
            ["--loader", "explainer"],
        ),
    ]


def install_default_runtimes(api: APIServer) -> None:
    from ..core.api import AlreadyExists

    for rt in default_runtimes():
        try:
            api.create(rt)
        except AlreadyExists:
            pass


def _supports(runtime: Obj, fmt: str, explicit: bool) -> Optional[int]:
    """Return the matching format's priority, or None. autoSelect=False
    runtimes only match when named explicitly via model.runtime."""
    for f in runtime["spec"]["supportedModelFormats"]:
        if f["name"] == fmt and (explicit or f.get("autoSelect", False)):
            return int(f.get("priority", runtime["spec"].get("priority", 1)))
    return None


def select_runtime(api: APIServer, namespace: str, model: dict) -> Obj:
    """Resolve a component's model spec to a runtime object.

    Order mirrors upstream: an explicit ``model.runtime`` name wins (namespace
    ServingRuntime first, then ClusterServingRuntime); otherwise the
    highest-priority auto-selectable runtime supporting the format, with
    namespaced runtimes beating cluster ones at equal priority.
    """
    fmt = model["modelFormat"]["name"]
    explicit = model.get("runtime")
    if explicit:
        rt = api.try_get("ServingRuntime", explicit, namespace) or api.try_get(
            "ClusterServingRuntime", explicit, ""
        )
        if rt is None:
            raise LookupError(f"runtime {explicit!r} not found")
        if _supports(rt, fmt, explicit=True) is None:
            raise LookupError(f"runtime {explicit!r} does not support format {fmt!r}")
        return rt
    candidates: list[tuple[int, int, str, Obj]] = []
    for scope_rank, (kind, ns) in enumerate(
        [("ServingRuntime", namespace), ("ClusterServingRuntime", None)]
    ):
        for rt in api.list(kind, namespace=ns):
            prio = _supports(rt, fmt, explicit=False)
            if prio is not None:
                candidates.append((-prio, scope_rank, rt["metadata"]["name"], rt))
    if not candidates:
        raise LookupError(f"no runtime supports model format {fmt!r}")
    candidates.sort(key=lambda t: t[:3])
    return candidates[0][3]


def render_container(runtime: Obj, *, model_name: str, model_dir: str, port, storage_uri: str = "") -> dict:
    """Substitute template placeholders into the runtime's first container."""
    from ..utils.render import deep_substitute

    return deep_substitute(
        runtime["spec"]["containers"][0],
        {
            "{{model_name}}": model_name,
            "{{model_dir}}": model_dir,
            "{{port}}": str(port),
            "{{storage_uri}}": storage_uri,
        },
    )
