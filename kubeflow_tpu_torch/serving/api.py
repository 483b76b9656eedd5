"""Serving API types: InferenceService + ServingRuntime CRDs.

Upstream analogue (UNVERIFIED, SURVEY.md §2a "KServe"): the
``serving.kserve.io/v1beta1 InferenceService`` and ``v1alpha1
(Cluster)ServingRuntime`` types.  The port's copy of
``kubeflow_tpu/serving/api.py``: the same CRDs, builders and validation.
Departures from upstream:

  * the default accelerator resource is ``nvidia.com/gpu`` (the JAX
    package's is ``google.com/tpu``), requested by the runtime catalog
    (serving/runtimes.py) and placed by the GPU scheduler
    (scheduler/topology.py);
  * the flagship runtime is a JetStream-style continuous-batching engine in
    PyTorch with hand-written CUDA kernels (see serving/engine/) rather than
    Triton/TF-Serving;
  * "serverless" is a concurrency-driven autoscaler with scale-to-zero and an
    activator in the router (serving/autoscaler.py, serving/router.py) — the
    in-process equivalent of Knative KPA + activator.

An InferenceService has up to three components (predictor required,
transformer/explainer optional).  Each component is either a catalog model
(``model: {modelFormat, storageUri, ...}`` resolved against ServingRuntimes)
or a custom container list.  Canary rollout: ``canaryTrafficPercent`` splits
traffic between the promoted revision (kept in an annotation) and the latest
spec, mirroring KServe's previous-rolledout-revision mechanism.
"""

from __future__ import annotations

import copy
from typing import Optional

from ..core.api import APIServer, CRD, Invalid, Obj

GROUP = "serving.kubeflow.org"
VERSION = "v1beta1"
RUNTIME_VERSION = "v1alpha1"

# condition types (status.conditions on InferenceService)
PREDICTOR_READY = "PredictorReady"
TRANSFORMER_READY = "TransformerReady"
EXPLAINER_READY = "ExplainerReady"
INGRESS_READY = "IngressReady"
READY = "Ready"

COMPONENTS = ("predictor", "transformer", "explainer")

# annotation holding the promoted (last fully-rolled-out) spec for canary
PROMOTED_SPEC_ANNOTATION = f"{GROUP}/promoted-spec"
# deployment annotations driving the autoscaler
TARGET_CONCURRENCY_ANNOTATION = f"{GROUP}/target-concurrency"
MIN_REPLICAS_ANNOTATION = f"{GROUP}/min-replicas"
MAX_REPLICAS_ANNOTATION = f"{GROUP}/max-replicas"
SCALE_TO_ZERO_GRACE_ANNOTATION = f"{GROUP}/scale-to-zero-grace"
# label wiring pods/services back to their isvc + component + revision
LABEL_ISVC = f"{GROUP}/inferenceservice"
LABEL_COMPONENT = f"{GROUP}/component"
LABEL_REVISION = f"{GROUP}/revision"


def _validate_component(name: str, comp: dict) -> None:
    has_model = "model" in comp
    has_containers = bool(comp.get("containers"))
    if name == "predictor" and not (has_model or has_containers):
        raise Invalid("predictor needs .model or .containers")
    if has_model and has_containers:
        raise Invalid(f"{name}: .model and .containers are mutually exclusive")
    if has_model:
        model = comp["model"]
        if "modelFormat" not in model:
            raise Invalid(f"{name}.model.modelFormat is required")
    for field in ("minReplicas", "maxReplicas"):
        v = comp.get(field)
        if v is not None and v < 0:
            raise Invalid(f"{name}.{field} must be >= 0")
    mn, mx = comp.get("minReplicas"), comp.get("maxReplicas")
    if mn is not None and mx is not None and mx != 0 and mx < mn:
        raise Invalid(f"{name}: maxReplicas < minReplicas")


def validate_isvc(obj: Obj) -> None:
    spec = obj.get("spec") or {}
    if "predictor" not in spec:
        raise Invalid("spec.predictor is required")
    for name in COMPONENTS:
        if name in spec:
            _validate_component(name, spec[name])
    canary = spec.get("canaryTrafficPercent")
    if canary is not None and not (0 <= canary <= 100):
        raise Invalid("canaryTrafficPercent must be in [0, 100]")


def default_isvc(obj: Obj, api: Optional["APIServer"] = None) -> None:
    """Admission defaulting; with an ``api`` handle (the registered path) the
    autoscaling defaults come from the inferenceservice-config ConfigMap —
    upstream's mutating webhook reads the same ConfigMap at admission."""
    auto = {"defaultMinReplicas": 1, "defaultMaxReplicas": 3, "defaultScaleTarget": 4}
    if api is not None:
        from .config import isvc_config

        auto.update(isvc_config(api).get("autoscaling", {}))
    spec = obj.setdefault("spec", {})
    for name in COMPONENTS:
        comp = spec.get(name)
        if comp is None:
            continue
        comp.setdefault("minReplicas", auto["defaultMinReplicas"])
        comp.setdefault("maxReplicas", auto["defaultMaxReplicas"])
        comp.setdefault("scaleTarget", auto["defaultScaleTarget"])  # target concurrent requests/replica
        if "model" in comp:
            model = comp["model"]
            fmt = model.get("modelFormat")
            if isinstance(fmt, str):  # accept shorthand "jax" for {name: "jax"}
                model["modelFormat"] = {"name": fmt}


def validate_runtime(obj: Obj) -> None:
    spec = obj.get("spec") or {}
    if not spec.get("supportedModelFormats"):
        raise Invalid("spec.supportedModelFormats is required")
    if not spec.get("containers"):
        raise Invalid("spec.containers is required")


def register(api: APIServer) -> None:
    api.register_crd(
        CRD(
            group=GROUP,
            version=VERSION,
            kind="InferenceService",
            plural="inferenceservices",
            validator=validate_isvc,
            # closure over the apiserver so admission defaulting can read the
            # inferenceservice-config ConfigMap (upstream webhook behavior)
            defaulter=lambda obj: default_isvc(obj, api),
        )
    )
    api.register_crd(
        CRD(
            group=GROUP,
            version=RUNTIME_VERSION,
            kind="ServingRuntime",
            plural="servingruntimes",
            validator=validate_runtime,
        )
    )
    api.register_crd(
        CRD(
            group=GROUP,
            version=RUNTIME_VERSION,
            kind="ClusterServingRuntime",
            plural="clusterservingruntimes",
            namespaced=False,
            validator=validate_runtime,
        )
    )
    api.register_crd(
        CRD(
            group=GROUP,
            version=RUNTIME_VERSION,
            kind="TrainedModel",
            plural="trainedmodels",
            validator=_validate_trained_model,
        )
    )


def _validate_trained_model(obj: Obj) -> None:
    spec = obj.get("spec", {})
    if not spec.get("inferenceService"):
        raise Invalid("TrainedModel: spec.inferenceService required")
    if not spec.get("model", {}).get("storageUri"):
        raise Invalid("TrainedModel: spec.model.storageUri required")


# ------------------------------------------------------------------ builders


def inference_service(
    name: str,
    *,
    namespace: str = "default",
    model_format: Optional[str] = None,
    storage_uri: Optional[str] = None,
    runtime: Optional[str] = None,
    predictor: Optional[dict] = None,
    transformer: Optional[dict] = None,
    explainer: Optional[dict] = None,
    canary_traffic_percent: Optional[int] = None,
    min_replicas: Optional[int] = 1,
    max_replicas: Optional[int] = 3,
    scale_target: Optional[int] = 4,
) -> Obj:
    """Typed builder — the Python-SDK analogue of kserve's V1beta1InferenceService."""
    if predictor is None:
        if model_format is None:
            raise ValueError("either predictor= or model_format= is required")
        model: dict = {"modelFormat": {"name": model_format}}
        if storage_uri is not None:
            model["storageUri"] = storage_uri
        if runtime is not None:
            model["runtime"] = runtime
        predictor = {"model": model}
    predictor = copy.deepcopy(predictor)
    # None = leave it to admission defaulting (inferenceservice-config)
    for key, value in (("minReplicas", min_replicas), ("maxReplicas", max_replicas),
                       ("scaleTarget", scale_target)):
        if value is not None:
            predictor.setdefault(key, value)
    spec: dict = {"predictor": predictor}
    if transformer is not None:
        spec["transformer"] = copy.deepcopy(transformer)
    if explainer is not None:
        spec["explainer"] = copy.deepcopy(explainer)
    if canary_traffic_percent is not None:
        spec["canaryTrafficPercent"] = canary_traffic_percent
    return {
        "apiVersion": f"{GROUP}/{VERSION}",
        "kind": "InferenceService",
        "metadata": {"name": name, "namespace": namespace},
        "spec": spec,
    }
