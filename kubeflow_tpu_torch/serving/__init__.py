"""Serving pillar of the port: InferenceService / ServingRuntime / model
server / router, and the generate engine.

The port's counterpart of ``kubeflow_tpu/serving/__init__.py``:
``install()`` wires the port's own serving control plane into a Manager,
so an InferenceService is reconciled, scheduled onto a GPU node and routed
by the port, and served by the port's runtime
(``kubeflow_tpu_torch.serving.runtime_main``).  As in the JAX package, the
control plane is imported with the package, so a runtime pod imports it
too.
"""

from __future__ import annotations

from ..core.api import APIServer
from . import api as serving_api
from . import graph as graph_api
from .autoscaler import ConcurrencyAutoscaler
from .controllers import DeploymentReconciler, InferenceServiceReconciler
from .graph import InferenceGraphReconciler
from .router import Router, ServiceProxy
from .runtimes import install_default_runtimes


def install(api: APIServer, manager, runtimes: bool = True):
    """Register serving CRDs + controllers. Returns (router, service_proxy)."""
    serving_api.register(api)
    graph_api.register(api)
    if runtimes:
        install_default_runtimes(api)
    manager.add(DeploymentReconciler(api), owns=("Pod",))
    manager.add(InferenceServiceReconciler(api), owns=("Deployment",))
    manager.add(InferenceGraphReconciler(api))
    proxy = ServiceProxy(api)
    # incident plane (README "Incident plane"): the autoscaler feeds its
    # flap detector into the proxy's per-service incident managers and
    # reads their open-incident state as a scale-down veto
    autoscaler = ConcurrencyAutoscaler(api, incidents=proxy.incident_view())
    manager.add_ticker(autoscaler.sync)
    manager.add_ticker(proxy.sync)
    return Router(api), proxy
