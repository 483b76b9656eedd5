"""Platform CRDs: Profile, Notebook, PodDefault (+ RBAC kinds).

Upstream analogue (UNVERIFIED, SURVEY.md §2a): the multi-tenancy layer of
kubeflow/kubeflow — profile-controller (`Profile` CR → namespace + RBAC +
quota), notebook-controller (`Notebook` CR → StatefulSet + Service + culling),
admission-webhook (`PodDefault` mutating injection).

The port's copy of ``kubeflow_tpu/platform/api.py``.  The accelerator is
``nvidia.com/gpu``: ``notebook(..., gpus=N)`` puts N cards in the notebook
container's limits where the reference's ``notebook(..., tpu_chips=N)`` puts
N ``google.com/tpu`` chips.  A Notebook manifest that still carries
``google.com/tpu`` is taken as it is; its pod stays Pending on the port's
scheduler, with a ``FailedScheduling`` event naming the resource.
"""

from __future__ import annotations

from typing import Optional

from ..core.api import APIServer, CRD, Invalid, Obj

GROUP = "kubeflow.org"
VERSION = "v1"

PROFILE_OWNER_LABEL = f"{GROUP}/profile-owner"
PROFILE_LABEL = f"{GROUP}/profile"
NOTEBOOK_LABEL = f"{GROUP}/notebook-name"
LAST_ACTIVITY_ANNOTATION = "notebooks.kubeflow.org/last-activity"
CULLED_ANNOTATION = "notebooks.kubeflow.org/culled"

# condition types
READY = "Ready"
CULLED = "Culled"


def _validate_profile(obj: Obj) -> None:
    owner = obj.get("spec", {}).get("owner", {})
    if not owner.get("name"):
        raise Invalid("Profile.spec.owner.name (user email) is required")


def _validate_notebook(obj: Obj) -> None:
    spec = obj.get("spec", {})
    tmpl = spec.get("template", {}).get("spec", {})
    if not tmpl.get("containers"):
        raise Invalid("Notebook.spec.template.spec.containers is required")


def _validate_poddefault(obj: Obj) -> None:
    if "selector" not in obj.get("spec", {}):
        raise Invalid("PodDefault.spec.selector is required")


def register(api: APIServer) -> None:
    api.register_crd(
        CRD(group=GROUP, version=VERSION, kind="Profile", plural="profiles",
            namespaced=False, validator=_validate_profile)
    )
    api.register_crd(
        CRD(group=GROUP, version=VERSION, kind="Notebook", plural="notebooks",
            validator=_validate_notebook)
    )
    api.register_crd(
        CRD(group="kubeflow.org", version="v1alpha1", kind="PodDefault",
            plural="poddefaults", validator=_validate_poddefault)
    )
    # RBAC + quota kinds the profile controller materializes
    api.register_crd(CRD(group="rbac.authorization.k8s.io", version="v1", kind="Role", plural="roles"))
    api.register_crd(CRD(group="rbac.authorization.k8s.io", version="v1", kind="RoleBinding", plural="rolebindings"))
    api.register_crd(CRD(group="", version="v1", kind="ResourceQuota", plural="resourcequotas"))
    api.register_crd(CRD(group="", version="v1", kind="ServiceAccount", plural="serviceaccounts"))
    api.register_crd(
        CRD(group="security.istio.io", version="v1beta1", kind="AuthorizationPolicy", plural="authorizationpolicies")
    )


def profile(name: str, owner: str, resource_quota: Optional[dict] = None) -> Obj:
    spec: dict = {"owner": {"kind": "User", "name": owner}}
    if resource_quota:
        spec["resourceQuotaSpec"] = {"hard": dict(resource_quota)}
    return {
        "apiVersion": f"{GROUP}/{VERSION}",
        "kind": "Profile",
        "metadata": {"name": name},
        "spec": spec,
    }


def notebook(
    name: str,
    namespace: str,
    image_command: list,
    cpu: str = "1",
    memory: str = "2Gi",
    gpus: int = 0,
    env: Optional[dict] = None,
    volumes: Optional[list] = None,
) -> Obj:
    container: dict = {
        "name": "notebook",
        "command": list(image_command),
        "resources": {"limits": {"cpu": cpu, "memory": memory}},
        "env": [{"name": k, "value": str(v)} for k, v in (env or {}).items()],
    }
    if gpus:
        container["resources"]["limits"]["nvidia.com/gpu"] = gpus
    return {
        "apiVersion": f"{GROUP}/{VERSION}",
        "kind": "Notebook",
        "metadata": {"name": name, "namespace": namespace},
        "spec": {"template": {"spec": {"containers": [container], "volumes": list(volumes or [])}}},
    }


def pod_default(
    name: str,
    namespace: str,
    selector: dict,
    env: Optional[dict] = None,
    annotations: Optional[dict] = None,
    volumes: Optional[list] = None,
    volume_mounts: Optional[list] = None,
    tolerations: Optional[list] = None,
) -> Obj:
    return {
        "apiVersion": "kubeflow.org/v1alpha1",
        "kind": "PodDefault",
        "metadata": {"name": name, "namespace": namespace},
        "spec": {
            "selector": dict(selector),
            "env": [{"name": k, "value": str(v)} for k, v in (env or {}).items()],
            "annotations": dict(annotations or {}),
            "volumes": list(volumes or []),
            "volumeMounts": list(volume_mounts or []),
            "tolerations": list(tolerations or []),
        },
    }
