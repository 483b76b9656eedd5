"""Authn/z on the API surface: profile-RBAC authorization + scoped clients.

A copy of ``kubeflow_tpu/core/authz.py``.

Upstream analogue (UNVERIFIED, SURVEY.md §1 X-row): Istio terminates authn at
the mesh edge (the `kubeflow-userid` header) and authorization is the
RoleBindings the Profile controller / KFAM materialize per namespace.  Here
the same trust boundary lands on ``AuthenticatedAPI`` — a per-user view over
the APIServer that SubjectAccessReview-checks every verb before delegating —
so UIs/SDK services can serve multi-tenant requests without each inventing
its own checks.

Roles (KFAM's ClusterRole set): ``admin``/``edit`` may mutate, ``view`` may
only read; a profile's OWNER is implicitly admin in its namespace; members of
``cluster_admins`` are admin everywhere (including non-namespaced kinds).
"""

from __future__ import annotations

from typing import Iterable, Optional

from .api import APIServer, Obj

READ_VERBS = ("get", "list", "watch")
WRITE_VERBS = ("create", "update", "patch", "delete")

_ROLE_VERBS = {
    "admin": READ_VERBS + WRITE_VERBS,
    "edit": READ_VERBS + WRITE_VERBS,
    "view": READ_VERBS,
}


class Forbidden(PermissionError):
    pass


class ProfileRBACAuthorizer:
    """KFAM-materialized RoleBindings + profile ownership → allow/deny."""

    def __init__(self, api: APIServer, cluster_admins: Iterable[str] = ()):
        self.api = api
        self.cluster_admins = set(cluster_admins)

    def roles_for(self, user: str, namespace: str) -> set[str]:
        roles = set()
        # try_get already returns None for a missing object or unregistered
        # kind, so no guard is needed there
        prof = self.api.try_get("Profile", namespace)
        if prof is not None and prof["spec"].get("owner", {}).get("name") == user:
            roles.add("admin")
        # a partially-installed platform (kfadm subsets) may not register the
        # RoleBinding CRD at all — api.list raises bare KeyError for an
        # unregistered kind; that means "no grants", not an authorizer crash
        # (cluster_admins still pass in authorize())
        try:
            bindings = self.api.list("RoleBinding", namespace=namespace)
        except KeyError:
            bindings = []
        for b in bindings:
            labels = b["metadata"].get("labels", {})
            if labels.get("user") == user and labels.get("role") in _ROLE_VERBS:
                roles.add(labels["role"])
        return roles

    def authorize(self, user: str, verb: str, kind: str,
                  namespace: Optional[str]) -> bool:
        if user in self.cluster_admins:
            return True
        if namespace is None:
            # non-namespaced kinds (Nodes, Profiles, …): cluster admins only
            # — except reads of Profiles, which every authenticated user may
            # list (the dashboard's namespace picker needs it, as upstream)
            return kind == "Profile" and verb in READ_VERBS
        for role in self.roles_for(user, namespace):
            if verb in _ROLE_VERBS[role]:
                return True
        return False


class AuthenticatedAPI:
    """A per-user facade over APIServer: every call is authorized first.

    The SelfSubjectAccessReview-shaped hop every UI backend goes through;
    construct one per request (cheap) with the identity the ingress
    authenticated.
    """

    def __init__(self, api: APIServer, user: str, authorizer: ProfileRBACAuthorizer):
        self.api = api
        self.user = user
        self.authorizer = authorizer

    def _check(self, verb: str, kind: str, namespace: Optional[str]) -> None:
        crd = self.api.crd_for(kind)
        ns = namespace if crd.namespaced else None
        if not self.authorizer.authorize(self.user, verb, kind, ns):
            raise Forbidden(
                f"user {self.user!r} cannot {verb} {kind}"
                + (f" in namespace {ns!r}" if ns else " (cluster-scoped)"))

    # -------------------------------------------------------------- verbs

    def create(self, obj: Obj) -> Obj:
        self._check("create", obj["kind"], obj["metadata"].get("namespace", "default"))
        return self.api.create(obj)

    def update(self, obj: Obj) -> Obj:
        self._check("update", obj["kind"], obj["metadata"].get("namespace", "default"))
        return self.api.update(obj)

    def patch(self, kind: str, name: str, patch: dict, namespace: str = "default") -> Obj:
        self._check("patch", kind, namespace)
        return self.api.patch(kind, name, patch, namespace)

    def delete(self, kind: str, name: str, namespace: str = "default") -> None:
        self._check("delete", kind, namespace)
        self.api.delete(kind, name, namespace)

    def get(self, kind: str, name: str, namespace: str = "default") -> Obj:
        self._check("get", kind, namespace)
        return self.api.get(kind, name, namespace)

    def try_get(self, kind: str, name: str, namespace: str = "default") -> Optional[Obj]:
        self._check("get", kind, namespace)
        return self.api.try_get(kind, name, namespace)

    def list(self, kind: str, namespace: Optional[str] = "default", **kw) -> list[Obj]:
        crd = self.api.crd_for(kind)
        if not crd.namespaced:
            namespace = None
        if crd.namespaced and namespace is None:
            # cross-namespace list: filter to the namespaces the user can
            # read; memoize per namespace (one decision per ns, not per obj)
            decided: dict[str, bool] = {}
            out = []
            for obj in self.api.list(kind, namespace=None, **kw):
                ns = obj["metadata"].get("namespace", "default")
                if ns not in decided:
                    decided[ns] = self.authorizer.authorize(self.user, "list", kind, ns)
                if decided[ns]:
                    out.append(obj)
            return out
        self._check("list", kind, namespace)
        return self.api.list(kind, namespace=namespace, **kw)

    def watch(self, kind: str, namespace: Optional[str] = None, **kw):
        self._check("watch", kind, namespace)
        return self.api.watch(kind, namespace=namespace, **kw)
