"""KFAM: profile access management (contributors).

A copy of ``kubeflow_tpu/platform/kfam.py``.

Upstream analogue (UNVERIFIED, SURVEY.md §2a): the access-management REST
service backing the dashboard's "manage contributors" — membership is
materialized as RoleBindings in the profile namespace.
"""

from __future__ import annotations

from ..core.api import AlreadyExists, APIServer, NotFound


class AccessManagement:
    ROLES = ("admin", "edit", "view")

    def __init__(self, api: APIServer):
        self.api = api

    def _profile(self, profile: str) -> dict:
        prof = self.api.try_get("Profile", profile)
        if prof is None:
            raise NotFound(f"profile {profile!r} not found")
        return prof

    def create_binding(self, profile: str, user: str, role: str = "edit") -> dict:
        if role not in self.ROLES:
            raise ValueError(f"role must be one of {self.ROLES}, got {role!r}")
        self._profile(profile)
        binding = {
            "apiVersion": "rbac.authorization.k8s.io/v1",
            "kind": "RoleBinding",
            "metadata": {
                "name": f"user-{user.replace('@', '-').replace('.', '-')}-{role}",
                "namespace": profile,
                "labels": {"role": role, "user": user},
            },
            "subjects": [{"kind": "User", "name": user}],
            "roleRef": {"kind": "ClusterRole", "name": f"kubeflow-{role}"},
        }
        try:
            return self.api.create(binding)
        except AlreadyExists:
            return self.api.get("RoleBinding", binding["metadata"]["name"], profile)

    def list_bindings(self, profile: str) -> list[dict]:
        self._profile(profile)
        return [
            {"user": b["metadata"]["labels"].get("user"), "role": b["metadata"]["labels"].get("role")}
            for b in self.api.list("RoleBinding", namespace=profile)
            if "user" in b["metadata"].get("labels", {})
        ]

    def delete_binding(self, profile: str, user: str, role: str = "edit") -> bool:
        name = f"user-{user.replace('@', '-').replace('.', '-')}-{role}"
        return self.api.try_delete("RoleBinding", name, profile)

    def namespaces_for(self, user: str) -> list[str]:
        """All profile namespaces the user owns or contributes to."""
        out = set()
        for prof in self.api.list("Profile"):
            if prof["spec"]["owner"]["name"] == user:
                out.add(prof["metadata"]["name"])
        for b in self.api.list("RoleBinding"):
            if b["metadata"].get("labels", {}).get("user") == user:
                out.add(b["metadata"].get("namespace", "default"))
        return sorted(out)
