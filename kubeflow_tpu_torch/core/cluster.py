"""The in-process "cluster": apiserver + scheduler + kubelets + controllers.

The port's copy of ``kubeflow_tpu/core/cluster.py``: GPU nodes
(``gpu_nodes=((name, accelerator, count), ...)``, one Node per entry,
scheduler/topology.py ``make_gpu_node``) take the place of ``tpu_slices``.

Upstream analogue (UNVERIFIED): a kind/envtest cluster with the full operator
set installed (SURVEY.md §4).  ``Cluster`` is the single entry point tests and
the CLI use: ``apply()`` a spec, ``wait_for()`` a condition, read logs.
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable, Optional

from .api import APIServer, Obj
from .controller import Manager
from .kubelet import LocalProcessKubelet
from ..scheduler import topology as topo
from ..scheduler.topology import TopologyScheduler, make_cpu_node, make_gpu_node


class Cluster:
    def __init__(
        self,
        workdir: Optional[str] = None,
        cpu_nodes: int = 1,
        gpu_nodes: tuple[tuple[str, str, int], ...] = (),  # (name, accelerator, count)
        base_env: Optional[dict] = None,
    ):
        self.api = APIServer()
        topo.register(self.api)
        self.workdir = workdir or tempfile.mkdtemp(prefix="kfcluster-")
        os.makedirs(self.workdir, exist_ok=True)
        self.manager = Manager(self.api)
        self.scheduler = TopologyScheduler(self.api)
        self.manager.add_ticker(self.scheduler.sync)
        self.kubelets: dict[str, LocalProcessKubelet] = {}
        for i in range(cpu_nodes):
            self.add_node(make_cpu_node(self.api, f"cpu-{i}"), base_env)
        for name, acc, count in gpu_nodes:
            self.add_node(make_gpu_node(self.api, name, acc, count), base_env)

    def add_node(self, name: str, base_env: Optional[dict] = None) -> None:
        kubelet = LocalProcessKubelet(
            self.api, node_name=name, workdir=os.path.join(self.workdir, name), base_env=base_env
        )
        self.kubelets[name] = kubelet
        self.manager.add_ticker(kubelet.sync)

    # -------------------------------------------------------------- user API

    def apply(self, obj: Obj) -> Obj:
        """Create-or-update, like ``kubectl apply``."""
        existing = self.api.try_get(
            obj["kind"], obj["metadata"]["name"], obj.get("metadata", {}).get("namespace", "default")
        )
        if existing is None:
            return self.api.create(obj)
        merged = dict(existing)
        merged["spec"] = obj.get("spec", merged.get("spec"))
        return self.api.update(merged)

    def wait_for(self, predicate: Callable[[], bool], timeout: float = 120.0) -> bool:
        return self.manager.run_until(predicate, timeout=timeout)

    def settle(self, quiet: float = 0.2, timeout: float = 30.0) -> None:
        self.manager.settle(quiet=quiet, timeout=timeout)

    def logs(self, pod_name: str, namespace: str = "default") -> str:
        for kubelet in self.kubelets.values():
            out = kubelet.logs(pod_name, namespace)
            if out:
                return out
        return ""

    def shutdown(self) -> None:
        for kubelet in self.kubelets.values():
            kubelet.shutdown()
        self.api.run_teardowns()
