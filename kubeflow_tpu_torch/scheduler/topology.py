"""GPU node model + gang scheduler.

The port's counterpart of ``kubeflow_tpu/scheduler/topology.py``.  Upstream
analogue (UNVERIFIED, SURVEY.md §2c): volcano ``PodGroup`` gang scheduling
used by training-operator (``RunPolicy.SchedulingPolicy``), plus the NVIDIA
device plugin's conventions (the ``nvidia.com/gpu`` extended resource and
GPU feature discovery's ``nvidia.com/gpu.product`` / ``gpu.count`` node
labels).

What differs from the JAX module:

* The accelerator is ``nvidia.com/gpu``.  ``make_gpu_node`` creates one Node
  that advertises ``count`` cards and carries the card's product name; it
  takes the place of ``make_tpu_slice``.
* On binding, the scheduler records which card indices the pod holds (the
  ``scheduling.kubeflow.org/gpu-indices`` annotation, lowest free first,
  distinct per pod on one node); the kubelet hands them to the pod's
  process as ``CUDA_VISIBLE_DEVICES`` (core/kubelet.py).
* TPU slices, ICI topology labels and multislice have no counterpart.  A
  pod that requests ``google.com/tpu`` or selects a TPU label is refused:
  it stays Pending with a ``FailedScheduling`` event naming the missing
  item, and is never bound to a node without the resource.

Resource accounting (requests against capacity, init containers max'd) and
PodGroup gang semantics (all-or-nothing, ``minMember``) are the JAX
module's.
"""

from __future__ import annotations

from typing import Optional

from ..core.api import APIServer, CRD, Obj
from ..core.events import EventRecorder

GROUP = "scheduling.kubeflow.org"
POD_GROUP_LABEL = f"{GROUP}/pod-group"
GPU_RESOURCE = "nvidia.com/gpu"
GPU_PRODUCT_LABEL = "nvidia.com/gpu.product"
GPU_COUNT_LABEL = "nvidia.com/gpu.count"
# the card indices a bound pod holds on its node, e.g. "0" or "0,1"
GPU_INDICES_ANNOTATION = f"{GROUP}/gpu-indices"

# what the JAX scheduler places and this one refuses
TPU_RESOURCE = "google.com/tpu"
TPU_LABELS = ("cloud.google.com/gke-tpu-topology", "cloud.google.com/gke-tpu-accelerator",
              f"{GROUP}/tpu-slice", f"{GROUP}/tpu-host-index", f"{GROUP}/tpu-slice-group")

# accelerator names -> the product label GPU feature discovery writes
GPU_PRODUCTS = {"h100": "NVIDIA-H100-80GB-HBM3"}


def register(api: APIServer) -> None:
    api.register_crd(
        CRD(group=GROUP, version="v1", kind="PodGroup", plural="podgroups")
    )


def make_gpu_node(
    api: APIServer,
    name: str,
    accelerator: str = "h100",
    count: int = 1,
    cpu: float = 32.0,
    memory: float = 384 * 2**30,
) -> str:
    """Create one Node holding ``count`` cards of ``accelerator`` (a key of
    ``GPU_PRODUCTS``)."""
    if count < 1:
        raise ValueError(f"GPU node {name!r}: count must be >= 1, got {count}")
    product = GPU_PRODUCTS[accelerator]
    api.create(
        {
            "apiVersion": "v1",
            "kind": "Node",
            "metadata": {
                "name": name,
                "labels": {
                    "kubernetes.io/hostname": name,
                    GPU_PRODUCT_LABEL: product,
                    GPU_COUNT_LABEL: str(count),
                },
            },
            "status": {
                "phase": "Ready",
                "capacity": {"cpu": cpu, "memory": memory, GPU_RESOURCE: count},
            },
        }
    )
    return name


def make_cpu_node(api: APIServer, name: str, cpu: float = 64.0, memory: float = 128 * 2**30) -> str:
    api.create(
        {
            "apiVersion": "v1",
            "kind": "Node",
            "metadata": {"name": name, "labels": {"kubernetes.io/hostname": name}},
            "status": {"phase": "Ready", "capacity": {"cpu": cpu, "memory": memory}},
        }
    )
    return name


# --------------------------------------------------------------------- parse

def parse_quantity(q) -> float:
    """Parse k8s resource quantities: 500m, 2, 1Gi, 1.5G, 4Ki…"""
    if isinstance(q, (int, float)):
        return float(q)
    s = str(q).strip()
    suffixes = {
        "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50,
        "k": 1e3, "K": 1e3, "M": 1e6, "G": 1e9, "T": 1e12,
    }
    if s.endswith("m"):
        return float(s[:-1]) / 1000.0
    for suf, mult in suffixes.items():
        if s.endswith(suf):
            return float(s[: -len(suf)]) * mult
    return float(s)


def pod_requests(pod: Obj) -> dict[str, float]:
    """Effective pod requests: sum over containers, max'd with each init
    container (init containers run alone, k8s semantics)."""
    spec = pod.get("spec", {})

    def container_req(c: dict) -> dict[str, float]:
        res = c.get("resources", {})
        req = res.get("requests") or res.get("limits") or {}
        return {k: parse_quantity(v) for k, v in req.items()}

    total: dict[str, float] = {}
    for c in spec.get("containers", []):
        for k, v in container_req(c).items():
            total[k] = total.get(k, 0.0) + v
    for c in spec.get("initContainers", []):
        for k, v in container_req(c).items():
            total[k] = max(total.get(k, 0.0), v)
    return total


def gpu_indices(pod: Obj) -> list[int]:
    """The card indices the scheduler bound ``pod`` to (empty: none)."""
    raw = pod["metadata"].get("annotations", {}).get(GPU_INDICES_ANNOTATION, "")
    return [int(x) for x in raw.split(",") if x.strip()]


def tpu_refusal(pod: Obj) -> Optional[str]:
    """Why ``pod`` cannot be placed on any node here, or None: a TPU
    request or a TPU label in its node selector."""
    if pod_requests(pod).get(TPU_RESOURCE, 0) > 0:
        return (f"no node offers {TPU_RESOURCE}: TPU slices have no counterpart "
                f"on this cluster; request {GPU_RESOURCE}")
    sel = pod.get("spec", {}).get("nodeSelector") or {}
    for label in TPU_LABELS:
        if label in sel:
            return (f"no node carries the TPU label {label}: TPU topologies have "
                    "no counterpart on this cluster")
    return None


# ----------------------------------------------------------------- scheduler

class TopologyScheduler:
    """Binds pods to nodes and cards; gang groups bind all-or-nothing."""

    def __init__(self, api: APIServer):
        self.api = api
        self.recorder = EventRecorder(api, "gpu-scheduler")

    # -- resource accounting

    def _free(self) -> dict[str, dict[str, float]]:
        nodes = {n["metadata"]["name"]: dict(n.get("status", {}).get("capacity", {})) for n in self.api.list("Node")}
        for name in nodes:
            nodes[name] = {k: parse_quantity(v) for k, v in nodes[name].items()}
        for pod in self.api.list("Pod"):
            node = pod.get("spec", {}).get("nodeName")
            phase = pod.get("status", {}).get("phase", "Pending")
            if node in nodes and phase not in ("Succeeded", "Failed"):
                for k, v in pod_requests(pod).items():
                    nodes[node][k] = nodes[node].get(k, 0.0) - v
        return nodes

    def _free_cards(self, nodes: dict) -> dict[str, list[int]]:
        """Each node's card indices that no live pod holds, ascending."""
        held: dict[str, set] = {name: set() for name in nodes}
        for pod in self.api.list("Pod"):
            node = pod.get("spec", {}).get("nodeName")
            phase = pod.get("status", {}).get("phase", "Pending")
            if node in held and phase not in ("Succeeded", "Failed"):
                held[node].update(gpu_indices(pod))
        out = {}
        for name, n in nodes.items():
            count = int(parse_quantity(n.get("status", {}).get("capacity", {}).get(GPU_RESOURCE, 0)))
            out[name] = [i for i in range(count) if i not in held[name]]
        return out

    @staticmethod
    def _fits(requests: dict, free: dict) -> bool:
        return all(free.get(k, 0.0) >= v - 1e-9 for k, v in requests.items())

    def _node_matches(self, pod: Obj, node: Obj) -> bool:
        sel = pod.get("spec", {}).get("nodeSelector")
        if not sel:
            return True
        labels = node["metadata"].get("labels", {})
        return all(labels.get(k) == v for k, v in sel.items())

    @staticmethod
    def _take_cards(req: dict, cards: list) -> Optional[list]:
        """The lowest free indices for the pod's card request, taken out of
        ``cards``, or None (``cards`` untouched) when too few are free."""
        n = int(round(req.get(GPU_RESOURCE, 0)))
        if n > len(cards):
            return None
        taken = cards[:n]
        del cards[:n]
        return taken

    # -- main sync

    def sync(self) -> bool:
        changed = False
        pending = [
            p
            for p in self.api.list("Pod")
            if not p.get("spec", {}).get("nodeName")
            and p.get("status", {}).get("phase", "Pending") == "Pending"
        ]
        if not pending:
            return False
        free = self._free()
        nodes = {n["metadata"]["name"]: n for n in self.api.list("Node")}
        cards = self._free_cards(nodes)

        singles = [p for p in pending if POD_GROUP_LABEL not in p["metadata"].get("labels", {})]
        groups: dict[tuple[str, str], list[Obj]] = {}
        for p in pending:
            g = p["metadata"].get("labels", {}).get(POD_GROUP_LABEL)
            if g:
                groups.setdefault((p["metadata"].get("namespace", "default"), g), []).append(p)

        for pod in singles:
            if self._bind_one(pod, nodes, free, cards):
                changed = True

        for (ns, gname), pods in groups.items():
            if self._bind_gang(ns, gname, pods, nodes, free, cards):
                changed = True
        return changed

    def _bind_one(self, pod: Obj, nodes: dict, free: dict, cards: dict) -> bool:
        refusal = tpu_refusal(pod)
        if refusal is not None:
            self.recorder.warning(pod, "FailedScheduling", refusal)
            return False
        req = pod_requests(pod)
        for name in sorted(nodes):
            if not self._node_matches(pod, nodes[name]):
                continue
            if self._fits(req, free[name]):
                taken = self._take_cards(req, cards[name])
                if taken is None:
                    continue
                self._bind(pod, name, taken)
                for k, v in req.items():
                    free[name][k] = free[name].get(k, 0.0) - v
                return True
        self.recorder.warning(pod, "FailedScheduling",
                              "no node with sufficient resources" + self._shortfall(req, free))
        return False

    @staticmethod
    def _shortfall(req: dict, free: dict) -> str:
        """``: insufficient <resource> (requested r, most free f)`` for each
        resource no node has enough of ('' when the selector is at fault)."""
        short = []
        for k, v in sorted(req.items()):
            most = max((f.get(k, 0.0) for f in free.values()), default=0.0)
            if most < v - 1e-9:
                short.append(f"insufficient {k} (requested {v:g}, most free {max(most, 0.0):g})")
        return (": " + "; ".join(short)) if short else ""

    def _bind_gang(self, ns: str, gname: str, pods: list[Obj], nodes: dict, free: dict,
                   cards: dict) -> bool:
        pg = self.api.try_get("PodGroup", gname, ns)
        min_member = pg["spec"].get("minMember", len(pods)) if pg else len(pods)
        if len(pods) < min_member:
            return False  # gang not fully created yet

        pods = sorted(pods, key=lambda p: p["metadata"]["name"])
        refusals = [(p, r) for p in pods if (r := tpu_refusal(p)) is not None]
        for pod, refusal in refusals:
            self.recorder.warning(pod, "FailedScheduling", refusal)
        assignment = None if refusals else self._plan_gang(pods, nodes, free, cards)
        if assignment is None:
            if pg:
                pgc = dict(pg)
                pgc.setdefault("status", {})["phase"] = "Pending"
                self.api.update_status(pgc)
                why = refusals[0][1] if refusals else "no feasible all-or-nothing placement"
                self.recorder.warning(pg, "Unschedulable", f"gang {gname}: {why}")
            return False
        for pod, node, taken in assignment:
            self._bind(pod, node, taken)
            for k, v in pod_requests(pod).items():
                free[node][k] = free[node].get(k, 0.0) - v
            cards[node] = [i for i in cards[node] if i not in taken]
        if pg:
            pgc = dict(pg)
            pgc.setdefault("status", {})["phase"] = "Running"
            self.api.update_status(pgc)
        return True

    def _plan_gang(
        self, pods: list[Obj], nodes: dict, free: dict, cards: dict
    ) -> Optional[list[tuple[Obj, str, list]]]:
        """All-or-nothing placement: every pod of the gang on a node that
        fits it, cards included, or none."""
        trial_free = {n: dict(f) for n, f in free.items()}
        trial_cards = {n: list(c) for n, c in cards.items()}
        assignment: list[tuple[Obj, str, list]] = []
        for pod in pods:
            req = pod_requests(pod)
            for name in sorted(nodes):
                if not (self._node_matches(pod, nodes[name])
                        and self._fits(req, trial_free[name])):
                    continue
                taken = self._take_cards(req, trial_cards[name])
                if taken is None:
                    continue
                assignment.append((pod, name, taken))
                for k, v in req.items():
                    trial_free[name][k] = trial_free[name].get(k, 0.0) - v
                break
            else:
                return None
        return assignment

    def _bind(self, pod: Obj, node: str, cards: list) -> None:
        patch: dict = {"spec": {"nodeName": node}}
        if cards:
            patch["metadata"] = {"annotations": {
                GPU_INDICES_ANNOTATION: ",".join(str(i) for i in cards)}}
        self.api.patch("Pod", pod["metadata"]["name"], patch, pod["metadata"].get("namespace", "default"))
