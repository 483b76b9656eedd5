"""Port parity: the port's KServe control plane against the JAX package's.

The same InferenceService, canary and InferenceGraph manifests go through
both control planes (each its own in-process cluster whose pods are real
processes).  The Deployment, Pod and Service objects they make, and the
sequence of the InferenceService's (or graph's) condition states, must be
equal once the run-specific values are masked (uids, ports, timestamps and
the template hash over them) and the documented differences are mapped
back:
  * the command module: ``kubeflow_tpu_torch.serving.runtime_main`` and
    ``kubeflow_tpu_torch.serving.storage`` (``kubeflow_tpu.…`` in JAX);
  * the accelerator resource: ``nvidia.com/gpu`` (``google.com/tpu``);
  * the storage module's mount root (the port's is under the process's
    temporary directory).

Then the port's GPU scheduler on its own: capacity accounting, distinct
``CUDA_VISIBLE_DEVICES`` per pod on a 2-card node, Pending with an event
when the cards are taken, a freed card going to the next pod, gangs
all-or-nothing, and the refusal of ``google.com/tpu`` requests and TPU
labels; and on CPU-only pods, bindings equal to the JAX scheduler's."""

import json
import os
import re
import sys

import pytest

from kubeflow_tpu.core import api as japi
from kubeflow_tpu.core.cluster import Cluster as JCluster
from kubeflow_tpu.scheduler import topology as jtopo
from kubeflow_tpu.serving import install as jinstall
from kubeflow_tpu.serving import runtimes as jruntimes
from kubeflow_tpu.serving import storage as jstorage
from kubeflow_tpu.serving.api import inference_service
from kubeflow_tpu.serving.graph import inference_graph
from kubeflow_tpu_torch.core import api as tapi
from kubeflow_tpu_torch.core.cluster import Cluster as TCluster
from kubeflow_tpu_torch.core.events import events_for
from kubeflow_tpu_torch.scheduler import topology as ttopo
from kubeflow_tpu_torch.serving import install as tinstall
from kubeflow_tpu_torch.serving import runtimes as truntimes
from kubeflow_tpu_torch.serving import storage as tstorage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLANES = {"jax": (JCluster, jinstall), "port": (TCluster, tinstall)}
# run-specific values: masked before the comparison
_VOLATILE_KEYS = {"uid", "creationTimestamp", "resourceVersion", "startTime",
                  "lastUpdateTime", "lastTransitionTime", "firstTimestamp"}
_HEX32 = re.compile(r"[0-9a-f]{32}")
PORT_KEYS = ("serving.kubeflow.org/port", "serving.kubeflow.org/proxy-port")


def _ports(objs: dict) -> set:
    """Every port the control plane allocated in this run."""
    out = set()
    for kind in ("Pod", "Service"):
        for o in objs[kind]:
            for key in PORT_KEYS:
                v = o["metadata"].get("annotations", {}).get(key)
                if v:
                    out.add(str(v))
    return out


def _normalize(node, ports: set, port_plane: bool):
    """``node`` with run-specific values masked and, for the port's
    objects, the documented differences mapped to the JAX package's."""
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            if k in _VOLATILE_KEYS:
                continue
            if k == "serving.kubeflow.org/template-hash":
                v = "<hash>"
            if port_plane and k == ttopo.GPU_RESOURCE:
                k = jtopo.TPU_RESOURCE
            out[k] = _normalize(v, ports, port_plane)
        return out
    if isinstance(node, list):
        return [_normalize(x, ports, port_plane) for x in node]
    if isinstance(node, int) and not isinstance(node, bool) and str(node) in ports:
        return "<port>"
    if isinstance(node, str):
        if port_plane:
            node = node.replace("kubeflow_tpu_torch.", "kubeflow_tpu.")
            node = node.replace(tstorage.MOUNT_PATH, jstorage.MOUNT_PATH)
        node = _HEX32.sub("<uid>", node)
        for p in ports:
            node = re.sub(rf"\b{p}\b", "<port>", node)
        return node
    return node


def _snapshot(c, port_plane: bool) -> dict:
    objs = {k: sorted(c.api.list(k), key=lambda o: o["metadata"]["name"])
            for k in ("Deployment", "Pod", "Service")}
    ports = _ports(objs)
    return {k: _normalize(v, ports, port_plane) for k, v in objs.items()}


class _Conditions:
    """The distinct condition states of one kind's objects, in order."""

    def __init__(self, api, kind: str):
        self.watch = api.watch(kind)
        self.seq: dict = {}

    def read(self) -> dict:
        while (ev := self.watch.poll()) is not None:
            name = ev.object["metadata"]["name"]
            state = tuple((x["type"], x["status"], x.get("reason", ""))
                          for x in ev.object.get("status", {}).get("conditions", []))
            seq = self.seq.setdefault(name, [])
            if not seq or seq[-1] != state:
                seq.append(state)
        return {k: list(v) for k, v in sorted(self.seq.items())}


def _ready(c, kind: str, name: str) -> bool:
    st = (c.api.try_get(kind, name) or {}).get("status", {})
    return any(x["type"] == "Ready" and x["status"] == "True"
               for x in st.get("conditions", []))


def _debug(c) -> str:
    pods = [(p["metadata"]["name"], p.get("status", {}).get("phase"),
             c.logs(p["metadata"]["name"])[-400:]) for p in c.api.list("Pod")]
    return f"pods={pods}"


def _pyfunc(root, name: str, factor: int) -> str:
    d = os.path.join(str(root), name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "model.py"), "w") as f:
        f.write("def predict(instances):\n"
                "    if isinstance(instances, dict) and 'predictions' in instances:\n"
                "        instances = instances['predictions']\n"
                f"    return [x * {factor} for x in instances]\n")
    return d


# each flow drives one cluster through a manifest's life and returns what
# the comparison reads: snapshots at its stable points and the conditions

def _flow_llama(c, router, root):
    """A catalog ``llama`` ISVC on a cluster with no accelerator node: the
    pod stays Pending in both planes (requests TPU / GPU)."""
    d = os.path.join(str(root), "llm")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"vocab_size": 64, "d_model": 32, "n_layers": 1, "n_heads": 2,
                   "n_kv_heads": 1, "d_ff": 64}, f)
    conds = _Conditions(c.api, "InferenceService")
    c.apply(inference_service("llm", model_format="llama", storage_uri=f"file://{d}"))

    def pending_pod():
        pods = c.api.list("Pod")
        return bool(pods) and all(not p["spec"].get("nodeName") for p in pods)
    assert c.wait_for(pending_pod, timeout=20)
    c.settle(quiet=0.3, timeout=10)
    pods = c.api.list("Pod")
    assert all(p.get("status", {}).get("phase", "Pending") == "Pending" for p in pods)
    return conds


def _flow_canary(c, router, root):
    """Roll out v1, a 30% canary of v2 (both revisions Ready, 30 of 100
    requests on v2), then promote v2 (v1's revision collected)."""
    old, new = _pyfunc(root, "old", 2), _pyfunc(root, "new", 10)
    conds = _Conditions(c.api, "InferenceService")
    c.apply(inference_service("canary", model_format="pyfunc", storage_uri=f"file://{old}"))
    assert c.wait_for(lambda: _ready(c, "InferenceService", "canary"), timeout=60), _debug(c)
    c.settle(quiet=0.3, timeout=10)
    c.apply(inference_service("canary", model_format="pyfunc", storage_uri=f"file://{new}",
                              canary_traffic_percent=30))

    def both_ready():
        isvc = c.api.try_get("InferenceService", "canary")
        tr = (isvc or {}).get("status", {}).get("components", {}).get("predictor", {}).get("traffic", [])
        deploys = c.api.list("Deployment")
        return len(tr) == 2 and len(deploys) == 2 and all(
            d.get("status", {}).get("readyReplicas", 0) >= 1 for d in deploys)
    assert c.wait_for(both_ready, timeout=60), _debug(c)
    c.settle(quiet=0.3, timeout=10)
    hits = [router.predict("canary", {"instances": [1]})["predictions"][0] for _ in range(100)]
    assert hits.count(10) == 30 and hits.count(2) == 70
    c.apply(inference_service("canary", model_format="pyfunc", storage_uri=f"file://{new}"))

    def promoted():
        deploys = c.api.list("Deployment")
        return len(deploys) == 1 and deploys[0].get("status", {}).get("readyReplicas", 0) >= 1
    assert c.wait_for(promoted, timeout=60), _debug(c)
    c.settle(quiet=0.3, timeout=10)
    return conds


def _flow_graph(c, router, root):
    """Two pyfunc ISVCs and an InferenceGraph (Switch over a Sequence and
    an Ensemble) reaching Ready."""
    conds = _Conditions(c.api, "InferenceGraph")
    for name, factor in (("dbl", 2), ("trp", 3)):
        c.apply(inference_service(name, model_format="pyfunc",
                                  storage_uri=f"file://{_pyfunc(root, name, factor)}"))
    c.apply(inference_graph("g", {
        "root": {"routerType": "Switch", "steps": [
            {"condition": "mode == \"chain\"", "nodeName": "chain"},
            {"serviceName": "dbl"}]},
        "chain": {"routerType": "Sequence", "steps": [
            {"serviceName": "dbl"}, {"serviceName": "trp"}]},
    }))
    assert c.wait_for(lambda: _ready(c, "InferenceGraph", "g"), timeout=60), _debug(c)
    c.settle(quiet=0.3, timeout=10)
    return conds


FLOWS = {"isvc_llama": _flow_llama, "canary": _flow_canary, "graph": _flow_graph}


def _run_flow(plane: str, flow, root) -> tuple:
    """Drive ``flow`` on a fresh cluster of ``plane``: the snapshots taken
    where it settles, the condition states and the InferenceGraphs."""
    Cluster, install = PLANES[plane]
    c = Cluster(cpu_nodes=1, base_env={"PYTHONPATH": REPO})
    router, proxy = install(c.api, c.manager)
    try:
        rec = _Recorder(c, plane == "port")
        conds = flow(rec, router, root)
        graphs = [_normalize(g, set(), plane == "port") for g in c.api.list("InferenceGraph")]
        return rec.snaps, conds.read(), graphs
    finally:
        proxy.shutdown()
        c.shutdown()


class _Recorder:
    """The cluster, with ``settle`` snapshotting it once settled: a flow's
    stable points are where it settles."""

    def __init__(self, c, port_plane: bool):
        self._c, self._port = c, port_plane
        self.api = c.api
        self.snaps: list = []

    def __getattr__(self, name):
        return getattr(self._c, name)

    def settle(self, quiet=0.2, timeout=30.0):
        self._c.settle(quiet=quiet, timeout=timeout)
        self.snaps.append(_snapshot(self._c, self._port))


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_manifests_make_the_same_objects_in_both_control_planes(flow, tmp_path):
    got = {}
    for plane in ("jax", "port"):
        got[plane] = _run_flow(plane, FLOWS[flow], tmp_path)
    (jsnaps, jconds, jgraphs), (tsnaps, tconds, tgraphs) = got["jax"], got["port"]
    assert jsnaps and len(tsnaps) == len(jsnaps)
    for stage, (t, j) in enumerate(zip(tsnaps, jsnaps)):
        for kind in ("Deployment", "Pod", "Service"):
            assert t[kind] == j[kind], (flow, stage, kind)
    assert tconds == jconds
    assert tgraphs == jgraphs
    assert jconds, "no condition recorded"
    if flow == "isvc_llama":  # the port's pod asked for a GPU (mapped above)
        pod = tsnaps[0]["Pod"][0]
        assert pod["spec"]["containers"][0]["resources"]["requests"] == {"google.com/tpu": 1}


def test_runtime_catalog_differs_only_where_documented():
    """The same runtime names, formats and priorities; the port's commands
    name its runtime module and its accelerator requests are GPUs."""
    jcat = {r["metadata"]["name"]: r for r in jruntimes.default_runtimes()}
    tcat = {r["metadata"]["name"]: r for r in truntimes.default_runtimes()}
    assert list(tcat) == list(jcat)
    gpu = set()
    for name, t in tcat.items():
        j = jcat[name]
        assert t["spec"]["supportedModelFormats"] == j["spec"]["supportedModelFormats"]
        assert t["spec"]["priority"] == j["spec"]["priority"]
        tc, jc = t["spec"]["containers"][0], j["spec"]["containers"][0]
        assert tc["command"][1:] == ["-m", "kubeflow_tpu_torch.serving.runtime_main"]
        assert jc["command"][1:] == ["-m", "kubeflow_tpu.serving.runtime_main"]
        assert tc["args"] == jc["args"]
        jreq = jc.get("resources", {}).get("requests", {})
        treq = tc.get("resources", {}).get("requests", {})
        assert treq == ({"nvidia.com/gpu": 1} if jreq == {"google.com/tpu": 1} else jreq)
        if treq:
            gpu.add(name)
    assert {"kserve-jetstream", "kserve-jax"} <= gpu
    # format auto-selection is the JAX catalog's
    for fmt in ("llama", "gemma", "jax-lm", "jax", "sklearn", "pyfunc", "explainer"):
        ja, ta = japi.APIServer(), tapi.APIServer()
        from kubeflow_tpu.serving import api as jsapi
        from kubeflow_tpu_torch.serving import api as tsapi
        jsapi.register(ja)
        tsapi.register(ta)
        jruntimes.install_default_runtimes(ja)
        truntimes.install_default_runtimes(ta)
        m = {"modelFormat": {"name": fmt}}
        assert (truntimes.select_runtime(ta, "default", m)["metadata"]["name"]
                == jruntimes.select_runtime(ja, "default", m)["metadata"]["name"])


# ------------------------------------------------------------ GPU scheduler


def _gpu_pod(name: str, cards: int = 1, extra: dict = None, group: str = None,
             code: str = "import time; time.sleep(60)") -> dict:
    pod = {"apiVersion": "v1", "kind": "Pod",
           "metadata": {"name": name, "labels": {}},
           "spec": {"restartPolicy": "Never", "containers": [{
               "name": "main", "command": [sys.executable, "-u", "-c", code],
               "resources": {"requests": {"nvidia.com/gpu": cards, **(extra or {})}}}]}}
    if group:
        pod["metadata"]["labels"][ttopo.POD_GROUP_LABEL] = group
    return pod


def _bound(api, name: str):
    return (api.try_get("Pod", name) or {}).get("spec", {}).get("nodeName")


def _warnings(c, name: str) -> list:
    pod = c.api.get("Pod", name)
    return [e["message"] for e in events_for(c.api, pod) if e["reason"] == "FailedScheduling"]


PRINT_CARDS = ("import os, sys, time; print('CVD=' + os.environ.get("
               "'CUDA_VISIBLE_DEVICES', '<unset>')); sys.stdout.flush(); time.sleep(60)")


def test_gpu_node_advertises_its_cards():
    api = tapi.APIServer()
    name = ttopo.make_gpu_node(api, "g0", "h100", 2)
    node = api.get("Node", name)
    assert node["status"]["capacity"]["nvidia.com/gpu"] == 2
    assert node["metadata"]["labels"]["nvidia.com/gpu.product"] == "NVIDIA-H100-80GB-HBM3"
    assert node["metadata"]["labels"]["nvidia.com/gpu.count"] == "2"
    with pytest.raises(ValueError):
        ttopo.make_gpu_node(api, "g1", "h100", 0)


def test_two_card_node_gives_each_pod_its_own_card_then_pends():
    c = TCluster(cpu_nodes=1, gpu_nodes=(("g0", "h100", 2),))
    try:
        for name in ("a", "b", "c"):
            c.api.create(_gpu_pod(name, code=PRINT_CARDS))
        assert c.wait_for(lambda: _bound(c.api, "a") and _bound(c.api, "b"), timeout=20)
        c.settle(quiet=0.3, timeout=10)
        assert _bound(c.api, "a") == _bound(c.api, "b") == "g0"
        assert not _bound(c.api, "c")  # both cards taken: Pending, never on cpu-0
        assert any("insufficient nvidia.com/gpu" in m for m in _warnings(c, "c"))

        def printed(name):
            return "CVD=" in c.logs(name)
        assert c.wait_for(lambda: printed("a") and printed("b"), timeout=30), _debug(c)
        seen = {n: re.search(r"CVD=(\S+)", c.logs(n)).group(1) for n in ("a", "b")}
        assert sorted(seen.values()) == ["0", "1"]
        idx = {n: ttopo.gpu_indices(c.api.get("Pod", n)) for n in ("a", "b")}
        assert {n: ",".join(map(str, v)) for n, v in idx.items()} == seen

        # a freed card goes to the pending pod, with the freed index
        freed = "a"
        c.api.delete("Pod", freed)
        assert c.wait_for(lambda: _bound(c.api, "c") == "g0", timeout=20)
        assert c.wait_for(lambda: printed("c"), timeout=30), _debug(c)
        assert re.search(r"CVD=(\S+)", c.logs("c")).group(1) == seen[freed]
    finally:
        c.shutdown()


PRINT_CARDS_REPR = ("import os, sys, time; print('CVD=' + repr(os.environ.get("
                    "'CUDA_VISIBLE_DEVICES'))); sys.stdout.flush(); time.sleep(60)")


def test_cards_map_through_the_parents_devices_and_cardless_pods_see_none():
    """Node card ``i`` is the ``i``-th card the cluster's process sees; a
    pod that asks for no card gets ``CUDA_VISIBLE_DEVICES=""``."""
    c = TCluster(cpu_nodes=1, gpu_nodes=(("g0", "h100", 2),),
                 base_env={"CUDA_VISIBLE_DEVICES": "5,7"})
    try:
        c.api.create(_gpu_pod("a", code=PRINT_CARDS_REPR))
        cpu = _gpu_pod("z", code=PRINT_CARDS_REPR)
        del cpu["spec"]["containers"][0]["resources"]
        c.api.create(cpu)

        def printed(name):
            return "CVD=" in c.logs(name)
        assert c.wait_for(lambda: printed("a") and printed("z"), timeout=30), _debug(c)
        (idx,) = ttopo.gpu_indices(c.api.get("Pod", "a"))
        assert re.search(r"CVD=(\S+)", c.logs("a")).group(1) == repr(["5", "7"][idx])
        assert re.search(r"CVD=(\S+)", c.logs("z")).group(1) == "''"
    finally:
        c.shutdown()


def test_payload_logger_default_lies_under_the_temp_dir():
    import tempfile

    from kubeflow_tpu_torch.serving.controllers import InferenceServiceReconciler
    from kubeflow_tpu_torch.serving import api as tsapi
    api = tapi.APIServer()
    tsapi.register(api)
    truntimes.install_default_runtimes(api)
    isvc = tsapi.inference_service("logged", model_format="sklearn", storage_uri="file:///m")
    isvc["metadata"]["uid"] = "u" * 32
    cspec = dict(isvc["spec"]["predictor"], logger={})
    spec = InferenceServiceReconciler(api)._render_pod_spec(isvc, "predictor", cspec, None)
    env = {e["name"]: e["value"] for e in spec["containers"][0]["env"]}
    assert env["LOGGER_PATH"] == os.path.join(
        tempfile.gettempdir(), "logged-predictor-payload.jsonl")


def test_gpu_capacity_accounting_counts_requests_not_pods():
    """A 2-card pod takes both cards of a 2-card node ("0,1"); a 3-card
    pod fits nowhere; cpu and memory are still counted."""
    api = tapi.APIServer()
    ttopo.register(api)
    ttopo.make_gpu_node(api, "g0", "h100", 2, cpu=4.0)
    ttopo.make_cpu_node(api, "cpu-0")
    sched = ttopo.TopologyScheduler(api)
    api.create(_gpu_pod("big", cards=3))
    api.create(_gpu_pod("two", cards=2, extra={"cpu": "3"}))
    api.create(_gpu_pod("more-cpu", cards=0, extra={"cpu": "2"}))
    sched.sync()
    assert not _bound(api, "big")
    assert _bound(api, "two") == "g0"
    assert api.get("Pod", "two")["metadata"]["annotations"][ttopo.GPU_INDICES_ANNOTATION] == "0,1"
    # 1 cpu left on g0: the 2-cpu pod lands on the CPU node, and holds no card
    assert _bound(api, "more-cpu") == "cpu-0"
    assert ttopo.gpu_indices(api.get("Pod", "more-cpu")) == []
    msgs = [e["message"] for e in events_for(api, api.get("Pod", "big"))]
    assert any("requested 3, most free 2" in m for m in msgs), msgs


@pytest.mark.parametrize("why", ["resource", "topology_label", "slice_label"])
def test_tpu_requests_are_refused_not_misplaced(why):
    api = tapi.APIServer()
    ttopo.register(api)
    ttopo.make_gpu_node(api, "g0", "h100", 1)
    ttopo.make_cpu_node(api, "cpu-0")
    pod = _gpu_pod("t", cards=0)
    if why == "resource":
        pod["spec"]["containers"][0]["resources"]["requests"] = {"google.com/tpu": 4}
        item = "google.com/tpu"
    else:
        item = {"topology_label": "cloud.google.com/gke-tpu-topology",
                "slice_label": "scheduling.kubeflow.org/tpu-slice"}[why]
        pod["spec"]["nodeSelector"] = {item: "2x2"}
    api.create(pod)
    sched = ttopo.TopologyScheduler(api)
    for _ in range(3):
        assert sched.sync() is False
    assert not _bound(api, "t")
    msgs = [e["message"] for e in events_for(api, api.get("Pod", "t"))
            if e["reason"] == "FailedScheduling"]
    assert msgs and all(item in m for m in msgs)


def test_gpu_gang_binds_all_or_nothing():
    api = tapi.APIServer()
    ttopo.register(api)
    ttopo.make_gpu_node(api, "g0", "h100", 2)
    api.create({"apiVersion": f"{ttopo.GROUP}/v1", "kind": "PodGroup",
                "metadata": {"name": "big", "namespace": "default"}, "spec": {"minMember": 3}})
    for i in range(3):
        api.create(_gpu_pod(f"big-{i}", group="big"))
    sched = ttopo.TopologyScheduler(api)
    sched.sync()
    assert not any(_bound(api, f"big-{i}") for i in range(3))
    pg = api.get("PodGroup", "big")
    assert pg["status"]["phase"] == "Pending"
    assert any(e["reason"] == "Unschedulable" for e in events_for(api, pg))
    # a gang that fits binds whole, each member its own card
    api.create({"apiVersion": f"{ttopo.GROUP}/v1", "kind": "PodGroup",
                "metadata": {"name": "duo", "namespace": "default"}, "spec": {"minMember": 2}})
    for i in range(2):
        api.create(_gpu_pod(f"duo-{i}", group="duo"))
    sched.sync()
    assert [_bound(api, f"duo-{i}") for i in range(2)] == ["g0", "g0"]
    assert sorted(ttopo.gpu_indices(api.get("Pod", f"duo-{i}"))[0] for i in range(2)) == [0, 1]
    assert api.get("PodGroup", "duo")["status"]["phase"] == "Running"
    # a gang with one TPU member stays whole and Pending, naming the item
    api.create({"apiVersion": f"{ttopo.GROUP}/v1", "kind": "PodGroup",
                "metadata": {"name": "mixed", "namespace": "default"}, "spec": {"minMember": 2}})
    api.create(_gpu_pod("mixed-0", cards=0, group="mixed"))
    tpu = _gpu_pod("mixed-1", cards=0, group="mixed")
    tpu["spec"]["containers"][0]["resources"]["requests"] = {"google.com/tpu": 1}
    api.create(tpu)
    sched.sync()
    assert not _bound(api, "mixed-0") and not _bound(api, "mixed-1")
    msgs = [e["message"] for e in events_for(api, api.get("PodGroup", "mixed"))]
    assert any("google.com/tpu" in m for m in msgs)


def _cpu_scenario(topo, api_mod, scenario: str) -> dict:
    """One CPU-only placement problem through ``topo``'s scheduler: node
    name -> the sorted pods bound there, and the unbound pods."""
    api = api_mod.APIServer()
    topo.register(api)
    topo.make_cpu_node(api, "n0", cpu=4.0, memory=8 * 2**30)
    topo.make_cpu_node(api, "n1", cpu=2.0, memory=16 * 2**30)

    def pod(name, cpu, mem="1Gi", group=None, init_cpu=None, selector=None):
        p = {"apiVersion": "v1", "kind": "Pod", "metadata": {"name": name, "labels": {}},
             "spec": {"containers": [{"name": "m", "command": ["true"],
                                      "resources": {"requests": {"cpu": cpu, "memory": mem}}}]}}
        if group:
            p["metadata"]["labels"][topo.POD_GROUP_LABEL] = group
        if init_cpu:
            p["spec"]["initContainers"] = [{"name": "i", "command": ["true"],
                                            "resources": {"requests": {"cpu": init_cpu}}}]
        if selector:
            p["spec"]["nodeSelector"] = selector
        api.create(p)

    if scenario == "fill":
        for i, cpu in enumerate(["1500m", "2", "1", "1", "500m", "1"]):
            pod(f"p{i}", cpu)
    elif scenario == "memory":
        for i, mem in enumerate(["6Gi", "6Gi", "10Gi", "4Gi"]):
            pod(f"p{i}", "100m", mem)
    elif scenario == "init_containers":
        pod("a", "1", init_cpu="3")
        pod("b", "2", init_cpu="1")
        pod("c", "1", init_cpu="4")
    elif scenario == "selector":
        pod("a", "1", selector={"kubernetes.io/hostname": "n1"})
        pod("b", "2", selector={"kubernetes.io/hostname": "n1"})
        pod("c", "1", selector={"kubernetes.io/hostname": "nope"})
    elif scenario == "gangs":
        for g, n, cpu in (("g1", 2, "2"), ("g2", 3, "1"), ("g3", 2, "3")):
            api.create({"apiVersion": f"{topo.GROUP}/v1", "kind": "PodGroup",
                        "metadata": {"name": g, "namespace": "default"},
                        "spec": {"minMember": n}})
            for i in range(n):
                pod(f"{g}-{i}", cpu, group=g)
    sched = topo.TopologyScheduler(api)
    for _ in range(3):
        sched.sync()
    out: dict = {}
    for p in api.list("Pod"):
        out.setdefault(p["spec"].get("nodeName") or "<pending>", []).append(p["metadata"]["name"])
    groups = {g["metadata"]["name"]: g.get("status", {}).get("phase") for g in api.list("PodGroup")}
    return {"nodes": {k: sorted(v) for k, v in sorted(out.items())}, "groups": groups}


@pytest.mark.parametrize("scenario", ["fill", "memory", "init_containers", "selector", "gangs"])
def test_cpu_placement_equals_the_jax_scheduler(scenario):
    got = _cpu_scenario(ttopo, tapi, scenario)
    assert got == _cpu_scenario(jtopo, japi, scenario)
    assert "<pending>" in got["nodes"] and len(got["nodes"]) > 1, got  # some fit, some not


def test_cluster_takes_gpu_nodes_in_place_of_tpu_slices():
    c = TCluster(cpu_nodes=1, gpu_nodes=(("g0", "h100", 1), ("g1", "h100", 2)))
    try:
        nodes = {n["metadata"]["name"]: n for n in c.api.list("Node")}
        assert set(nodes) == {"cpu-0", "g0", "g1"} and set(c.kubelets) == set(nodes)
        assert nodes["g1"]["status"]["capacity"]["nvidia.com/gpu"] == 2
        assert "nvidia.com/gpu" not in nodes["cpu-0"]["status"]["capacity"]
    finally:
        c.shutdown()
