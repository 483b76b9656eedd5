"""An InferenceService at ``tensor_parallel`` N on N cards of the port's plane.

A runtime that requests ``nvidia.com/gpu: 2`` (a namespace
``ServingRuntime``, the surface the JAX CRDs already have) gets its pod
bound to both cards of a 2-card GPU node; the kubelet hands the pod both
card indices as ``CUDA_VISIBLE_DEVICES``, and the pod's ``engine.json`` at
``tensor_parallel`` 2 serves one shard on the card of each entry
(``serve.shard_devices``).  The catalog's runtime requests one card, so a
pod of it refuses ``tensor_parallel`` 2 on the card, naming its file.

The CPU cases run here.  The ``cuda`` case serves the same InferenceService
on the card, both node cards mapped onto the test process's first card
(``"c,c"``), as chip_smoke.py's phase 6c does at Llama-3-8B width.  The file
imports neither JAX nor the JAX package, so the card case runs where only
the port's dependencies are:

    python -m pytest --noconftest -m cuda tests/test_torch_isvc_tensor_parallel.py
"""

import copy
import json
import os
import subprocess
import sys
import urllib.request

import pytest
import torch

from kubeflow_tpu_torch.core.cluster import Cluster
from kubeflow_tpu_torch.examples import serve_llm
from kubeflow_tpu_torch.scheduler.topology import GPU_INDICES_ANNOTATION
from kubeflow_tpu_torch.serving import install
from kubeflow_tpu_torch.serving.api import inference_service
from kubeflow_tpu_torch.serving.controllers import pod_port
from kubeflow_tpu_torch.serving.engine import serve as S
from kubeflow_tpu_torch.serving.engine.model import DecoderConfig
from kubeflow_tpu_torch.serving.runtimes import default_runtimes

TP = 2
RUNTIME = "jetstream-tp2"
PROMPT = "hello tpu"


def tp_runtime(cards: int = TP, namespace: str = "default") -> dict:
    """The catalog's ``kserve-jetstream`` as a namespace ``ServingRuntime``
    that requests ``cards`` cards."""
    rt = copy.deepcopy(next(r for r in default_runtimes()
                            if r["metadata"]["name"] == "kserve-jetstream"))
    rt["kind"] = "ServingRuntime"
    rt["metadata"] = {"name": RUNTIME, "namespace": namespace}
    for fmt in rt["spec"]["supportedModelFormats"]:
        fmt["autoSelect"] = False  # named by the model's runtime only
    rt["spec"]["containers"][0]["resources"] = {"requests": {"nvidia.com/gpu": cards}}
    return rt


def process_env(cluster, pod_name: str) -> dict:
    for kubelet in cluster.kubelets.values():
        for run in kubelet._runs.values():
            if run.name == pod_name and run.current is not None and not run.in_init:
                with open(f"/proc/{run.current.pid}/environ", "rb") as f:
                    return dict(kv.decode().split("=", 1)
                                for kv in f.read().split(b"\0") if b"=" in kv)
    return {}


def platform_of(pod: dict, name: str) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{pod_port(pod)}/engine/perf",
                                timeout=30) as r:
        return json.loads(r.read())["models"][name]["platform"]


@pytest.mark.parametrize("visible, want", [
    ("0,1", ["cuda:0", "cuda:1"]),
    ("0,0", ["cuda:0", "cuda:0"]),
    ("3, 2", ["cuda:0", "cuda:1"]),
    ("GPU-a,GPU-b,GPU-a", ["cuda:0", "cuda:1"]),
])
def test_shard_devices_follow_the_pods_cards(monkeypatch, visible, want):
    """Shard i on the card of the i-th entry, numbered as torch numbers the
    distinct entries; two node cards mapped onto one card share it."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    assert S.pod_cards() == [e.strip() for e in visible.split(",")]
    assert [str(d) for d in S.shard_devices(TP)] == want


def test_a_repeated_card_list_is_collapsed_before_cuda_starts():
    """Under ``"0,0"`` the CUDA runtime finds no card (``cudaGetDeviceCount``
    fails with error 101 on the H100): the process's first device
    resolution narrows the variable to ``"0"`` and ``pod_cards`` still
    counts two.  A list without repeats is left as it is."""
    code = ("import os\n"
            "from kubeflow_tpu_torch.utils import device\n"
            "try:\n"
            "    device.resolve_device('cuda')\n"
            "except RuntimeError:\n"
            "    pass  # no card in this build\n"
            "print(os.environ['CUDA_VISIBLE_DEVICES'], ','.join(device.pod_cards()))\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for given, want in (("0,0", "0 0,0"), ("3,3,5", "3,5 3,3,5"), ("0,1", "0,1 0,1")):
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             env={**os.environ, "CUDA_VISIBLE_DEVICES": given,
                                  "PYTHONPATH": repo}, timeout=120, check=True)
        assert out.stdout.split("\n")[-2] == want, out


def test_one_card_refuses_two_shards(monkeypatch, tmp_path):
    """A pod of the catalog's runtime holds one card: its engine.json at
    tensor_parallel 2 is refused on the card with the file named, and
    ``shard_devices`` refuses too."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        S.shard_devices(TP)
    model_dir = serve_llm.write_model_dir(str(tmp_path), tensor_parallel=TP)
    path = os.path.join(model_dir, "engine.json")
    with pytest.raises(ValueError) as e:
        S._engine_config(path, DecoderConfig.from_dir(model_dir), torch.device("cuda"))
    assert str(e.value) == (f"{path}: tensor_parallel=2 needs 2 devices, have 1 — "
                            "refusing to silently serve at a lower degree")
    # two entries serve two shards; the CPU takes any degree
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,0")
    S._engine_config(path, DecoderConfig.from_dir(model_dir), torch.device("cuda"))
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    S._engine_config(path, DecoderConfig.from_dir(model_dir), torch.device("cpu"))


def _serve_tp(tmp_path, base_env: dict) -> dict:
    """The InferenceService at tensor_parallel 2 through the port's plane on
    one CPU node and one GPU node of two cards; its pod's view and answer."""
    model_dir = serve_llm.write_model_dir(str(tmp_path), tensor_parallel=TP)
    cluster = Cluster(workdir=str(tmp_path / "cluster"), cpu_nodes=1,
                      gpu_nodes=(("g0", "h100", TP),), base_env=base_env)
    router, proxy = install(cluster.api, cluster.manager)
    try:
        cluster.api.create(tp_runtime())
        cluster.apply(inference_service("llm", model_format="llama", runtime=RUNTIME,
                                        storage_uri=f"file://{model_dir}"))
        def pod_log() -> str:
            pods = cluster.api.list("Pod")
            return cluster.logs(pods[0]["metadata"]["name"]) if pods else ""

        # Ready, or the pod's runtime died (a crash loop would wait it out)
        cluster.wait_for(lambda: serve_llm.isvc_ready(cluster.api, "llm")
                         or "Traceback" in pod_log(), timeout=300)
        assert serve_llm.isvc_ready(cluster.api, "llm"), pod_log()[-3000:]
        pod = cluster.api.list("Pod")[0]
        out = router.predict("llm", {"instances": [{"prompt": PROMPT, "max_tokens": 8}]})
        return {"node": pod["spec"]["nodeName"],
                "requests": pod["spec"]["containers"][0]["resources"]["requests"],
                "indices": pod["metadata"]["annotations"][GPU_INDICES_ANNOTATION],
                "env": process_env(cluster, pod["metadata"]["name"]),
                "platform": platform_of(pod, "llm"),
                "prediction": out["predictions"][0], "model_dir": model_dir}
    finally:
        proxy.shutdown()
        cluster.shutdown()


def test_two_card_runtime_binds_both_cards_and_serves_two_shards(tmp_path, monkeypatch):
    """On the CPU (``TORCH_DEVICE=cpu`` reaches the pod): the pod is bound to
    both cards of the node, sees ``CUDA_VISIBLE_DEVICES=0,1``, serves a
    two-shard engine, and answers with the tokens the same model dir gives
    in this process at tensor_parallel 2."""
    monkeypatch.setenv("TORCH_DEVICE", "cpu")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    got = _serve_tp(tmp_path, serve_llm.pod_env())
    assert got["node"] == "g0"
    assert got["requests"] == {"nvidia.com/gpu": TP}
    assert got["indices"] == "0,1"
    assert got["env"]["CUDA_VISIBLE_DEVICES"] == "0,1"
    assert got["platform"] == f"cpux{TP}"
    local = S.JetStreamModel("llm", got["model_dir"], device="cpu")
    local.load()
    try:
        assert local.engine.stats["tensor_parallel"] == TP
        want = local.predict({"instances": [{"prompt": PROMPT, "max_tokens": 8}]})
    finally:
        local.engine.stop()
    assert got["prediction"]["tokens"] == 8
    assert got["prediction"]["text"] == want[0]["text"]


@pytest.mark.cuda
def test_two_shards_serve_on_the_card(tmp_path, monkeypatch):
    """On the card: both node cards mapped onto this process's first card;
    the pod holds ``"c,c"``, serves two shards there and answers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pod's engine takes the card or raises")
    monkeypatch.delenv("TORCH_DEVICE", raising=False)  # the pod must take the card
    parent = os.environ.get("CUDA_VISIBLE_DEVICES")
    card = parent.split(",")[0].strip() if parent else "0"
    got = _serve_tp(tmp_path, {**serve_llm.pod_env(),
                               "CUDA_VISIBLE_DEVICES": ",".join([card] * TP)})
    assert got["node"] == "g0" and got["indices"] == "0,1"
    assert got["env"]["CUDA_VISIBLE_DEVICES"] == ",".join([card] * TP)
    assert got["platform"].startswith("cuda-") and got["platform"].endswith(f"x{TP}")
    assert got["prediction"]["tokens"] == 8
