"""The port's serve_llm flow on the card: its own control plane schedules a
``llama`` InferenceService onto a GPU node, and the pod serves on the card
it was given.

Marked ``cuda``: it skips without an NVIDIA GPU.  The file imports neither
JAX nor the JAX package, so it runs where only the port's dependencies are:

    python -m pytest --noconftest -m cuda tests/test_torch_control_plane_cuda.py

The CPU run of the same flow, held against the JAX package's, is
tests/test_torch_control_plane_serve.py's."""

import json
import os
import urllib.request

import pytest
import torch

from kubeflow_tpu_torch.core.cluster import Cluster
from kubeflow_tpu_torch.examples import serve_llm
from kubeflow_tpu_torch.serving import install
from kubeflow_tpu_torch.serving.api import inference_service
from kubeflow_tpu_torch.serving.controllers import pod_port


def _process_env(cluster, pod_name: str) -> dict:
    for kubelet in cluster.kubelets.values():
        for run in kubelet._runs.values():
            if run.name == pod_name and run.current is not None:
                with open(f"/proc/{run.current.pid}/environ", "rb") as f:
                    return dict(kv.decode().split("=", 1)
                                for kv in f.read().split(b"\0") if b"=" in kv)
    return {}


@pytest.mark.cuda
def test_serve_llm_on_the_card(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pod's engine takes the card or raises")
    monkeypatch.delenv("TORCH_DEVICE", raising=False)  # the pod must take the card
    model_dir = serve_llm.write_model_dir(str(tmp_path))
    cluster = Cluster(workdir=str(tmp_path / "cluster"), cpu_nodes=1,
                      gpu_nodes=(("g0", "h100", torch.cuda.device_count()),),
                      base_env=serve_llm.pod_env())
    router, proxy = install(cluster.api, cluster.manager)
    try:
        cluster.apply(inference_service("llm", model_format="llama",
                                        storage_uri=f"file://{model_dir}"))
        assert cluster.wait_for(lambda: serve_llm.isvc_ready(cluster.api, "llm"),
                                timeout=300), cluster.logs(cluster.api.list("Pod")[0]
                                                            ["metadata"]["name"])[-3000:]
        pod = cluster.api.list("Pod")[0]
        assert pod["spec"]["nodeName"] == "g0"
        main = pod["spec"]["containers"][0]
        assert main["resources"]["requests"] == {"nvidia.com/gpu": 1}
        env = _process_env(cluster, pod["metadata"]["name"])
        # node card 0 is this process's first visible card
        parent = os.environ.get("CUDA_VISIBLE_DEVICES")
        assert env.get("CUDA_VISIBLE_DEVICES") == (parent.split(",")[0].strip()
                                                   if parent else "0")
        assert "TORCH_DEVICE" not in env
        out = router.predict("llm", {"instances": [{"prompt": "hello tpu", "max_tokens": 16}]})
        assert out["predictions"][0]["tokens"] == 16
        # the engine's perf plane names the backend it serves on
        port = pod_port(pod)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/engine/perf", timeout=30) as r:
            platform = json.loads(r.read())["models"]["llm"]["platform"]
        assert platform.startswith("cuda-"), platform
    finally:
        proxy.shutdown()
        cluster.shutdown()
    # the pod's process is gone with the cluster
    assert not any(k._runs for k in cluster.kubelets.values())
