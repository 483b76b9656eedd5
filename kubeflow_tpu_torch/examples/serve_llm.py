"""Serve an LLM through the port's full platform path (BASELINE config[3] shape).

The port's counterpart of ``kubeflow_tpu/examples/serve_llm.py``: write a
model dir (decoder config + engine.json), apply an InferenceService with
modelFormat ``llama`` to the port's own control plane, and send a prompt
through its router.  The port's catalog picks ``kserve-jetstream``, whose
pod runs ``python -m kubeflow_tpu_torch.serving.runtime_main`` and requests
``nvidia.com/gpu: 1``; the cluster has one GPU node in place of the JAX
example's TPU slice, and the scheduler hands the pod its card as
``CUDA_VISIBLE_DEVICES``.

Run: python -m kubeflow_tpu_torch.examples.serve_llm [--tensor-parallel N]

On the card the pod serves there (no ``TORCH_DEVICE``: the runtime takes
the card or raises).  ``TORCH_DEVICE=cpu`` in this process's environment
reaches the pod and serves on the CPU.  Either way it serves a tiny
random-weight decoder (the JAX example's widths); point ``storage_uri`` at
real Llama/Gemma weights (``params.npz``, or a raw HuggingFace checkout that
the runtime converts on load) and size ``engine.json`` for a real model.
``--tensor-parallel N`` on the card needs a pod that holds N cards: a
runtime that requests ``nvidia.com/gpu: N`` (a namespace ``ServingRuntime``
named by the model's ``runtime``, or the predictor's own ``containers``) on
a node with N cards; the pod serves shard i on the card of its
``CUDA_VISIBLE_DEVICES``' i-th entry.  The catalog's runtime requests one
card, so this example's pod refuses N > 1 on the card (the message names
its ``engine.json``) and serves it on the CPU.  Prints ``SERVE-LLM-OK`` as
the JAX example does.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile


def write_model_dir(root: str, tensor_parallel: int = 1) -> str:
    """The example's model dir under ``root``: the JAX example's tiny
    decoder ``config.json`` and ``engine.json``."""
    model_dir = os.path.join(root, "model")
    os.makedirs(model_dir, exist_ok=True)
    # graftlint: disable=atomic-write -- demo scaffolding into a
    # directory this script just created; no concurrent reader
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump({"vocab_size": 512, "d_model": 64, "n_layers": 2,
                   "n_heads": 4, "n_kv_heads": 2, "d_ff": 128}, f)
    # graftlint: disable=atomic-write -- demo scaffolding into a
    # directory this script just created; no concurrent reader
    with open(os.path.join(model_dir, "engine.json"), "w") as f:
        json.dump({"max_slots": 4, "num_pages": 128, "page_size": 16,
                   "max_pages_per_slot": 32, "prefill_chunk": 64,
                   "tensor_parallel": tensor_parallel}, f)
    return model_dir


def pod_env() -> dict:
    """The environment every pod of the example's cluster starts from: the
    repo on ``PYTHONPATH``, and ``TORCH_DEVICE`` when this process has one."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = {"PYTHONPATH": repo + (os.pathsep + os.environ["PYTHONPATH"]
                                 if os.environ.get("PYTHONPATH") else "")}
    if os.environ.get("TORCH_DEVICE"):
        env["TORCH_DEVICE"] = os.environ["TORCH_DEVICE"]
    return env


def isvc_ready(api, name: str) -> bool:
    st = (api.try_get("InferenceService", name) or {}).get("status", {})
    return any(c["type"] == "Ready" and c["status"] == "True"
               for c in st.get("conditions", []))


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--tensor-parallel", type=int, default=1)
    p.add_argument("--prompt", default="hello tpu")
    p.add_argument("--max-tokens", type=int, default=16)
    args = p.parse_args()

    from kubeflow_tpu_torch.core.cluster import Cluster
    from kubeflow_tpu_torch.serving import install
    from kubeflow_tpu_torch.serving.api import inference_service

    model_dir = write_model_dir(tempfile.mkdtemp(prefix="llm-"), args.tensor_parallel)
    # the jetstream runtime requests nvidia.com/gpu, so give the simulated
    # cluster a GPU node (its nodes run pods as local processes)
    cluster = Cluster(cpu_nodes=1, gpu_nodes=(("g0", "h100", 1),),
                      base_env=pod_env())
    router, proxy = install(cluster.api, cluster.manager)
    try:
        cluster.apply(inference_service(
            "llm", model_format="llama", storage_uri=f"file://{model_dir}"))
        assert cluster.wait_for(lambda: isvc_ready(cluster.api, "llm"), timeout=180), \
            "InferenceService never became Ready"

        isvc = cluster.api.get("InferenceService", "llm")
        print("url:", isvc["status"]["url"])
        out = router.predict("llm", {"instances": [
            {"prompt": args.prompt, "max_tokens": args.max_tokens}]})
        print("generated:", out["predictions"][0]["text"][:120])
        print("SERVE-LLM-OK")
    finally:
        proxy.shutdown()
        cluster.shutdown()


if __name__ == "__main__":
    main()
