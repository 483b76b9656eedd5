"""Port parity: the LLM serving flow end to end through both control planes.

The port's ``serve_llm`` flow (``kubeflow_tpu_torch/examples/serve_llm.py``:
its model dir, a ``llama`` InferenceService, the router) against the JAX
example's, on the CPU.  One model dir holds the example's tiny decoder
(``config.json``, ``engine.json``) and a ``params.npz`` drawn from a numpy
seed; the JAX control plane serves it from a TPU-slice node (the JAX
runtime on ``JAX_PLATFORMS=cpu``), the port's from a GPU node (its runtime
on ``TORCH_DEVICE=cpu``).  The port's pod runs the port's runtime module,
requests ``nvidia.com/gpu`` and gets ``CUDA_VISIBLE_DEVICES``; its greedy
tokens pass the JAX ``forward_full`` tie-aware oracle and equal the JAX
ISVC's up to the first step whose top-2 gap is a near-tie.

Then, on the port's control plane alone: scale to zero and activation
through the port's ingress (``tests/test_serving.py``'s flow, with longer
waits), and the two examples run as ``python -m``."""

import json
import os
import re
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest

from kubeflow_tpu.core.cluster import Cluster as JCluster
from kubeflow_tpu.serving import install as jinstall
from kubeflow_tpu.serving.api import inference_service
from kubeflow_tpu.serving.engine import model as JM
from kubeflow_tpu_torch.core.cluster import Cluster as TCluster
from kubeflow_tpu_torch.examples import serve_llm
from kubeflow_tpu_torch.serving import api as tsapi
from kubeflow_tpu_torch.serving import install as tinstall
from kubeflow_tpu_torch.serving.controllers import SCALED_TO_ZERO_ANNOTATION

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = ["hello tpu", "the port serves", "abc"]
MAX_TOKENS = 8
STABLE_GAP = 0.07  # a top-2 gap above this cannot flip across frameworks
TIE_EPS = 5e-2     # the cross-framework bf16 logit tolerance
ORACLE_LEN = 32


def numpy_params(cfg: JM.DecoderConfig, seed: int) -> dict:
    """The decoder's parameters drawn with numpy at ``JM.init``'s scales
    (f32; both packages' ``load_params`` cast them to bf16)."""
    rng = np.random.default_rng(seed)
    n, d, hd = cfg.n_layers, cfg.d_model, cfg.head_dim

    def w(*shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    return {
        "embed": w(cfg.vocab_size, d, fan_in=1.0),
        "wq": w(n, d, cfg.n_heads * hd, fan_in=d),
        "wk": w(n, d, cfg.n_kv_heads * hd, fan_in=d),
        "wv": w(n, d, cfg.n_kv_heads * hd, fan_in=d),
        "wo": w(n, cfg.n_heads * hd, d, fan_in=cfg.n_heads * hd),
        "w1": w(n, d, cfg.d_ff, fan_in=d),
        "w3": w(n, d, cfg.d_ff, fan_in=d),
        "w2": w(n, cfg.d_ff, d, fan_in=cfg.d_ff),
        "ln_attn": (1 + 0.1 * rng.standard_normal((n, d))).astype(np.float32),
        "ln_mlp": (1 + 0.1 * rng.standard_normal((n, d))).astype(np.float32),
        "ln_out": (1 + 0.1 * rng.standard_normal((d,))).astype(np.float32),
        "unembed": w(d, cfg.vocab_size, fan_in=d),
    }


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = serve_llm.write_model_dir(str(tmp_path_factory.mktemp("llm")))
    with open(os.path.join(d, "config.json")) as f:
        cfg = JM.DecoderConfig(**json.load(f))
    np.savez(os.path.join(d, "params.npz"), **numpy_params(cfg, seed=0))
    return d


def _ready(c, name: str) -> bool:
    st = (c.api.try_get("InferenceService", name) or {}).get("status", {})
    return any(x["type"] == "Ready" and x["status"] == "True"
               for x in st.get("conditions", []))


def _debug(c) -> str:
    return str([(p["metadata"]["name"], p.get("status", {}).get("phase"),
                 c.logs(p["metadata"]["name"])[-600:]) for p in c.api.list("Pod")])


def _serve(plane: str, model_dir: str) -> dict:
    """The serve_llm flow on ``plane``: the ISVC's pod spec, its process's
    ``CUDA_VISIBLE_DEVICES`` and the greedy token ids of every prompt."""
    if plane == "jax":
        c = JCluster(cpu_nodes=1, tpu_slices=(("s0", "v5e", "2x2"),),
                     base_env={"PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"})
        install = jinstall
    else:
        c = TCluster(cpu_nodes=1, gpu_nodes=(("g0", "h100", 1),),
                     base_env={"PYTHONPATH": REPO, "TORCH_DEVICE": "cpu"})
        install = tinstall
    router, proxy = install(c.api, c.manager)
    try:
        c.apply(inference_service("llm", model_format="llama",
                                  storage_uri=f"file://{model_dir}"))
        assert c.wait_for(lambda: _ready(c, "llm"), timeout=240), _debug(c)
        pod = c.api.list("Pod")[0]
        environ = {}
        for kubelet in c.kubelets.values():
            for run in kubelet._runs.values():
                if run.name == pod["metadata"]["name"] and run.current is not None:
                    with open(f"/proc/{run.current.pid}/environ", "rb") as f:
                        environ = dict(kv.split(b"=", 1) for kv in f.read().split(b"\0") if b"=" in kv)
        out = router.predict("llm", {"instances": [
            {"prompt": p, "max_tokens": MAX_TOKENS} for p in PROMPTS]})
        return {"pod": pod, "cvd": environ.get(b"CUDA_VISIBLE_DEVICES", b"<unset>").decode(),
                "tokens": [r["token_ids"] for r in out["predictions"]]}
    finally:
        proxy.shutdown()
        c.shutdown()


def _oracle(jp, cfg, toks) -> np.ndarray:
    padded = np.zeros((1, ORACLE_LEN), np.int32)
    padded[0, :len(toks)] = toks
    return np.asarray(JM.forward_full(jp, cfg, jnp.asarray(padded)))[0, :len(toks)]


def test_serve_llm_flow_matches_the_jax_isvc(model_dir):
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = JM.DecoderConfig(**json.load(f))
    jp = JM.load_params(model_dir, cfg)
    got = {plane: _serve(plane, model_dir) for plane in ("jax", "port")}

    main = got["port"]["pod"]["spec"]["containers"][0]
    assert main["command"][1:3] == ["-m", "kubeflow_tpu_torch.serving.runtime_main"]
    assert main["resources"]["requests"] == {"nvidia.com/gpu": 1}
    init = got["port"]["pod"]["spec"]["initContainers"][0]
    assert init["command"][1:] == ["-m", "kubeflow_tpu_torch.serving.storage"]
    assert got["port"]["pod"]["spec"]["nodeName"] == "g0"
    assert got["port"]["cvd"] == "0"
    assert got["jax"]["pod"]["spec"]["containers"][0]["resources"]["requests"] == {
        "google.com/tpu": 1}

    for prompt, jt, tt in zip(PROMPTS, got["jax"]["tokens"], got["port"]["tokens"]):
        ids = list(prompt.encode())
        assert len(jt) == len(tt) == MAX_TOKENS
        for plane, toks in (("jax", jt), ("port", tt)):
            logits = _oracle(jp, cfg, ids + toks)
            for i, t in enumerate(toks):
                row = logits[len(ids) - 1 + i]
                assert float(row[t]) >= float(row.max()) - TIE_EPS, (plane, prompt, i)
        # the two ISVCs' tokens are the same ids up to the first step whose
        # top-2 gap (on the shared prefix) is a near-tie, where they may part
        logits = _oracle(jp, cfg, ids + jt)
        for i in range(MAX_TOKENS):
            if tt[i] != jt[i]:
                top2 = np.sort(logits[len(ids) - 1 + i])[-2:]
                assert float(top2[1] - top2[0]) <= STABLE_GAP, (prompt, i, tt, jt)
                break


def _pyfunc(root, name: str, factor: int) -> str:
    d = root / name
    d.mkdir(exist_ok=True)
    (d / "model.py").write_text(f"def predict(instances):\n    return [x * {factor} for x in instances]\n")
    return str(d)


def test_isvc_scale_to_zero_and_activation_through_the_port_ingress(tmp_path):
    c = TCluster(cpu_nodes=1, base_env={"PYTHONPATH": REPO})
    router, proxy = tinstall(c.api, c.manager)
    try:
        c.apply(inference_service("zero", model_format="pyfunc", min_replicas=0,
                                  storage_uri=f"file://{_pyfunc(tmp_path, 'm1', 3)}"))
        assert c.wait_for(lambda: _ready(c, "zero"), timeout=90), _debug(c)

        def scaled_to_zero():
            deploys = c.api.list("Deployment", label_selector={tsapi.LABEL_ISVC: "zero"})
            return deploys and all(d["spec"]["replicas"] == 0 for d in deploys)
        assert c.wait_for(scaled_to_zero, timeout=90), _debug(c)

        def pods_gone():
            return not [p for p in c.api.list("Pod")
                        if p["metadata"]["labels"].get(tsapi.LABEL_ISVC) == "zero"]
        assert c.wait_for(pods_gone, timeout=60), _debug(c)
        deploys = c.api.list("Deployment", label_selector={tsapi.LABEL_ISVC: "zero"})
        assert deploys[0]["metadata"]["annotations"].get(SCALED_TO_ZERO_ANNOTATION) == "true"
        assert c.wait_for(lambda: _ready(c, "zero"), timeout=30)  # Ready at zero

        # the activator: a request against zero replicas wakes the deployment
        result = {}

        def fire():
            result["out"] = router.predict("zero", {"instances": [2]})
        t = threading.Thread(target=fire, daemon=True)
        t.start()
        assert c.wait_for(lambda: "out" in result, timeout=90), _debug(c)
        assert result["out"] == {"predictions": [6]}
    finally:
        proxy.shutdown()
        c.shutdown()


def _run_example(module: str, env: dict) -> str:
    r = subprocess.run([sys.executable, "-m", module], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def test_serve_llm_example_prints_ok_on_the_cpu():
    out = _run_example("kubeflow_tpu_torch.examples.serve_llm",
                       dict(os.environ, PYTHONPATH=REPO, TORCH_DEVICE="cpu"))
    lines = out.strip().splitlines()
    assert lines[-1] == "SERVE-LLM-OK"
    assert any(x.startswith("url: http://llm.default.") for x in lines)


def test_explain_isvc_example_equals_the_jax_example():
    env = dict(os.environ, PYTHONPATH=REPO)
    jax_out = _run_example("kubeflow_tpu.examples.explain_isvc", env)
    port_out = _run_example("kubeflow_tpu_torch.examples.explain_isvc", env)
    assert port_out == jax_out
    assert re.search(r"shap attributions: \[3\.0, 2\.0, 0\.0, 3\.0\]", port_out)
