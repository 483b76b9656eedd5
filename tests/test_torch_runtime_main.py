"""The port's pod entry point, ``python -m kubeflow_tpu_torch.serving.runtime_main``.

Run as a subprocess on the CPU (``TORCH_DEVICE=cpu``), as a pod runs it:
the ``jetstream`` loader serves a model dir (a tiny ``config.json`` with no
weights, so random init, plus an ``engine.json`` with ``scheduler`` and
``kv_store`` blocks) through ready, generate, stream and ``/engine/health``;
``echo`` and ``pyfunc`` serve too; ``jax`` serves a ``load_torch`` model
and refuses a ``load_jax`` one, ``explainer`` serves SHAP and refuses a
dir without ``explainer.json`` or a white-box model without
``load_torch``.
``BATCHER_MAX_BATCH_SIZE`` wraps the model in the agent's batcher and
``LOGGER_PATH`` in its payload logger.  The ``sklearn`` loader's ``joblib``
and the ``huggingface`` loader's ``transformers`` import with JAX absent."""

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from kubeflow_tpu_torch.serving import runtime_main as RM
from kubeflow_tpu_torch.serving.agent import PayloadLogger, RequestBatcher

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = {"vocab_size": 256, "d_model": 32, "n_layers": 1, "n_heads": 2,
          "n_kv_heads": 1, "d_ff": 64}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _req(port, path, body=None, headers=None, timeout=30):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class Runtime:
    """``runtime_main`` in a subprocess on a free port; terminated (and
    its exit checked) when the ``with`` block ends."""

    def __init__(self, loader, model_dir="", **env):
        self.port = _free_port()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "kubeflow_tpu_torch.serving.runtime_main",
             "--loader", loader, "--model-name", "m", "--model-dir", model_dir,
             "--port", str(self.port)],
            cwd=REPO, env={**os.environ, "PYTHONPATH": REPO, "TORCH_DEVICE": "cpu", **env},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def __enter__(self):
        deadline = time.monotonic() + 120
        while True:
            assert self.proc.poll() is None, self.proc.communicate()[1][-3000:]
            try:
                if _req(self.port, "/v2/health/ready", timeout=2)[0] == 200:
                    return self
            except OSError:
                pass
            assert time.monotonic() < deadline, "runtime_main never became ready"
            time.sleep(0.1)

    def __exit__(self, *exc):
        self.proc.terminate()
        out, err = self.proc.communicate(timeout=30)
        self.stdout, self.stderr = out, err
        assert "Traceback" not in err, err[-3000:]


def test_jetstream_loader_serves_a_model_dir(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(CONFIG))
    (tmp_path / "engine.json").write_text(json.dumps({
        "max_slots": 2, "num_pages": 32, "page_size": 8, "max_pages_per_slot": 8,
        "scheduler": {"policy": "fifo", "adapter_weights": []},
        "kv_store": {"host_max_bytes": 1 << 20, "disk_dir": str(tmp_path / "kv")}}))
    with Runtime("jetstream", str(tmp_path)) as rt:
        code, raw = _req(rt.port, "/v2/models/m/generate",
                         {"text_input": "hello", "parameters": {"max_tokens": 5}})
        out = json.loads(raw)
        assert code == 200 and out["tokens"] == 5
        code, raw = _req(rt.port, "/v2/models/m/generate_stream",
                         {"text_input": "hello", "parameters": {"max_tokens": 5}},
                         {"X-Stream-Resume": "1"})
        events = [json.loads(b[len(b"data: "):]) for b in raw.split(b"\n\n") if b]
        assert code == 200 and events[-1]["done"] and events[-1]["tokens"] == 5
        assert [t for e in events for t in e.get("token_ids", ())] == out["token_ids"]
        code, raw = _req(rt.port, "/engine/health")
        assert code == 200 and json.loads(raw)["state"] == "SERVING"
    assert "serving m (jetstream)" in rt.stdout


def test_jetstream_loader_refuses_a_bad_engine_json(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(CONFIG))
    (tmp_path / "engine.json").write_text(json.dumps({"tensor_parallel": 4}))
    r = subprocess.run([sys.executable, "-m", "kubeflow_tpu_torch.serving.runtime_main",
                        "--loader", "jetstream", "--model-name", "m", "--model-dir",
                        str(tmp_path), "--port", str(_free_port())],
                       cwd=REPO, env={**os.environ, "PYTHONPATH": REPO, "TORCH_DEVICE": "cpu"},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert f"{tmp_path}/engine.json: tensor_parallel=4" in r.stderr


def test_echo_and_pyfunc_loaders(tmp_path):
    with Runtime("echo") as rt:
        code, raw = _req(rt.port, "/v1/models/m:predict", {"instances": [1, "a"]})
        assert code == 200 and json.loads(raw) == {"predictions": [1, "a"]}
    (tmp_path / "model.py").write_text("def predict(instances):\n"
                                       "    return [x * 3 for x in instances]\n")
    with Runtime("pyfunc", str(tmp_path)) as rt:
        code, raw = _req(rt.port, "/v1/models/m:predict", {"instances": [1, 2]})
        assert code == 200 and json.loads(raw) == {"predictions": [3, 6]}
        code, raw = _req(rt.port, "/v2/models/m/infer", {"inputs": [
            {"name": "x", "shape": [2], "datatype": "INT64", "data": [4, 5]}]})
        assert code == 200 and json.loads(raw)["outputs"][0]["data"] == [12, 15]


@pytest.mark.parametrize("loader", ["jax", "explainer"])
def test_unported_loaders_are_refused(tmp_path, loader):
    """What these loaders cannot run is refused, naming what they need: a
    JAX model (``model.py`` with only ``load_jax``) has no ``load_torch``
    for the ``jax`` loader or for the explainer's integrated gradients; an
    explainer dir without ``explainer.json`` has no method; and an unknown
    loader is refused."""
    (tmp_path / "model.py").write_text("def load_jax(model_dir):\n    return None, None\n")
    if loader == "jax":
        with pytest.raises(AttributeError, match="load_torch"):
            RM.load_model(loader, "m", str(tmp_path), device="cpu")
    else:
        with pytest.raises(FileNotFoundError, match="explainer.json"):
            RM.load_model(loader, "m", str(tmp_path), device="cpu")
        (tmp_path / "explainer.json").write_text(json.dumps({"method": "integrated_gradients"}))
        with pytest.raises(AttributeError, match="load_torch"):
            RM.load_model(loader, "m", str(tmp_path), device="cpu").load()
    with pytest.raises(ValueError, match="unknown loader"):
        RM.load_model("bogus", "m", str(tmp_path))


@pytest.mark.parametrize("loader", ["jax", "explainer"])
def test_jax_and_explainer_loaders_serve(tmp_path, loader):
    """The ``jax`` loader serves a ``load_torch`` model; the ``explainer``
    loader answers ``:explain`` with SHAP through its predictor."""
    if loader == "jax":
        (tmp_path / "model.py").write_text(
            "import torch\n"
            "def load_torch(model_dir):\n"
            "    return (lambda p, x: x * p), torch.tensor(2.0)\n")
        m = RM.load_model(loader, "m", str(tmp_path), device="cpu")
        assert m.predict({"instances": [[1.0, 2.5]]}) == [[2.0, 5.0]]
    else:
        (tmp_path / "explainer.json").write_text(json.dumps(
            {"method": "shap", "background": [[0.0, 0.0]]}))
        m = RM.load_model(loader, "m", str(tmp_path))
        m.predictor = type("P", (), {"predict": staticmethod(
            lambda name, body: {"predictions": [sum(r) * 2 for r in body["instances"]]})})()
        m.load()
        assert m.explain({"instances": [[1.0, 3.0]]}) == [{"shap_values": [2.0, 6.0]}]


def test_agent_wrappers_from_the_environment(tmp_path):
    """The batcher coalesces two concurrent single predicts into ONE model
    call (the pyfunc model sees a batch of 2); the logger writes a request
    and a response record for each."""
    (tmp_path / "model.py").write_text("def predict(instances):\n"
                                       "    return [len(instances)] * len(instances)\n")
    log = tmp_path / "payloads.jsonl"
    with Runtime("pyfunc", str(tmp_path), BATCHER_MAX_BATCH_SIZE="2",
                 BATCHER_MAX_LATENCY_MS="5000", LOGGER_PATH=str(log)) as rt:
        outs = [None, None]

        def one(i):
            outs[i] = _req(rt.port, "/v1/models/m:predict", {"instances": [i]})

        threads = [threading.Thread(target=one, args=(i,)) for i in range(2)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert time.monotonic() - t0 < 5.0  # the full batch went at once
        assert [json.loads(o[1]) for o in outs] == [{"predictions": [2]}] * 2
    records = [json.loads(line) for line in log.read_text().splitlines()]
    assert sorted(r["type"] for r in records) == ["request"] * 2 + ["response"] * 2


def test_wrappers_pass_health_through():
    inner = RM.EchoModel("m")
    inner.load()
    for wrapped in (RequestBatcher(inner), PayloadLogger(inner, sink=lambda r: None)):
        wrapped.load()
        assert wrapped.ready and wrapped.health() == {"state": "SERVING"}


def test_optional_loader_imports_with_jax_absent(tmp_path):
    """JAX, ml_dtypes and the JAX package absent (as on the chip machine):
    the sklearn loader (joblib) serves, and transformers imports."""
    from sklearn.linear_model import LinearRegression
    import joblib

    joblib.dump(LinearRegression().fit([[0.0], [1.0], [2.0]], [1.0, 3.0, 5.0]),
                tmp_path / "model.joblib")
    code = f"""
import sys
for b in ("jax", "jaxlib", "ml_dtypes", "optax", "orbax", "kubeflow_tpu"):
    sys.modules[b] = None  # absent: imports fail, find_spec answers None
from kubeflow_tpu_torch.serving import runtime_main as RM
m = RM.load_model("sklearn", "m", {str(tmp_path)!r})
print("PRED", [round(x, 3) for x in m.predict({{"instances": [[3.0]]}})])
import transformers
print("TRANSFORMERS", transformers.__version__)
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env={**os.environ, "PYTHONPATH": REPO},
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "PRED [7.0]" in r.stdout and "TRANSFORMERS" in r.stdout
