"""Port parity: the explainer runtimes and the ``jax`` loader's torch contract.

- Integrated gradients: the port's ``torch.func.grad`` under ``vmap``
  against the JAX package's ``jax.grad`` under ``jax.vmap``, on the same
  linear and MLP weights, with and without a baseline and with
  ``output_index``, within 1e-5 (f32); completeness holds (attributions sum
  to f(x) - f(baseline) up to the midpoint rule).
- SHAP: ``shap_values`` exact and sampled are identical to the JAX
  package's for the same predictor and seed.
- Over HTTP: ``runtime_main --loader jax`` serves a ``load_torch`` model
  (the predictor pod), ``--loader explainer`` pods answer ``:explain`` with
  SHAP through ``PREDICTOR_HOST`` (the JAX package's ``ExplainerModel``
  against the same predictor gives the same values) and with integrated
  gradients over the ``load_torch`` model of their own dir (the JAX
  package's attributions on the same weights); a ``model.py`` that defines
  only ``load_jax`` is refused, naming ``load_torch``.
- Device: the loaders move ``load_torch``'s params (torch's default, the
  CPU) to the requested device, the card by default, and a run without a
  card that asks for none raises instead of serving on the CPU."""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.serving import explainers as JX
from kubeflow_tpu.serving.runtime_main import PredictorClient as JPredictorClient
from kubeflow_tpu_torch.serving import explainers as TX
from kubeflow_tpu_torch.serving import runtime_main as RM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, H, O = 5, 8, 3


def _weights(seed=7) -> dict:
    rng = np.random.default_rng(seed)
    return {"w1": (rng.normal(size=(D, H)) * 0.6).astype(np.float32),
            "b1": (rng.normal(size=(H,)) * 0.1).astype(np.float32),
            "w2": rng.normal(size=(H, O)).astype(np.float32),
            "b2": (rng.normal(size=(O,)) * 0.1).astype(np.float32)}


def _jax_mlp(p, x):
    return jnp.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def _torch_mlp(p, x):
    return torch.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def _models(kind):
    w = _weights()
    if kind == "linear":
        lin = w["w1"][:, 0].copy()
        return ((lambda p, x: x @ p), jnp.asarray(lin),
                (lambda p, x: x @ p), torch.from_numpy(lin))
    return (_jax_mlp, {k: jnp.asarray(v) for k, v in w.items()},
            _torch_mlp, {k: torch.from_numpy(v) for k, v in w.items()})


X = np.random.default_rng(1).normal(size=(3, D)).astype(np.float32)
BASE = np.linspace(-0.5, 0.5, D).astype(np.float32)


@pytest.mark.parametrize("output_index", [None, 1])
@pytest.mark.parametrize("baseline", [None, "vector"])
@pytest.mark.parametrize("kind", ["linear", "mlp"])
def test_integrated_gradients_match_jax(kind, baseline, output_index):
    if kind == "linear" and output_index is not None:
        output_index = 0  # one output: its only column
    japply, jp, tapply, tp = _models(kind)
    base = None if baseline is None else BASE
    want = JX.integrated_gradients(japply, jp, X, baseline=base, steps=16,
                                   output_index=output_index)
    got = TX.integrated_gradients(tapply, tp, X, baseline=base, steps=16,
                                  output_index=output_index)
    assert got.dtype == np.float32 and got.shape == X.shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("output_index", [None, 2])
def test_integrated_gradients_completeness(output_index):
    _, _, tapply, tp = _models("mlp")
    attr = TX.integrated_gradients(tapply, tp, X, baseline=BASE, steps=128,
                                   output_index=output_index)

    def f(x):
        y = tapply(tp, torch.from_numpy(np.array(np.atleast_2d(x)))).numpy()
        return y[:, output_index] if output_index is not None else y.sum(-1)

    gap = f(X) - f(np.broadcast_to(BASE, X.shape))
    np.testing.assert_allclose(attr.sum(-1), gap, rtol=1e-3, atol=1e-4)


def test_params_device_reads_nests():
    assert TX.params_device({"a": [torch.zeros(1)]}) == torch.device("cpu")
    assert TX.params_device(torch.nn.Linear(2, 2)) == torch.device("cpu")
    assert TX.params_device({}) == torch.device("cpu")


def test_params_to_moves_every_tensor_of_a_nest():
    meta = torch.device("meta")
    moved = TX.params_to({"a": [torch.zeros(1), (torch.ones(2), 3)],
                          "m": torch.nn.Linear(2, 2), "s": "tag"}, meta)
    assert moved["a"][0].device == meta and moved["a"][1][0].device == meta
    assert moved["a"][1][1] == 3 and moved["s"] == "tag"
    assert TX.params_device(moved["m"]) == meta
    assert TX.params_device(moved) == meta


def _np_predict(rows):
    w = _weights()
    h = np.tanh(np.asarray(rows, np.float64) @ w["w1"] + w["b1"])
    return h @ w["w2"] + w["b2"]


@pytest.mark.parametrize("d,nsamples", [(D, 2048), (14, 256)], ids=["exact", "sampled"])
def test_shap_values_identical_to_jax(d, nsamples):
    rng = np.random.default_rng(5)
    Xs = rng.normal(size=(2, d))
    bg = rng.normal(size=(4, d))
    wide = rng.normal(size=(d, D))

    def predict(rows):
        return _np_predict(np.asarray(rows) @ wide)[:, 1]

    for seed in (0, 3):
        got = TX.shap_values(predict, Xs, bg, nsamples=nsamples, seed=seed)
        want = JX.shap_values(predict, Xs, bg, nsamples=nsamples, seed=seed)
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ pods

MODEL_PY = '''
import os

import numpy as np
import torch


def load_torch(model_dir):
    with np.load(os.path.join(model_dir, "mlp.npz")) as z:  # CPU tensors
        params = {k: torch.from_numpy(z[k]) for k in z.files}

    def apply(p, x):
        return torch.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]

    return apply, params
'''


def _model_dir(d, explainer=None):
    os.makedirs(d, exist_ok=True)
    np.savez(os.path.join(d, "mlp.npz"), **_weights())
    with open(os.path.join(d, "model.py"), "w") as f:
        f.write(MODEL_PY)
    if explainer is not None:
        with open(os.path.join(d, "explainer.json"), "w") as f:
            json.dump(explainer, f)
    return str(d)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _req(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class Pod:
    """``runtime_main`` in a subprocess on a free port, on the CPU."""

    def __init__(self, loader, model_dir, **env):
        self.port = _free_port()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "kubeflow_tpu_torch.serving.runtime_main",
             "--loader", loader, "--model-name", "m", "--model-dir", model_dir,
             "--port", str(self.port)],
            cwd=REPO, env={**os.environ, "PYTHONPATH": REPO, "TORCH_DEVICE": "cpu", **env},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def __enter__(self):
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and self.proc.poll() is None:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{self.port}/v2/health/ready",
                                            timeout=2) as r:
                    if r.status == 200:
                        return self
            except OSError:
                time.sleep(0.1)
        self.proc.kill()
        raise AssertionError(self.proc.communicate()[1][-3000:])

    def __exit__(self, *exc):
        self.proc.terminate()
        _, err = self.proc.communicate(timeout=30)
        assert "Traceback" not in err, err[-3000:]


def test_explainer_pods_over_http(tmp_path):
    rows = X[:2].tolist()
    bg = np.random.default_rng(2).normal(size=(3, D)).tolist()
    with Pod("jax", _model_dir(tmp_path / "predictor")) as pred:
        code, out = _req(pred.port, "/v1/models/m:predict", {"instances": rows})
        assert code == 200
        want = _torch_mlp({k: torch.from_numpy(v) for k, v in _weights().items()},
                          torch.tensor(rows, dtype=torch.float32)).numpy()
        np.testing.assert_allclose(out["predictions"], want, rtol=1e-6, atol=1e-6)

        shap_cfg = {"method": "shap", "background": bg, "output_index": 1}
        host = f"127.0.0.1:{pred.port}"
        with Pod("explainer", _model_dir(tmp_path / "shap", shap_cfg),
                 PREDICTOR_HOST=host) as ex:
            code, out = _req(ex.port, "/v1/models/m:explain", {"instances": rows})
            assert code == 200
        jm = JX.ExplainerModel("m", str(tmp_path / "shap"))
        jm.predictor = JPredictorClient(host)
        jm.load()
        want = jm.explain({"instances": rows})
        assert out["explanations"] == want

    ig_cfg = {"method": "integrated_gradients", "steps": 64, "baseline": BASE.tolist(),
              "output_index": 2}
    with Pod("explainer", _model_dir(tmp_path / "ig", ig_cfg)) as ex:
        code, out = _req(ex.port, "/v1/models/m:explain", {"instances": rows})
        assert code == 200
    jattr = JX.integrated_gradients(_jax_mlp, {k: jnp.asarray(v) for k, v in _weights().items()},
                                    np.asarray(rows, np.float32), baseline=BASE, steps=64,
                                    output_index=2)
    got = np.asarray([e["attributions"] for e in out["explanations"]])
    np.testing.assert_allclose(got, np.asarray(jattr), rtol=1e-5, atol=1e-5)


def test_jax_loader_contract(tmp_path):
    d = _model_dir(tmp_path / "ok")
    m = RM.load_model("jax", "m", d, device="cpu")
    assert m.device == torch.device("cpu")
    out = m.predict({"instances": X[:1].tolist()})
    assert np.asarray(out).shape == (1, O)
    # V2 infer rides the same function
    out2 = m.predict({"inputs": [{"name": "x", "shape": [1, D], "datatype": "FP32",
                                  "data": X[0].tolist()}]})
    np.testing.assert_allclose(out2, out, rtol=1e-6)

    jax_only = tmp_path / "jax_only"
    jax_only.mkdir()
    (jax_only / "model.py").write_text("def load_jax(model_dir):\n    return None, None\n")
    with pytest.raises(AttributeError, match="load_torch"):
        RM.load_model("jax", "m", str(jax_only), device="cpu")
    with pytest.raises(FileNotFoundError, match="jax: no model.py"):
        RM.load_model("jax", "m", str(tmp_path), device="cpu")
    # the explainer's white-box method reads the same contract
    ex = jax_only / "explainer.json"
    ex.write_text(json.dumps({"method": "integrated_gradients"}))
    with pytest.raises(AttributeError, match="load_torch"):
        RM.load_model("explainer", "m", str(jax_only), device="cpu").load()


def test_torch_loaders_move_params_to_the_requested_device(tmp_path):
    """``load_torch`` returns CPU tensors (torch's default); the loader puts
    them where the pod runs: here the meta device, which only a move can
    reach."""
    d = _model_dir(tmp_path / "ok", {"method": "integrated_gradients"})
    apply, params, dev = RM.load_torch_model(d, "jax", "meta")
    assert dev == torch.device("meta")
    assert {p.device for p in params.values()} == {dev}
    assert RM.load_model("jax", "m", d, device="meta").device == dev
    ex = RM.load_model("explainer", "m", d, device="meta")
    ex.load()
    assert ex.device == dev


def test_torch_loaders_default_to_the_card(tmp_path, monkeypatch):
    """No device asked for (``TORCH_DEVICE`` unset, as ``runtime_main``
    reads it): the ``jax`` loader and integrated gradients run on the card,
    and a run without one raises instead of serving on the CPU."""
    monkeypatch.delenv("TORCH_DEVICE", raising=False)
    d = _model_dir(tmp_path / "ok", {"method": "integrated_gradients"})
    if torch.cuda.is_available():
        assert RM.load_model("jax", "m", d).device.type == "cuda"
        ex = RM.load_model("explainer", "m", d)
        ex.load()
        assert ex.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        RM.load_model("jax", "m", d)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        RM.load_model("explainer", "m", d).load()
    r = subprocess.run([sys.executable, "-m", "kubeflow_tpu_torch.serving.runtime_main",
                        "--loader", "jax", "--model-name", "m", "--model-dir", d,
                        "--port", str(_free_port())],
                       cwd=REPO, env={k: v for k, v in {**os.environ, "PYTHONPATH": REPO}.items()
                                      if k != "TORCH_DEVICE"},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "torch.cuda.is_available() is False" in r.stderr
