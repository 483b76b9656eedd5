"""Runtime container entry point: load a model, serve the V1/V2 protocols.

The port's counterpart of ``kubeflow_tpu/serving/runtime_main.py``: one
entry point with pluggable loaders, run as

    python -m kubeflow_tpu_torch.serving.runtime_main --loader jetstream \
        --model-name llm --model-dir /mnt/models --port 8080

Loaders:
  pyfunc       model dir contains ``model.py`` defining either a ``UserModel``
               (subclass of serving.server.Model) or ``predict(instances)``.
  sklearn      ``model.joblib``/``model.pkl`` with a ``.predict`` method.
  xgboost      ``model.json``/``model.ubj`` loaded via xgboost if present,
               else a pickled booster.
  tensorflow   (or ``savedmodel``) a TF SavedModel's ``serving_default``
               signature on TF's own runtime.
  jetstream    the LLM decode engine (serving/engine) on a checkpoint dir,
               on the card unless ``TORCH_DEVICE`` names another device
               (``TORCH_DEVICE=cpu`` for a run without one).
  huggingface  a transformers pipeline.
  echo         identity model (tests, smoke).

The ``jax`` loader has no torch contract yet, and the ``explainer`` loader
waits for the explainers' port (ROADMAP item 2.2): both are refused.

A transformer component sets ``PREDICTOR_HOST``; the loaded model's
``predict`` then delegates over HTTP — the same chain as upstream
transformers.  ``BATCHER_MAX_BATCH_SIZE`` (with ``BATCHER_MAX_LATENCY_MS``)
wraps the model in the agent's request batcher, ``LOGGER_PATH`` (with
``LOGGER_MODE``) in its payload logger.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import urllib.request
from typing import Any, Optional

from .server import Model, ModelServer


class EchoModel(Model):
    def predict(self, payload: Any, headers: Optional[dict] = None) -> Any:
        if isinstance(payload, dict) and "instances" in payload:
            return payload["instances"]
        return payload


class PredictorClient:
    """HTTP client a transformer uses to call its predictor (V1 protocol)."""

    def __init__(self, host: str):
        self.host = host if host.startswith("http") else f"http://{host}"

    def predict(self, model_name: str, payload: dict) -> dict:
        req = urllib.request.Request(
            f"{self.host}/v1/models/{model_name}:predict",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read())


def _load_module(path: str):
    spec = importlib.util.spec_from_file_location("user_model", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # type: ignore[union-attr]
    return mod


def _find(model_dir: str, *names: str) -> Optional[str]:
    for n in names:
        p = os.path.join(model_dir, n)
        if os.path.exists(p):
            return p
    return None


class _FnModel(Model):
    def __init__(self, name: str, fn):
        super().__init__(name)
        self._fn = fn

    def predict(self, payload: Any, headers: Optional[dict] = None) -> Any:
        if isinstance(payload, dict) and "inputs" in payload:  # V2 protocol
            import numpy as np

            t = payload["inputs"][0]
            instances = np.asarray(t["data"]).reshape(t["shape"]).tolist()
        elif isinstance(payload, dict):
            instances = payload.get("instances", payload)
        else:
            instances = payload
        return self._fn(instances)


def load_model(loader: str, name: str, model_dir: str, device=None) -> Model:
    """The model ``loader`` builds from ``model_dir``; ``device`` is where
    the ``jetstream`` engine runs (default: the card)."""
    predictor_host = os.environ.get("PREDICTOR_HOST", "")

    if loader == "echo":
        return EchoModel(name)

    if loader == "pyfunc":
        path = _find(model_dir, "model.py")
        if path is None:
            raise FileNotFoundError(f"pyfunc: no model.py in {model_dir}")
        mod = _load_module(path)
        if hasattr(mod, "UserModel"):
            m = mod.UserModel(name)
            if predictor_host and not getattr(m, "predictor", None):
                m.predictor = PredictorClient(predictor_host)  # type: ignore[attr-defined]
            return m
        if hasattr(mod, "predict"):
            return _FnModel(name, mod.predict)
        raise AttributeError("pyfunc: model.py must define UserModel or predict()")

    if loader == "sklearn":
        path = _find(model_dir, "model.joblib", "model.pkl")
        if path is None:
            raise FileNotFoundError(f"sklearn: no model.joblib/model.pkl in {model_dir}")
        try:
            import joblib  # type: ignore

            est = joblib.load(path)
        except ImportError:
            import pickle

            with open(path, "rb") as f:
                est = pickle.load(f)
        return _FnModel(name, lambda instances: _np_list(est.predict(_np(instances))))

    if loader == "xgboost":
        path = _find(model_dir, "model.json", "model.ubj", "model.pkl")
        if path is None:
            raise FileNotFoundError(f"xgboost: no model file in {model_dir}")
        if path.endswith(".pkl"):
            import pickle

            with open(path, "rb") as f:
                booster = pickle.load(f)
        else:
            import xgboost  # type: ignore

            booster = xgboost.Booster()
            booster.load_model(path)
        return _FnModel(name, lambda instances: _np_list(booster.predict(_np(instances))))

    if loader == "explainer":
        raise ValueError("loader 'explainer' is not ported yet (ROADMAP item "
                         "2.2 brings the explainers)")

    if loader == "jax":
        raise ValueError("loader 'jax' is not ported: a model.py's load_jax "
                         "returns a JAX function, and a torch loader contract "
                         "for it is not defined yet")

    if loader in ("tensorflow", "savedmodel"):
        # TF-Serving-equivalent SavedModel path: TF's own runtime executes
        # the serving_default signature
        import numpy as np
        import tensorflow as tf  # type: ignore

        # the standard layout puts saved_model.pb one level down (a version
        # or model subdirectory) — search recursively
        sm_pb = None
        for root, _, files in os.walk(model_dir):
            if "saved_model.pb" in files:
                sm_pb = os.path.join(root, "saved_model.pb")
                break
        if sm_pb is None:
            raise FileNotFoundError(f"savedmodel: no saved_model.pb under {model_dir}")
        loaded = tf.saved_model.load(os.path.dirname(sm_pb))
        sig = loaded.signatures["serving_default"]
        out_keys = sorted(sig.structured_outputs)
        # serving signatures take keyword tensors; single-input models only
        in_key = sorted(sig.structured_input_signature[1])[0]
        in_spec = sig.structured_input_signature[1][in_key]

        def _tf_predict(instances):
            x = tf.constant(np.asarray(instances), dtype=in_spec.dtype)
            out = sig(**{in_key: x})
            return _np_list(out[out_keys[0]].numpy())

        return _FnModel(name, _tf_predict)

    if loader == "jetstream":
        from .engine.serve import JetStreamModel

        return JetStreamModel(name, model_dir, device=device)

    if loader == "huggingface":
        from transformers import pipeline  # type: ignore

        task = os.environ.get("HF_TASK", "text-generation")
        pipe = pipeline(task, model=model_dir)
        return _FnModel(name, lambda instances: [pipe(x) for x in instances])

    raise ValueError(f"unknown loader {loader!r}")


def _np(instances):
    import numpy as np

    return np.asarray(instances)


def _np_list(arr):
    import numpy as np

    return np.asarray(arr).tolist()


def main(argv: Optional[list[str]] = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--loader", required=True)
    p.add_argument("--model-name", required=True)
    p.add_argument("--model-dir", default="")
    p.add_argument("--port", type=int, required=True)
    args = p.parse_args(argv)

    model = load_model(args.loader, args.model_name, args.model_dir,
                       device=os.environ.get("TORCH_DEVICE") or None)
    # agent wrappers, controller-injected: batcher innermost (coalesces
    # model calls), logger outermost (logs the caller-shaped request and
    # response)
    if os.environ.get("BATCHER_MAX_BATCH_SIZE"):
        from .agent import RequestBatcher

        model = RequestBatcher(
            model,
            max_batch_size=int(os.environ["BATCHER_MAX_BATCH_SIZE"]),
            max_latency=float(os.environ.get("BATCHER_MAX_LATENCY_MS", "20")) / 1000.0,
        )
    if os.environ.get("LOGGER_PATH"):
        from .agent import PayloadLogger

        model = PayloadLogger(model, path=os.environ["LOGGER_PATH"],
                              log_mode=os.environ.get("LOGGER_MODE", "all"))
    server = ModelServer([model], port=args.port)
    print(f"runtime_main: serving {args.model_name} ({args.loader}) on :{server.port}",
          flush=True)
    server.start(block=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
