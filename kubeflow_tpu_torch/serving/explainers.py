"""Explainer runtimes for the InferenceService ``explainer`` component.

The port's twin of ``kubeflow_tpu/serving/explainers.py``: a separate
component pod that answers ``/v1/models/<name>:explain`` by interrogating
the model.

* ``integrated_gradients`` — white-box attribution for torch models (the
  ``load_torch`` contract of ``runtime_main``'s ``jax`` loader):
  path-integrated gradients from a baseline, computed with
  ``torch.func.grad`` under ``torch.func.vmap`` over the interpolation
  batch, on the params' device.  The JAX package's midpoint rule,
  ``output_index`` handling and baseline broadcast.  Exact for linear
  models (attribution == w * (x - baseline)).
* ``shap_values`` — black-box Shapley values over ANY predictor, talking
  to it over HTTP as upstream explainers do.  Exact subset enumeration for
  d <= ``exact_features`` features (all 2^d masked coalitions in ONE
  batched predict call), Shapley-kernel weighted sampling beyond.  A copy
  of the JAX package's numpy code: the same values for the same predictor
  and seed.

Deployment shape: ``spec.explainer`` with model format ``explainer`` and a
``model_dir`` containing ``explainer.json``::

    {"method": "shap", "background": [...], "nsamples": 2048}
    {"method": "integrated_gradients", "steps": 32, "baseline": [...]}

The kubelet-rendered env gives the component ``PREDICTOR_HOST``; ``shap``
masks features against the background and calls the predictor;
``integrated_gradients`` loads the torch model from the SAME model_dir
(``model.py`` defining ``load_torch(model_dir) -> (apply, params)``).
"""

from __future__ import annotations

import itertools
import json
import math
import os
from typing import Any, Callable, Optional

import numpy as np
import torch

from .server import Model


# ---------------------------------------------------------------- white-box


def params_device(params: Any) -> torch.device:
    """The device of the first tensor in ``params`` (a tensor, a module, or
    a dict/list/tuple nest of them); the CPU when it holds none."""
    if isinstance(params, torch.Tensor):
        return params.device
    if isinstance(params, torch.nn.Module):
        for t in itertools.chain(params.parameters(), params.buffers()):
            return t.device
        return torch.device("cpu")
    if isinstance(params, dict):
        params = list(params.values())
    if isinstance(params, (list, tuple)):
        for p in params:
            d = params_device(p)
            if d.type != "cpu":
                return d
    return torch.device("cpu")


def params_to(params: Any, device: torch.device) -> Any:
    """``params`` (a tensor, a module, or a dict/list/tuple nest of them)
    with every tensor on ``device``; anything else as it is."""
    if isinstance(params, (torch.Tensor, torch.nn.Module)):
        return params.to(device)
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        moved = [params_to(v, device) for v in params]
        return type(params)(*moved) if hasattr(params, "_fields") else type(params)(moved)
    return params


def make_integrated_gradients(apply: Callable, params: Any, steps: int = 32,
                              output_index: Optional[int] = None,
                              device: Optional[torch.device] = None) -> Callable:
    """Build the attribution function ONCE (steps/output_index are
    config-fixed).  Returns ``fn(x, baseline=None) -> attributions [batch,
    d]`` as float32 numpy, computed on ``device`` (default: the params')."""
    from torch.func import grad, vmap

    dev = params_device(params) if device is None else device

    def scalar_out(xi):
        y = apply(params, xi[None])[0]
        y = torch.as_tensor(y)
        if output_index is not None:
            y = y.reshape(-1)[output_index]
        return torch.sum(y)

    g = grad(scalar_out)

    def one(xi, bi):
        # midpoint rule over the interpolation path
        alphas = (torch.arange(steps, dtype=torch.float32, device=xi.device) + 0.5) / steps
        pts = bi[None] + alphas[:, None] * (xi - bi)[None]
        gs = vmap(g)(pts)
        return (xi - bi) * torch.mean(gs, dim=0)

    batched = vmap(one)

    def run(x, baseline=None):
        x = torch.as_tensor(np.asarray(x, np.float32), device=dev)
        base = torch.zeros_like(x) if baseline is None else torch.broadcast_to(
            torch.as_tensor(np.asarray(baseline, np.float32), device=dev), x.shape)
        return batched(x, base).detach().cpu().numpy()

    return run


def integrated_gradients(apply: Callable, params: Any, x: "np.ndarray",
                         baseline: Optional["np.ndarray"] = None,
                         steps: int = 32, output_index: Optional[int] = None):
    """One-shot convenience over ``make_integrated_gradients`` — attributions
    [batch, d] from ``baseline`` (default zeros); ``output_index`` selects
    one output column (default: sum of outputs).  Completeness either way:
    attributions sum to f(x) - f(baseline) up to the midpoint rule."""
    return make_integrated_gradients(apply, params, steps, output_index)(
        x, baseline)


# ---------------------------------------------------------------- black-box


def _exact_shap(predict: Callable, x: "np.ndarray", bg: "np.ndarray"):
    """Exact Shapley values for one instance: every coalition evaluated in
    ONE predict call (2^d masked rows), then the classic weighted sum."""
    d = x.shape[0]
    masks = np.array(list(itertools.product((0, 1), repeat=d)), np.bool_)
    rows = np.where(masks, x[None, :], bg[None, :])
    preds = np.asarray(predict(rows), np.float64).reshape(len(masks), -1).sum(axis=1)
    by_mask = {tuple(int(b) for b in m): p for m, p in zip(masks, preds)}
    fact = math.factorial
    phi = np.zeros(d)
    for i in range(d):
        acc = 0.0
        for m, p in by_mask.items():
            if m[i]:
                continue
            with_i = list(m)
            with_i[i] = 1
            s = sum(m)
            weight = fact(s) * fact(d - s - 1) / fact(d)
            acc += weight * (by_mask[tuple(with_i)] - p)
        phi[i] = acc
    return phi


def _sampled_shap(predict: Callable, x: "np.ndarray", bg: "np.ndarray",
                  nsamples: int, seed: int):
    """KernelSHAP-style estimate for larger d: sample coalitions by the
    Shapley kernel over sizes, antithetic pairs, one batched predict, then
    the constrained weighted least squares (constraint: completeness)."""
    d = x.shape[0]
    rng = np.random.default_rng(seed)
    sizes = np.arange(1, d)
    kernel = (d - 1) / (sizes * (d - sizes))
    kernel = kernel / kernel.sum()
    half = max(nsamples // 2, d + 2)
    picks = rng.choice(sizes, size=half, p=kernel)
    masks = np.zeros((2 * half, d), np.bool_)
    for j, s in enumerate(picks):
        idx = rng.choice(d, size=s, replace=False)
        masks[2 * j, idx] = True
        masks[2 * j + 1] = ~masks[2 * j]  # antithetic pair
    rows = np.where(masks, x[None, :], bg[None, :])
    both = np.concatenate([rows, x[None, :], bg[None, :]], axis=0)
    preds = np.asarray(predict(both), np.float64).reshape(len(both), -1).sum(axis=1)
    v = preds[:-2]
    f_x, f_bg = preds[-2], preds[-1]
    # eliminate the completeness constraint: phi_d = (f_x - f_bg) - sum(rest)
    z = masks.astype(np.float64)
    y = v - f_bg - z[:, -1] * (f_x - f_bg)
    A = z[:, :-1] - z[:, -1:]
    sol, *_ = np.linalg.lstsq(A, y, rcond=None)
    phi = np.empty(d)
    phi[:-1] = sol
    phi[-1] = (f_x - f_bg) - sol.sum()
    return phi


def shap_values(predict: Callable, X: "np.ndarray", background: "np.ndarray",
                exact_features: int = 12, nsamples: int = 2048,
                seed: int = 0) -> "np.ndarray":
    """Shapley attributions [batch, d] for a black-box ``predict(rows)``.

    ``background``: [k, d] reference rows; masked-out features take the
    background MEAN (one synthetic baseline keeps every coalition a single
    predict row — the d<=exact_features path is then exactly the Shapley
    value of that value function, which for linear models equals
    w * (x - mean(background)))."""
    X = np.asarray(X, np.float64)
    bg = np.asarray(background, np.float64).reshape(-1, X.shape[-1]).mean(axis=0)
    out = []
    for x in X:
        if X.shape[-1] <= exact_features:
            out.append(_exact_shap(predict, x, bg))
        else:
            out.append(_sampled_shap(predict, x, bg, nsamples, seed))
    return np.stack(out)


# ------------------------------------------------------------ runtime model


class ExplainerModel(Model):
    """The explainer component's served model: answers ``:explain`` using
    the method configured in ``model_dir/explainer.json``."""

    def __init__(self, name: str, model_dir: str, device=None):
        super().__init__(name)
        self.model_dir = model_dir
        self.device = device  # the white-box model's (default: the card)
        self.predictor = None  # PredictorClient, injected by runtime_main
        cfg_path = os.path.join(model_dir, "explainer.json")
        with open(cfg_path) as f:
            self.cfg = json.load(f)
        method = self.cfg.get("method")
        if method not in ("shap", "integrated_gradients"):
            raise ValueError(f"explainer.json method must be 'shap' or "
                             f"'integrated_gradients', got {method!r}")

    def load(self) -> None:
        if self.cfg["method"] == "integrated_gradients":
            # white-box: the torch model lives in the same model_dir, under
            # the jax loader's load_torch contract; the attribution fn is
            # built ONCE
            from .runtime_main import load_torch_model

            apply, params, self.device = load_torch_model(
                self.model_dir, "explainer", self.device)
            self._ig = make_integrated_gradients(
                apply, params, steps=int(self.cfg.get("steps", 32)),
                output_index=self.cfg.get("output_index"), device=self.device)
        self.ready = True

    def _predict_rows(self, rows: "np.ndarray"):
        if self.predictor is None:
            raise RuntimeError("explainer has no PREDICTOR_HOST configured")
        out = self.predictor.predict(self.name,
                                     {"instances": np.asarray(rows).tolist()})
        p = np.asarray(out["predictions"], np.float64)
        oi = self.cfg.get("output_index")
        if oi is not None:
            # multi-output predictors (softmax heads): explain ONE column —
            # summing a probability vector is constant 1.0 and every
            # Shapley value would be exactly zero
            p = p.reshape(len(np.asarray(rows)), -1)[:, int(oi)]
        return p

    def explain(self, payload: Any, headers: Optional[dict] = None) -> Any:
        instances = payload.get("instances", payload) if isinstance(payload, dict) else payload
        X = np.asarray(instances, np.float64)
        cfg = self.cfg
        if cfg["method"] == "shap":
            bg = cfg.get("background")
            if bg is None:
                bg = np.zeros((1, X.shape[-1]))
            phi = shap_values(self._predict_rows, X, np.asarray(bg),
                              exact_features=int(cfg.get("exact_features", 12)),
                              nsamples=int(cfg.get("nsamples", 2048)),
                              seed=int(cfg.get("seed", 0)))
            return [{"shap_values": p.tolist()} for p in phi]
        attr = self._ig(
            X.astype(np.float32),
            baseline=(np.asarray(cfg["baseline"], np.float32)
                      if cfg.get("baseline") is not None else None))
        return [{"attributions": a.tolist()} for a in attr]
