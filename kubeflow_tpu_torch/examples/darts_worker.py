"""DARTS trial workload: differentiable architecture search in one trial.

Counterpart of ``kubeflow_tpu/examples/darts_worker.py``, with the same
environment (``NUM_LAYERS``, ``DIM``, ``SEARCH_STEPS``, ``SEED``) and the
same stdout lines (``step=... train_loss=... val_loss=...``, ``genotype=``,
``val_acc=``, ``discretized_loss=``, ``DARTS-OK``).  Katib's DARTS runs the
whole differentiable search inside one trial container; this is that
container.  Each step is bilevel (first-order DARTS): the supernet weights
take an Adam step on a train batch, then the architecture logits an Adam
step on a validation batch.

Search space: a chain of ``NUM_LAYERS`` mixed ops, each a temperature-
annealed softmax mixture of {linear, relu-linear, skip, zero}.  The target
is a relu-linear stack, so only the all-``relu_linear`` genotype can
represent it: a correct search recovers it.  The draws (weights, target,
batches) come from a ``torch.Generator`` seeded from ``SEED`` on the CPU, so
the numbers differ from the JAX worker's; the search is the same.  The
device is ``TORCH_DEVICE`` (default the card), with TF32 off.

    python -m kubeflow_tpu_torch.examples.darts_worker
"""

from __future__ import annotations

import json
import os

import torch

OPS = ("linear", "relu_linear", "skip", "zero")
BATCH = 64


def target_fn(tgt: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    h = x
    for l in range(tgt.shape[0]):
        h = torch.relu(h @ tgt[l])
    return h


def mixed_layer(h, w_lin, w_relu, a, tau):
    # temperature-annealed mixture (SNAS-style): tau decays toward 0 so the
    # relaxation sharpens to a discrete choice
    p = torch.softmax(a / tau, dim=-1)
    return (p[0] * (h @ w_lin)
            + p[1] * torch.relu(h @ w_relu)
            + p[2] * h
            + p[3] * torch.zeros_like(h))


def forward(weights: dict, alphas: torch.Tensor, x: torch.Tensor, tau) -> torch.Tensor:
    h = x
    for l in range(alphas.shape[0]):
        h = mixed_layer(h, weights["linear"][l], weights["relu_linear"][l], alphas[l], tau)
    return h


def loss(weights: dict, alphas: torch.Tensor, tgt: torch.Tensor, x: torch.Tensor,
         tau=1.0) -> torch.Tensor:
    return ((forward(weights, alphas, x, tau) - target_fn(tgt, x)) ** 2).mean()


def search_step(weights: dict, alphas: torch.Tensor, w_opt, w_state, a_opt, a_state,
                tgt: torch.Tensor, x_train: torch.Tensor, x_val: torch.Tensor, tau):
    """One bilevel step, in place: the weights on ``x_train``, then the
    alphas on ``x_val`` through the updated weights.  Returns the two
    losses (before their updates)."""
    wl = loss(weights, alphas.detach(), tgt, x_train, tau)
    w_grads = dict(zip(weights, torch.autograd.grad(wl, list(weights.values()))))
    w_opt.update(w_grads, w_state, weights)
    vl = loss({k: v.detach() for k, v in weights.items()}, alphas, tgt, x_val, tau)
    (a_grad,) = torch.autograd.grad(vl, [alphas])
    a_opt.update({"alphas": a_grad}, a_state, {"alphas": alphas})
    return wl.detach(), vl.detach()


def tau_at(i: int, steps: int) -> float:
    """The 1.0 -> 0.1 anneal."""
    return max(1.0 - i / max(steps - 1, 1), 0.1)


def main() -> None:
    from kubeflow_tpu_torch.train.trainer import adam
    from kubeflow_tpu_torch.utils.jax_platform import honor_jax_platforms

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = honor_jax_platforms()
    num_layers = int(os.environ.get("NUM_LAYERS", "4"))
    dim = int(os.environ.get("DIM", "16"))
    steps = int(os.environ.get("SEARCH_STEPS", "150"))
    seed = int(os.environ.get("SEED", "0"))

    gen = torch.Generator().manual_seed(seed)

    def normal(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(device)

    # supernet weights: one kernel per (layer, op-with-weights)
    weights = {"linear": normal(num_layers, dim, dim, scale=0.3).requires_grad_(),
               "relu_linear": normal(num_layers, dim, dim, scale=0.3).requires_grad_()}
    alphas = torch.zeros((num_layers, len(OPS)), device=device, requires_grad=True)
    tgt = normal(num_layers, dim, dim, scale=0.3)
    w_opt, a_opt = adam(3e-3), adam(3e-2)
    w_state, a_state = w_opt.init(weights), a_opt.init({"alphas": alphas})
    data = [(normal(BATCH, dim), normal(BATCH, dim)) for _ in range(steps)]

    for i, (x_train, x_val) in enumerate(data):
        wl, vl = search_step(weights, alphas, w_opt, w_state, a_opt, a_state, tgt,
                             x_train, x_val, tau_at(i, steps))
        if (i + 1) % 50 == 0:
            print(f"step={i + 1} train_loss={float(wl):.5f} val_loss={float(vl):.5f}", flush=True)

    with torch.no_grad():
        choice = alphas.argmax(dim=1)
        genotype = [OPS[int(i)] for i in choice]
        # score: 1 / (1 + val loss of the DISCRETIZED architecture)
        hard = torch.full((num_layers, len(OPS)), -30.0, device=device)
        hard[torch.arange(num_layers, device=device), choice] = 30.0
        x_test = (torch.randn((256, dim), generator=torch.Generator().manual_seed(seed + 999))
                  .to(device))
        disc_loss = float(loss(weights, hard, tgt, x_test))
    val_acc = 1.0 / (1.0 + disc_loss)
    print("genotype=" + json.dumps(genotype), flush=True)
    print(f"val_acc={val_acc:.6f}", flush=True)
    print(f"discretized_loss={disc_loss:.6f}", flush=True)
    print("DARTS-OK", flush=True)


if __name__ == "__main__":
    main()
