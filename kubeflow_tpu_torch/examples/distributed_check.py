"""Pod entrypoint: verify the injected rendezvous env forms a real process
group, run a cross-process sum, and train a tiny data-parallel model.

Counterpart of ``kubeflow_tpu/examples/distributed_check.py`` on
``torch.distributed`` (gloo on the CPU, nccl on the card), with the same
stdout protocol: ``RENDEZVOUS process=i/n global_devices=g``, ``PSUM
got=x expected=y``, ``STEP i loss=...`` for five data-parallel steps, then
``TRAIN-OK``.  One device per process; a one-process job forms no group,
and its sums are over itself.  The device is ``TORCH_DEVICE`` (default the
card).  The weights and each process's data are drawn with numpy (weights
from seed 0, process p's data from seed p + 1), where the JAX worker draws
with ``jax.random``: the same law, other numbers.

    python -m kubeflow_tpu_torch.examples.distributed_check
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

LR = 0.05
STEPS = 5


def draw(process_id: int) -> tuple:
    """(w [8, 4], x [16, 8], y [16, 4]) f32 numpy arrays of one process."""
    w = np.random.default_rng(0).standard_normal((8, 4)).astype(np.float32) * np.float32(0.1)
    x = np.random.default_rng(process_id + 1).standard_normal((16, 8)).astype(np.float32)
    y = np.repeat(np.sin(x.sum(-1, keepdims=True)), 4, axis=-1)
    return w, x, y


def loss_fn(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return ((x @ w - y) ** 2).mean()


def train(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
          all_reduce: Callable[[torch.Tensor], None], steps: int = STEPS,
          report: Optional[Callable[[int, float], None]] = None) -> tuple:
    """``steps`` data-parallel steps: this process's gradient and loss,
    summed over every process by ``all_reduce`` (in place), then ``w - LR *
    sum(grad)``.  Returns (w, [summed loss of each step])."""
    losses = []
    for i in range(steps):
        w = w.detach().requires_grad_()
        loss = loss_fn(w, x, y)
        (grad,) = torch.autograd.grad(loss, w)
        packed = torch.cat([grad.reshape(-1), loss.detach().reshape(1)])
        all_reduce(packed)
        w = w.detach() - LR * packed[:-1].reshape(w.shape)
        losses.append(float(packed[-1]))
        if report is not None:
            report(i, losses[-1])
    return w, losses


def main() -> None:
    import torch.distributed as dist

    from kubeflow_tpu_torch.parallel.distributed import initialize
    from kubeflow_tpu_torch.utils.jax_platform import honor_jax_platforms

    torch.backends.cuda.matmul.allow_tf32 = False
    device = honor_jax_platforms()
    penv = initialize(local_device_count=1, device=device)

    def all_reduce(t: torch.Tensor) -> None:
        if dist.is_initialized():
            dist.all_reduce(t)

    try:
        n_global = penv.num_processes
        print(f"RENDEZVOUS process={penv.process_id}/{penv.num_processes} "
              f"global_devices={n_global}", flush=True)

        # cross-process collective: sum of (process_id + 1) over all processes
        x = torch.full((1,), float(penv.process_id + 1), device=device)
        all_reduce(x)
        expected = sum(p + 1 for p in range(penv.num_processes))
        print(f"PSUM got={float(x[0])} expected={float(expected)}", flush=True)
        assert float(x[0]) == float(expected), "psum mismatch"

        # tiny data-parallel training step: grads summed across processes
        w, xs, ys = (torch.from_numpy(a).to(device) for a in draw(penv.process_id))
        _, losses = train(w, xs, ys, all_reduce,
                          report=lambda i, v: print(f"STEP {i} loss={v:.5f}", flush=True))
        assert losses[-1] < losses[0], "loss did not decrease"
        print("TRAIN-OK", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
