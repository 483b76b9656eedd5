"""PyTorchJob-parity ResNet-50 DDP worker (BASELINE.json config[1]).

Counterpart of ``kubeflow_tpu/examples/resnet_ddp_worker.py``, with the same
environment (``TRAIN_STEPS``, ``PER_CHIP_BATCH``, ``IMAGE_SIZE``,
``DDP_TRANSPORT``, ``LOCAL_DEVICES`` and the operator-injected
``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``) and the same
stdout lines (``loss=``, ``samples_per_sec=``, ``samples_per_sec_per_chip=``,
``world size=... global devices=...``, ``transport=shim`` on the shim path,
``RESNET-DDP-OK``).  ``NUM_CLASSES`` (default 100, the JAX worker's) sets
the classifier's width.  The optimiser is ``optax.sgd(0.1, momentum=0.9)``'s
arithmetic, TF32 is off, and the device is ``TORCH_DEVICE`` (default the
card).

Two paths, both data parallel over equal local slices of one global batch
(every rank draws the whole batch from the step's seed and keeps its slice),
so mean-reduced gradients equal the global-batch gradient:

* the default path joins a ``torch.distributed`` group through
  ``parallel.distributed.initialize`` (gloo on the CPU, nccl on the card;
  one rank per card, so one process on a one-card machine) and averages the
  gradients with ``all_reduce``;
* ``DDP_TRANSPORT=shim``: every process keeps a full replica and the
  per-step gradient sync goes through the C++ ring (``transport/``) over
  host TCP instead, so several processes can share one card.

    python -m kubeflow_tpu_torch.examples.resnet_ddp_worker
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np
import torch

LEARNING_RATE, MOMENTUM = 0.1, 0.9


def settings() -> dict:
    env = os.environ
    return {"steps": int(env.get("TRAIN_STEPS", "3")),
            "per_chip_batch": int(env.get("PER_CHIP_BATCH", "8")),
            "image_size": int(env.get("IMAGE_SIZE", "64")),
            "num_classes": int(env.get("NUM_CLASSES", "100"))}


def local_batch(seed: int, world: int, rank: int, per_chip_batch: int, image_size: int,
                num_classes: int) -> tuple:
    """This rank's slice of the step's global batch (the JAX worker's
    ``np.random.seed(seed)`` draws, from a generator of its own)."""
    rs = np.random.RandomState(seed)
    global_batch = per_chip_batch * world
    imgs = rs.randn(global_batch, image_size, image_size, 3).astype(np.float32)
    lbls = rs.randint(0, num_classes, (global_batch,))
    lo = rank * per_chip_batch
    return imgs[lo:lo + per_chip_batch], lbls[lo:lo + per_chip_batch]


def make_model(num_classes: int, device):
    """The replica every rank starts from: ``ResNetConfig(num_classes)``,
    seed 0, so all ranks hold equal weights; its flat named leaves; the
    optimiser and its state."""
    from kubeflow_tpu_torch.models import resnet
    from kubeflow_tpu_torch.models._tree import named_leaves
    from kubeflow_tpu_torch.train.trainer import SGD

    config = resnet.ResNetConfig(num_classes=num_classes)
    params = resnet.init(config, device, seed=0)
    leaves = named_leaves(params)
    for t in leaves.values():
        t.requires_grad_()
    opt = SGD(LEARNING_RATE, MOMENTUM)
    return config, params, leaves, opt, opt.init(leaves)


def train_step(config, params: dict, leaves: dict, opt, opt_state, imgs, lbls, device,
               sync: Optional[Callable[[dict], dict]] = None,
               update: bool = True) -> torch.Tensor:
    """One local forward/backward, the gradient sync (``sync``: a dict of
    named gradients -> their mean over ranks; None for one process) and,
    with ``update``, one SGD step.  Returns the local loss, on the device."""
    from kubeflow_tpu_torch.models import resnet

    loss = resnet.loss(params, config, torch.from_numpy(imgs).to(device),
                       torch.from_numpy(lbls).to(device))
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    if sync is not None:
        grads = sync(grads)
    if update:
        opt.update(grads, opt_state, leaves)
    return loss.detach()


def dist_mean(grads: dict) -> dict:
    """The default path's sync: a mean ``all_reduce`` per leaf over the
    ``torch.distributed`` group, in sorted name order on every rank."""
    import torch.distributed as dist

    world = dist.get_world_size()
    for n in sorted(grads):
        dist.all_reduce(grads[n])
        grads[n].div_(world)
    return grads


def _run(device, world: int, rank: int, sync, mean_loss: Callable[[float], float],
         warm_update: bool) -> dict:
    """The timed loop of both paths, after a warm-up step on batch 0 that
    updates the weights (``warm_update``, the default path's compile step)
    or only computes the gradients (the shim's), as in the JAX worker."""
    s = settings()
    config, params, leaves, opt, opt_state = make_model(s["num_classes"], device)

    def batch(seed):
        return local_batch(seed, world, rank, s["per_chip_batch"], s["image_size"],
                           s["num_classes"])

    train_step(config, params, leaves, opt, opt_state, *batch(0), device, sync, warm_update)
    loss = None
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for i in range(s["steps"]):
        loss = train_step(config, params, leaves, opt, opt_state, *batch(i + 1), device, sync)
    loss = float(loss)  # waits for the device
    dt = time.perf_counter() - t0
    sps = s["steps"] * s["per_chip_batch"] * world / dt
    # global mean loss so every rank prints the single-process-comparable value
    return {"loss": mean_loss(loss), "samples_per_sec": sps, "per_chip": sps / world}


def _report(res: dict, world: int) -> None:
    print(f"loss={res['loss']:.4f}")
    print(f"samples_per_sec={res['samples_per_sec']:.1f}")
    print(f"samples_per_sec_per_chip={res['per_chip']:.1f}")
    print(f"world size={world} global devices={world}")


def main_shim(device) -> None:
    """DDP via the C++ transport shim: local compute, ring allreduce sync."""
    from kubeflow_tpu_torch.transport import RingTransport, grad_allreduce

    tr = RingTransport.from_env()
    try:
        res = _run(device, tr.world, tr.rank, lambda g: grad_allreduce(tr, g),
                   lambda x: float(tr.allreduce(np.array([x], np.float32), mean=True)[0]),
                   warm_update=False)
        tr.barrier()
    finally:
        tr.close()
    _report(res, tr.world)
    print("transport=shim")
    print("RESNET-DDP-OK")


def main() -> None:
    from kubeflow_tpu_torch.utils.jax_platform import honor_jax_platforms

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = honor_jax_platforms()
    if os.environ.get("DDP_TRANSPORT") == "shim":
        main_shim(device)
        return
    import torch.distributed as dist

    from kubeflow_tpu_torch.parallel.distributed import initialize

    penv = initialize(local_device_count=int(os.environ.get("LOCAL_DEVICES", "1")),
                      device=device)
    world, rank = penv.num_processes, penv.process_id

    def mean_loss(x: float) -> float:
        if world == 1:
            return x
        t = torch.tensor([x], device=device)
        dist.all_reduce(t)
        return float(t[0]) / world

    try:
        res = _run(device, world, rank, dist_mean if world > 1 else None, mean_loss,
                   warm_update=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    _report(res, world)
    print("RESNET-DDP-OK")


if __name__ == "__main__":
    main()
