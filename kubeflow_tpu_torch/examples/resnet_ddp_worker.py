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

Two paths, both data parallel over equal slices of one global batch of
``PER_CHIP_BATCH`` x the job's devices (drawn whole from the step's seed, as
the JAX worker's ``make_batch`` draws it), so the gradient is the
global-batch gradient:

* the default path joins a ``torch.distributed`` group through
  ``parallel.distributed.initialize`` (gloo on the CPU, nccl on the card;
  one rank per card, so one process on a one-card machine) and averages the
  gradients with ``all_reduce``.  A one-process job with ``LOCAL_DEVICES=N``
  > 1 trains as the JAX worker does over its N devices: over
  ``build_mesh(MeshConfig(data=N), [device] * N)``, the parameters and the
  SGD momentum replicated (one tensor of each on the one device), each data shard
  taking its own rows of the global batch through ResNet's mesh loss, whose
  exact global mean makes the gradient the shards' mean gradient, as
  ``dist_mean`` averages the ranks'.  ``LOCAL_DEVICES`` > 1 in a job of
  several processes trains, as the JAX worker does, over the job's global
  ``MeshConfig(data=world x N)`` (``parallel/distributed.devices()``): each
  process materializes only its rows of the step's global batch (assembled
  by ``train.data.global_batch``), the mesh loss is the global mean, and
  ``dist_sum`` adds the processes' shares of the gradient;
* ``DDP_TRANSPORT=shim``: every process keeps a full replica and the
  per-step gradient sync goes through the C++ ring (``transport/``) over
  host TCP instead, so several processes can share one card.

    python -m kubeflow_tpu_torch.examples.resnet_ddp_worker
"""

from __future__ import annotations

import contextlib
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
               update: bool = True, mesh=None) -> torch.Tensor:
    """One local forward/backward, the gradient sync (``sync``: a dict of
    named gradients -> their mean over ranks; None for one process) and,
    with ``update``, one SGD step.  On ``mesh`` (N data shards of
    ``device``) the loss is ResNet's mesh loss over the shards' rows, the
    parameters replicated over them: the shards of the one device read
    the one tensor of each leaf.  Returns the loss, on the device."""
    from kubeflow_tpu_torch.models import resnet
    from kubeflow_tpu_torch.train.data import global_batch

    with mesh if mesh is not None else contextlib.nullcontext():
        if mesh is not None and not mesh.is_fully_addressable:
            # this process's rows of the global batch, on its positions
            b = global_batch({"images": imgs, "labels": lbls}, mesh)
            images, labels = b["images"], b["labels"]
        else:
            images, labels = torch.from_numpy(imgs).to(device), torch.from_numpy(lbls).to(device)
        loss = resnet.loss(params, config, images, labels)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    if sync is not None:
        grads = sync(grads)
    if update:
        opt.update(grads, opt_state, leaves)
    return loss.detach()


def dist_sum(grads: dict) -> dict:
    """The mesh across processes' sync: each process's gradient is its
    share of the global mean's, so the ranks' shares add up: one
    ``all_reduce`` of every leaf in sorted name order, in f32 (staged
    through host memory where the processes share a card)."""
    from kubeflow_tpu_torch.parallel.distributed import all_reduce_sum

    names = sorted(grads)
    total = all_reduce_sum(torch.cat([grads[n].float().reshape(-1) for n in names]))
    off = 0
    for n in names:
        g = grads[n]
        grads[n] = total[off:off + g.numel()].reshape(g.shape).to(g.dtype)
        off += g.numel()
    return grads


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
         warm_update: bool, local_devices: int = 1) -> dict:
    """The timed loop of both paths, after a warm-up step on batch 0 that
    updates the weights (``warm_update``, the default path's compile step)
    or only computes the gradients (the shim's), as in the JAX worker.
    ``local_devices`` > 1 trains over a data mesh of that many shards of
    ``device`` in each process, over the job's global devices at world > 1."""
    s = settings()
    mesh = None
    if local_devices > 1:
        from kubeflow_tpu_torch.parallel import distributed
        from kubeflow_tpu_torch.parallel.mesh import MeshConfig, build_mesh

        devs = distributed.devices() if world > 1 else [device] * local_devices
        mesh = build_mesh(MeshConfig(data=len(devs), fsdp=1), devs)
    config, params, leaves, opt, opt_state = make_model(s["num_classes"], device)

    def batch(seed):
        # the step's global batch of PER_CHIP_BATCH x every device of the
        # job; this process keeps its ranks' rows, its mesh splits them
        return local_batch(seed, world, rank, s["per_chip_batch"] * local_devices,
                           s["image_size"], s["num_classes"])

    train_step(config, params, leaves, opt, opt_state, *batch(0), device, sync, warm_update,
               mesh=mesh)
    loss = None
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for i in range(s["steps"]):
        loss = train_step(config, params, leaves, opt, opt_state, *batch(i + 1), device, sync,
                          mesh=mesh)
    loss = float(loss)  # waits for the device
    dt = time.perf_counter() - t0
    devices = world * local_devices
    sps = s["steps"] * s["per_chip_batch"] * devices / dt
    # global mean loss so every rank prints the single-process-comparable value
    return {"loss": mean_loss(loss), "samples_per_sec": sps, "per_chip": sps / devices,
            "devices": devices}


def _report(res: dict, world: int) -> None:
    print(f"loss={res['loss']:.4f}")
    print(f"samples_per_sec={res['samples_per_sec']:.1f}")
    print(f"samples_per_sec_per_chip={res['per_chip']:.1f}")
    print(f"world size={world} global devices={res['devices']}")


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

    local_devices = int(os.environ.get("LOCAL_DEVICES", "1"))
    penv = initialize(local_device_count=local_devices, device=device)
    world, rank = penv.num_processes, penv.process_id

    def mean_loss(x: float) -> float:
        if world == 1:
            return x
        t = torch.tensor([x], device=device)
        dist.all_reduce(t)
        return float(t[0]) / world

    sync = None if world == 1 else dist_sum if local_devices > 1 else dist_mean
    try:
        res = _run(device, world, rank, sync, mean_loss if local_devices == 1 else float,
                   warm_update=True, local_devices=local_devices)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    _report(res, world)
    print("RESNET-DDP-OK")


if __name__ == "__main__":
    main()
