"""TFJob MNIST CNN worker (BASELINE.json config[0]).

Counterpart of ``kubeflow_tpu/examples/mnist_worker.py``, with the same
environment (``TRAIN_STEPS``, ``BATCH_SIZE``, ``LEARNING_RATE``,
``LOCAL_DEVICES``) and the same stdout lines (``loss=``, ``accuracy=``,
``samples_per_sec=``, ``MNIST-OK``).  Runs as the pod command of a
TFJob/TPUJob replica: joins the process group from the injected env, trains
the CNN on synthetic MNIST with Adam (``optax.adam``'s arithmetic), and
prints Katib-style ``key=value`` metrics.  The device is ``TORCH_DEVICE``
(default the card).  As the JAX worker (which builds no mesh), each process
of a job trains on its own device, ``LOCAL_DEVICES`` > 1 included.  TF32 is off for convolutions and matmuls, so an f32
config computes in f32 on the card as on the CPU.

    python -m kubeflow_tpu_torch.examples.mnist_worker
"""

from __future__ import annotations

import os
import time


def main() -> None:
    import torch

    from kubeflow_tpu_torch.models import mnist
    from kubeflow_tpu_torch.parallel.distributed import initialize
    from kubeflow_tpu_torch.train.data import to_device
    from kubeflow_tpu_torch.train.trainer import adam
    from kubeflow_tpu_torch.utils.jax_platform import honor_jax_platforms

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = honor_jax_platforms()
    initialize(local_device_count=int(os.environ.get("LOCAL_DEVICES", "1")), device=device)

    steps = int(os.environ.get("TRAIN_STEPS", "60"))
    batch = int(os.environ.get("BATCH_SIZE", "64"))
    lr = float(os.environ.get("LEARNING_RATE", "1e-3"))

    config = mnist.MnistConfig()
    params = {k: v.requires_grad_() for k, v in mnist.init(config, device, seed=0).items()}
    opt = adam(lr)
    opt_state = opt.init(params)

    def step(b):
        loss = mnist.loss(params, config, b["images"], b["labels"])
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        opt.update(grads, opt_state, params)
        return loss.detach()

    batches = [to_device(mnist.synthetic_batch(i + 1, batch), device) for i in range(steps)]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    loss = None
    for b in batches:
        loss = step(b)
    loss = float(loss)  # waits for the device
    dt = time.perf_counter() - t0
    with torch.no_grad():
        acc = float(mnist.accuracy(params, config,
                                   **to_device(mnist.synthetic_batch(0, 256), device)))
    print(f"loss={loss:.4f}")
    print(f"accuracy={acc:.4f}")
    print(f"samples_per_sec={steps * batch / dt:.1f}")
    print("MNIST-OK")


if __name__ == "__main__":
    main()
