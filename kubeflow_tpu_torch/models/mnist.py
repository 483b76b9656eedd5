"""MNIST CNN: the TFJob benchmark workload (BASELINE.json config[0]).

Counterpart of ``kubeflow_tpu/models/mnist.py``: the classic two-conv CNN,
bf16 weights with f32 loss math.  The public functions keep the JAX
package's layout: images are NHWC ``[B, 28, 28, 1]`` and the parameters keep
its names.  Inside, the convolutions run in PyTorch's NCHW order, so the two
conv kernels are stored OIHW (``params_from_jax`` transposes the JAX
package's HWIO kernels) and the activations are permuted back to NHWC before
the flatten, because ``dense_kernel`` is ``[49 * c2, d]`` in NHWC order.
``SHARDING_RULES`` waits for ROADMAP Queue 1 item 3.3.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device
from ._tree import tensor_from_numpy


@dataclass(frozen=True)
class MnistConfig:
    num_classes: int = 10
    conv1_features: int = 32
    conv2_features: int = 64
    dense_features: int = 512
    dtype: torch.dtype = torch.bfloat16

    @property
    def num_params(self) -> int:
        c1, c2, d = self.conv1_features, self.conv2_features, self.dense_features
        return (25 * c1 + c1) + (25 * c1 * c2 + c2) + (49 * c2 * d + d) + (d * self.num_classes + self.num_classes)


CONV_KERNELS = ("conv1_kernel", "conv2_kernel")


def init(config: MnistConfig = MnistConfig(), device=None, seed: int = 0) -> dict:
    """He-normal kernels and zero biases, drawn in f32 on the CPU from a
    ``torch.Generator`` seeded by ``seed`` and cast to ``config.dtype`` (the
    JAX package's scales, not its numbers: ``params_from_jax`` carries
    those)."""
    dev = resolve_device(device)
    c1, c2, d = config.conv1_features, config.conv2_features, config.dense_features
    g = torch.Generator().manual_seed(seed)

    def he(shape, fan_in):
        return (torch.randn(shape, generator=g) * (2.0 / fan_in) ** 0.5).to(dev, config.dtype)

    def zeros(n):
        return torch.zeros((n,), dtype=config.dtype, device=dev)

    return {
        "conv1_kernel": he((c1, 1, 5, 5), 25),
        "conv1_bias": zeros(c1),
        "conv2_kernel": he((c2, c1, 5, 5), 25 * c1),
        "conv2_bias": zeros(c2),
        "dense_kernel": he((49 * c2, d), 49 * c2),
        "dense_bias": zeros(d),
        "out_kernel": he((d, config.num_classes), d),
        "out_bias": zeros(config.num_classes),
    }


def params_from_jax(np_tree: dict, device=None) -> dict:
    """The JAX package's parameters (numpy leaves) -> tensors on ``device``
    (default ``"cuda"``), bit for bit, the HWIO conv kernels as OIHW."""
    dev = resolve_device(device)
    out = {}
    for name, arr in np_tree.items():
        t = tensor_from_numpy(arr)
        out[name] = (t.permute(3, 2, 0, 1) if name in CONV_KERNELS else t).contiguous().to(dev)
    return out


def forward(params: dict, config: MnistConfig, images: torch.Tensor) -> torch.Tensor:
    """images [B, 28, 28, 1] -> f32 logits [B, 10]."""
    x = images.to(config.dtype).permute(0, 3, 1, 2)
    for i in (1, 2):
        # "SAME" at stride 1 with a 5x5 kernel: 2 on every side; the bias is
        # added after the convolution's bf16 rounding, as the JAX package adds it
        x = F.conv2d(x, params[f"conv{i}_kernel"], padding=2)
        x = torch.relu(x + params[f"conv{i}_bias"][:, None, None])
        # 2x2 windows at stride 2 tile 28 and 14 exactly: "SAME" pads nothing
        x = F.max_pool2d(x, 2, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flatten in NHWC order
    x = torch.relu(x @ params["dense_kernel"] + params["dense_bias"])
    return (x @ params["out_kernel"] + params["out_bias"]).float()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """-mean(sum(one_hot(labels) * log_softmax(logits))) of f32 logits."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.take_along_dim(logp, labels.long()[:, None], dim=-1).mean()


def loss(params: dict, config: MnistConfig, images: torch.Tensor,
         labels: torch.Tensor) -> torch.Tensor:
    return cross_entropy(forward(params, config, images), labels)


def accuracy(params: dict, config: MnistConfig, images: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
    return (forward(params, config, images).argmax(-1) == labels).float().mean()


def synthetic_batch(seed: int, batch_size: int) -> dict:
    """Deterministic class-structured fake MNIST, drawn with numpy from
    ``seed``: the label's image row lit, plus noise (labels recoverable, so
    the model can fit it).  The JAX package draws with ``jax.random``, so the
    numbers differ; the structure is the same."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, batch_size).astype(np.int32)
    base = np.zeros((batch_size, 28, 28), np.float32)
    base[np.arange(batch_size), labels, :] = 1.0
    noise = 0.3 * rng.standard_normal((batch_size, 28, 28), dtype=np.float32)
    return {"images": (base + noise)[..., None], "labels": labels}
