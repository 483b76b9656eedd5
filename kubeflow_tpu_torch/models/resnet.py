"""ResNet-50 with GroupNorm: the PyTorchJob DDP benchmark workload
(BASELINE.json config[1]).

Counterpart of ``kubeflow_tpu/models/resnet.py``: bf16 weights, GroupNorm
(stateless, computed in f32 with the population variance, then cast back),
``gn3.scale`` zero-initialised so every residual branch starts as identity.
``forward`` takes NHWC images, as the JAX function does, and permutes them
to NCHW with channels-last strides, which cuDNN's NHWC convolutions read as
they are.  The conv kernels are stored OIHW (``params_from_jax`` transposes
the JAX package's HWIO kernels); the parameter tree keeps the JAX names and
its ``blocks`` list.

"SAME" padding is the JAX package's: where the total padding is odd (every
stride-2 convolution and the stem's max pool at even sizes), the extra row
and column go on the high side, so a stride-2 layer pads explicitly
(``F.pad``) rather than through ``conv2d``'s symmetric ``padding``; the 7x7
stride-2 stem at 224 pads (2, 3) and the 3x3 stride-2 max pool (0, 1), with
-inf.

``SHARDING_RULES`` are the JAX package's, with the conv kernels' spec laid
out as ``params_from_jax`` lays out the kernels: the JAX rule
``P(None, None, None, "fsdp")`` splits an HWIO kernel's output channels,
which are dim 0 of the port's OIHW kernel, so the port's rule is
``P("fsdp", None, None, None)`` and every leaf's shard holds the same
numbers as the JAX shard.  On a mesh (``with mesh:``), with the parameters
placed by these rules, ``forward``, ``loss`` and ``accuracy``-style callers
split the batch over ``("data", "fsdp")``: the conv kernels are gathered at
use, GroupNorm stays local to each example (no state to reduce), and the
classifier is column-parallel over ``tensor`` (``fc_kernel``'s classes,
the replicated ``fc_bias`` sliced to each tensor shard's classes), its
logits left split and their cross entropy reduced over ``tensor``
(``models/_mesh.py``).  ``loss`` is the exact mean over the global batch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.shard_map_compat import each
from ..parallel.mesh import Mesh, current_mesh
from ..parallel.sharding import P, Views, place_params, tree_map_with_path
from ..utils.device import resolve_device
from . import _mesh
from ._tree import named_leaves, tensor_from_numpy

STAGES_50 = (3, 4, 6, 3)

SHARDING_RULES = (
    (r"fc_kernel", P("fsdp", "tensor")),
    # the JAX rule splits an HWIO kernel's output channels: dim 0 of OIHW
    (r".*conv.*", P("fsdp", None, None, None)),
    (r".*", P()),
)


@dataclass(frozen=True)
class ResNetConfig:
    stages: tuple = STAGES_50
    width: int = 64
    num_classes: int = 1000
    groups: int = 32  # GroupNorm groups
    dtype: torch.dtype = torch.bfloat16

    def flops_per_image(self) -> float:
        """Matmul-equivalent fwd FLOPs for 224x224 (the standard ~4.1 GFLOP)."""
        return 4.1e9


def count_params(params: dict) -> int:
    return sum(t.numel() for t in named_leaves(params).values())


def _strides(config: ResNetConfig) -> list:
    # the first block of every stage after the first halves the resolution
    return [2 if (b == 0 and stage > 0) else 1
            for stage, n_blocks in enumerate(config.stages) for b in range(n_blocks)]


def init(config: ResNetConfig = ResNetConfig(), device=None, seed: int = 0) -> dict:
    """He-normal conv kernels (OIHW), unit GroupNorm scales (``gn3``'s
    zero), zero biases and an N(0, 1/cin) classifier, drawn in f32 on the
    CPU from a ``torch.Generator`` seeded by ``seed`` and cast to
    ``config.dtype``: the JAX package's scales, not its numbers."""
    dev = resolve_device(device)
    dt, w = config.dtype, config.width
    g = torch.Generator().manual_seed(seed)

    def conv(kh, kw, cin, cout):
        fan_in = kh * kw * cin
        return (torch.randn((cout, cin, kh, kw), generator=g) * (2.0 / fan_in) ** 0.5).to(dev, dt)

    def gn(c, scale=1.0):
        return {"scale": torch.full((c,), scale, dtype=dt, device=dev),
                "bias": torch.zeros((c,), dtype=dt, device=dev)}

    params: dict = {"stem_conv": conv(7, 7, 3, w), "stem_gn": gn(w), "blocks": []}
    cin = w
    for stage, n_blocks in enumerate(config.stages):
        mid = w * (2 ** stage)
        cout = mid * 4
        for b in range(n_blocks):
            blk = {"conv1": conv(1, 1, cin, mid), "gn1": gn(mid),
                   "conv2": conv(3, 3, mid, mid), "gn2": gn(mid),
                   "conv3": conv(1, 1, mid, cout), "gn3": gn(cout, 0.0)}
            if b == 0:
                blk["proj"] = conv(1, 1, cin, cout)
                blk["proj_gn"] = gn(cout)
            params["blocks"].append(blk)
            cin = cout
    params["fc_kernel"] = (torch.randn((cin, config.num_classes), generator=g)
                           * cin ** -0.5).to(dev, dt)
    params["fc_bias"] = torch.zeros((config.num_classes,), dtype=dt, device=dev)
    return params


def params_from_jax(np_tree: dict, device=None) -> dict:
    """The JAX package's parameter tree (numpy leaves) -> the same tree of
    tensors on ``device`` (default ``"cuda"``), bit for bit, with the HWIO
    conv kernels (4-d leaves) as OIHW."""
    dev = resolve_device(device)

    def conv(arr):
        t = tensor_from_numpy(arr)
        return (t.permute(3, 2, 0, 1) if t.dim() == 4 else t).contiguous().to(dev)

    def tree(node):
        if isinstance(node, dict):
            return {k: tree(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [tree(v) for v in node]
        return conv(node)

    return tree(np_tree)


def _same_pad(size: int, k: int, stride: int) -> tuple:
    """(low, high) padding of "SAME": ceil(size / stride) outputs, the odd
    one out on the high side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, kernel, stride):
    k = kernel.shape[-1]
    (hlo, hhi), (wlo, whi) = (_same_pad(x.shape[2], k, stride), _same_pad(x.shape[3], k, stride))
    if hlo == hhi and wlo == whi:
        return F.conv2d(x, kernel, stride=stride, padding=(hlo, wlo))
    return F.conv2d(F.pad(x, (wlo, whi, hlo, hhi)), kernel, stride=stride)


def _group_norm(x, gn, groups, eps=1e-5):
    g = min(groups, x.shape[1])
    y = F.group_norm(x.float(), g, gn["scale"].float(), gn["bias"].float(), eps)
    return y.to(x.dtype)


def _max_pool_3x3_s2(x):
    (hlo, hhi), (wlo, whi) = _same_pad(x.shape[2], 3, 2), _same_pad(x.shape[3], 3, 2)
    return F.max_pool2d(F.pad(x, (wlo, whi, hlo, hhi), value=float("-inf")), 3, 2)


def forward(params: dict, config: ResNetConfig, images: torch.Tensor) -> torch.Tensor:
    """images [B, H, W, 3] (NHWC) -> f32 logits [B, num_classes]; on a mesh
    a ShardedTensor split over the batch and, where the rules split the
    classes, over ``tensor``."""
    mesh = current_mesh()
    if mesh is not None:
        logits, split = _mesh_logits(place_params(params, mesh, SHARDING_RULES), config, mesh,
                                     _mesh.batch_lists(mesh, images)[0])
        return _mesh.split_logits(mesh, logits, images.shape[0], config.num_classes, split)
    return _head(params, _features(params, config, images))


def _features(params: dict, config: ResNetConfig, images: torch.Tensor) -> torch.Tensor:
    """The backbone: images [B, H, W, 3] -> pooled features [B, C] in
    ``config.dtype``."""
    x = images.to(config.dtype).permute(0, 3, 1, 2)  # NCHW view, channels-last strides
    x = _conv(x, params["stem_conv"], 2)
    x = torch.relu(_group_norm(x, params["stem_gn"], config.groups))
    x = _max_pool_3x3_s2(x)
    for blk, stride in zip(params["blocks"], _strides(config)):
        residual = x
        y = torch.relu(_group_norm(_conv(x, blk["conv1"], 1), blk["gn1"], config.groups))
        y = torch.relu(_group_norm(_conv(y, blk["conv2"], stride), blk["gn2"], config.groups))
        y = _group_norm(_conv(y, blk["conv3"], 1), blk["gn3"], config.groups)
        if "proj" in blk:
            residual = _group_norm(_conv(x, blk["proj"], stride), blk["proj_gn"], config.groups)
        x = torch.relu(residual + y)
    # the spatial mean in f32, cast back, as jnp.mean does for bf16
    return x.float().mean(dim=(2, 3)).to(config.dtype)


def _head(params: dict, x: torch.Tensor) -> torch.Tensor:
    return (x @ params["fc_kernel"] + params["fc_bias"]).float()


def loss(params: dict, config: ResNetConfig, images: torch.Tensor,
         labels: torch.Tensor) -> torch.Tensor:
    mesh = current_mesh()
    if mesh is not None:
        return _mesh_loss(params, config, mesh, images, labels)
    logp = torch.log_softmax(forward(params, config, images), dim=-1)
    return -torch.take_along_dim(logp, labels.long()[:, None], dim=-1).mean()


# ------------------------------------------------------------ on a mesh


def _mesh_loss(params, config: ResNetConfig, mesh: Mesh, images, labels) -> torch.Tensor:
    """``loss`` over the mesh: each batch shard's cross-entropy sum on its
    class-split logits, the mean over the global batch."""
    params = place_params(params, mesh, SHARDING_RULES)
    imgs, lbls = _mesh.batch_lists(mesh, images, labels)
    logits, split = _mesh_logits(params, config, mesh, imgs)
    sums = _mesh.xent_sums(mesh, logits, lbls,
                           _mesh.class_starts(mesh, params["fc_kernel"], 1), split)
    return _mesh.global_mean(mesh, sums, each(torch.numel, lbls))


def _mesh_logits(params: dict, config: ResNetConfig, mesh: Mesh, imgs: list) -> tuple:
    """Per-position f32 logits ``[b, C or C/tensor]`` of the batch shards
    ``imgs`` (the backbone's weights gathered whole, once per device and
    batch shard), and whether they are split over ``tensor``."""
    views = Views(mesh)
    backbone = {k: v for k, v in params.items() if not k.startswith("fc_")}
    flat = named_leaves(backbone)

    def features(img, *ws):
        by_name = dict(zip(flat, ws))
        tree = tree_map_with_path(lambda kp, _: by_name[".".join(map(str, kp))], backbone)
        return _features(tree, config, img)

    xs = each(features, imgs, *(views(t) for t in flat.values()))
    fc = params["fc_kernel"]
    starts = _mesh.class_starts(mesh, fc, 1)
    split = "tensor" in fc.split_axes(1)

    def head(x, w, b, lo):
        return _head({"fc_kernel": w, "fc_bias": b[lo:lo + w.shape[1]]}, x)

    return each(head, xs, views(fc, ("tensor",)), views(params["fc_bias"]), starts), split


def synthetic_batch(seed: int, batch_size: int, image_size: int = 224,
                    num_classes: int = 1000) -> dict:
    """Random labels and N(0, 1) NHWC images, drawn with numpy from ``seed``
    (the JAX package draws with ``jax.random``: other numbers, same law)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, batch_size).astype(np.int32)
    images = rng.standard_normal((batch_size, image_size, image_size, 3), dtype=np.float32)
    return {"images": images, "labels": labels}
