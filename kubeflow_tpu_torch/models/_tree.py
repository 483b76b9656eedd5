"""Helpers the port's model modules share: numpy leaves from the JAX package
in, named leaves out."""

from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(arr) -> torch.Tensor:
    """numpy array -> CPU tensor.  bf16 arrays (JAX hands out
    ml_dtypes.bfloat16) travel bit-exactly through an int16 view,
    recognised by dtype name so nothing imports ml_dtypes."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:  # e.g. a view of a JAX buffer: never alias it
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def named_leaves(tree, prefix: str = "") -> dict:
    """Every tensor of a nested dict / list of tensors, under dotted names
    (``blocks.0.conv1``, ``stem_gn.scale``), in the tree's order."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out: dict = {}
    for k, v in items:
        out.update(named_leaves(v, f"{prefix}.{k}" if prefix else str(k)))
    return out
