"""Ulysses sequence parallelism: head all-to-all over the ``seq`` mesh axis.

Counterpart of ``kubeflow_tpu/ops/ulysses.py``.  Operands arrive
sequence-sharded ([B, S/n, H, D] per shard); one all-to-all re-shards them
head-wise ([B, S, H/n, D]) so every shard runs *full-length* attention on
its head subset, then a second all-to-all restores sequence sharding.  Two
collectives in all, against n-1 ``ppermute`` steps for the ring.

Requires heads % ring-size == 0.  Differentiable end to end (the
all-to-all's backward is the reverse exchange).  ``inner`` defaults to
dense MHA and may be the port's ``flash_attention``: on CUDA tensors that
launches the Hopper kernel once per shard.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from ..parallel.mesh import Mesh
from ..parallel.sharding import P
from .attention import multihead_attention
from .shard_map_compat import all_to_all, each, shard_map


def _ulysses_sharded(qs, ks, vs, *, axis_name, causal, inner):
    # [B, S/n, H, D] --all_to_all--> [B, S, H/n, D]
    def seq_to_heads(xs):
        return all_to_all(xs, axis_name, split_axis=2, concat_axis=1, tiled=True)

    def heads_to_seq(xs):
        return all_to_all(xs, axis_name, split_axis=1, concat_axis=2, tiled=True)

    outs = each(lambda q, k, v: inner(q, k, v, causal),
                seq_to_heads(qs), seq_to_heads(ks), seq_to_heads(vs))
    return heads_to_seq(outs)


def ulysses_attention(
    q: torch.Tensor,  # [B, S, H, D] — S split over `axis`
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    causal: bool = True,
    axis: str = "seq",
    qkv_spec: Optional[P] = None,
    inner: Optional[Callable] = None,
) -> torch.Tensor:
    """Head-scattered full attention; ``inner`` defaults to dense MHA and can
    be the flash kernel (ops.flash_attention)."""
    n = mesh.shape[axis]
    h = q.shape[2]
    if h % n:
        raise ValueError(f"heads ({h}) must divide the {axis!r} axis size ({n}) for Ulysses")
    if inner is None:
        def inner(q_, k_, v_, c):
            return multihead_attention(q_, k_, v_, causal=c)
    spec = qkv_spec if qkv_spec is not None else P(None, axis, None, None)
    fn = shard_map(
        functools.partial(_ulysses_sharded, axis_name=axis, causal=causal, inner=inner),
        mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=spec,
        check_vma=False,
    )
    return fn(q, k, v)
