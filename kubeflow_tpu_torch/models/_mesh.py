"""Helpers the models' mesh paths share: the batch split over the mesh, a
cross-entropy over logits whose classes are split over ``tensor``, and the
exact global mean over the batch shards.

A model's mesh path computes per-position values (``ops/shard_map_compat``):
each batch input is split over ``batch_spec`` (``("data", "fsdp")``), and
where a rule splits the classifier's (or the unembedding's) class dim over
``tensor``, each tensor shard holds the logits of its block of classes.
GSPMD computes the JAX model's ``log_softmax`` over such logits with a
max and a sum reduced over ``tensor``; here the same reductions are
``pmax`` and ``psum``, so no position ever holds the full class dim.
"""

from __future__ import annotations

import torch

from ..ops.shard_map_compat import axis_index, each, pmax, position0, psum
from ..parallel.mesh import Mesh
from ..parallel.sharding import NamedSharding, P, ShardedTensor, as_sharded, batch_spec


def batch_lists(mesh: Mesh, *ts) -> list:
    """Each batch input's per-position shards (split over the batch spec)."""
    spec = batch_spec(mesh)
    return [as_sharded(t, mesh, spec).shards for t in ts]


def class_starts(mesh: Mesh, st: ShardedTensor, dim: int) -> list:
    """Each position's first class on ``st``'s dim ``dim`` (the vocabulary
    of an embedding, the classes of a classifier): its tensor block's start
    where ``tensor`` splits the dim, else 0 everywhere."""
    if "tensor" not in st.split_axes(dim):
        return [0] * mesh.size
    n = st.shape[dim] // mesh.shape["tensor"]
    return [i * n for i in axis_index("tensor", mesh)]


def split_logits(mesh: Mesh, shards: list, batch: int, n_classes: int,
                 split: bool) -> ShardedTensor:
    """Per-position logits ``[b, ..., classes/tensor]`` as one ShardedTensor:
    the batch over ``("data", "fsdp")``, the last dim over ``tensor`` where
    ``split``."""
    lead = shards[mesh.local_positions[0]].shape[1:-1]
    spec = P(batch_spec(mesh)[0], *([None] * len(lead)), "tensor" if split else None)
    return ShardedTensor(shards, (batch, *lead, n_classes), NamedSharding(mesh, spec))


def xent_sums(mesh: Mesh, logits: list, targets: list, starts: list, split: bool) -> list:
    """Each position's sum of ``-log_softmax(logits)[target]`` over its rows
    (f32 logits ``[..., C or C/tensor]``, int targets ``[...]``).  Where the
    classes are split over ``tensor`` (``split``), the log-sum-exp takes the
    max and the sum of exponentials over the tensor shards (``pmax``,
    ``psum``) and the target's logit is picked on the shard that holds it
    and summed over ``tensor``; every tensor shard of a batch shard then
    holds the same sum."""
    if not split:
        return each(lambda z, t: torch.nn.functional.cross_entropy(
            z.reshape(-1, z.shape[-1]), t.reshape(-1).long(), reduction="sum"), logits, targets)
    # the shift is a constant of the log-sum-exp: its gradient is softmax's
    # whatever the shift, so the max is taken off the graph
    tops = pmax(each(lambda z: z.detach().amax(-1), logits), "tensor", mesh)
    sums = psum(each(lambda z, m: torch.exp(z - m[..., None]).sum(-1), logits, tops),
                "tensor", mesh)

    def pick(z, t, lo):
        local = t.long() - lo
        hit = (local >= 0) & (local < z.shape[-1])
        got = torch.take_along_dim(z, local.clamp(0, z.shape[-1] - 1)[..., None], dim=-1)
        return torch.where(hit, got[..., 0], torch.zeros((), dtype=z.dtype, device=z.device))

    picked = psum(each(pick, logits, targets, starts), "tensor", mesh)
    return each(lambda s, m, p: (torch.log(s) + m - p).sum(), sums, tops, picked)


def global_mean(mesh: Mesh, sums: list, counts: list) -> torch.Tensor:
    """The ``psum`` over the batch axes of each position's sum, over the
    ``psum`` of its count (a per-position list of numbers): the mean over
    every row of the global batch (position 0's value, whose graph reaches
    every shard; ``position0`` on a mesh across processes)."""
    axes = batch_spec(mesh)[0]
    totals, n = psum(sums, axes, mesh), psum(counts, axes, mesh)
    return position0(each(lambda t, c: t / c, totals, n), mesh)
