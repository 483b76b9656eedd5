"""Data loading: synthetic MLM batches and their move to the card.

Counterpart of ``kubeflow_tpu/train/data.py``.  ``synthetic_mlm_batches`` is
the JAX package's numpy generator verbatim, so one seed gives byte-identical
batches in both packages.  ``to_device`` moves a batch to one device;
``global_batch`` splits it over a mesh's batch axes, in one process (the
cross-process mesh is ROADMAP Queue 1 item 3.3).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.mesh import Mesh
from ..parallel.sharding import ShardedTensor, batch_spec


def synthetic_mlm_batches(
    vocab_size: int,
    batch_size: int,
    seq_len: int,
    mask_prob: float = 0.15,
    mask_token: int = 103,
    seed: int = 0,
) -> Iterator[dict]:
    """Deterministic synthetic MLM stream: (input_ids, labels, attention_mask)."""
    rng = np.random.default_rng(seed)
    low = min(mask_token + 1, vocab_size - 1)
    while True:
        ids = rng.integers(low, vocab_size, size=(batch_size, seq_len), dtype=np.int32)
        mask = rng.random((batch_size, seq_len)) < mask_prob
        labels = np.where(mask, ids, -100).astype(np.int32)
        input_ids = np.where(mask, mask_token, ids).astype(np.int32)
        yield {
            "input_ids": input_ids,
            "labels": labels,
            "attention_mask": np.ones((batch_size, seq_len), np.int32),
        }


def host_shard(global_batch_size: int) -> tuple[int, int]:
    """(local_batch_size, offset) for this process: world size and rank come
    from ``torch.distributed`` when it is initialized, else 1 and 0."""
    if dist.is_available() and dist.is_initialized():
        n, rank = dist.get_world_size(), dist.get_rank()
    else:
        n, rank = 1, 0
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible by {n} hosts")
    local = global_batch_size // n
    return local, local * rank


def to_device(batch: dict, device) -> dict:
    """numpy (or tensor) batch -> tensors on one device."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}


def global_batch(local_batch: dict, mesh: Mesh) -> dict:
    """A batch split over the mesh's batch axes (``P(("data", "fsdp"))``):
    each leaf a ShardedTensor whose positions hold their rows on their own
    devices.  One process holds the whole batch; a job of several processes
    would assemble it from each one's rows (ROADMAP Queue 1 item 3.3)."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise NotImplementedError(
            "global_batch across processes is not ported yet (ROADMAP Queue 1 item "
            "3.3: the cross-process mesh)")
    spec = batch_spec(mesh)
    return {k: ShardedTensor.shard(torch.as_tensor(v), mesh, spec)
            for k, v in local_batch.items()}
