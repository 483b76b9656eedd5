"""Data loading: synthetic MLM batches and their move to the card.

Counterpart of ``kubeflow_tpu/train/data.py``.  ``synthetic_mlm_batches`` is
the JAX package's numpy generator verbatim, so one seed gives byte-identical
batches in both packages.  ``to_device`` moves a batch to one device;
``global_batch`` assembles a mesh's batch from each process's local rows
(``make_array_from_process_local_data``).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.mesh import Mesh
from ..parallel.sharding import NamedSharding, ShardedTensor, batch_spec


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
    """``jax.make_array_from_process_local_data``: the global batch is every
    process's local rows concatenated in process order, split over the
    mesh's batch axes (``P(("data", "fsdp"))``); each leaf a ShardedTensor
    whose positions (this process's) hold their rows on their own devices.
    In one process the local batch is the global one."""
    spec = batch_spec(mesh)
    out = {}
    for k, v in local_batch.items():
        v = torch.as_tensor(v)
        if mesh.is_fully_addressable:
            out[k] = ShardedTensor.shard(v, mesh, spec)
            continue
        shape = (v.shape[0] * len(mesh.processes), *v.shape[1:])
        st = ShardedTensor([None] * mesh.size, shape, NamedSharding(mesh, spec))
        # this process's rows are its positions' blocks, in block order
        blocks = sorted({st.block(p)[0] for p in mesh.local_positions})
        rows = st.sharding.shard_shape(shape)[0]
        if rows * len(blocks) != v.shape[0]:
            raise ValueError(f"{v.shape[0]} local rows for {len(blocks)} batch blocks of "
                             f"{rows} on this process")
        made: dict = {}
        for pos in mesh.local_positions:
            dev, b = mesh.device(pos), st.block(pos)[0]
            if (dev, b) not in made:
                i = blocks.index(b)
                made[(dev, b)] = v[i * rows:(i + 1) * rows].to(dev)
            st.shards[pos] = made[(dev, b)]
        out[k] = st
    return out
