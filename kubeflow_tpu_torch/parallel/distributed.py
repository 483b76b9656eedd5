"""Workload-side distributed bootstrap: read the env the job controller
injects and join the process group.

Counterpart of ``kubeflow_tpu/parallel/distributed.py``, on
``torch.distributed``: ``gloo`` for CPU processes, ``nccl`` on the card.
``read_env`` takes the JAX package's variables (``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``, ``MEGASCALE_*``) and, where the
coordinator is not set, the PyTorchJob rendezvous (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), as the JAX ResNet worker's
``_map_torch_env`` maps them.  ``local_device_count=N`` in a
single-process job means N mesh shards on the process's device
(``parallel/mesh.py``); the mesh across processes waits for ROADMAP Queue 1
item 3.3.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.device import resolve_device


@dataclass(frozen=True)
class ProcessEnv:
    coordinator_address: Optional[str]
    num_processes: int
    process_id: int
    num_slices: int
    slice_id: int

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1


def read_env(environ=None) -> ProcessEnv:
    env = dict(os.environ if environ is None else environ)
    if "MASTER_ADDR" in env and "JAX_COORDINATOR_ADDRESS" not in env:
        env["JAX_COORDINATOR_ADDRESS"] = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        env["JAX_NUM_PROCESSES"] = env.get("WORLD_SIZE", "1")
        env["JAX_PROCESS_ID"] = env.get("RANK", "0")
    return ProcessEnv(
        coordinator_address=env.get("JAX_COORDINATOR_ADDRESS"),
        num_processes=int(env.get("JAX_NUM_PROCESSES", "1")),
        process_id=int(env.get("JAX_PROCESS_ID", "0")),
        num_slices=int(env.get("MEGASCALE_NUM_SLICES", "1")),
        slice_id=int(env.get("MEGASCALE_SLICE_ID", "0")),
    )


def initialize(local_device_count: Optional[int] = None, device=None) -> ProcessEnv:
    """Join the job's process group (no-op for single-process jobs).

    ``device`` (default ``"cuda"``) picks the backend: ``nccl`` for the
    card, ``gloo`` for the CPU.  ``local_device_count`` forces N virtual
    CPU devices per process in the JAX package; here, in a single-process
    job, it means N mesh shards on the process's device (the caller builds
    the mesh over ``[device] * N``).  More than one in a multi-process job
    is refused: that is a mesh across processes."""
    penv = read_env()
    if local_device_count not in (None, 1) and penv.is_distributed:
        raise ValueError(
            f"local_device_count={local_device_count} in a job of "
            f"{penv.num_processes} processes: a mesh across processes is not ported "
            "yet (ROADMAP Queue 1 item 3.3: the cross-process mesh)")
    if penv.is_distributed and not dist.is_initialized():
        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://{penv.coordinator_address}",
            world_size=penv.num_processes, rank=penv.process_id)
    return penv
