"""Workload-side distributed bootstrap: read the env the job controller
injects, join the process group, and know the job's devices.

Counterpart of ``kubeflow_tpu/parallel/distributed.py``, on
``torch.distributed``.  ``read_env`` takes the JAX package's variables
(``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``,
``MEGASCALE_*``) and, where the coordinator is not set, the PyTorchJob
rendezvous (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), as
the JAX ResNet worker's ``_map_torch_env`` maps them.

``initialize(local_device_count=N)`` in a job of several processes gives
each process N positions of the job's global device list, process-major
(process p owns positions ``p·N … p·N+N-1``, as JAX orders a multi-process
CPU job): ``devices()`` is that list, the counterpart of the global
``jax.devices()``, and ``build_mesh`` with no devices lays its mesh over it
(``parallel/mesh.py``).  A device of another process is a ``JobDevice``
record, never resolved here.  In a single-process job nothing is joined
and N means N mesh shards on the process's device (the caller builds the
mesh over ``[device] * N``).

The backend is a rule: ``nccl`` where every process has a card of its own,
``gloo`` for the CPU and where processes share a card (NCCL refuses two
ranks on one card; each process's card UUID is exchanged over the
rendezvous to tell).  Under ``gloo`` a collective of CUDA tensors stages
them through host memory (``all_gather_bytes``, ``all_reduce_sum``); the
compute stays on the card.  The choice is printed to stderr.

A collective that fails because another process is gone raises
``GangMemberLost``: the member cannot go on, and a worker exits with
``GANG_LOST_EXIT`` (retryable under the ExitCode policy, as the JAX
survivor that the controller kills is), so the controller restarts the gang.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

# the process group's and the rendezvous's timeout: a collective that one
# member never joins fails after this long instead of hanging the job
TIMEOUT_S = 300.0
_KEY = "kubeflow_tpu_torch/process"
# a worker whose gang lost a member exits so: 128 + SIGTERM, retryable
GANG_LOST_EXIT = 143


class GangMemberLost(RuntimeError):
    """A collective failed: another process of the job is gone (or hung
    past ``TIMEOUT_S``)."""


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


@dataclass(frozen=True)
class JobDevice:
    """A position of the job's global device list: the process that owns it
    and the device's name there (``"cuda:0"``, ``"cpu"``)."""

    process: int
    name: str


@dataclass
class _Job:
    process_index: int
    process_count: int
    local: list          # this process's devices, one per local position
    devices: list        # every process's JobDevices, process-major
    cards: list          # each process's card (its UUID) or "cpu"
    backend: str
    staged: bool         # CUDA tensors cross through host memory (gloo)
    # what the cross-process collectives moved: calls, bytes, host seconds
    stats: dict = field(default_factory=lambda: {"calls": 0, "bytes": 0, "seconds": 0.0})


_JOB: Optional[_Job] = None


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


def _card(dev: torch.device) -> str:
    return str(torch.cuda.get_device_properties(dev).uuid) if dev.type == "cuda" else "cpu"


def initialize(local_device_count: Optional[int] = None, device=None) -> ProcessEnv:
    """Join the job's process group (no-op for single-process jobs).

    ``device`` (default ``"cuda"``) is this process's device.
    ``local_device_count`` forces N virtual CPU devices per process in the
    JAX package; here it gives this process N positions of the job's global
    device list (``devices()``), all on ``device``."""
    global _JOB
    penv = read_env()
    if not penv.is_distributed or dist.is_initialized():
        return penv
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    n = local_device_count or 1
    host, port = penv.coordinator_address.rsplit(":", 1)
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    store = dist.TCPStore(host, int(port), penv.num_processes, penv.process_id == 0,
                          timeout=timeout)
    store.set(f"{_KEY}/{penv.process_id}",
              json.dumps({"card": _card(dev), "device": str(dev), "local": n}))
    peers = [json.loads(store.get(f"{_KEY}/{r}")) for r in range(penv.num_processes)]
    cards = [p["card"] for p in peers]
    shared = dev.type == "cuda" and len(set(cards)) < len(cards)
    backend = "nccl" if dev.type == "cuda" and not shared else "gloo"
    dist.init_process_group(backend, store=store, world_size=penv.num_processes,
                            rank=penv.process_id, timeout=timeout)
    _JOB = _Job(process_index=penv.process_id, process_count=penv.num_processes,
                local=[dev] * n,
                devices=[JobDevice(r, p["device"]) for r, p in enumerate(peers)
                         for _ in range(p["local"])],
                cards=cards, backend=backend, staged=backend == "gloo" and dev.type == "cuda")
    why = ("processes share a card: collectives staged through host memory" if shared
           else "a card per process" if backend == "nccl" else "CPU processes")
    print(f"kubeflow_tpu_torch.distributed: process {penv.process_id} of "
          f"{penv.num_processes}, {n} local device(s) on {dev}, backend {backend} ({why})",
          file=sys.stderr, flush=True)
    return penv


def process_count() -> int:
    """The job's processes (``jax.process_count()``): 1 before a group is joined."""
    return _JOB.process_count if _JOB else 1


def process_index() -> int:
    """This process's index in the job (``jax.process_index()``)."""
    return _JOB.process_index if _JOB else 0


def visible_cards() -> list:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("build_mesh: no visible card; pass devices explicitly "
                           "(for example ['cpu'] * n) to build a mesh on the CPU")
    return [torch.device("cuda", i) for i in range(n)]


def local_devices() -> list:
    """This process's devices (``jax.local_devices()``): in a joined job its
    ``local_device_count`` positions, else every visible card (raises
    without one)."""
    return list(_JOB.local) if _JOB else visible_cards()


def devices() -> list:
    """The job's global device list (the global ``jax.devices()``): in a
    joined job a ``JobDevice`` per position, process-major; else
    ``local_devices()``."""
    return list(_JOB.devices) if _JOB else local_devices()


def backend() -> Optional[str]:
    """The joined group's backend, or None in a single-process job."""
    return _JOB.backend if _JOB else None


def card_count(processes) -> int:
    """How many distinct cards (or hosts' CPUs) ``processes`` run on."""
    return len({_JOB.cards[p] for p in processes}) if _JOB else 1


def collective_stats(reset: bool = False) -> dict:
    """What this process's cross-process collectives moved since the last
    reset: calls, bytes sent and received, host seconds spent in them."""
    if _JOB is None:
        return {"calls": 0, "bytes": 0, "seconds": 0.0}
    out = dict(_JOB.stats)
    if reset:
        _JOB.stats.update(calls=0, bytes=0, seconds=0.0)
    return out


@contextlib.contextmanager
def _collective(nbytes: int):
    """Count a collective's call, bytes and host time."""
    t0 = time.perf_counter()
    yield
    s = _JOB.stats
    s["calls"] += 1
    s["bytes"] += nbytes
    s["seconds"] += time.perf_counter() - t0


def _call(fn, *args, **kw):
    """A ``torch.distributed`` call; its failure is a lost gang member."""
    try:
        return fn(*args, **kw)
    except RuntimeError as e:
        raise GangMemberLost(f"process {_JOB.process_index} of {_JOB.process_count}: "
                             f"{fn.__name__} failed ({e})") from e


def _to_wire(t: torch.Tensor) -> torch.Tensor:
    if _JOB.staged and t.is_cuda:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return host.copy_(t)
    return t


def all_gather_bytes(buf: torch.Tensor, sizes: list, group=None) -> list:
    """Every process's 1-D uint8 ``buf`` (``sizes[i]`` bytes from the i-th
    process of ``group``, this one's ``buf.numel()``), on ``buf``'s device."""
    width = max(sizes)
    with _collective(width * len(sizes)):
        wire = _to_wire(torch.nn.functional.pad(buf, (0, width - buf.numel())))
        outs = [torch.empty_like(wire) for _ in sizes]
        _call(dist.all_gather, outs, wire, group=group)
        return [o[:n].to(buf.device) for o, n in zip(outs, sizes)]


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over ``group`` (in f32 on the wire), as a new tensor
    of ``t``'s dtype on its device."""
    with _collective(t.numel() * 4 * 2):
        wire = _to_wire(t.float())
        if wire is t:
            wire = t.clone()
        _call(dist.all_reduce, wire, group=group)
        return wire.to(t.device, t.dtype)


def all_gather_object(obj, group=None) -> list:
    """Every process's ``obj`` (picklable), in process order."""
    with _collective(0):
        out = [None] * dist.get_world_size(group)
        _call(dist.all_gather_object, out, obj, group=group)
        return out


def broadcast_object(obj, src: int = 0):
    """Process ``src``'s ``obj`` (picklable), on every process."""
    with _collective(0):
        box = [obj]
        _call(dist.broadcast_object_list, box, src=src)
        return box[0]


def send_recv(sends: list, recvs: list) -> None:
    """Point-to-point: ``sends`` of (tensor, process), ``recvs`` of
    (tensor to fill, process), matched by their order between each pair."""
    with _collective(sum(t.numel() * t.element_size() for t, _ in sends + recvs)):
        wires = [_to_wire(t) for t, _ in recvs]
        ops = [dist.P2POp(dist.isend, _to_wire(t.contiguous()), p) for t, p in sends]
        ops += [dist.P2POp(dist.irecv, w, p) for w, (_, p) in zip(wires, recvs)]
        if ops:
            for req in _call(dist.batch_isend_irecv, ops):
                _call(req.wait)
        for w, (t, _) in zip(wires, recvs):
            if w is not t:
                t.copy_(w)
