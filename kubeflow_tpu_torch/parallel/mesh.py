"""Device mesh construction: the scaling substrate of the port.

Counterpart of ``kubeflow_tpu/parallel/mesh.py``: one ``Mesh`` with the
same named axes, in the same order (MaxText-style):

  data   — pure data parallel, outermost
  fsdp   — ZeRO-3-style sharded data parallel
  tensor — tensor/model parallel (Megatron-style), innermost
  seq    — sequence/context parallel (ring attention rides this axis)
  expert — MoE expert parallel
  stages — pipeline stages

``Mesh.devices`` is a numpy object array shaped by ``AXES``
(``mesh.devices.size`` and ``.shape`` read as in JAX), and a device may
repeat: N shards may share one card (or ``"cpu"``), each still holding only
its own slice and getting its own kernel launches, as the JAX package's
tests run N shards on forced virtual CPU devices.  Sharded values are held
as per-shard tensors (``parallel/sharding.py``) and the collectives are
functions over those shards (``ops/shard_map_compat.py``).

One process drives every position it owns.  A mesh over ``torch.device``s
is all this process's (a single controller, as a one-process JAX mesh); a
mesh over the job's global list (``distributed.devices()``) holds
``JobDevice`` records, and the positions of other processes are known by
their owner and device name only: ``device(pos)`` answers for local
positions, and a collective between positions of different processes goes
over ``torch.distributed``, through the groups the mesh builds once, in one
fixed order on every process (``process_group``).

``with mesh:`` makes the mesh current (``current_mesh()``), the
counterpart of ``jax.set_mesh`` / ``get_abstract_mesh()`` that model code
consults.
"""

from __future__ import annotations

import contextvars
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from . import distributed
from .distributed import JobDevice

AXES = ("data", "stages", "fsdp", "seq", "expert", "tensor")

_CURRENT: contextvars.ContextVar = contextvars.ContextVar("kubeflow_tpu_torch_mesh",
                                                          default=None)


@dataclass(frozen=True)
class MeshConfig:
    """Sizes per axis; -1 on at most one axis means "absorb remaining devices"."""

    data: int = 1
    stages: int = 1
    fsdp: int = -1
    seq: int = 1
    expert: int = 1
    tensor: int = 1

    def sizes(self, n_devices: int) -> dict[str, int]:
        vals = {a: getattr(self, a) for a in AXES}
        fills = [a for a, v in vals.items() if v == -1]
        if len(fills) > 1:
            raise ValueError(f"at most one -1 axis, got {fills}")
        fixed = math.prod(v for v in vals.values() if v != -1)
        if fills:
            if n_devices % fixed:
                raise ValueError(f"{n_devices} devices not divisible by fixed axes {fixed}")
            vals[fills[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(f"mesh {vals} needs {fixed} devices, have {n_devices}")
        return vals


class Mesh:
    """Named axes over an array of devices (one entry per shard).

    Shards are numbered by their flat position in ``devices`` (C order:
    ``data`` slowest, ``tensor`` fastest); ``coords(pos)`` gives a shard's
    coordinate on each axis, ``process_of(pos)`` the process that owns it
    and ``device(pos)`` its device, for a position of this process."""

    def __init__(self, devices: np.ndarray, axis_names: tuple = AXES):
        if devices.ndim != len(axis_names):
            raise ValueError(f"devices of rank {devices.ndim} for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        me = distributed.process_index()
        self._owner = [d.process if isinstance(d, JobDevice) else me for d in devices.flat]
        self._names = [d.name if isinstance(d, JobDevice) else str(resolve_device(d))
                       for d in devices.flat]
        if len({torch.device(n).type for n in self._names}) > 1:
            raise ValueError(f"a mesh of mixed device types: {sorted(set(self._names))}")
        self._flat = [resolve_device(n) if p == me else None
                      for n, p in zip(self._names, self._owner)]
        self.local_positions = [p for p, o in enumerate(self._owner) if o == me]
        self.processes = sorted(set(self._owner))
        self._tokens: list = []
        # the groups of a mesh that spans several processes, built alike on
        # every process, also on one that holds none of its positions (a
        # pipeline stage's sub-mesh); a mesh in one process needs none
        if len(self.processes) > 1:
            self._build_groups()

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def device(self, pos: int) -> torch.device:
        """Position ``pos``'s device; raises for a position of another process."""
        dev = self._flat[pos]
        if dev is None:
            raise RuntimeError(f"mesh position {pos} is on process {self._owner[pos]} "
                               f"({self._names[pos]}), not this one")
        return dev

    def device_name(self, pos: int) -> str:
        """Position ``pos``'s device as its own process names it."""
        return self._names[pos]

    def process_of(self, pos: int) -> int:
        return self._owner[pos]

    def is_local(self, pos: int) -> bool:
        return self._flat[pos] is not None

    @property
    def is_fully_addressable(self) -> bool:
        """Whether this process owns every position (a single controller)."""
        return len(self.local_positions) == self.size

    def _build_groups(self) -> None:
        """The ``torch.distributed`` group of every set of processes that a
        group of positions along some axes spans: built here, for every
        subset of the mesh's axes, in sorted order, so that every process
        calls ``new_group`` alike (it is collective)."""
        axes = [a for a in self.axis_names if self.shape[a] > 1]
        sets = {tuple(self.processes)}
        for mask in range(1, 2 ** len(axes)):
            chosen = [a for i, a in enumerate(axes) if mask >> i & 1]
            groups: dict = {}
            for pos in range(self.size):
                c = self.coords(pos)
                key = tuple(int(c[a]) for a in self.axis_names if a not in chosen)
                groups.setdefault(key, set()).add(self._owner[pos])
            sets.update(tuple(sorted(g)) for g in groups.values() if len(g) > 1)
        for procs in sorted(sets):
            process_group(procs)

    def group(self, processes) -> Optional[object]:
        """The group over ``processes`` (a sorted tuple); None is the world."""
        return process_group(tuple(processes))

    def coords(self, pos: int) -> dict:
        return dict(zip(self.axis_names, np.unravel_index(pos, self.devices.shape)))

    def position(self, coords: dict) -> int:
        return int(np.ravel_multi_index(tuple(int(coords[a]) for a in self.axis_names),
                                        self.devices.shape))

    def submesh(self, axis: str, index: int) -> tuple:
        """The positions whose ``axis`` coordinate is ``index``: a mesh of
        the same axes with ``axis`` of size 1, and the positions in this
        mesh of its positions, in its order (a pipeline stage's sub-mesh,
        ``parallel/pipeline.py``)."""
        devices = np.take(self.devices, [index], axis=self.axis_names.index(axis))
        sub = Mesh(devices, self.axis_names)
        return sub, [self.position({**sub.coords(p), axis: index}) for p in range(sub.size)]

    @property
    def distinct_devices(self) -> list:
        """This process's devices of the mesh without repeats, in first-use
        order."""
        return list(dict.fromkeys(d for d in self._flat if d is not None))

    def __enter__(self) -> "Mesh":
        self._tokens.append(_CURRENT.set(self))
        return self

    def __exit__(self, *exc) -> None:
        _CURRENT.reset(self._tokens.pop())

    def __repr__(self) -> str:
        sizes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({sizes}; {[str(d) for d in self.distinct_devices]})"


def current_mesh() -> Optional[Mesh]:
    """The mesh of the innermost ``with mesh:`` block, or None."""
    return _CURRENT.get()


_GROUPS: dict = {}


def process_group(processes: tuple):
    """The ``torch.distributed`` group over ``processes``, made on first
    use (every process of the job must ask for the same groups in the same
    order); None (the default group) for the whole job."""
    if len(processes) == distributed.process_count():
        return None
    if processes not in _GROUPS:
        _GROUPS[processes] = dist.new_group(list(processes))
    return _GROUPS[processes]


def build_mesh(config: Optional[MeshConfig] = None, devices=None) -> Mesh:
    """Build the global mesh over ``devices`` (default: the job's global
    device list in a job of several processes, else every visible card;
    raises without one).  A device may repeat.  Axis order puts ``data``
    outermost and ``tensor`` innermost, as the JAX package lays a slice."""
    config = config or MeshConfig()
    devices = list(devices if devices is not None else distributed.devices())
    sizes = config.sizes(len(devices))
    shape = tuple(sizes[a] for a in AXES)
    arr = np.empty(len(devices), dtype=object)
    arr[:] = [d if isinstance(d, JobDevice) else resolve_device(d) for d in devices]
    return Mesh(arr.reshape(shape), AXES)


def single_device_mesh(device=None) -> Mesh:
    d = resolve_device(device) if device is not None else distributed.visible_cards()[0]
    arr = np.empty(1, dtype=object)
    arr[0] = d
    return Mesh(arr.reshape((1,) * len(AXES)), AXES)
