"""Device mesh construction: the scaling substrate of the port.

Counterpart of ``kubeflow_tpu/parallel/mesh.py``: one ``Mesh`` with the
same named axes, in the same order (MaxText-style):

  data   — pure data parallel, outermost
  fsdp   — ZeRO-3-style sharded data parallel
  tensor — tensor/model parallel (Megatron-style), innermost
  seq    — sequence/context parallel (ring attention rides this axis)
  expert — MoE expert parallel
  stages — pipeline stages

A JAX mesh is driven by a single controller: one process drives every
device of its mesh.  So is this one.  ``Mesh.devices`` is a numpy object
array of ``torch.device``s shaped by ``AXES`` (``mesh.devices.size`` and
``.shape`` read as in JAX), and a device may repeat: N shards may share one
card (or ``"cpu"``), each still holding only its own slice and getting its
own kernel launches, as the JAX package's tests run N shards on forced
virtual CPU devices.  Sharded values are held as per-shard tensors
(``parallel/sharding.py``) and the collectives are functions over those
shards (``ops/shard_map_compat.py``); nothing here uses
``torch.distributed``.

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

from ..utils.device import resolve_device

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
    coordinate on each axis and ``device(pos)`` its device."""

    def __init__(self, devices: np.ndarray, axis_names: tuple = AXES):
        if devices.ndim != len(axis_names):
            raise ValueError(f"devices of rank {devices.ndim} for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self._flat = [resolve_device(d) for d in devices.flat]
        if len({d.type for d in self._flat}) > 1:
            raise ValueError("a mesh of mixed device types: "
                             f"{sorted({str(d) for d in self._flat})}")
        self._tokens: list = []

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def device(self, pos: int) -> torch.device:
        return self._flat[pos]

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
        """The mesh's devices without repeats, in first-use order."""
        return list(dict.fromkeys(self._flat))

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


def _visible_cards() -> list:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("build_mesh: no visible card; pass devices explicitly "
                           "(for example ['cpu'] * n) to build a mesh on the CPU")
    return [torch.device("cuda", i) for i in range(n)]


def build_mesh(config: Optional[MeshConfig] = None, devices=None) -> Mesh:
    """Build the global mesh over ``devices`` (default: every visible card;
    raises without one).  A device may repeat.  Axis order puts ``data``
    outermost and ``tensor`` innermost, as the JAX package lays a slice."""
    config = config or MeshConfig()
    devices = list(devices if devices is not None else _visible_cards())
    sizes = config.sizes(len(devices))
    shape = tuple(sizes[a] for a in AXES)
    arr = np.empty(len(devices), dtype=object)
    arr[:] = [resolve_device(d) for d in devices]
    return Mesh(arr.reshape(shape), AXES)


def single_device_mesh(device=None) -> Mesh:
    d = resolve_device(device) if device is not None else _visible_cards()[0]
    arr = np.empty(1, dtype=object)
    arr[0] = d
    return Mesh(arr.reshape((1,) * len(AXES)), AXES)
