"""ctypes bindings for the C++ ring-collective core (transport_core.cc).

Counterpart of ``kubeflow_tpu/transport/transport.py``.  The PyTorchJob DDP
shim uses this the way the reference uses NCCL: the controller injects
MASTER_ADDR/RANK/WORLD_SIZE, each worker opens a RingTransport on a port
derived from MASTER_PORT, and the gradient sync goes through ``allreduce``
(mean).  The collectives take numpy arrays on the host; ``grad_allreduce``
moves a dict of tensors (on any device) through one flat f32 buffer.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Mapping, Optional

import numpy as np
import torch

from ..utils.native_build import load_native

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "transport_core.cc")
_LOCK = threading.Lock()
_LIB = None

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def load_library() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = load_native(_SRC, "transport", extra_flags=["-pthread"])
            i32, i64, p = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
            lib.tr_create.restype = p
            lib.tr_create.argtypes = [i32, i32, ctypes.c_char_p, i32]
            lib.tr_destroy.argtypes = [p]
            lib.tr_allreduce_f32.restype = i32
            lib.tr_allreduce_f32.argtypes = [p, _f32p, i64]
            lib.tr_reduce_scatter_f32.restype = i32
            lib.tr_reduce_scatter_f32.argtypes = [p, _f32p, i64, _f32p]
            lib.tr_allgather.restype = i32
            lib.tr_allgather.argtypes = [p, _u8p, i64, _u8p]
            lib.tr_broadcast.restype = i32
            lib.tr_broadcast.argtypes = [p, _u8p, i64, i32]
            lib.tr_barrier.restype = i32
            lib.tr_barrier.argtypes = [p]
            _LIB = lib
    return _LIB


class RingTransport:
    """Ring collectives among ``world`` processes; rank r listens on
    base_port+r and connects to base_port+(r+1)%world on the RIGHT
    neighbor's host.

    ``host`` is where rank (r+1)%world listens.  Single-host gangs pass one
    address for everyone; multi-pod gangs pass ``hosts``, the full per-rank
    address list (the hostfile analogue), and each rank dials its own
    neighbor.
    """

    def __init__(self, rank: int, world: int, host: str = "127.0.0.1",
                 base_port: int = 23456, hosts: Optional[list[str]] = None):
        self.lib = load_library()
        self.rank, self.world = rank, world
        if hosts is not None:
            if len(hosts) != world:
                raise ValueError(f"hosts list has {len(hosts)} entries for world {world}")
            host = hosts[(rank + 1) % world]
        self._h = self.lib.tr_create(rank, world, host.encode(), base_port)
        if not self._h:
            raise ConnectionError(
                f"transport rendezvous failed (rank {rank}/{world} @ {host}:{base_port})"
            )

    @classmethod
    def from_env(cls) -> "RingTransport":
        """Open from the PyTorchJob-injected rendezvous env.

        ``TRANSPORT_HOSTS`` (comma-separated, one address per rank: the
        controller's hostfile analogue) enables multi-pod rings; without it
        every rank dials MASTER_ADDR, which is right only when the gang
        shares one host and network namespace.
        """
        env = os.environ
        hosts = env.get("TRANSPORT_HOSTS")
        return cls(
            rank=int(env.get("RANK", "0")),
            world=int(env.get("WORLD_SIZE", "1")),
            host=env.get("MASTER_ADDR", "127.0.0.1"),
            # offset from the coordinator port: it stays free for the
            # process group's own rendezvous
            base_port=int(env.get("MASTER_PORT", "29500")) + 1000,
            hosts=hosts.split(",") if hosts else None,
        )

    def close(self) -> None:
        if self._h:
            self.lib.tr_destroy(self._h)
            self._h = None

    def _check(self, rc: int, op: str) -> None:
        if rc != 0:
            raise ConnectionError(f"transport {op} failed (rc={rc})")

    def allreduce(self, x: np.ndarray, mean: bool = False) -> np.ndarray:
        """In-place sum (or mean) allreduce of a float32 array; returns it."""
        flat = np.ascontiguousarray(x, np.float32).reshape(-1)
        self._check(self.lib.tr_allreduce_f32(self._h, flat, flat.size), "allreduce")
        if mean:
            flat /= self.world
        return flat.reshape(x.shape)

    def reduce_scatter(self, x: np.ndarray) -> np.ndarray:
        """Sum-reduce a flat f32 array; return this rank's chunk
        (chunk (rank+1) % world of the near-equal split)."""
        flat = np.ascontiguousarray(x, np.float32).reshape(-1)
        base, rem = divmod(flat.size, self.world)
        mine = (self.rank + 1) % self.world
        out = np.zeros(base + (1 if mine < rem else 0), np.float32)
        self._check(
            self.lib.tr_reduce_scatter_f32(self._h, flat, flat.size, out),
            "reduce_scatter",
        )
        return out

    def allgather(self, x: np.ndarray) -> np.ndarray:
        """Gather equal-shaped arrays from all ranks -> stacked [world, ...]."""
        buf = np.ascontiguousarray(x).view(np.uint8).reshape(-1)
        out = np.zeros(self.world * buf.size, np.uint8)
        self._check(self.lib.tr_allgather(self._h, buf, buf.size, out), "allgather")
        return out.view(x.dtype).reshape((self.world,) + x.shape)

    def broadcast(self, x: np.ndarray, root: int = 0) -> np.ndarray:
        buf = np.ascontiguousarray(x).view(np.uint8).reshape(-1)
        self._check(self.lib.tr_broadcast(self._h, buf, buf.size, root), "broadcast")
        return buf.view(x.dtype).reshape(x.shape)

    def barrier(self) -> None:
        self._check(self.lib.tr_barrier(self._h), "barrier")

    def __enter__(self) -> "RingTransport":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # pragma: no cover - defensive
        try:
            self.close()
        except Exception:
            pass


def grad_allreduce(transport: RingTransport, grads: Mapping[str, torch.Tensor]) -> dict:
    """Mean-allreduce a dict of gradient tensors (e.g. a module's named
    gradients) through the shim: one flat f32 host buffer per call (the
    NCCL-bucket analogue), leaves packed in sorted name order so every rank
    lays them out alike whatever order its dict has.  Returns a new dict
    with each leaf's shape, dtype and device."""
    names = sorted(grads)
    if not names:
        return {}
    dev = grads[names[0]].device
    # one device-side concat, one copy to the host and one back
    flat = torch.cat([grads[n].detach().reshape(-1).to(dev, torch.float32) for n in names])
    buf = torch.from_numpy(transport.allreduce(flat.cpu().numpy(), mean=True)).to(dev)
    out, off = {}, 0
    for n in names:
        g = grads[n]
        out[n] = buf[off:off + g.numel()].reshape(g.shape).to(g.device, g.dtype)
        off += g.numel()
    return out
