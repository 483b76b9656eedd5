"""Collective-transport shim: the NCCL stand-in of the DDP shim path.

Counterpart of ``kubeflow_tpu/transport/``: ring allreduce, allgather and
reduce-scatter in C++ (``transport_core.cc``, the port's own copy) over TCP
between the gang's processes, bound via ctypes.
"""

from .transport import RingTransport, grad_allreduce

__all__ = ["RingTransport", "grad_allreduce"]
