"""Port allocation for rendezvous endpoints in the local simulator.

A copy of ``kubeflow_tpu/utils/net.py``.
"""

from __future__ import annotations

import socket


def find_free_ports(n: int) -> list[int]:
    """Reserve n distinct free TCP ports (best-effort; released on return)."""
    socks, ports = [], []
    try:
        for _ in range(n):
            s = socket.socket()
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", 0))
            socks.append(s)
            ports.append(s.getsockname()[1])
    finally:
        for s in socks:
            s.close()
    return ports
