"""Pooled keepalive HTTP/1.1 transport for backend pulls.

A copy of ``kubeflow_tpu/serving/transport.py``: one bounded pool of
persistent ``http.client.HTTPConnection`` objects keyed by backend port,
instead of a TCP handshake per hop, for the ingress relay
(``serving/router.py``), its probes and load scrapes, and the serve
layer's KVPG handoff and fabric pulls.  The JAX package's ``legacy_core``
switch (a benchmark arm of its ingress) is left out: the pool always
reuses.

Contract (the one ``urllib.request.urlopen`` callers expect):

- status >= 400 raises a real ``urllib.error.HTTPError`` carrying the
  response headers and body.
- connect failures raise ``OSError`` subclasses and read stalls raise
  ``socket.timeout`` (== ``TimeoutError``).
- the returned response is a context manager with ``.status``,
  ``.headers``, ``.read()`` and ``.read1()``; exiting it returns the
  connection to the pool iff the response was fully drained and the
  backend did not ask for close.

Degradation contract: pool exhaustion or a stale pooled socket never
fails a request. A reused connection that dies before the response
line arrives is retired and the request transparently retried once on
a fresh connection; an empty pool simply dials fresh. The only
observable difference is the ``outcome`` label on
``ingress_conn_reuse_total``.

Bounds: at most ``_MAX_IDLE_PER_BACKEND`` idle sockets are kept per port
and idle sockets older than ``_IDLE_TTL_S`` are evicted at checkout time,
so the pool can never grow past ``ports x _MAX_IDLE_PER_BACKEND`` entries.
"""

from __future__ import annotations

import http.client
import io
import socket
import threading
import time
import urllib.error
from collections import deque
from typing import Dict, Optional, Tuple

from ..core.metrics import REGISTRY

CONN_REUSE = REGISTRY.counter(
    "ingress_conn_reuse_total",
    "pooled backend connection checkouts by outcome (reused = served "
    "from pool, fresh = new TCP dial, evicted = idle-TTL/stale retire)")

# Bounds for the idle pool.  Eviction happens inline at checkout (no
# reaper thread): anything idle past the TTL is closed while popping.
_MAX_IDLE_PER_BACKEND = 8
_IDLE_TTL_S = 30.0

class PooledResponse:
    """HTTPResponse facade that knows how to give its socket back.

    Exposes the slice of the urlopen response surface the relay uses
    (``status``/``headers``/``read``/``read1``/``fp`` + context
    manager) and, on clean exit, returns the underlying connection to
    the pool when — and only when — the body was fully drained and the
    backend did not request close.
    """

    def __init__(self, pool: "ConnectionPool", port: int,
                 conn: http.client.HTTPConnection,
                 resp: http.client.HTTPResponse,
                 timing: Dict[str, object]):
        self._pool = pool
        self._port = port
        self._conn = conn
        self._resp = resp
        self.timing = timing
        self.status = resp.status
        self.headers = resp.headers
        self._released = False

    # -- file-ish surface the relay/stream paths consume ----------------
    def read(self, amt: Optional[int] = None) -> bytes:
        return self._resp.read() if amt is None else self._resp.read(amt)

    def read1(self, amt: int = -1) -> bytes:
        return self._resp.read1(amt)

    def getheader(self, name: str, default=None):
        return self._resp.getheader(name, default)

    def __enter__(self) -> "PooledResponse":
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def release(self) -> None:
        """Return the socket to the pool, or retire it.

        Reusable iff the response was read to completion (the HTTP/1.1
        framing guarantees the next response starts at the cursor) and
        the server did not send ``Connection: close``.  SSE streams are
        close-delimited, so they always land in the retire branch.
        """
        if self._released:
            return
        self._released = True
        reusable = False
        try:
            reusable = (self._resp.isclosed()
                        and not self._resp.will_close)
        except Exception:  # noqa: BLE001 - retire on any doubt
            reusable = False
        if reusable:
            self._pool._checkin(self._port, self._conn)
        else:
            try:
                self._conn.close()
            except Exception:  # noqa: BLE001
                pass

    def close(self) -> None:
        self.release()


class ConnectionPool:
    """Bounded per-backend keepalive pool (127.0.0.1 data plane).

    ``_idle`` is a dict of deques, each deque capped at ``max_idle`` and TTL-evicted at checkout, so the
    resident socket count is hard-bounded.
    """

    def __init__(self, max_idle: int = _MAX_IDLE_PER_BACKEND,
                 idle_ttl_s: float = _IDLE_TTL_S):
        self._lock = threading.Lock()
        self._max_idle = int(max_idle)
        self._idle_ttl_s = float(idle_ttl_s)
        # port -> deque[(conn, idle_since)]; LIFO so the warmest socket
        # (most likely still alive) is reused first.
        self._idle: Dict[int, deque] = {}

    # -- checkout / checkin ---------------------------------------------
    def _checkout(self, port: int) -> Tuple[Optional[http.client.HTTPConnection], int]:
        """Pop a live idle connection; returns (conn|None, evicted)."""
        evicted = 0
        now = time.monotonic()
        with self._lock:
            dq = self._idle.get(port)
            while dq:
                conn, since = dq.pop()
                if now - since > self._idle_ttl_s:
                    evicted += 1
                    try:
                        conn.close()
                    except Exception:  # noqa: BLE001
                        pass
                    continue
                return conn, evicted
        return None, evicted

    def _checkin(self, port: int, conn: http.client.HTTPConnection) -> None:
        with self._lock:
            dq = self._idle.setdefault(port, deque())
            if len(dq) >= self._max_idle:
                # Bound the pool: retire the coldest socket instead of
                # growing.  Counted as an eviction so the reuse metric
                # explains where sockets go.
                old, _ = dq.popleft()
                try:
                    old.close()
                except Exception:  # noqa: BLE001
                    pass
                CONN_REUSE.inc(outcome="evicted")
            dq.append((conn, time.monotonic()))

    def close_all(self) -> None:
        with self._lock:
            drained = [c for dq in self._idle.values() for (c, _) in dq]
            self._idle.clear()
        for c in drained:
            try:
                c.close()
            except Exception:  # noqa: BLE001
                pass

    def idle_count(self, port: Optional[int] = None) -> int:
        with self._lock:
            if port is not None:
                return len(self._idle.get(port, ()))
            return sum(len(dq) for dq in self._idle.values())

    # -- the one request primitive --------------------------------------
    def request(self, method: str, port: int, path: str,
                body: Optional[bytes] = None,
                headers: Optional[dict] = None,
                timeout: float = 10.0) -> PooledResponse:
        """Issue one HTTP/1.1 request over a pooled (or fresh) socket.

        Raises ``urllib.error.HTTPError`` for status >= 400 (with the
        connection already released), ``OSError``/``socket.timeout``
        for transport failures — the same exception envelope the relay
        retry loop was built against.
        """
        t0 = time.perf_counter()
        conn, evicted = self._checkout(port)
        for _ in range(evicted):
            CONN_REUSE.inc(outcome="evicted")
        reused = conn is not None
        t_wait = time.perf_counter() - t0
        attempts = 2 if reused else 1
        last_err: Optional[BaseException] = None
        for attempt in range(attempts):
            t_dial0 = time.perf_counter()
            if conn is None:
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=timeout)
                try:
                    # Persistent sockets make Nagle + delayed-ACK bite:
                    # the header write then body write pattern stalls
                    # ~40ms per request waiting for the peer's ACK.
                    # Connection-per-request hid this (close flushes);
                    # keepalive must disable Nagle explicitly.
                    conn.connect()
                    conn.sock.setsockopt(socket.IPPROTO_TCP,
                                         socket.TCP_NODELAY, 1)
                except OSError:
                    pass
                reused = False
            else:
                # Re-arm the deadline: pooled sockets keep whatever
                # timeout their last request set.
                try:
                    conn.timeout = timeout
                    if conn.sock is not None:
                        conn.sock.settimeout(timeout)
                except Exception:  # noqa: BLE001
                    pass
            try:
                hdrs = dict(headers or {})
                conn.request(method, path, body=body, headers=hdrs)
                t_sent = time.perf_counter()
                resp = conn.getresponse()
                t_first = time.perf_counter()
            except Exception as e:  # noqa: BLE001
                try:
                    conn.close()
                except Exception:  # noqa: BLE001
                    pass
                conn = None
                if reused and attempt == 0:
                    # Stale keep-alive race: the backend closed the idle
                    # socket between checkout and write.  Degradation
                    # contract: retire it and retry once on a fresh dial
                    # — never surface the race as a failed request.
                    CONN_REUSE.inc(outcome="evicted")
                    reused = False
                    last_err = e
                    continue
                raise
            break
        else:  # pragma: no cover - loop always breaks or raises
            raise last_err  # type: ignore[misc]
        CONN_REUSE.inc(outcome="reused" if reused else "fresh")
        timing = {
            "outcome": "reused" if reused else "fresh",
            "pool_wait_s": t_wait,
            "connect_s": 0.0 if reused else max(0.0, t_sent - t_dial0),
            "first_byte_s": max(0.0, t_first - t_sent),
        }
        out = PooledResponse(self, port, conn, resp, timing)
        if resp.status >= 400:
            data = b""
            try:
                data = resp.read()
            except Exception:  # noqa: BLE001
                pass
            out.release()
            raise urllib.error.HTTPError(
                f"http://127.0.0.1:{port}{path}", resp.status,
                resp.reason, resp.headers, io.BytesIO(data))
        return out


_DEFAULT = ConnectionPool()


def default_pool() -> ConnectionPool:
    return _DEFAULT


def request(method: str, port: int, path: str, body: Optional[bytes] = None,
            headers: Optional[dict] = None,
            timeout: float = 10.0) -> PooledResponse:
    """Module-level request on the shared default pool."""
    return _DEFAULT.request(method, port, path, body=body, headers=headers,
                            timeout=timeout)


def get(port: int, path: str, timeout: float = 10.0) -> bytes:
    """GET ``path`` and return the full body (pooled, keepalive)."""
    with _DEFAULT.request("GET", port, path, timeout=timeout) as r:
        return r.read()
