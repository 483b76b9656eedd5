"""Event-loop ingress core: the proxy's front door at wire speed.

A copy of ``kubeflow_tpu/serving/ingress_core.py``.

The seed data plane was ``ThreadingHTTPServer`` — an OS thread spawned
per accepted connection, ``BaseHTTPRequestHandler`` readline parsing,
and a thread stack held hostage for the connection's whole lifetime.
This module replaces it with one selectors-driven readiness loop plus a
small fixed worker set:

    loop thread (non-blocking):   accept -> read -> frame request
                                  -> hand off -> keep-alive re-arm
    relay workers (fixed count):  run the proxy's admission pipeline +
                                  retry state machine for one framed
                                  request, then give the socket back

The loop owns every socket while it is *waiting* (idle keep-alive
connections cost one selector key, not one thread); a worker owns the
socket only while a fully-framed request is being relayed.  SSE
passthrough runs in the worker as a readiness-driven splice of raw
backend frames (see ``router._stream_passthrough``) — the loop is never
blocked by a slow stream, and idle connections never occupy a worker.

The ``Conn`` facade exposes the slice of the
``BaseHTTPRequestHandler`` surface the relay pipeline consumes
(``command``/``path``/``headers``/``rfile``/``wfile``,
``send_response``/``send_header``/``end_headers``, ``_reply``/
``_chunk``), so ``router._relay`` runs unchanged on either core.

Server-side contract preserved from the seed core: HTTP/1.1 with
keep-alive by default, ``Connection: close`` honored, request bodies
framed by ``Content-Length`` (the only framing our clients emit).
"""

from __future__ import annotations

import io
import queue
import selectors
import socket
import threading
from http.client import responses as _REASONS
from typing import Callable, Dict, List, Optional, Tuple

# Per-connection receive buffer cap while parsing the head: a client
# that streams junk without a blank line is cut off, not buffered
# forever (graftlint: bounded-growth).
_MAX_HEAD_BYTES = 65536
_RECV_CHUNK = 65536
_DEFAULT_WORKERS = 16


class Headers:
    """Case-insensitive read view over parsed request headers.

    Mirrors the slice of ``email.message.Message`` the relay touches:
    ``get`` (case-insensitive, first value wins) and ``items`` (original
    casing, original order — hop-by-hop stripping iterates this).
    """

    __slots__ = ("_pairs", "_first")

    def __init__(self, pairs: List[Tuple[str, str]]):
        self._pairs = pairs
        self._first: Dict[str, str] = {}
        for k, v in pairs:
            self._first.setdefault(k.lower(), v)

    def get(self, name: str, default=None):
        return self._first.get(name.lower(), default)

    def items(self) -> List[Tuple[str, str]]:
        return list(self._pairs)

    def __contains__(self, name: str) -> bool:
        return name.lower() in self._first

    def __iter__(self):
        return iter(k for k, _ in self._pairs)


class _WFile:
    """Blocking write file over the client socket (worker-side only)."""

    __slots__ = ("_sock",)

    def __init__(self, sock: socket.socket):
        self._sock = sock

    def write(self, data: bytes) -> int:
        self._sock.sendall(data)
        return len(data)

    def flush(self) -> None:  # sendall is unbuffered
        pass


class Conn:
    """One framed request, presented with the handler surface the
    relay pipeline was written against."""

    protocol_version = "HTTP/1.1"

    def __init__(self, sock: socket.socket, addr, command: str, path: str,
                 headers: Headers, body: bytes):
        self.sock = sock
        self.client_address = addr
        self.command = command
        self.path = path
        self.headers = headers
        self.rfile = io.BytesIO(body)
        self.wfile = _WFile(sock)
        # HTTP/1.1 defaults to keep-alive; the client (or a streaming
        # reply path) can opt out.
        self.close_connection = \
            (headers.get("Connection", "") or "").lower() == "close"
        self.wrote_status = False
        self._hdr_buf: List[bytes] = []
        self._sent_connection_hdr = False

    # -- response surface (subset of BaseHTTPRequestHandler) ------------
    def send_response(self, code: int, message: Optional[str] = None) -> None:
        reason = message if message is not None else _REASONS.get(code, "")
        self.wrote_status = True
        self._hdr_buf = [b"HTTP/1.1 %d %s\r\n" % (code, reason.encode())]

    def send_header(self, keyword: str, value) -> None:
        if keyword.lower() == "connection":
            self._sent_connection_hdr = True
            if str(value).lower() == "close":
                self.close_connection = True
        self._hdr_buf.append(
            f"{keyword}: {value}\r\n".encode("latin-1"))

    def end_headers(self) -> None:
        if not self._sent_connection_hdr:
            self._hdr_buf.append(b"Connection: keep-alive\r\n")
        self._hdr_buf.append(b"\r\n")
        self.wfile.write(b"".join(self._hdr_buf))
        self._hdr_buf = []

    def _reply(self, code: int, data: bytes,
               ctype: str = "application/json",
               extra: Optional[dict] = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _chunk(self, data: bytes) -> None:
        self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))

    def log_message(self, *a) -> None:  # handler-surface compat
        pass


class _ConnState:
    """Loop-side per-connection parse state."""

    __slots__ = ("sock", "addr", "buf", "head_done", "command", "path",
                 "headers", "clen", "alive")

    def __init__(self, sock: socket.socket, addr):
        self.sock = sock
        self.addr = addr
        self.buf = bytearray()
        self.alive = True
        self.reset()

    def reset(self) -> None:
        self.head_done = False
        self.command = ""
        self.path = ""
        self.headers: Optional[Headers] = None
        self.clen = 0


class IngressServer:
    """Selectors event loop + fixed relay worker set.

    Drop-in for the slice of ``ThreadingHTTPServer`` the proxy uses:
    ``server_address``, ``serve_forever()``, ``shutdown()``,
    ``server_close()``.
    """

    def __init__(self, address: Tuple[str, int],
                 handler: Callable[[Conn], None],
                 workers: int = _DEFAULT_WORKERS):
        self._handler = handler
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind(address)
        self._lsock.listen(256)
        self._lsock.setblocking(False)
        self.server_address = self._lsock.getsockname()
        self._sel = selectors.DefaultSelector()
        # Self-pipe: workers wake the loop to re-arm keep-alive sockets
        # and to deliver shutdown.
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._rearm: "queue.SimpleQueue[_ConnState]" = queue.SimpleQueue()
        self._work: "queue.SimpleQueue[Optional[Tuple[_ConnState, Conn]]]" = \
            queue.SimpleQueue()
        self._shut = threading.Event()
        self._done = threading.Event()
        self._closed = False
        self._nworkers = max(1, int(workers))
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"ingress-worker-{i}")
            for i in range(self._nworkers)]
        for t in self._threads:
            t.start()

    # -- lifecycle -------------------------------------------------------
    def serve_forever(self, poll_interval: float = 0.5) -> None:
        self._sel.register(self._lsock, selectors.EVENT_READ, "accept")
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        try:
            self._run_loop()
        finally:
            self._done.set()

    def shutdown(self) -> None:
        self._shut.set()
        self._wake()
        self._done.wait(timeout=5.0)
        for _ in self._threads:
            self._work.put(None)

    def server_close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for s in (self._lsock, self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass

    # -- the readiness loop ---------------------------------------------
    # graftlint: event-loop
    def _run_loop(self) -> None:
        sel = self._sel
        while not self._shut.is_set():
            for key, _ in sel.select(timeout=0.5):
                tag = key.data
                if tag == "accept":
                    self._accept()
                elif tag == "wake":
                    self._drain_wakeups()
                else:
                    self._on_readable(tag)
        # Drain: unregister everything and close loop-owned sockets.
        for key in list(sel.get_map().values()):
            data = key.data
            try:
                sel.unregister(key.fileobj)
            except (KeyError, ValueError):
                pass
            if isinstance(data, _ConnState):
                self._close_state(data)
        sel.close()

    # graftlint: event-loop
    def _accept(self) -> None:
        while True:
            try:
                sock, addr = self._lsock.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            st = _ConnState(sock, addr)
            self._sel.register(sock, selectors.EVENT_READ, st)

    # graftlint: event-loop
    def _drain_wakeups(self) -> None:
        try:
            while self._wake_r.recv(4096):
                pass
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            return
        # Re-arm keep-alive sockets handed back by workers.  Pipelined
        # bytes may already sit in the buffer, so try to frame
        # immediately instead of waiting for the next readable event.
        while True:
            try:
                st = self._rearm.get_nowait()
            except queue.Empty:
                break
            if not st.alive:
                continue
            try:
                st.sock.setblocking(False)
                self._sel.register(st.sock, selectors.EVENT_READ, st)
            except (OSError, ValueError, KeyError):
                self._close_state(st)
                continue
            self._try_dispatch(st)

    # graftlint: event-loop
    def _on_readable(self, st: _ConnState) -> None:
        try:
            data = st.sock.recv(_RECV_CHUNK)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._drop(st)
            return
        if not data:
            self._drop(st)
            return
        st.buf += data
        self._try_dispatch(st)

    # graftlint: event-loop
    def _try_dispatch(self, st: _ConnState) -> None:
        """Frame one request off the buffer; hand it to a worker."""
        if not st.head_done:
            idx = st.buf.find(b"\r\n\r\n")
            if idx < 0:
                if len(st.buf) > _MAX_HEAD_BYTES:
                    self._drop(st)
                return
            head = bytes(st.buf[:idx])
            del st.buf[:idx + 4]
            if not self._parse_head(st, head):
                self._drop(st)
                return
        if len(st.buf) < st.clen:
            return
        body = bytes(st.buf[:st.clen])
        del st.buf[:st.clen]
        conn = Conn(st.sock, st.addr, st.command, st.path,
                    st.headers or Headers([]), body)
        st.reset()
        # The worker owns the socket until it re-arms or closes it.
        try:
            self._sel.unregister(st.sock)
        except (KeyError, ValueError):
            pass
        self._work.put((st, conn))

    @staticmethod
    def _parse_head(st: _ConnState, head: bytes) -> bool:
        try:
            lines = head.decode("latin-1").split("\r\n")
            command, path, _version = lines[0].split(" ", 2)
        except ValueError:
            return False
        pairs: List[Tuple[str, str]] = []
        for ln in lines[1:]:
            if not ln:
                continue
            k, sep, v = ln.partition(":")
            if not sep:
                return False
            pairs.append((k.strip(), v.strip()))
        st.command = command
        st.path = path
        st.headers = Headers(pairs)
        try:
            st.clen = int(st.headers.get("Content-Length", "0") or 0)
        except ValueError:
            return False
        if st.clen < 0:
            return False
        st.head_done = True
        return True

    def _drop(self, st: _ConnState) -> None:
        try:
            self._sel.unregister(st.sock)
        except (KeyError, ValueError):
            pass
        self._close_state(st)

    @staticmethod
    def _close_state(st: _ConnState) -> None:
        st.alive = False
        try:
            st.sock.close()
        except OSError:
            pass

    # -- workers ---------------------------------------------------------
    def _worker(self) -> None:
        while True:
            item = self._work.get()
            if item is None:
                return
            st, conn = item
            try:
                conn.sock.setblocking(True)
                self._handler(conn)
            except Exception:  # noqa: BLE001 - one request, not the server
                if not conn.wrote_status:
                    try:
                        conn._reply(500, b'{"error": "internal"}')
                    except Exception:  # noqa: BLE001
                        pass
                conn.close_connection = True
            if conn.close_connection or self._shut.is_set():
                self._close_state(st)
            else:
                self._rearm.put(st)
                self._wake()
