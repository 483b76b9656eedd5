"""event-loop-blocking: functions on the ingress readiness loop never
block.

Opt-in via '# graftlint: event-loop' on (or directly above) the def
line — the marker the ingress data plane (serving/ingress_core.py)
puts on every function the selector loop thread runs.  One blocked
call there stalls EVERY connection the proxy is carrying, so the rule
bans the calls that block by construction (time.sleep, a synchronous
urlopen, reading a whole response) and the ones that block by default
(socket recv/accept on a socket that was never switched to
non-blocking mode).

The socket check is structural, not nominal: a recv()/accept()/
recvfrom() is accepted only when the call sits under a ``try`` whose
handlers catch BlockingIOError — the unavoidable signature of
non-blocking socket code (a non-blocking socket RAISES
BlockingIOError instead of waiting; code that never catches it either
blocks or was never tested).  Referencing the loop's selector is not
enough: registering a socket with a selector does not make its recv
non-blocking.

json.loads/json.load are banned outright: the loop only FRAMES
requests (split head, count Content-Length bytes); parsing a multi-KB
body is worker-pool work, and on the loop it is a per-request stall
multiplied by every other connection.
"""

from __future__ import annotations

import ast
from typing import Iterable

from ..core import Context, Finding, Rule, SourceFile, _EVLOOP_RE, expr_text

BANNED_CALLS = {
    "time.sleep": "a sleeping loop thread stalls every connection — "
                  "use the selector timeout for pacing",
    "urllib.request.urlopen": "a synchronous dial+read on the loop "
                              "blocks all connections — backend I/O "
                              "belongs on the worker pool (see "
                              "serving/transport.py)",
    "urlopen": "a synchronous dial+read on the loop blocks all "
               "connections — backend I/O belongs on the worker pool "
               "(see serving/transport.py)",
    "json.loads": "body parsing is worker-pool work — the loop only "
                  "frames bytes (head split + Content-Length count)",
    "json.load": "body parsing is worker-pool work — the loop only "
                 "frames bytes (head split + Content-Length count)",
}

# socket methods that block unless the socket is non-blocking
_BLOCKING_SOCK_METHODS = ("recv", "accept", "recvfrom")


class EventLoopRule(Rule):
    name = "event-loop-blocking"
    invariant = ("functions marked '# graftlint: event-loop' never call "
                 "time.sleep/urlopen/json.loads, and every socket "
                 "recv/accept sits under a try that catches "
                 "BlockingIOError (the non-blocking discipline proof)")
    history = ("the ingress moved from thread-per-connection "
               "to one readiness loop — a single blocked call there now "
               "stalls every in-flight request, not one; the rule makes "
               "the loop's non-blocking discipline machine-checked "
               "instead of reviewed")

    def check(self, sf: SourceFile, ctx: Context) -> Iterable[Finding]:
        for node in ast.walk(sf.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            marked = sf.directive_near(node.lineno, _EVLOOP_RE) or any(
                sf.directive_near(d.lineno, _EVLOOP_RE)
                for d in node.decorator_list)
            if not marked:
                continue
            yield from self._check_body(sf, node)

    def _check_body(self, sf: SourceFile, fn) -> Iterable[Finding]:
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            t = expr_text(node.func)
            if t in BANNED_CALLS:
                yield Finding(
                    self.name, sf.rel, node.lineno,
                    f"event-loop function '{fn.name}' calls {t}() — "
                    f"{BANNED_CALLS[t]}")
                continue
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _BLOCKING_SOCK_METHODS \
                    and not self._under_blockingio_guard(sf, node, fn):
                yield Finding(
                    self.name, sf.rel, node.lineno,
                    f"event-loop function '{fn.name}' calls "
                    f".{node.func.attr}() outside a try that catches "
                    f"BlockingIOError — a default (blocking) socket "
                    f"here stalls every connection on the loop; set the "
                    f"socket non-blocking and handle BlockingIOError")

    @staticmethod
    def _under_blockingio_guard(sf: SourceFile, node, fn) -> bool:
        """True when an ancestor ``try`` (inside fn) has a handler whose
        exception list names BlockingIOError."""
        for a in sf.ancestors(node):
            if a is fn:
                return False
            if not isinstance(a, ast.Try):
                continue
            for handler in a.handlers:
                for exc in _exc_names(handler.type):
                    if exc.endswith("BlockingIOError"):
                        return True
        return False


def _exc_names(t) -> list:
    """Dotted names inside an except clause type (name or tuple)."""
    if t is None:
        return []
    if isinstance(t, ast.Tuple):
        out = []
        for e in t.elts:
            out.extend(_exc_names(e))
        return out
    name = expr_text(t)
    return [name] if name else []
