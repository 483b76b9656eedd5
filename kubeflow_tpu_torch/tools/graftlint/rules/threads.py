"""thread-lifecycle: every threading.Thread is daemonized or joined.

A non-daemon thread with no join owner outlives its creator: it pins
interpreter shutdown, leaks across test cases, and — the production
shape — keeps polling a dead engine's state forever.  Accepted
ownership shapes:

  * ``daemon=True`` at construction (or ``.daemon = True`` before start)
  * ``self._t = Thread(...)`` with a ``self._t.join(...)`` anywhere in
    the owning class (a ``stop()``/``close()`` join path)
  * a local/listcomp thread with a ``.join(`` later in the same function
    (the router's scatter-gather fan-outs)
"""

from __future__ import annotations

import ast
from typing import Iterable

from ..core import Context, Finding, Rule, SourceFile, expr_text


class ThreadLifecycleRule(Rule):
    name = "thread-lifecycle"
    invariant = ("every threading.Thread is constructed daemon=True, "
                 "joined by its owning class, or joined in its creating "
                 "function")
    history = ("a second engine start() spawned a SECOND loop "
               "thread racing every dispatch's buffer-donation contract; "
               "owned lifecycle (idempotent start, joined stop) is the "
               "fix pattern")

    def check(self, sf: SourceFile, ctx: Context) -> Iterable[Finding]:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            t = expr_text(node.func)
            if t not in ("threading.Thread", "Thread"):
                continue
            if self._daemon_kwarg(node):
                continue
            if self._owned(sf, node):
                continue
            yield Finding(
                self.name, sf.rel, node.lineno,
                "threading.Thread without daemon=True and without a "
                "join owner — daemonize it or join it from the owner's "
                "stop()/close()")

    @staticmethod
    def _daemon_kwarg(node) -> bool:
        for kw in node.keywords:
            if kw.arg == "daemon" and isinstance(kw.value, ast.Constant) \
                    and kw.value.value is True:
                return True
        return False

    def _owned(self, sf: SourceFile, node) -> bool:
        # find the assignment this call feeds (directly or via listcomp)
        assign = None
        for a in sf.ancestors(node):
            if isinstance(a, (ast.Assign, ast.AnnAssign)):
                assign = a
                break
            if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                break
        fn = sf.enclosing_function(node)
        if assign is not None:
            targets = assign.targets if isinstance(assign, ast.Assign) \
                else [assign.target]
            for t in targets:
                # self.<attr> = Thread(...): join or daemon anywhere in class
                if isinstance(t, ast.Attribute) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == "self":
                    cls = sf.enclosing_class(node)
                    if cls is not None and self._class_owns(cls, t.attr):
                        return True
                # local = Thread(...) (or a listcomp of them)
                if isinstance(t, ast.Name) and fn is not None \
                        and self._joined_later(fn, node.lineno):
                    return True
        # bare Thread(...).start() or constructor arg: only daemon saves it
        return False

    def _class_owns(self, cls, attr: str) -> bool:
        for node in ast.walk(cls):
            # self.<attr>.join(...)
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "join" \
                    and expr_text(node.func.value) == f"self.{attr}":
                return True
            # t = self.<attr>; ... t.join() — the incidents stop()
            # pattern; the local MUST actually be joined in the same
            # method (a mere is_alive() read alias is not ownership)
            if isinstance(node, ast.Assign) \
                    and expr_text(node.value) == f"self.{attr}":
                for t in node.targets:
                    if isinstance(t, ast.Name) and self._local_joined(
                            cls, node, t.id):
                        return True
            # self.<attr>.daemon = True before start
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Attribute) and t.attr == "daemon" \
                            and expr_text(t.value) == f"self.{attr}":
                        return True
        return False

    @staticmethod
    def _local_joined(cls, assign, name: str) -> bool:
        """True when the method containing ``assign`` also calls
        ``<name>.join(...)``."""
        for fn in ast.walk(cls):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not (fn.lineno <= assign.lineno
                    <= (fn.end_lineno or fn.lineno)):
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "join" \
                        and expr_text(node.func.value) == name:
                    return True
        return False

    @staticmethod
    def _joined_later(fn, after_line: int) -> bool:
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "join" \
                    and node.lineno >= after_line:
                return True
        return False
