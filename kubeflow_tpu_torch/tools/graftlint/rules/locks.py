"""lock-discipline and release-guarantee: the concurrency rules.

Both are annotation-driven (@GuardedBy-style): the code declares its
discipline inline and the checker enforces the declaration everywhere in
the module — including call sites written much later by someone who
never read the declaring class.
"""

from __future__ import annotations

import ast
from typing import Iterable

from ..core import (Context, Finding, Rule, SourceFile, _ACQ_RE, _GUARDED_RE,
                    _HOLDS_RE, _REL_RE, expr_text)


class LockDisciplineRule(Rule):
    name = "lock-discipline"
    invariant = ("attributes declared '# guarded-by: <lock>' are only "
                 "touched inside 'with <owner>.<lock>:' (or in functions "
                 "annotated '# graftlint: holds-lock=<lock>')")
    history = ("the ingress evidence snapshot iterated "
               "shared proxy state without state.lock and raced pod-churn "
               "mutation exactly when churn was the story")

    def check(self, sf: SourceFile, ctx: Context) -> Iterable[Finding]:
        # 1. collect guarded declarations: self.<attr> = ...  # guarded-by: L
        guarded: dict[str, str] = {}
        decl_fn: dict[str, ast.AST] = {}  # attr -> declaring function
        for node in ast.walk(sf.tree):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    lock = sf.directive_near(node.lineno, _GUARDED_RE)
                    if lock:
                        guarded[t.attr] = lock
                        decl_fn[t.attr] = sf.enclosing_function(node)
        if not guarded:
            return
        # imported module names are not instances — 'json.loads' must not
        # match a guarded attr that happens to be called 'loads'
        imported: set = set()
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    imported.add(a.asname or a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom):
                for a in node.names:
                    imported.add(a.asname or a.name)
        # 2. every access to a guarded attr must be lock-covered
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Attribute):
                continue
            lock = guarded.get(node.attr)
            if lock is None:
                continue
            recv = expr_text(node.value)
            if recv is None or recv.split(".")[0] in imported:
                continue
            fn = sf.enclosing_function(node)
            # the declaring function (the constructor) initializes before
            # the object is shared — exempt
            if fn is not None and fn is decl_fn.get(node.attr):
                continue
            if self._covered(sf, node, recv, lock):
                continue
            yield Finding(
                self.name, sf.rel, node.lineno,
                f"'{recv}.{node.attr}' is guarded-by '{lock}' but accessed "
                f"outside 'with {recv}.{lock}:' (annotate the enclosing "
                f"function '# graftlint: holds-lock={lock}' if every "
                f"caller holds it)")

    @staticmethod
    def _covered(sf: SourceFile, node, recv: str, lock: str) -> bool:
        want = f"{recv}.{lock}"
        for a in sf.ancestors(node):
            if isinstance(a, (ast.With, ast.AsyncWith)):
                for item in a.items:
                    t = expr_text(item.context_expr)
                    if t == want or t == lock:
                        return True
            if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef)):
                held = sf.directive_near(a.lineno, _HOLDS_RE)
                if held == lock:
                    return True
                # a decorated def: the directive may sit on the first
                # decorator line instead of the def line
                for dec in a.decorator_list:
                    if sf.directive_near(dec.lineno, _HOLDS_RE) == lock:
                        return True
        return False


class ReleaseGuaranteeRule(Rule):
    name = "release-guarantee"
    invariant = ("a statement annotated '# graftlint: acquires=<token>' "
                 "has a matching '# graftlint: releases=<token>' inside a "
                 "'finally:' block of the same function")
    history = ("an exception in the pre-relay span leaked "
               "the admitted inflight slot forever — leaked slots ratchet "
               "the AIMD count until the service sheds 100%")

    def check(self, sf: SourceFile, ctx: Context) -> Iterable[Finding]:
        acquires: list[tuple[int, str]] = []
        releases: list[tuple[int, str]] = []
        for ln, c in sf.comments.items():
            target = ln if ln in sf.code_lines else ln + 1
            m = _ACQ_RE.search(c)
            if m:
                acquires.append((target, m.group(1)))
            m = _REL_RE.search(c)
            if m:
                releases.append((target, m.group(1)))
        if not acquires and not releases:
            return
        # index releases by (function chain, token); require finally
        # context.  A release in a closure DEFINED in the acquiring
        # function counts (the background-thread handoff shape), so the
        # whole enclosing-function chain is credited.
        safe: set[tuple[int, str]] = set()
        unsafe_fn: dict[tuple[int, str], int] = {}
        for ln, token in releases:
            node = self._node_at(sf, ln)
            if node is None:
                continue
            chain = [0]
            cur = sf.enclosing_function(node)
            while cur is not None:
                chain.append(id(cur))
                cur = sf.enclosing_function(cur)
            for fid in chain:
                if self._in_finally(sf, node):
                    safe.add((fid, token))
                else:
                    unsafe_fn[(fid, token)] = ln
        for ln, token in acquires:
            node = self._node_at(sf, ln)
            fn = sf.enclosing_function(node) if node is not None else None
            fid = id(fn) if fn is not None else 0
            if (fid, token) in safe:
                continue
            if (fid, token) in unsafe_fn:
                yield Finding(
                    self.name, sf.rel, ln,
                    f"'{token}' is released at line "
                    f"{unsafe_fn[(fid, token)]} but not from a 'finally:' "
                    f"block — an exception between acquire and release "
                    f"leaks it")
            else:
                yield Finding(
                    self.name, sf.rel, ln,
                    f"acquire of '{token}' has no "
                    f"'# graftlint: releases={token}' in a 'finally:' "
                    f"block of the same function")

    @staticmethod
    def _node_at(sf: SourceFile, line: int):
        best = None
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.stmt) and node.lineno <= line \
                    and (node.end_lineno or node.lineno) >= line:
                if best is None or node.lineno >= best.lineno:
                    best = node
        return best

    @staticmethod
    def _in_finally(sf: SourceFile, node) -> bool:
        # parents are immediate, so at each Try ancestor the previous hop
        # is one of its direct body/handler/finalbody statements
        child = node
        for a in sf.ancestors(node):
            if isinstance(a, ast.Try) and any(child is s
                                              for s in a.finalbody):
                return True
            child = a
        return False
