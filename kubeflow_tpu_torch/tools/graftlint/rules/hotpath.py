"""hot-path: functions on the per-request/per-tick critical path stay
allocation-light and O(1).

Opt-in via '# graftlint: hot-path' on (or directly above) the def line.
Bans the known offenders from the repo's review history — JSON parsing,
sorting, deep copies — and flags O(n) iteration under a lock.
"""

from __future__ import annotations

import ast
from typing import Iterable

from ..core import Context, Finding, Rule, SourceFile, _HOT_RE, expr_text

BANNED_CALLS = {
    "json.loads": "parse once at the boundary, pass the object",
    "json.dumps": "serialize off the hot path",
    "json.dump": "serialize off the hot path",
    "copy.deepcopy": "deep copies are O(object graph)",
    "sorted": "sorting is O(n log n) — keep a cache or a heap",
    "time.time": "wall clock skews under NTP steps — hot-path timing "
                 "uses time.perf_counter",
    # grammar/regex compilation is admission-time work (README
    # "Structured output"): the per-tick mask path walks PRE-compiled
    # automata; a compile here would stall every slot in the batch
    "re.compile": "pattern compilation is O(pattern) with a global lock "
                  "on the cache — compile at module scope",
    "compile_grammar": "grammar compilation belongs at admission — the "
                       "tick path only walks compiled automata",
    "compile_json_schema": "schema compilation belongs at admission — "
                           "the tick path only walks compiled automata",
    "compile_spec": "spec compilation belongs at admission — the tick "
                    "path only walks compiled automata",
    "constrain.compile_grammar": "grammar compilation belongs at "
                                 "admission — the tick path only walks "
                                 "compiled automata",
    "constrain.compile_spec": "spec compilation belongs at admission — "
                              "the tick path only walks compiled "
                              "automata",
}


class HotPathRule(Rule):
    name = "hot-path"
    invariant = ("functions marked '# graftlint: hot-path' never call "
                 "json.loads/json.dumps/copy.deepcopy/sorted/time.time "
                 "and never iterate a collection under a lock")
    history = ("the deadline gate sorted the rolling latency "
               "window per admission under the controller lock — the "
               "module's stated O(1) discipline, made true by a p50 cache "
               "refreshed once per adjust pass")

    def check(self, sf: SourceFile, ctx: Context) -> Iterable[Finding]:
        for node in ast.walk(sf.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            marked = sf.directive_near(node.lineno, _HOT_RE) or any(
                sf.directive_near(d.lineno, _HOT_RE)
                for d in node.decorator_list)
            if not marked:
                continue
            yield from self._check_body(sf, node)

    def _check_body(self, sf: SourceFile, fn) -> Iterable[Finding]:
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                t = expr_text(node.func)
                if t in BANNED_CALLS:
                    yield Finding(
                        self.name, sf.rel, node.lineno,
                        f"hot-path function '{fn.name}' calls {t}() — "
                        f"{BANNED_CALLS[t]}")
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                lock = self._lock_above(sf, node, fn)
                if lock and self._iterates_collection(node.iter):
                    yield Finding(
                        self.name, sf.rel, node.lineno,
                        f"hot-path function '{fn.name}' iterates a "
                        f"collection inside 'with {lock}:' — O(n) work "
                        f"under a lock serializes every other holder")

    @staticmethod
    def _lock_above(sf: SourceFile, node, fn) -> str:
        """Name of a lock-ish context manager between node and fn."""
        for a in sf.ancestors(node):
            if a is fn:
                return ""
            if isinstance(a, (ast.With, ast.AsyncWith)):
                for item in a.items:
                    t = expr_text(item.context_expr)
                    if t and "lock" in t.lower():
                        return t
        return ""

    @staticmethod
    def _iterates_collection(it) -> bool:
        """True for 'for x in <attr>' / '<attr>.items()/values()/keys()'
        — the unbounded-collection shapes; range()/literals are fine."""
        if isinstance(it, ast.Attribute):
            return True
        if isinstance(it, ast.Call) and isinstance(it.func, ast.Attribute) \
                and it.func.attr in ("items", "values", "keys"):
            return True
        return False
