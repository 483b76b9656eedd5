"""atomic-write: durable JSON/state writes use tmp + os.replace.

A write is "durable JSON" when the function both opens a path in a
write mode and serializes JSON into it (json.dump / f.write(json.dumps)),
or the path literal names a .json file.  The sanctioned discipline is
the kvstore one: write to a sibling tmp path, fsync-free os.replace.
Writes whose path expression already mentions tmp are the first half of
that discipline and pass.
"""

from __future__ import annotations

import ast
from typing import Iterable

from ..core import Context, Finding, Rule, SourceFile, expr_text


class AtomicWriteRule(Rule):
    name = "atomic-write"
    invariant = ("durable JSON/state writes go through tmp + os.replace, "
                 "never bare open(path, 'w')")
    history = ("torn-write chaos against the tiered KV store — "
               "every durable artifact since (page files, incident "
               "bundles, checkpoints) uses the tmp+os.replace discipline "
               "so a crash mid-write leaves the old file, not half a new "
               "one")

    def check(self, sf: SourceFile, ctx: Context) -> Iterable[Finding]:
        funcs = [n for n in ast.walk(sf.tree)
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        # module body as a pseudo-function for script-style files
        for scope in funcs + [sf.tree]:
            yield from self._check_scope(sf, scope)

    def _check_scope(self, sf: SourceFile, scope) -> Iterable[Finding]:
        own_nodes = list(self._own_walk(scope))
        opens = []
        json_write = False
        replaced_srcs: list = []  # os.replace(<src>, <dst>) first args
        for node in own_nodes:
            if not isinstance(node, ast.Call):
                continue
            t = expr_text(node.func)
            if t == "open" and len(node.args) >= 2 \
                    and isinstance(node.args[1], ast.Constant) \
                    and isinstance(node.args[1].value, str) \
                    and node.args[1].value.startswith("w"):
                opens.append(node)
            elif t in ("json.dump", "json.dumps"):
                json_write = True
            elif t == "os.replace" and node.args:
                replaced_srcs.append(
                    ast.get_source_segment(sf.text, node.args[0]) or "")
        if not opens:
            return
        for node in opens:
            path_src = ast.get_source_segment(sf.text, node.args[0]) or ""
            durable = json_write or ".json" in path_src
            if not durable:
                continue
            if "tmp" in path_src.lower():
                continue  # writing the tmp half of the discipline
            # exemption is PER OPEN: this open's exact path must be what
            # an os.replace in the scope moves — one correctly-staged
            # write must not grandfather a second bare one next to it
            if any(path_src == r for r in replaced_srcs):
                continue
            yield Finding(
                self.name, sf.rel, node.lineno,
                f"bare open({path_src}, 'w') with a JSON payload and no "
                f"os.replace of that path in scope — a crash mid-write "
                f"leaves a torn file; write to '<path>.tmp' then "
                f"os.replace")

    @staticmethod
    def _own_walk(scope):
        """Walk scope WITHOUT descending into nested function defs (their
        writes are judged in their own scope)."""
        stack = list(ast.iter_child_nodes(scope))
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node is not scope:
                continue
            yield node
            stack.extend(ast.iter_child_nodes(node))
