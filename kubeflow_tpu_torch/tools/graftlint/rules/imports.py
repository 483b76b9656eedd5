"""import-weight: the router's POD import chain stays light.

Walks the REAL top-level import graph from the ingress roots
(serving/router.py, serving/overload.py) and flags any module in the
closure that imports numpy, torch, or the serving engine at module scope.
Function-scope (lazy) imports are the sanctioned pattern and are not
edges.
"""

from __future__ import annotations

import ast
import collections
from typing import Iterable, Optional

from ..core import (Context, Finding, Rule, is_package, module_name,
                    resolve_import_base)

PACKAGE = "kubeflow_tpu_torch"
ROOTS = (f"{PACKAGE}.serving.router", f"{PACKAGE}.serving.overload")
# heavy leaf packages that must never ride the ingress import chain; the
# engine subtree transitively pulls numpy AND torch (torch is the port's
# heavy leaf, as jax is the JAX package's)
BANNED_EXTERNAL = ("numpy", "torch")
BANNED_INTERNAL_PREFIX = f"{PACKAGE}.serving.engine"


def _top_level_imports(tree: ast.Module) -> Iterable[ast.stmt]:
    """Module-scope import statements, descending into module-level
    If/Try bodies but skipping 'if TYPE_CHECKING:' guards."""
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            yield node
        elif isinstance(node, ast.If):
            t = node.test
            name = t.id if isinstance(t, ast.Name) else (
                t.attr if isinstance(t, ast.Attribute) else "")
            if name != "TYPE_CHECKING":
                stack.extend(node.body)
            stack.extend(node.orelse)
        elif isinstance(node, ast.Try):
            stack.extend(node.body)
            for h in node.handlers:
                stack.extend(h.body)
            stack.extend(node.orelse)
            stack.extend(node.finalbody)


class ImportWeightRule(Rule):
    name = "import-weight"
    invariant = ("no module reachable from serving/router.py or "
                 "serving/overload.py via top-level imports may import "
                 "numpy, torch, or kubeflow_tpu_torch.serving.engine at "
                 "module scope")
    history = ("a top-level numpy/scheduler import on the serving "
               "package chain took the POD subprocess import from 0.28s "
               "to 1.26s — enough to blow the 1.5s scale-from-zero "
               "activation grace and re-zero the deployment")

    def finalize(self, ctx: Context) -> Iterable[Finding]:
        # adjacency: module -> [(target_module, line)]
        edges: dict[str, list] = {}
        banned_at: dict[str, list] = {}  # module -> [(line, what)]
        for sf in ctx.files:
            mod = module_name(sf.rel)
            out: list = []
            bans: list = []
            for node in _top_level_imports(sf.tree):
                if isinstance(node, ast.Import):
                    for a in node.names:
                        root = a.name.split(".")[0]
                        if root in BANNED_EXTERNAL:
                            bans.append((node.lineno, a.name))
                        if a.name.startswith(PACKAGE):
                            out.append((a.name, node.lineno))
                else:
                    base = resolve_import_base(mod, is_package(sf.rel),
                                               node)
                    if base is None:
                        continue
                    if base.split(".")[0] in BANNED_EXTERNAL:
                        bans.append((node.lineno, base))
                    if base.startswith(PACKAGE):
                        for a in node.names:
                            sub = f"{base}.{a.name}"
                            # 'from .x import y': y may be a submodule or
                            # a symbol — edge to the submodule when it
                            # exists, else to the base module
                            out.append((sub if sub in ctx.by_module
                                        else base, node.lineno))
            # importing any module executes its ancestor packages too
            withself = set()
            for tgt, ln in out:
                parts = tgt.split(".")
                for i in range(1, len(parts) + 1):
                    anc = ".".join(parts[:i])
                    if anc in ctx.by_module and anc != mod:
                        withself.add((anc, ln))
            edges[mod] = sorted(withself)
            if bans:
                banned_at[mod] = bans
        # BFS the closure from the roots, keeping one witness chain
        parent: dict[str, Optional[str]] = {}
        q = collections.deque()
        for r in ROOTS:
            if r in ctx.by_module and r not in parent:
                parent[r] = None
                q.append(r)
        while q:
            cur = q.popleft()
            for tgt, _ in edges.get(cur, ()):
                if tgt not in parent and tgt in ctx.by_module:
                    parent[tgt] = cur
                    q.append(tgt)
        for mod in sorted(parent):
            sf = ctx.by_module[mod]
            # banned internal targets: an edge INTO the engine subtree
            for tgt, ln in edges.get(mod, ()):
                if tgt.startswith(BANNED_INTERNAL_PREFIX):
                    yield Finding(
                        self.name, sf.rel, ln,
                        f"{mod} (on the ingress import chain: "
                        f"{self._chain(parent, mod)}) imports {tgt} at "
                        f"module scope — move it into the function that "
                        f"needs it")
            for ln, what in banned_at.get(mod, ()):
                yield Finding(
                    self.name, sf.rel, ln,
                    f"{mod} (on the ingress import chain: "
                    f"{self._chain(parent, mod)}) imports {what} at "
                    f"module scope — move it into the function that "
                    f"needs it")

    @staticmethod
    def _chain(parent: dict, mod: str) -> str:
        hops = [mod]
        while parent.get(hops[-1]) is not None:
            hops.append(parent[hops[-1]])
        return " <- ".join(hops)
