"""bounded-growth: dicts keyed by unbounded identity need a prune path.

Heuristic: an instance (or module-level) dict whose name mentions a
request/tenant/pod-shaped identity must have SOME shrink operation —
pop/popitem/clear/del/reassignment — reachable in the same class (or
module).  Existence, not call-graph reachability: the historical bugs
were dicts with NO removal code at all.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable

from ..core import Context, Finding, Rule, SourceFile

IDENT_RE = re.compile(
    r"tenant|session|pod\b|pods|rid|request|replica|backend|handle|"
    r"bucket|trace", re.IGNORECASE)
DICT_FACTORIES = {"dict", "defaultdict", "OrderedDict", "Counter"}


def _is_dict_value(v) -> bool:
    if isinstance(v, ast.Dict):
        return True
    if isinstance(v, ast.Call):
        f = v.func
        name = f.id if isinstance(f, ast.Name) else (
            f.attr if isinstance(f, ast.Attribute) else "")
        return name in DICT_FACTORIES
    return False


class BoundedGrowthRule(Rule):
    name = "bounded-growth"
    invariant = ("a dict keyed by request/tenant/pod/session identity has "
                 "a prune/eviction operation in its owning class or module")
    history = ("a unique-X-Tenant-Id-per-request storm grew "
               "four per-tenant dicts and the per-admission share sum "
               "without bound until the amortized adjust pass learned to "
               "prune them")

    def check(self, sf: SourceFile, ctx: Context) -> Iterable[Finding]:
        for cls in ast.walk(sf.tree):
            if isinstance(cls, ast.ClassDef):
                yield from self._check_class(sf, cls)
        yield from self._check_module_level(sf)

    def _check_class(self, sf: SourceFile, cls) -> Iterable[Finding]:
        init = next((n for n in cls.body
                     if isinstance(n, ast.FunctionDef)
                     and n.name == "__init__"), None)
        if init is None:
            return
        candidates: dict[str, int] = {}
        for node in ast.walk(init):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            value = node.value
            if value is None or not _is_dict_value(value):
                continue
            for t in targets:
                if (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                        and IDENT_RE.search(t.attr)):
                    candidates[t.attr] = node.lineno
        if not candidates:
            return
        shrunk = _module_shrunk_names(sf)
        shrunk |= self._reassigned_attrs(cls, init)
        for attr, line in sorted(candidates.items(), key=lambda kv: kv[1]):
            if attr in shrunk:
                continue
            yield Finding(
                self.name, sf.rel, line,
                f"'self.{attr}' in class {cls.name} looks keyed by "
                f"unbounded identity but nothing in the module pops/"
                f"clears/deletes from it — a churn workload grows it "
                f"forever")

    @staticmethod
    def _reassigned_attrs(cls, init) -> set:
        """self.X reassigned wholesale in a method outside __init__."""
        out: set = set()
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign) \
                    and not (init.lineno <= node.lineno
                             <= (init.end_lineno or init.lineno)):
                for t in node.targets:
                    if isinstance(t, ast.Attribute) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id == "self":
                        out.add(t.attr)
        return out

    def _check_module_level(self, sf: SourceFile) -> Iterable[Finding]:
        candidates: dict[str, int] = {}
        for node in sf.tree.body:
            if isinstance(node, ast.Assign) and _is_dict_value(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name) and IDENT_RE.search(t.id):
                        candidates[t.id] = node.lineno
        if not candidates:
            return
        shrunk = _module_shrunk_names(sf)
        for name, line in sorted(candidates.items(), key=lambda kv: kv[1]):
            if name not in shrunk:
                yield Finding(
                    self.name, sf.rel, line,
                    f"module-level dict '{name}' looks keyed by unbounded "
                    f"identity but nothing in the module pops/clears/"
                    f"deletes from it")


def _module_shrunk_names(sf: SourceFile) -> set:
    """Names (attribute or bare) with a shrink op anywhere in the module.

    Receiver-agnostic on purpose: proxy state dicts are pruned by the
    OWNING component (``state.sessions.pop`` in ServiceProxy), not by
    methods of the declaring dataclass.  Also recognizes the alias-loop
    fold shape ``for d in (self.a, self.b): ... d.pop(...)``."""
    shrunk: set = set()
    aliased: dict[str, list] = {}  # loop-var -> attr names it aliases
    for node in ast.walk(sf.tree):
        if isinstance(node, (ast.For, ast.AsyncFor)) \
                and isinstance(node.target, ast.Name) \
                and isinstance(node.iter, (ast.Tuple, ast.List)):
            attrs = [e.attr for e in node.iter.elts
                     if isinstance(e, ast.Attribute)]
            if attrs:
                aliased.setdefault(node.target.id, []).extend(attrs)
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("pop", "popitem", "clear"):
            recv = node.func.value
            if isinstance(recv, ast.Attribute):
                shrunk.add(recv.attr)
            elif isinstance(recv, ast.Name):
                shrunk.add(recv.id)
                shrunk.update(aliased.get(recv.id, ()))
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                if isinstance(t, ast.Subscript):
                    if isinstance(t.value, ast.Attribute):
                        shrunk.add(t.value.attr)
                    elif isinstance(t.value, ast.Name):
                        shrunk.add(t.value.id)
                        shrunk.update(aliased.get(t.value.id, ()))
    return shrunk
