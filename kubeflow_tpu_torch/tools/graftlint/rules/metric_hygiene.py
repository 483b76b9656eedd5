"""metric-hygiene: metric objects resolve to a registration; labeled
series keyed by unbounded identity have a removal path.

Registrations are ``<registry>.counter|gauge|histogram("name", ...)``
calls anywhere in the tree (telemetry.py owns the engine scope, the
router/disagg modules own the ingress scope).  Usage sites are
``ALL_CAPS.inc/observe/set`` on module-level constants — the convention
every metric in the repo follows.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, Optional

from ..core import (Context, Finding, Rule, SourceFile, is_package,
                    module_name, resolve_import_base)

REG_METHODS = {"counter", "gauge", "histogram"}
USE_METHODS = {"inc", "observe", "set"}
ALLCAPS_RE = re.compile(r"^[A-Z][A-Z0-9_]*$")
# label keys whose value space grows with traffic, not with config
IDENTITY_LABELS = {"tenant", "pod", "session", "rid", "handle"}


class MetricHygieneRule(Rule):
    name = "metric-hygiene"
    invariant = ("every ALL_CAPS metric constant used via .inc/.observe/"
                 ".set resolves to a registry registration, and any metric "
                 "labeled by unbounded identity (tenant/pod/session/rid/"
                 "handle) has a .remove() path somewhere in the tree")
    history = ("ingress_tenant_tokens leaked one "
               "registry series per tenant forever under a unique-tenant "
               "storm while the controller's own dicts were bounded — the "
               "gauge needed drain_pruned_tenants wired to .remove()")

    def finalize(self, ctx: Context) -> Iterable[Finding]:
        # pass 1: registrations and the module-level constants bound to them
        reg_names: dict[str, str] = {}          # metric name -> kind
        aliases: dict[str, dict[str, str]] = {}  # module -> const -> metric
        for sf in ctx.files:
            mod = module_name(sf.rel)
            amap: dict[str, str] = {}
            for node in ast.walk(sf.tree):
                if isinstance(node, ast.Assign):
                    m = self._registration(node.value)
                    if m is not None:
                        name, kind = m
                        reg_names[name] = kind
                        for t in node.targets:
                            if isinstance(t, ast.Name):
                                amap[t.id] = name
                elif isinstance(node, ast.Call):
                    m = self._registration(node)
                    if m is not None:
                        reg_names[m[0]] = m[1]
            aliases[mod] = amap
        # imported aliases: from X import CONST / import X as x
        imports: dict[str, dict[str, str]] = {}  # module -> local -> module
        modules = set(ctx.by_module)
        for sf in ctx.files:
            mod = module_name(sf.rel)
            imap: dict[str, str] = {}
            for node in ast.walk(sf.tree):
                if isinstance(node, ast.ImportFrom):
                    base = resolve_import_base(mod, is_package(sf.rel),
                                               node)
                    if base is None:
                        continue
                    for a in node.names:
                        # 'from . import disagg' binds the SUBMODULE —
                        # resolve to it when it exists, else the base
                        # (symbol import)
                        sub = f"{base}.{a.name}"
                        imap[a.asname or a.name] = (sub if sub in modules
                                                    else base)
                elif isinstance(node, ast.Import):
                    for a in node.names:
                        imap[a.asname or a.name.split(".")[0]] = a.name
            imports[mod] = imap
        # pass 2: usages
        label_use: dict[str, set] = {}   # metric name -> label keys seen
        removed: set = set()             # metric names with a .remove path
        use_sites: dict[str, list] = {}  # metric name -> [(rel, line)]
        for sf in ctx.files:
            mod = module_name(sf.rel)
            for node in ast.walk(sf.tree):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)):
                    continue
                method = node.func.attr
                if method not in USE_METHODS and method != "remove":
                    continue
                metric = self._resolve(node.func.value, mod, aliases,
                                       imports)
                if metric is None:
                    if method in USE_METHODS \
                            and self._looks_like_metric(node.func.value):
                        yield Finding(
                            self.name, sf.rel, node.lineno,
                            f"'{ast.get_source_segment(sf.text, node.func) or method}' "
                            f"does not resolve to a registry "
                            f"counter/gauge/histogram registration")
                    continue
                if method == "remove":
                    removed.add(metric)
                    continue
                keys = {kw.arg for kw in node.keywords if kw.arg}
                label_use.setdefault(metric, set()).update(keys)
                use_sites.setdefault(metric, []).append((sf.rel,
                                                         node.lineno))
        # pass 3: identity-labeled series need a removal path
        for metric in sorted(label_use):
            idents = label_use[metric] & IDENTITY_LABELS
            if not idents or metric in removed:
                continue
            rel, line = use_sites[metric][0]
            yield Finding(
                self.name, rel, line,
                f"metric '{metric}' is labeled by unbounded identity "
                f"({', '.join(sorted(idents))}) but no .remove() call "
                f"exists anywhere — each new identity leaks a series "
                f"forever")

    # ------------------------------------------------------------- helpers

    @staticmethod
    def _registration(node) -> Optional[tuple]:
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in REG_METHODS \
                and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            return node.args[0].value, node.func.attr
        return None

    @staticmethod
    def _looks_like_metric(recv) -> bool:
        """Only ALL_CAPS constants are held to the registration rule —
        lowercase receivers (self.ttft, histogram locals) register at
        their own assignment site."""
        if isinstance(recv, ast.Name):
            return bool(ALLCAPS_RE.match(recv.id))
        if isinstance(recv, ast.Attribute):
            return bool(ALLCAPS_RE.match(recv.attr))
        return False

    def _resolve(self, recv, mod: str, aliases: dict,
                 imports: dict) -> Optional[str]:
        """Metric name for a usage receiver: NAME in this module, or
        mod_alias.NAME through the import map."""
        if isinstance(recv, ast.Name):
            local = aliases.get(mod, {}).get(recv.id)
            if local:
                return local
            src = imports.get(mod, {}).get(recv.id)
            if src:  # from X import CONST
                return aliases.get(src, {}).get(recv.id)
            return None
        if isinstance(recv, ast.Attribute) \
                and isinstance(recv.value, ast.Name):
            src = imports.get(mod, {}).get(recv.value.id)
            if src:
                return aliases.get(src, {}).get(recv.attr)
        return None
