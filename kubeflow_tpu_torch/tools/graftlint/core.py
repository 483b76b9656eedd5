"""Analyzer framework: parsed sources, suppressions, baseline, driver.

The framework is deliberately small: each rule sees a ``SourceFile``
(AST + per-line comments + directive index) per file and a shared
``Context`` for cross-module facts (the import graph, the metric
registry).  Findings carry a content fingerprint — rule + path +
normalized source line + occurrence index — so the committed baseline
survives line drift without grandfathering NEW instances of an old bug.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import io
import json
import os
import re
import time
import tokenize
from typing import Iterable, Optional

# ---------------------------------------------------------------- directives

_DISABLE_RE = re.compile(
    r"#\s*graftlint:\s*disable=([\w,\-]+)(?:\s*--\s*(\S.*))?")
_GUARDED_RE = re.compile(r"#\s*guarded-by:\s*([\w]+)")
_HOLDS_RE = re.compile(r"#\s*graftlint:\s*holds-lock=([\w]+)")
_HOT_RE = re.compile(r"#\s*graftlint:\s*hot-path\b")
_EVLOOP_RE = re.compile(r"#\s*graftlint:\s*event-loop\b")
_ACQ_RE = re.compile(r"#\s*graftlint:\s*acquires=([\w\-]+)")
_REL_RE = re.compile(r"#\s*graftlint:\s*releases=([\w\-]+)")

# block statements a standalone/header suppression extends over
_BLOCK_STMTS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                ast.With, ast.AsyncWith, ast.For, ast.AsyncFor, ast.While,
                ast.If, ast.Try)


@dataclasses.dataclass
class Finding:
    rule: str
    path: str          # repo-relative, e.g. kubeflow_tpu_torch/serving/router.py
    line: int
    message: str
    suppressed: bool = False
    baselined: bool = False
    fingerprint: str = ""

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message, "fingerprint": self.fingerprint,
                "suppressed": self.suppressed, "baselined": self.baselined}

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def expr_text(node) -> Optional[str]:
    """Dotted-name text of a Name/Attribute chain (None for anything
    else) — the receiver-matching currency of the lock rules."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = expr_text(node.value)
        return None if base is None else f"{base}.{node.attr}"
    return None


class SourceFile:
    """One parsed module: AST, parent links, comments and directives."""

    def __init__(self, path: str, rel: str, text: str):
        self.path = path
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)
        self.parents: dict[int, ast.AST] = {}
        self._stmt_at: dict[int, ast.stmt] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[id(child)] = node
            if isinstance(node, ast.stmt):
                prev = self._stmt_at.get(node.lineno)
                # outermost statement starting on a line wins (its extent
                # is what a header suppression should cover)
                if prev is None or ((node.end_lineno or node.lineno)
                                    > (prev.end_lineno or prev.lineno)):
                    self._stmt_at[node.lineno] = node
        self.comments: dict[int, str] = {}
        self.code_lines: set[int] = set()
        try:
            for tok in tokenize.generate_tokens(io.StringIO(text).readline):
                if tok.type == tokenize.COMMENT:
                    self.comments[tok.start[0]] = tok.string
                elif tok.type not in (tokenize.NL, tokenize.NEWLINE,
                                      tokenize.INDENT, tokenize.DEDENT,
                                      tokenize.ENCODING, tokenize.ENDMARKER):
                    for ln in range(tok.start[0], tok.end[0] + 1):
                        self.code_lines.add(ln)
        except tokenize.TokenError:  # pragma: no cover - ast.parse passed
            pass
        # suppression ranges: (lo, hi, {rules}) — built after comments
        self.suppressions: list[tuple[int, int, set]] = []
        self.bad_suppressions: list[int] = []  # lines missing a reason
        self._build_suppressions()

    # ------------------------------------------------------------ comments

    def comment(self, line: int) -> str:
        return self.comments.get(line, "")

    def directive_near(self, line: int, regex: re.Pattern) -> Optional[str]:
        """Match a directive on ``line`` or on a standalone comment line
        directly above it; returns the first capture group (or the match
        text for group-less patterns)."""
        for ln in (line, line - 1):
            c = self.comments.get(ln)
            if not c:
                continue
            if ln != line and ln in self.code_lines:
                continue  # the line above holds code — its comment is its own
            m = regex.search(c)
            if m:
                return m.group(1) if m.groups() else m.group(0)
        return None

    # --------------------------------------------------------- suppressions

    def _build_suppressions(self) -> None:
        for ln, c in self.comments.items():
            m = _DISABLE_RE.search(c)
            if not m:
                continue
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            reason = (m.group(2) or "").strip()
            if not reason:
                self.bad_suppressions.append(ln)
                continue
            target = ln
            if ln not in self.code_lines:  # standalone: covers next stmt
                target = ln + 1
                while (target <= len(self.lines)
                       and target not in self.code_lines):
                    target += 1
            stmt = self._stmt_at.get(target)
            hi = target
            if stmt is not None and isinstance(stmt, _BLOCK_STMTS):
                hi = stmt.end_lineno or target
            self.suppressions.append((min(ln, target), hi, rules))

    def suppressed(self, rule: str, line: int) -> bool:
        for lo, hi, rules in self.suppressions:
            if lo <= line <= hi and (rule in rules or "all" in rules):
                return True
        return False

    # -------------------------------------------------------------- queries

    def parent(self, node) -> Optional[ast.AST]:
        return self.parents.get(id(node))

    def ancestors(self, node) -> Iterable[ast.AST]:
        cur = self.parents.get(id(node))
        while cur is not None:
            yield cur
            cur = self.parents.get(id(cur))

    def enclosing_function(self, node):
        for a in self.ancestors(node):
            if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return a
        return None

    def enclosing_class(self, node):
        for a in self.ancestors(node):
            if isinstance(a, ast.ClassDef):
                return a
        return None

class Context:
    """Shared cross-module state handed to every rule."""

    def __init__(self, root: str, package_root: str,
                 files: list[SourceFile]):
        self.root = root
        self.package_root = package_root
        self.files = files
        self.by_rel = {f.rel: f for f in files}
        self.by_module = {module_name(f.rel): f for f in files}
        self.shared: dict[str, object] = {}  # per-rule scratch


def module_name(rel: str) -> str:
    """kubeflow_tpu_torch/serving/router.py -> kubeflow_tpu_torch.serving.router."""
    parts = rel.replace(os.sep, "/").split("/")
    if parts[-1] == "__init__.py":
        parts = parts[:-1]
    else:
        parts[-1] = parts[-1][:-3]
    return ".".join(parts)


def is_package(rel: str) -> bool:
    return rel.replace(os.sep, "/").endswith("/__init__.py")


def resolve_import_base(mod: str, is_pkg: bool, node) -> Optional[str]:
    """Absolute dotted base of a (possibly relative) ImportFrom, given the
    importing module's dotted name.  A PACKAGE (__init__) is its own
    level-1 anchor — ``from . import x`` inside kubeflow_tpu_torch/serving/
    __init__.py means kubeflow_tpu_torch.serving.x, so packages strip one
    level fewer than plain modules."""
    if node.level == 0:
        return node.module
    strip = node.level - 1 if is_pkg else node.level
    parts = mod.split(".")
    base = parts[:len(parts) - strip] if strip <= len(parts) else []
    if node.module:
        base = base + node.module.split(".")
    return ".".join(base) if base else None


class Rule:
    """Base rule: per-file ``check`` plus cross-module ``finalize``."""

    name = "abstract"
    invariant = ""
    history = ""  # the historical bug this rule encodes

    def check(self, sf: SourceFile, ctx: Context) -> Iterable[Finding]:
        return ()

    def finalize(self, ctx: Context) -> Iterable[Finding]:
        return ()


# ------------------------------------------------------------------ baseline

def default_root() -> str:
    """The kubeflow_tpu_torch package directory (three levels up)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.json")


def load_baseline(path: str) -> set:
    if not path or not os.path.exists(path):
        return set()
    with open(path) as f:
        data = json.load(f)
    return {e["fingerprint"] for e in data.get("entries", ())}


def write_baseline(path: str, findings: list) -> None:
    entries = [{"rule": f.rule, "path": f.path, "line": f.line,
                "fingerprint": f.fingerprint, "message": f.message}
               for f in findings]
    entries.sort(key=lambda e: (e["path"], e["line"], e["rule"]))
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"version": 1, "entries": entries}, f, indent=1,
                  sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


# -------------------------------------------------------------------- driver

@dataclasses.dataclass
class Report:
    root: str
    files_analyzed: int
    elapsed_s: float
    findings: list          # every finding, flags set
    parse_errors: list      # (rel, message)

    @property
    def unsuppressed(self) -> list:
        return [f for f in self.findings
                if not f.suppressed and not f.baselined]

    def counts(self) -> dict:
        by_rule: dict[str, int] = {}
        for f in self.unsuppressed:
            by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
        return by_rule

    def to_dict(self) -> dict:
        return {
            "version": 1,
            "root": self.root,
            "files_analyzed": self.files_analyzed,
            "elapsed_s": round(self.elapsed_s, 4),
            "findings": [f.to_dict() for f in self.unsuppressed],
            "counts": {
                "unsuppressed": len(self.unsuppressed),
                "suppressed": sum(1 for f in self.findings if f.suppressed),
                "baselined": sum(1 for f in self.findings if f.baselined),
                "by_rule": self.counts(),
            },
            "parse_errors": [{"path": p, "message": m}
                             for p, m in self.parse_errors],
        }


def discover(root: str) -> list:
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", ".git"))
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                out.append(os.path.join(dirpath, fn))
    return out


def analyze(paths: Optional[list] = None, root: Optional[str] = None,
            rules: Optional[list] = None,
            baseline_path: Optional[str] = None,
            use_baseline: bool = True) -> Report:
    """Run the rule set; ``paths`` overrides discovery (fixture tests)."""
    from .rules import ALL_RULES  # late: rules import core
    t0 = time.perf_counter()
    root = root or default_root()
    package_root = os.path.dirname(root)
    targets = paths if paths is not None else discover(root)
    files: list[SourceFile] = []
    parse_errors: list[tuple[str, str]] = []
    for p in targets:
        p = os.path.abspath(p)
        rel = os.path.relpath(p, package_root)
        try:
            with open(p, encoding="utf-8") as f:
                text = f.read()
            files.append(SourceFile(p, rel, text))
        except (SyntaxError, ValueError, OSError) as e:
            parse_errors.append((rel, str(e)))
    ctx = Context(root, package_root, files)
    active = rules if rules is not None else [cls() for cls in ALL_RULES]
    findings: list[Finding] = []
    for rule in active:
        for sf in files:
            findings.extend(rule.check(sf, ctx))
        findings.extend(rule.finalize(ctx))
    # reasonless suppressions are findings themselves (never suppressible)
    for sf in files:
        for ln in sf.bad_suppressions:
            findings.append(Finding(
                "suppression-syntax", sf.rel, ln,
                "graftlint suppression without a reason: use "
                "'# graftlint: disable=<rule> -- <why this is safe>'"))
    # mark suppressions, assign fingerprints, apply baseline
    seq: dict[tuple, int] = {}
    baseline = (load_baseline(baseline_path or default_baseline_path())
                if use_baseline else set())
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    for f in findings:
        sf = ctx.by_rel.get(f.path)
        src = (sf.lines[f.line - 1].strip()
               if sf and 0 < f.line <= len(sf.lines) else "")
        key = (f.rule, f.path, src)
        k = seq.get(key, 0)
        seq[key] = k + 1
        f.fingerprint = hashlib.sha1(
            f"{f.rule}|{f.path}|{src}|{k}".encode()).hexdigest()[:16]
        if sf is not None and f.rule != "suppression-syntax" \
                and sf.suppressed(f.rule, f.line):
            f.suppressed = True
        elif f.fingerprint in baseline:
            f.baselined = True
    return Report(root=root, files_analyzed=len(files),
                  elapsed_s=time.perf_counter() - t0,
                  findings=findings, parse_errors=parse_errors)
