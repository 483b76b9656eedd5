"""gather-ban: hot-path functions never gather a mesh-sharded KV pool to
host.

Opt-in via '# graftlint: hot-path' on (or directly above) the def line —
the same marker hot-path reads.  Flags the torch host copies —
``.cpu()``, ``.to("cpu")``, ``.numpy()``, ``.tolist()`` — and
``np.asarray(...)`` / ``numpy.asarray(...)`` of an expression that names a
pool (contains "pool", e.g. ``self.k_pool``, ``pool[:, pages]``): on a
tensor-parallel pool one such copy of ``leaf[:, pages]`` implies a gather
of pool-sized KV through host RAM.  The shard-native path
(sharding.snapshot_shards) copies each shard's block, which this rule
deliberately does not match.  The JAX package's rule flags
``jax.device_get``, which has no torch counterpart: a torch tensor reaches
the host only through the copies above.  Heuristic by design: per-shard
helpers name their locals ``block`` / ``shard``; anything called "pool"
inside a hot-path function is the engine's device pool.
"""

from __future__ import annotations

import ast
from typing import Iterable

from ..core import Context, Finding, Rule, SourceFile, _HOT_RE, expr_text

# tensor methods that copy their receiver to host memory
_HOST_METHODS = ("cpu", "numpy", "tolist")
# host-copy calls that gather when aimed at a pool
_ASARRAY_CALLS = ("np.asarray", "numpy.asarray")


def _names_pool(node) -> bool:
    """True when any name inside the argument expression names a pool —
    walks the whole subtree so subscripted forms (``self.k_pool[:, p]``)
    match, not just bare dotted chains."""
    for sub in ast.walk(node):
        t = expr_text(sub)
        if t and "pool" in t.lower():
            return True
    return False


def _host_copy(call: ast.Call):
    """``(receiver, method text)`` when ``call`` is a torch host copy —
    ``x.cpu()``, ``x.numpy()``, ``x.tolist()``, ``x.to("cpu")`` or
    ``x.to(device="cpu")`` — else None."""
    f = call.func
    if not isinstance(f, ast.Attribute):
        return None
    if f.attr in _HOST_METHODS:
        return f.value, f".{f.attr}()"
    if f.attr == "to":
        args = list(call.args[:1]) + [k.value for k in call.keywords
                                      if k.arg == "device"]
        if any(isinstance(a, ast.Constant) and a.value == "cpu"
               for a in args):
            return f.value, '.to("cpu")'
    return None


class GatherBanRule(Rule):
    name = "gather-ban"
    invariant = ("functions marked '# graftlint: hot-path' never copy a "
                 "mesh-sharded pool to host (.cpu(), .to(\"cpu\"), "
                 ".numpy(), .tolist(), np.asarray) — snapshot per shard "
                 "(sharding.snapshot_shards) so host copies move one "
                 "shard's bytes, not the pool's")
    history = ("every KV snapshot path (swap park, session pin, "
               "handoff export, fabric publish) gathered the full pool to "
               "host via np.asarray(leaf[:, pages]) — at TP=N that is an "
               "all-gather of N chips' KV through one host buffer; the "
               "sharded data plane moves per-shard addressable bytes only")

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
            if not isinstance(node, ast.Call):
                continue
            t = expr_text(node.func)
            copy = _host_copy(node)
            if copy is not None and _names_pool(copy[0]):
                yield Finding(
                    self.name, sf.rel, node.lineno,
                    f"hot-path function '{fn.name}' calls {copy[1]} on a "
                    f"pool — on a mesh-sharded pool this gathers every "
                    f"shard's KV through host RAM; use "
                    f"sharding.snapshot_shards to move one shard's bytes")
            elif t in _ASARRAY_CALLS and node.args \
                    and _names_pool(node.args[0]):
                yield Finding(
                    self.name, sf.rel, node.lineno,
                    f"hot-path function '{fn.name}' calls {t}() on a "
                    f"pool — on a mesh-sharded pool this gathers every "
                    f"chip's KV through host RAM; use "
                    f"sharding.snapshot_shards to move one shard's bytes")
