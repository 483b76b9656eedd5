"""graftlint — repo-native static analysis for the serving stack's
load-bearing invariants, pointed at ``kubeflow_tpu_torch/``.

Counterpart of ``kubeflow_tpu/tools/graftlint``: the same framework and
rules, with the ingress import chain's heavy leaf ``torch`` in place of
``jax`` (import-weight) and the torch host copies of a pool in place of
``jax.device_get`` (gather-ban).

Review fixes kept rediscovering the same defect classes by
hand: shared proxy state read outside ``state.lock``, inflight slots
incremented without a ``finally`` release, per-tenant dicts and metric
label series that grow without a prune path, heavy imports leaking onto
the router's POD import chain (the 0.28s -> 1.26s cold-start regression),
non-atomic durable writes, and O(n) work on paths the modules document as
O(1).  JetStream's "orchestration off the critical path" discipline and
NanoFlow's host-side-bottleneck finding (PAPERS.md) both say these
invariants are load-bearing for serving throughput — so they are enforced
here by an AST checker, not by reviewer memory.

Usage::

    python -m kubeflow_tpu_torch.tools.graftlint            # human output
    python -m kubeflow_tpu_torch.tools.graftlint --json     # machine-readable
    python -m kubeflow_tpu_torch.tools.graftlint --write-baseline

Suppression syntax (reason REQUIRED — a reasonless suppression is itself
a finding)::

    x = self._table[k]  # graftlint: disable=lock-discipline -- single-writer loop thread

A suppression comment on its own line covers the next statement; on a
``def``/``class``/``with``/``for`` header it covers the whole block.

Annotation conventions the rules consume::

    self.sessions = {}        # guarded-by: lock        (lock-discipline)
    def _eject(...):          # graftlint: holds-lock=lock
    decision = admit(...)     # graftlint: acquires=inflight
    ov.release(decision)      # graftlint: releases=inflight
    def feed(...):            # graftlint: hot-path

The tier-1 gate (tests/test_torch_graftlint.py) runs the analyzer over all
of ``kubeflow_tpu_torch/`` and requires zero unsuppressed findings.
"""

from .core import (Finding, Report, SourceFile, analyze, default_baseline_path,
                   default_root, load_baseline, write_baseline)
from .rules import ALL_RULES, rule_table

__all__ = [
    "ALL_RULES", "Finding", "Report", "SourceFile", "analyze",
    "default_baseline_path", "default_root", "load_baseline",
    "rule_table", "write_baseline",
]
