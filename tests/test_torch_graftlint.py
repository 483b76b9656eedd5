"""Port parity: graftlint over the port (``kubeflow_tpu_torch/tools/graftlint``).

- Every rule whose logic the port copies unchanged fires on the reference's
  violating golden fixture, passes its clean sibling, and gives exactly the
  reference linter's findings on both (rule, path, line, message,
  fingerprint).
- The two rules that changed: import-weight bans ``torch`` (the port's heavy
  leaf, as ``jax`` is the reference's) and ``numpy`` on the port's ingress
  import chain; gather-ban flags the torch host copies of a pool in a
  hot-path function (``.cpu()``, ``.to("cpu")``, ``.numpy()``,
  ``.tolist()``) and keeps ``np.asarray``.  Their fixtures are written here.
- Suppression, baseline and JSON semantics equal the reference's on the same
  fixtures; the CLI's exit codes (0 clean, 1 findings, 2 parse error or an
  unknown rule).
- The live gate: one ``analyze()`` over all of ``kubeflow_tpu_torch/`` from a
  module fixture, zero unsuppressed findings, zero parse errors, no
  reasonless suppression, the empty baseline, within ``LIVE_BUDGET_S``.
- The port router's import stays light: no ``torch``, no ``numpy``, no
  engine module, within ``ROUTER_IMPORT_BUDGET_S``."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import time

import pytest

from kubeflow_tpu.tools import graftlint as ref_lint
from kubeflow_tpu_torch.tools import graftlint as lint
from kubeflow_tpu_torch.tools.graftlint.core import default_baseline_path

pytestmark = pytest.mark.analysis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "goldens", "graftlint")
# one analyze() of the port's ~160 files took 4.2-4.6 s alone on a CPU
# test box and 7.0-20.9 s (five runs) beside six pytest workers there, as
# the tier-1 run gives it: the budget is twice the worst of those (the
# reference analyzer's 10 s budget fails under that load)
LIVE_BUDGET_S = 40.0
# the port router's subprocess import (interpreter start included) took
# ~0.3 s alone on a CPU test box; importing torch alone takes longer than
# the budget there, so the module check above and this bound agree
ROUTER_IMPORT_BUDGET_S = 1.5

UNCHANGED = {
    "lock-discipline": ("lock_discipline_bad.py", 1, "lock_discipline_ok.py"),
    "release-guarantee": ("release_guarantee_bad.py", 1, "release_guarantee_ok.py"),
    "hot-path": ("hot_path_bad.py", 4, "hot_path_ok.py"),
    "event-loop-blocking": ("event_loop_bad.py", 4, "event_loop_ok.py"),
    "bounded-growth": ("bounded_growth_bad.py", 1, "bounded_growth_ok.py"),
    "atomic-write": ("atomic_write_bad.py", 1, "atomic_write_ok.py"),
    "metric-hygiene": ("metric_hygiene_bad.py", 2, "metric_hygiene_ok.py"),
    "thread-lifecycle": ("thread_lifecycle_bad.py", 1, "thread_lifecycle_ok.py"),
}


def _rows(report, rule=None):
    return [(f.rule, f.path, f.line, f.message, f.fingerprint, f.suppressed, f.baselined)
            for f in report.findings if rule is None or f.rule == rule]


def _both(paths, **kw):
    port = lint.analyze(paths=paths, use_baseline=False, **kw)
    ref = ref_lint.analyze(paths=paths, use_baseline=False, **kw)
    return port, ref


# ------------------------------------------------------------- rule fixtures


@pytest.mark.parametrize("rule", sorted(UNCHANGED))
def test_unchanged_rule_matches_the_reference_on_its_fixtures(rule):
    bad, n, ok = UNCHANGED[rule]
    port, ref = _both([os.path.join(GOLDENS, bad)])
    assert len([f for f in port.unsuppressed if f.rule == rule]) >= n
    assert _rows(port) == _rows(ref)
    port, ref = _both([os.path.join(GOLDENS, ok)])
    assert [f for f in port.unsuppressed if f.rule == rule] == []
    assert _rows(port) == _rows(ref)


def test_rule_registry_is_the_reference_registry():
    port = {r[0] for r in lint.rule_table()}
    assert port == {r[0] for r in ref_lint.rule_table()}
    assert {c.name for c in lint.ALL_RULES} == port
    for name, invariant, history in lint.rule_table():
        assert invariant and history, f"{name} missing docs"
    with open(default_baseline_path()) as f:
        assert json.load(f) == {"version": 1, "entries": []}


GATHER_BAD = '''
import numpy as np


class Engine:
    k_pool = None
    v_pool = None

    def export_pages(self, pages):  # graftlint: hot-path
        a = self.k_pool[:, pages].cpu()
        b = self.v_pool.to("cpu")
        c = self.k_pool[:, pages].to(device="cpu").numpy()
        d = self.v_pool[0].tolist()
        e = np.asarray(self.k_pool[:, pages])
        return a, b, c, d, e
'''

GATHER_OK = '''
import numpy as np


class Engine:
    k_pool = None
    v_pool = None

    def export_pages(self, pages):  # graftlint: hot-path
        # shard-native: each block is one shard's own bytes
        blocks = [s[:, pages].cpu() for s in self.k_pool_shards]
        lens = self.lengths.tolist()
        return blocks, lens, self.v_pool.to("cuda")

    def debug_dump(self):  # cold path: no marker, host copies are fine
        return self.k_pool.cpu(), np.asarray(self.v_pool), self.v_pool.tolist()
'''


def test_gather_ban_flags_the_torch_host_copies_of_a_pool(tmp_path):
    bad = tmp_path / "engine_bad.py"
    bad.write_text(GATHER_BAD)
    found = [f for f in lint.analyze(paths=[str(bad)], use_baseline=False).unsuppressed
             if f.rule == "gather-ban"]
    methods = ('.cpu()', '.to("cpu")', '.numpy()', '.tolist()', 'np.asarray()')
    got = sorted((f.line, m) for f in found for m in methods if f"calls {m}" in f.message)
    assert got == [(10, '.cpu()'), (11, '.to("cpu")'), (12, '.numpy()'), (12, '.to("cpu")'),
                   (13, '.tolist()'), (14, 'np.asarray()')]
    ok = tmp_path / "engine_ok.py"
    ok.write_text(GATHER_OK)
    assert [f for f in lint.analyze(paths=[str(ok)], use_baseline=False).unsuppressed
            if f.rule == "gather-ban"] == []


def test_gather_ban_on_the_reference_fixtures():
    """The reference's pair: ``np.asarray`` of a pool still fires (same
    finding as the reference's); ``jax.device_get`` has no torch
    counterpart and is not a port finding; the clean sibling stays clean."""
    port, ref = _both([os.path.join(GOLDENS, "gather_ban_bad.py")])
    p = [(f.line, f.message) for f in port.unsuppressed if f.rule == "gather-ban"]
    r = [(f.line, f.message) for f in ref.unsuppressed if f.rule == "gather-ban"]
    assert len(r) == 2 and p == [x for x in r if "np.asarray" in x[1]]
    port, _ = _both([os.path.join(GOLDENS, "gather_ban_ok.py")])
    assert [f for f in port.unsuppressed if f.rule == "gather-ban"] == []


def _tree(root, files: dict) -> str:
    for rel, text in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(textwrap.dedent(text))
    return root


@pytest.mark.parametrize("heavy", ["torch", "numpy as np"])
def test_import_weight_bans_torch_and_numpy_on_the_port_ingress_chain(tmp_path, heavy):
    """A fake ``kubeflow_tpu_torch`` whose router chain pulls torch (or
    numpy) at module scope fires once, at the helper, with the witness
    chain; the lazy sibling and an engine import inside a function do
    not; a module-scope import of the engine subtree fires."""
    root = _tree(str(tmp_path / "kubeflow_tpu_torch"), {
        "__init__.py": "",
        "serving/__init__.py": "",
        "serving/router.py": "from . import helper\nfrom . import overload\n",
        "serving/helper.py": f"import {heavy}\n\n\ndef pick(xs):\n    return xs\n",
        "serving/lazy_ok.py": f"def pick(xs):\n    import {heavy}\n    return xs\n",
        "serving/overload.py": ("def admit():\n    from .engine import core\n"
                                "    return core\n"),
        "serving/engine/__init__.py": "",
        "serving/engine/core.py": "",
    })
    r = lint.analyze(root=root, use_baseline=False)
    hits = [f for f in r.unsuppressed if f.rule == "import-weight"]
    assert len(hits) == 1 and hits[0].path.endswith("helper.py")
    assert heavy.split()[0] in hits[0].message and "router" in hits[0].message
    with open(os.path.join(root, "serving", "overload.py"), "w") as f:
        f.write("from .engine import core\n")
    r = lint.analyze(root=root, use_baseline=False)
    hits = {f.path.rsplit("/", 1)[-1] for f in r.unsuppressed if f.rule == "import-weight"}
    assert hits == {"helper.py", "overload.py"}


def test_import_weight_ignores_jax_in_the_port(tmp_path):
    """The reference's heavy leaf is not the port's: a module-scope jax
    import on the port's chain is not an import-weight finding (the port
    imports no jax at all; tests/test_torch_imports.py holds that)."""
    root = _tree(str(tmp_path / "kubeflow_tpu_torch"), {
        "__init__.py": "", "serving/__init__.py": "",
        "serving/router.py": "import jax\n",
    })
    r = lint.analyze(root=root, use_baseline=False)
    assert [f for f in r.unsuppressed if f.rule == "import-weight"] == []


# ------------------------------------------------- suppressions and baseline


def test_suppression_semantics_match_the_reference():
    port, ref = _both([os.path.join(GOLDENS, "suppressed_ok.py")])
    assert port.unsuppressed == []
    sup = [f for f in port.findings if f.suppressed]
    assert len(sup) == 1 and sup[0].rule == "atomic-write"
    assert _rows(port) == _rows(ref)
    port, ref = _both([os.path.join(GOLDENS, "suppression_noreason_bad.py")])
    assert {"suppression-syntax", "atomic-write"} <= {f.rule for f in port.unsuppressed}
    assert _rows(port) == _rows(ref)


def test_baseline_semantics_match_the_reference(tmp_path):
    """Fingerprints mask the grandfathered write, not a second identical
    one added later, and survive line drift — in both linters alike."""
    src = open(os.path.join(GOLDENS, "atomic_write_bad.py")).read()
    out = {}
    bad = tmp_path / "state.py"  # one path for both: fingerprints include it
    for name, L in (("port", lint), ("ref", ref_lint)):
        bad.write_text(src)
        r1 = L.analyze(paths=[str(bad)], use_baseline=False)
        bl = tmp_path / f"{name}-baseline.json"
        L.write_baseline(str(bl), r1.unsuppressed)
        r2 = L.analyze(paths=[str(bad)], baseline_path=str(bl))
        assert r2.unsuppressed == [] and any(f.baselined for f in r2.findings)
        bad.write_text("# drift\n" + src + "\n\ndef save_more(path, state):\n"
                       "    with open(path, \"w\") as f:\n"
                       "        json.dump([state], f)\n")
        r3 = L.analyze(paths=[str(bad)], baseline_path=str(bl))
        live = [f for f in r3.unsuppressed if f.rule == "atomic-write"]
        assert len(live) == 1
        out[name] = (json.loads(bl.read_text()), _rows(r3))
    assert out["port"] == out["ref"]


def test_json_report_schema_matches_the_reference():
    port, ref = _both([os.path.join(GOLDENS, "atomic_write_bad.py")])
    p, r = port.to_dict(), ref.to_dict()
    assert p["version"] == 1 and p["files_analyzed"] == 1
    assert isinstance(p["elapsed_s"], float)
    assert p["counts"]["unsuppressed"] == len(p["findings"]) > 0
    assert set(p["findings"][0]) == {"rule", "path", "line", "message", "fingerprint",
                                     "suppressed", "baselined"}
    for d in (p, r):
        d.pop("elapsed_s")
        d.pop("root")
    assert p == r
    json.dumps(p)


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "kubeflow_tpu_torch.tools.graftlint", *args],
                          capture_output=True, text=True, cwd=REPO,
                          env={**os.environ, "PYTHONPATH": REPO}, timeout=120)


def test_cli_exit_codes(tmp_path):
    ok = _cli("--json", os.path.join(GOLDENS, "atomic_write_ok.py"))
    assert ok.returncode == 0, ok.stdout + ok.stderr
    assert json.loads(ok.stdout)["counts"]["unsuppressed"] == 0
    assert _cli(os.path.join(GOLDENS, "atomic_write_bad.py")).returncode == 1
    broken = tmp_path / "broken.py"
    broken.write_text("def f(:\n")
    res = _cli(str(broken))
    assert res.returncode == 2 and "PARSE ERROR" in res.stdout
    assert _cli("--rules", "no-such-rule").returncode == 2
    listed = _cli("--list-rules")
    assert listed.returncode == 0 and "gather-ban" in listed.stdout


# ------------------------------------------------------------ the live gate


@pytest.fixture(scope="module")
def live():
    t0 = time.perf_counter()
    report = lint.analyze()
    return report, time.perf_counter() - t0


def test_live_tree_zero_findings_under_budget(live):
    """The tier-1 gate: graftlint over all of kubeflow_tpu_torch/ — zero
    unsuppressed findings (with the empty baseline), zero parse errors."""
    report, wall = live
    assert report.root == lint.default_root()
    assert os.path.basename(report.root) == "kubeflow_tpu_torch"
    assert report.parse_errors == []
    assert report.files_analyzed > 100
    msgs = [f.render() for f in report.unsuppressed]
    assert msgs == [], "graftlint findings in the port:\n" + "\n".join(msgs)
    assert not any(f.baselined for f in report.findings)
    assert wall < LIVE_BUDGET_S, f"analyzer took {wall:.1f}s"


def test_live_tree_suppressions_all_carry_reasons(live):
    report, _ = live
    assert [f for f in report.findings if f.rule == "suppression-syntax"] == []
    # the engine's hot-path marks are back, as the reference engine has them
    engine = os.path.join(lint.default_root(), "serving", "engine", "engine.py")
    with open(engine) as f:
        marked = [ln for ln in f if "# graftlint: hot-path" in ln]
    assert len(marked) == 4


# ------------------------------------------------------ import-time budget


def _timed_router_import() -> tuple:
    code = ("import sys, json, kubeflow_tpu_torch.serving.router; print(json.dumps("
            "[m for m in ('torch', 'numpy', 'jax', 'kubeflow_tpu_torch.serving.engine') "
            "if m in sys.modules]))")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                         capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": REPO})
    return time.perf_counter() - t0, json.loads(out.stdout)


def test_router_import_time_budget():
    """The import every port pod pays at scale-from-zero loads neither
    torch nor numpy nor the engine; best of 3 under budget."""
    runs = [_timed_router_import() for _ in range(3)]
    assert all(loaded == [] for _, loaded in runs), runs
    best = min(t for t, _ in runs)
    assert best < ROUTER_IMPORT_BUDGET_S, f"import took {best:.2f}s"
