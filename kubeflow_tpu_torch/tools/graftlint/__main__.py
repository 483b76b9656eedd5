"""CLI: ``python -m kubeflow_tpu_torch.tools.graftlint [paths...]``.

Exit status 0 = clean (or everything suppressed/baselined), 1 =
unsuppressed findings, 2 = a target failed to parse.
"""

from __future__ import annotations

import argparse
import json
import sys

from .core import analyze, default_baseline_path, default_root, \
    write_baseline
from .rules import ALL_RULES, rule_table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="graftlint",
        description="repo-native static analysis for serving invariants")
    ap.add_argument("paths", nargs="*",
                    help="files to analyze (default: all of kubeflow_tpu_torch/)")
    ap.add_argument("--root", default=None,
                    help="package root to discover under")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable report on stdout")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline file (default {default_baseline_path()})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline (show grandfathered findings)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write current unsuppressed findings as the new "
                         "baseline and exit 0")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule subset to run")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for name, invariant, history in rule_table():
            print(f"{name}\n  invariant: {invariant}\n  history: {history}")
        return 0

    rules = None
    if args.rules:
        wanted = {r.strip() for r in args.rules.split(",")}
        unknown = wanted - {r.name for r in ALL_RULES}
        if unknown:
            print(f"unknown rules: {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2
        rules = [cls() for cls in ALL_RULES if cls.name in wanted]

    report = analyze(
        paths=args.paths or None,
        root=args.root or default_root(),
        rules=rules,
        baseline_path=args.baseline,
        use_baseline=not (args.no_baseline or args.write_baseline))

    if args.write_baseline:
        path = args.baseline or default_baseline_path()
        write_baseline(path, report.unsuppressed)
        print(f"baseline: {len(report.unsuppressed)} entries -> {path}")
        return 0

    if args.as_json:
        json.dump(report.to_dict(), sys.stdout, indent=1)
        print()
    else:
        for f in report.unsuppressed:
            print(f.render())
        for rel, msg in report.parse_errors:
            print(f"{rel}: PARSE ERROR: {msg}")
        counts = report.to_dict()["counts"]
        print(f"graftlint: {report.files_analyzed} files, "
              f"{counts['unsuppressed']} findings "
              f"({counts['suppressed']} suppressed, "
              f"{counts['baselined']} baselined) "
              f"in {report.elapsed_s:.2f}s")
    if report.parse_errors:
        return 2
    return 1 if report.unsuppressed else 0


if __name__ == "__main__":
    sys.exit(main())
