#!/usr/bin/env python
"""torch-rescal-lint — the port's static analysis (repro_torch.analysis).

Usage:
    python scripts/torch_rescal_lint.py [paths...]   # default src/repro_torch
    python scripts/torch_rescal_lint.py --strict src/repro_torch
    python scripts/torch_rescal_lint.py --json src/repro_torch
    python scripts/torch_rescal_lint.py --rules cuda-kernel,host-sync-hazard
    python scripts/torch_rescal_lint.py --list-rules

Exit codes: 0 clean (warnings allowed unless --strict), 1 findings,
2 usage error.  Pure stdlib — runs without torch installed.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.analysis.framework import all_rules, run_lint  # noqa: E402

DEFAULT = os.path.join("src", "repro_torch")


def main() -> int:
    ap = argparse.ArgumentParser(prog="torch-rescal-lint")
    ap.add_argument("paths", nargs="*", default=[DEFAULT],
                    help=f"files or directories to lint (default: {DEFAULT})")
    ap.add_argument("--json", action="store_true", help="JSON report")
    ap.add_argument("--strict", action="store_true",
                    help="warnings also fail the run")
    ap.add_argument("--rules", default=None,
                    help="comma-separated subset of rules to run")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args()

    if args.list_rules:
        for name, rule in sorted(all_rules().items()):
            print(f"{name:28s} {rule.description}")
        return 0

    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = set(rules) - set(all_rules())
        if unknown:
            print(f"torch-rescal-lint: unknown rule(s): {sorted(unknown)}",
                  file=sys.stderr)
            return 2

    missing = [p for p in args.paths if not os.path.exists(p)]
    if missing:
        print(f"torch-rescal-lint: no such path(s): {missing}",
              file=sys.stderr)
        return 2

    result = run_lint(args.paths, root=os.getcwd(), rules=rules)
    print(result.to_json() if args.json else result.format_human())
    failed = result.errors or (args.strict and result.warnings)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
