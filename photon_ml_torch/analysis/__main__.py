"""photon-lint CLI: ``python -m photon_ml_torch.analysis``.

Runs the AST checker suite over the ``photon_ml_torch`` package (and
the recorded-duration test audit) and exits 0 (clean) / 1
(violations), printing one ``path:line rule-id message`` line per
violation, with the path relative to the repo, and a final
machine-readable JSON line either way.

``--format github`` emits GitHub Actions ``::error`` annotations
instead of the plain lines (the JSON tail line is unchanged), so a CI
step can surface violations inline on the PR diff.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from photon_ml_torch.analysis.checkers import NOT_PORTED, RULES, run_checks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m photon_ml_torch.analysis",
        description=__doc__.split("\n")[0])
    p.add_argument("paths", nargs="*",
                   help="specific files to check (default: the whole "
                        "photon_ml_torch package + the slow-test audit)")
    p.add_argument("--root", default=None,
                   help="repo root (default: the package's parent)")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule ids to run "
                        f"({'|'.join(RULES)}); default all")
    p.add_argument("--format", choices=("text", "github"),
                   default="text")
    p.add_argument("--list-rules", action="store_true")
    args = p.parse_args(argv)

    if args.list_rules:
        for rule, desc in RULES.items():
            print(f"{rule}: {desc}")
        print(json.dumps({"rules": sorted(RULES)}))
        return 0

    root = args.root or os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    rules = (set(r for r in args.rules.split(",") if r)
             if args.rules else None)
    if rules:
        unknown = rules - set(RULES)
        if unknown:
            why = "; ".join(f"{r} is not ported: {NOT_PORTED[r]}"
                            for r in sorted(unknown & set(NOT_PORTED)))
            p.error(f"unknown rules {sorted(unknown)}; "
                    f"pick from {sorted(RULES)}"
                    + (f" ({why})" if why else ""))
    files = [os.path.abspath(f) for f in args.paths] or None

    violations, n_files = run_checks(root, rules=rules, files=files)
    for v in violations:
        # Repo-relative paths: GitHub ::error annotations only attach
        # to the PR diff with workspace-relative `file=` values, and
        # the text form reads better too.
        shown = dataclasses.replace(
            v, path=os.path.relpath(v.path, root))
        print(shown.github() if args.format == "github" else str(shown))

    per_rule: dict[str, int] = {}
    for v in violations:
        per_rule[v.rule] = per_rule.get(v.rule, 0) + 1
    print(json.dumps({
        "ok": not violations,
        "violations": len(violations),
        "files_checked": n_files,
        "rules_run": sorted(rules) if rules else sorted(RULES),
        "by_rule": per_rule,
    }))
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
