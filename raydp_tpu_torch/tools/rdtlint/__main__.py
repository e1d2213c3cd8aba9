"""CLI: ``python -m raydp_tpu_torch.tools.rdtlint [paths...]``.

Pure AST pass — no runtime spin-up; safe to run anywhere the sources parse.
Exit codes: 0 = clean (suppressed-only), 1 = unsuppressed violations,
2 = usage/parse failure. ``--json`` emits a machine-readable report;
``--write-rpc-docs`` regenerates the RPC-surface table in
raydp_tpu_torch/doc/dev_lint.md.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from raydp_tpu_torch.tools.rdtlint import RULES, run


def _default_paths() -> list:
    here = os.path.dirname(os.path.abspath(__file__))
    return [os.path.dirname(os.path.dirname(here))]  # the package dir


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raydp_tpu_torch.tools.rdtlint",
        description="project-native static analysis of the port "
                    "(raydp_tpu_torch/doc/dev_lint.md)")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/directories to lint (default: the "
                         "raydp_tpu_torch package next to this tool)")
    ap.add_argument("--rule", action="append", choices=RULES, default=None,
                    help="run only this rule (repeatable)")
    ap.add_argument("--root", default=None,
                    help="repo root for cross-checks (default: nearest "
                         "pyproject.toml above the first path)")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also print suppressed violations")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output: {files_linted, "
                         "violations: [{file, line, rule, message, "
                         "suppressed, reason}]}")
    ap.add_argument("--write-rpc-docs", action="store_true",
                    help="regenerate the RPC-surface table in "
                         "raydp_tpu_torch/doc/dev_lint.md from the linted "
                         "sources")
    args = ap.parse_args(argv)

    paths = args.paths or _default_paths()
    if args.write_rpc_docs:
        from raydp_tpu_torch.tools.rdtlint import surfaces
        from raydp_tpu_torch.tools.rdtlint.core import Project

        try:
            project = Project.load(paths, root=args.root)
            changed = surfaces.write_doc_table(project)
        except (FileNotFoundError, ValueError) as e:
            print(f"rdtlint: {e}", file=sys.stderr)
            return 2
        for rel in changed:
            print(f"rewrote {rel}")
        if not changed:
            print("rpc-surface table already fresh")
        return 0

    try:
        report = run(paths, root=args.root, rules=args.rule)
    except FileNotFoundError as e:
        print(f"rdtlint: {e}", file=sys.stderr)
        return 2
    if report.files_linted == 0:
        # an empty run is a misconfiguration, never a clean tree
        print(f"rdtlint: no Python files under {' '.join(paths)}",
              file=sys.stderr)
        return 2
    if args.json:
        shown = report.violations if args.show_suppressed \
            else report.unsuppressed
        print(json.dumps({
            "files_linted": report.files_linted,
            "violations": [
                {"file": v.path, "line": v.line, "rule": v.rule,
                 "message": v.message, "suppressed": v.suppressed,
                 "reason": v.reason}
                for v in shown],
            "suppressed": len(report.suppressed),
        }, indent=2))
    else:
        print(report.render(show_suppressed=args.show_suppressed))
    return 1 if report.unsuppressed else 0


if __name__ == "__main__":
    raise SystemExit(main())
