"""CLI for the port's repo-specific lint pass.

    python -m repro_torch.analysis src/repro_torch tests benchmarks examples
    python -m repro_torch.analysis --list-rules
    python -m repro_torch.analysis --select RA003,RA010 src/repro_torch
    python -m repro_torch.analysis --allowlist allow.txt src/repro_torch

Port of ``src/repro/analysis/__main__.py``.  Exit status 0 when clean, 1
when any finding survives suppression, 2 on usage errors (no path, an
unknown rule code, a missing path).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis.lint import RULES, lint_paths, rule_catalog


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repo-specific AST lint pass (rules RA001-RA011)")
    ap.add_argument("paths", nargs="*", help="files or directories to lint")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--select", default=None,
                    help="comma-separated rule codes to run (default: all)")
    ap.add_argument("--allowlist", default=None,
                    help="file of 'RULE path-substring' lines to suppress")
    args = ap.parse_args(argv)

    if args.list_rules:
        print(rule_catalog())
        return 0
    if not args.paths:
        ap.print_usage(sys.stderr)
        return 2

    select = None
    if args.select:
        select = [c.strip() for c in args.select.split(",") if c.strip()]
        known = {r.code for r in RULES}
        bad = [c for c in select if c not in known]
        if bad:
            print(f"unknown rule code(s): {', '.join(bad)}", file=sys.stderr)
            return 2

    allowlist = ()
    if args.allowlist:
        allowlist = Path(args.allowlist).read_text().splitlines()

    missing = [p for p in args.paths if not Path(p).exists()]
    if missing:
        print(f"no such path(s): {', '.join(missing)}", file=sys.stderr)
        return 2

    findings = lint_paths(args.paths, select=select, allowlist=allowlist)
    for f in findings:
        print(f.format())
    if findings:
        print(f"\n{len(findings)} finding(s).", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
