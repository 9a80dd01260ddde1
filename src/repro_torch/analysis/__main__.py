"""``python -m repro_torch.analysis``: the port's contract gate.

Runs every registered checker (or ``--checks a,b``) over the port's sources,
tests and card check, prints a summary (each checker's findings and facts;
``-q``: the totals and the active findings only), writes the
``repro_torch.analysis/v1`` report with ``--json PATH``, and exits 1 when
any finding is active.  There is no baseline: the port's gate starts clean.
Run it from the repo root with ``PYTHONPATH=src``, or name the root with
``--root``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis.core import run_analysis


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="The port's contract gate.")
    parser.add_argument("--root", type=Path, default=Path.cwd(), help="the repo root")
    parser.add_argument("--checks", default=None, help="comma-separated check ids (default: all)")
    parser.add_argument("--json", type=Path, default=None, help="write the report here")
    parser.add_argument("-q", "--quiet", action="store_true", help="totals and findings only")
    args = parser.parse_args(argv)
    checks = [c.strip() for c in args.checks.split(",") if c.strip()] if args.checks else None
    report = run_analysis(args.root, checks=checks)
    if args.json is not None:
        args.json.write_text(report.to_json() + "\n")
    if not args.quiet:
        for row in report.checkers:
            print(f"{row['id']}: {row['findings']} finding(s), {row['suppressed']} suppressed")
            facts = report.facts.get(row["id"])
            if facts:
                print(f"  facts: {json.dumps(facts, sort_keys=True, default=str)}")
    for f in report.active:
        print(f"{f.location}: [{f.check_id}] {f.message}")
    print(f"{report.files_scanned} files, {len(report.active)} active finding(s), "
          f"{len(report.suppressed)} suppressed")
    return 1 if report.active else 0


if __name__ == "__main__":
    sys.exit(main())
