"""CLI: ``python -m repro_torch.analysis [root] [--check] [--json PATH] ...``

The port's greenlint over ``src/repro_torch`` (or ``root``).

Exit codes: 0 clean (or findings fully covered by the baseline), 1 new
findings with ``--check``, 2 usage errors. ``--update-baseline`` rewrites
the committed baseline from the current findings (the shipped baseline is
empty; keep it that way — fix violations at the source).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.analysis import engine


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="greenlint: project-invariant static analysis",
    )
    p.add_argument(
        "root", nargs="?", default=None,
        help="directory to lint (default: the repro_torch package)",
    )
    p.add_argument(
        "--check", action="store_true",
        help="exit 1 if any non-baseline finding exists (the CI gate)",
    )
    p.add_argument(
        "--json", metavar="PATH", default=None,
        help="write the full JSON report to PATH (- for stdout)",
    )
    p.add_argument(
        "--baseline", metavar="PATH", default=None,
        help="baseline file (default: the committed package baseline)",
    )
    p.add_argument(
        "--update-baseline", action="store_true",
        help="rewrite the baseline from current findings and exit 0",
    )
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    findings = engine.run_analysis(args.root)

    if args.update_baseline:
        path = engine.save_baseline(findings, args.baseline)
        print(f"[greenlint] baseline updated: {path} "
              f"({len(findings)} suppressions)")
        return 0

    baseline = engine.load_baseline(args.baseline)
    new, suppressed = engine.split_baseline(findings, baseline)

    for f in new:
        print(str(f))
    report = {
        "n_findings": len(findings),
        "n_new": len(new),
        "n_baseline_suppressed": len(suppressed),
        "findings": [f.to_dict() for f in new],
        "baseline_suppressed": [f.to_dict() for f in suppressed],
    }
    if args.json == "-":
        json.dump(report, sys.stdout, indent=2)
        print()
    elif args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2)
            fh.write("\n")
    print(
        f"[greenlint] {len(new)} finding(s), "
        f"{len(suppressed)} baseline-suppressed"
    )
    if args.check and new:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
