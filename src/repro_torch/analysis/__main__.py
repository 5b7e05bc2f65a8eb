"""``python -m repro_torch.analysis`` — the port's lint entry point.

Port of ``repro.analysis.__main__``.  Exit status 0 iff every rule passes
on the scanned files (by default the port's own: ``src/repro_torch``,
``chip_smoke.py``, ``tests/test_torch_*.py``, ``tests/_torch_*.py``).
Formats:

* ``text`` (default) — ``path:line:col: RPRxxx message`` per finding;
* ``github`` — workflow-command annotations, rendered inline on a diff;
* ``json`` — the full machine-readable report on stdout.

``--report PATH`` additionally writes the JSON report, independent of the
chosen display format.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from repro_torch.analysis.core import DEFAULT_PATTERNS, all_rules, find_repo_root, run_all


def _build_report(findings, rule_ids) -> dict:
    return {
        "tool": "repro_torch.analysis",
        "rules": [
            {"id": cls.id, "summary": cls.summary, "rationale": cls.rationale}
            for cls in all_rules()
            if rule_ids is None or cls.id in rule_ids
        ],
        "findings": [f.to_dict() for f in findings],
        "count": len(findings),
        "ok": not findings,
    }


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's invariant checker (AST lint, rules RPR001-RPR010)",
    )
    parser.add_argument(
        "paths",
        nargs="*",
        help=f"files/directories to scan (default: {' '.join(DEFAULT_PATTERNS)})",
    )
    parser.add_argument(
        "--format",
        choices=("text", "github", "json"),
        default="text",
        help="finding output format (default: text)",
    )
    parser.add_argument(
        "--report",
        type=Path,
        default=None,
        metavar="PATH",
        help="also write the JSON report to PATH",
    )
    parser.add_argument(
        "--select",
        default=None,
        metavar="IDS",
        help="comma-separated rule IDs to run (default: all)",
    )
    parser.add_argument(
        "--root",
        type=Path,
        default=None,
        help="repo root for relative paths (default: nearest pyproject.toml)",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="print the rule table and exit"
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for cls in all_rules():
            print(f"{cls.id}  {cls.summary}")
        return 0

    rule_ids = (
        tuple(s.strip().upper() for s in args.select.split(",") if s.strip())
        if args.select
        else None
    )
    root = (args.root or find_repo_root()).resolve()
    findings = run_all(args.paths or None, root=root, rule_ids=rule_ids)
    report = _build_report(findings, rule_ids)

    if args.report is not None:
        args.report.write_text(json.dumps(report, indent=2) + "\n")

    if args.format == "json":
        print(json.dumps(report, indent=2))
    else:
        for f in findings:
            print(f.format_github() if args.format == "github" else f.format_text())
        scanned = args.paths or list(DEFAULT_PATTERNS)
        status = "ok" if not findings else f"{len(findings)} finding(s)"
        print(
            f"repro_torch.analysis: {status} over {', '.join(map(str, scanned))}",
            file=sys.stderr,
        )
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
