"""The pilint command line of the port: ``python -m repro_torch.analysis``.

Counterpart of ``repro.analysis.cli``, with its flags, exit codes and
JSON payload keys; the default path is ``src/repro_torch``.  Exit status
is the gate contract: 0 when every finding is grandfathered by the
baseline (or there are none), 1 when new findings exist, 2 on usage
errors.  ``--json`` writes the machine report (all findings plus the
new/grandfathered/stale split) for CI artifacts; the human report prints
one ``path:line:col: RULE message`` per new finding.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from repro_torch.analysis import baseline as baseline_mod
from repro_torch.analysis.rules import all_rules, lint_paths

DEFAULT_BASELINE = "pilint-baseline.json"
DEFAULT_PATHS = ["src/repro_torch"]


def _report_json(path: str, findings, new, grandfathered, stale) -> None:
    payload = {
        "tool": "pilint",
        "rules": {r.id: r.title for r in all_rules()},
        "findings": [f.to_json() for f in findings],
        "new": [f.to_json() for f in new],
        "grandfathered": len(grandfathered),
        "stale_baseline_entries": stale,
    }
    text = json.dumps(payload, indent=2, sort_keys=True) + "\n"
    if path == "-":
        sys.stdout.write(text)
    else:
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="pilint",
        description="Contract-enforcing static analysis for the PI "
                    "pipeline's PyTorch port (rules PI001-PI006, "
                    "DESIGN.md §10).")
    parser.add_argument("paths", nargs="*", default=DEFAULT_PATHS,
                        help="files or directories to lint (default: "
                             "src/repro_torch)")
    parser.add_argument("--baseline", default=DEFAULT_BASELINE,
                        help="baseline file of grandfathered findings "
                             f"(default: {DEFAULT_BASELINE}; missing file "
                             f"= empty baseline)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="ignore the baseline: every finding is new")
    parser.add_argument("--update-baseline", action="store_true",
                        help="rewrite the baseline from the current "
                             "findings and exit 0")
    parser.add_argument("--json", dest="json_out", metavar="FILE",
                        help="write the machine-readable report here "
                             "('-' for stdout)")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule registry and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in all_rules():
            print(f"{rule.id}  {rule.title}")
        return 0

    findings = lint_paths(args.paths)

    if args.update_baseline:
        baseline_mod.write(args.baseline, findings)
        print(f"pilint: baseline {args.baseline} updated with "
              f"{len(findings)} finding(s)")
        return 0

    entries = []
    if not args.no_baseline and os.path.exists(args.baseline):
        entries = baseline_mod.load(args.baseline)
    new, grandfathered, stale = baseline_mod.diff(findings, entries)

    if args.json_out:
        _report_json(args.json_out, findings, new, grandfathered, stale)

    for finding in new:
        print(finding.render())
    for fp in stale:
        print(f"pilint: stale baseline entry (fixed or moved — prune it): "
              f"{fp}")
    print(f"pilint: {len(findings)} finding(s), {len(new)} new, "
          f"{len(grandfathered)} grandfathered, {len(stale)} stale "
          f"baseline entr{'y' if len(stale) == 1 else 'ies'}")
    return 1 if new else 0
