"""Committed-baseline handling: grandfather old findings, fail new ones.

Counterpart of ``repro.analysis.baseline``, in the same file format
(version 1), so a baseline either package writes is read by the other.
The baseline is a JSON list of line-number-free fingerprints
(``rule :: path :: stripped source line``), so edits elsewhere in a file
do not churn it, while touching a grandfathered line re-surfaces the
finding.  Matching is multiset-exact: each baseline entry forgives at
most one live finding, and entries with no live finding are reported as
stale (so the file shrinks as debt is paid, never silently).

Policy (DESIGN.md §10): the baseline is for benign legacy only — real
defects in ``pipeline/`` or ``core/`` get fixed, not grandfathered.
"""
from __future__ import annotations

import collections
import json
from typing import Dict, List, Sequence, Tuple

from repro_torch.analysis.findings import Finding

VERSION = 1


def load(path: str) -> List[Dict[str, str]]:
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if data.get("version") != VERSION:
        raise ValueError(f"baseline {path}: unsupported version "
                         f"{data.get('version')!r}")
    return list(data.get("findings", []))


def write(path: str, findings: Sequence[Finding]) -> None:
    entries = [{"rule": f.rule, "path": f.path, "context": f.context}
               for f in sorted(findings)]
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"version": VERSION, "findings": entries}, f, indent=2,
                  sort_keys=True)
        f.write("\n")


def _entry_fingerprint(entry: Dict[str, str]) -> str:
    return f"{entry['rule']}::{entry['path']}::{entry['context']}"


def diff(findings: Sequence[Finding], entries: Sequence[Dict[str, str]]
         ) -> Tuple[List[Finding], List[Finding], List[str]]:
    """Split live findings against the baseline.

    Returns ``(new, grandfathered, stale)`` where ``stale`` lists
    baseline fingerprints with no matching live finding.
    """
    budget = collections.Counter(_entry_fingerprint(e) for e in entries)
    new: List[Finding] = []
    grandfathered: List[Finding] = []
    for finding in sorted(findings):
        fp = finding.fingerprint()
        if budget.get(fp, 0) > 0:
            budget[fp] -= 1
            grandfathered.append(finding)
        else:
            new.append(finding)
    stale = sorted(fp for fp, n in budget.items() for _ in range(n) if n > 0)
    return new, grandfathered, stale
