"""The finding record shared by rules, baseline and both report formats.

Counterpart of ``repro.analysis.findings``: the same fields, fingerprint,
JSON and rendering, so either package's CLI reads the other's baseline.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One rule violation at one source location.

    ``context`` carries the stripped source line; the baseline matches on
    it (not on ``line``) so unrelated edits above a grandfathered finding
    do not churn the baseline file.
    """

    path: str       # as reported (posix, repo-relative when run from root)
    line: int       # 1-based
    col: int        # 0-based
    rule: str       # "PI001".."PI006" ("PI000" = unparseable file)
    message: str
    context: str = dataclasses.field(default="", compare=False)

    def fingerprint(self) -> str:
        """Line-number-free identity used by the baseline."""
        return f"{self.rule}::{self.path}::{self.context}"

    def to_json(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"
