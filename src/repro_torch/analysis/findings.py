"""Finding records + suppression comments shared by the audit passes
(a copy of ``repro.analysis.findings``: the same findings give the same
``Report.to_json()`` bytes in both packages).

A finding pins one violation to a (rule, file, line) triple with a
human-readable message.  Any finding can be suppressed at its source line
with a trailing marker comment::

    rc = lib.a1_lanes_resident_blocks(...)  # audit-ok: KC102 no launch

The marker names the rule it waives (one rule per marker; repeat the
marker to waive several) and should carry a short justification after the
rule id — the linter does not parse the justification, reviewers do.
Suppressions are themselves reported (``Report.suppressed``) so a waiver
can never disappear silently from the JSON artifact.
"""

from __future__ import annotations

import dataclasses
import json
import re

_SUPPRESS_RE = re.compile(r"#\s*audit-ok:\s*([A-Z]+\d+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str      # e.g. "KC105"
    path: str      # repo-relative path
    line: int      # 1-based
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def suppressed_rules(source_line: str) -> set[str]:
    """Rule ids waived by ``# audit-ok: <RULE>`` markers on this line."""
    return set(_SUPPRESS_RE.findall(source_line))


def split_suppressed(findings, source_lines_by_path):
    """Partition ``findings`` into (active, suppressed) using the marker
    comment on each finding's own source line.

    ``source_lines_by_path`` maps repo-relative path -> list of lines.
    """
    active, waived = [], []
    for f in findings:
        lines = source_lines_by_path.get(f.path)
        line = lines[f.line - 1] if lines and 0 < f.line <= len(lines) \
            else ""
        (waived if f.rule in suppressed_rules(line) else active).append(f)
    return active, waived


@dataclasses.dataclass
class Report:
    """Aggregated audit result across passes."""

    findings: list = dataclasses.field(default_factory=list)
    suppressed: list = dataclasses.field(default_factory=list)
    summary: dict = dataclasses.field(default_factory=dict)

    def extend(self, findings, suppressed=(), **summary) -> None:
        self.findings.extend(findings)
        self.suppressed.extend(suppressed)
        self.summary.update(summary)

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_json(self) -> str:
        return json.dumps({
            "ok": self.ok,
            "findings": [f.to_json() for f in self.findings],
            "suppressed": [f.to_json() for f in self.suppressed],
            "summary": self.summary,
        }, indent=2, sort_keys=True)

    def format(self) -> str:
        out = [f.format() for f in self.findings]
        out += [f"{f.format()}  [suppressed]" for f in self.suppressed]
        verdict = "AUDIT CLEAN" if self.ok else \
            f"AUDIT FAILED: {len(self.findings)} finding(s)"
        if self.suppressed:
            verdict += f" ({len(self.suppressed)} suppressed)"
        out.append(verdict)
        return "\n".join(out)
