"""Finding model, suppression comments, and the committed baseline (a port
of ``repro.analysis.findings``).

A finding is one defect instance: (rule, file, line, message, severity).
The JSON report, the ``# analysis: allow(rule-id)`` suppression comments,
and ``baseline.json`` all key off this object.

Baseline matching deliberately EXCLUDES the line number: a baselined
false positive should not resurface because unrelated edits shifted the
file.  The key is (rule, file, message): if the message changes, the
finding is new and the gate fires.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re

SEVERITIES = ("error", "warning")

# matches both `# analysis: allow(rule-a, rule-b)` in Python and
# `<!-- analysis: allow(rule-a) -->` in markdown
_ALLOW_RE = re.compile(r"analysis:\s*allow\(([^)]*)\)")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    file: str           # repo-relative posix path ("" for synthetic targets)
    line: int           # 1-based; 0 means file-level
    message: str
    severity: str = "error"

    @property
    def key(self) -> tuple:
        """Baseline identity, line-independent on purpose."""
        return (self.rule, self.file, self.message)

    def to_json(self) -> dict:
        return {"rule": self.rule, "file": self.file, "line": self.line,
                "message": self.message, "severity": self.severity}

    @classmethod
    def from_json(cls, d: dict) -> "Finding":
        return cls(rule=d["rule"], file=d.get("file", ""), line=int(d.get("line", 0)),
                   message=d["message"], severity=d.get("severity", "error"))

    def render(self) -> str:
        loc = f"{self.file}:{self.line}" if self.file else "<synthetic>"
        return f"{loc}: [{self.rule}] {self.severity}: {self.message}"


def allowed_rules_on_line(text_line: str) -> set:
    """Rule ids named by an ``analysis: allow(...)`` marker on this line."""
    m = _ALLOW_RE.search(text_line)
    if not m:
        return set()
    return {r.strip() for r in m.group(1).split(",") if r.strip()}


def is_suppressed(finding: Finding, root: str) -> bool:
    """True when the finding's line, or the line directly above it,
    carries an ``analysis: allow(<rule>)`` marker."""
    if not finding.file or finding.line <= 0:
        return False
    try:
        with open(os.path.join(root, finding.file), encoding="utf-8") as f:
            lines = f.read().splitlines()
    except OSError:
        return False
    idx = finding.line - 1
    return any(0 <= i < len(lines) and finding.rule in allowed_rules_on_line(lines[i])
               for i in (idx, idx - 1))


def filter_suppressed(findings, root: str) -> list:
    return [f for f in findings if not is_suppressed(f, root)]


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------


def baseline_path() -> str:
    """The committed baseline that ships with the package."""
    return os.path.join(os.path.dirname(__file__), "baseline.json")


def load_baseline(path: str | None = None) -> set:
    """Set of baselined finding keys.  Every entry in the file must carry a
    ``reason``: only documented false positives may be baselined."""
    path = path or baseline_path()
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except OSError:
        return set()
    keys = set()
    for ent in data.get("findings", []):
        if not ent.get("reason"):
            raise ValueError(
                f"baseline entry without a reason: {ent}; baseline.json only "
                "admits documented false positives (fix true positives instead)")
        keys.add((ent["rule"], ent.get("file", ""), ent["message"]))
    return keys


def new_findings(findings, baseline_keys: set) -> list:
    """The gate: findings not covered by the committed baseline."""
    return [f for f in findings if f.key not in baseline_keys]


def write_baseline(findings, path: str | None = None) -> str:
    """``--update-baseline``: rewrite the baseline from the current run.
    Entries get an empty reason that ``load_baseline`` refuses until a
    human writes one: updating the baseline is a reviewed act, not a way
    to silence the gate."""
    path = path or baseline_path()
    data = {
        "comment": "Documented false positives only; every entry needs a "
                   "human-written reason.",
        "findings": [{**f.to_json(), "reason": ""} for f in findings],
    }
    for ent in data["findings"]:
        ent.pop("line", None)  # line-independent matching
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=1)
        f.write("\n")
    return path
