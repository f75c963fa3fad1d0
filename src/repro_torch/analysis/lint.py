"""Layer 2: repo-specific AST/doc lint (a port of ``repro.analysis.lint``).

The engine is deliberately tiny: a rule is a function
``rule(ctx: LintContext) -> list[Finding]`` registered in
``repro_torch.analysis.rules.LINT_RULES``.  All paths come from the
``LintContext``, so planted-violation fixtures can point the same rules
at mini-trees.
"""
from __future__ import annotations

import dataclasses
import os

from repro_torch.analysis.findings import Finding, filter_suppressed

# Modules inside the hot packages that are documented host-side code
# (diagnostics, accounting and schedulers that run between rounds, never
# inside a round's K local steps).
HOST_SIDE_MODULES = (
    "core/convergence.py",    # Lemma-1/2 diagnostics: host loop over agents
    "run/evals.py",           # eval harness: deliberate device->host fetch
    "run/simclock.py",        # virtual-clock simulator: pure host event math
    "run/async_agg.py",       # async server loop: host event loop between rounds
    "privacy/accountant.py",  # closed-form RDP accountant: pure host math
    # the port's own, each for its reason:
    "core/participation.py",  # cohort schedule: numpy Threefry on host values,
                              # drawn before the round that uses it
    "run/profile.py",         # the profiler times rounds: it waits on the card
                              # around every timed window by design
    "run/virtual.py",         # the fleet's store paging: numpy rows on the host,
                              # paged through pinned buffers between rounds
)


@dataclasses.dataclass(frozen=True)
class LintContext:
    """Where the rules look.  ``root`` anchors the repo-relative paths in
    findings; ``src`` is the package directory itself."""

    root: str                 # repo root (for relative paths + suppressions)
    src: str                  # .../src/repro_torch
    docs: str                 # .../docs
    tests: str                # .../tests
    hot_packages: tuple = ("core", "run", "dist", "comm", "privacy")
    host_side_modules: tuple = HOST_SIDE_MODULES

    @classmethod
    def for_repo(cls, root: str, package: str = "repro_torch") -> "LintContext":
        return cls(root=root, src=os.path.join(root, "src", package),
                   docs=os.path.join(root, "docs"), tests=os.path.join(root, "tests"))

    def rel(self, path: str) -> str:
        return os.path.relpath(path, self.root).replace(os.sep, "/")

    def finding(self, rule: str, path: str, line: int, message: str,
                severity: str = "error") -> Finding:
        return Finding(rule=rule, file=self.rel(path), line=line, message=message,
                       severity=severity)


def repo_root_from_package() -> str:
    """<root>/src/repro_torch/analysis/lint.py -> <root>."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


def run_lint(ctx: LintContext | None = None, rules=None) -> list:
    """Run the lint rules (all by default); suppression comments applied."""
    from repro_torch.analysis.rules import LINT_RULES
    ctx = ctx or LintContext.for_repo(repo_root_from_package())
    findings = []
    for name, rule in LINT_RULES.items():
        if rules is None or name in rules:
            findings.extend(rule(ctx))
    findings.sort(key=lambda f: (f.file, f.line, f.rule))
    return filter_suppressed(findings, ctx.root)
