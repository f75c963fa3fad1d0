"""repro_torch.analysis: the two-layer static analysis of the port (the
twin of ``repro.analysis``).

Layer 1 (``trace``/``hotpath``) audits the *built rounds*: it runs them
once under dispatch modes and watches what they do (host waits and keys
inside the K-step loop, pad reuse, donation) and what crosses the mesh
(the strategy x codec wire matrix on a fake process group).  Layer 2
(``lint``) audits the *source and docs*: host syncs in hot paths,
kernel/plain-version pairing, refusal-matrix and catalogue drift.

CLI: ``python -m repro_torch.analysis [--json] [--rules ...]``; the
committed ``baseline.json`` makes the gate "zero NEW findings".
"""
from repro_torch.analysis.findings import (Finding, baseline_path, filter_suppressed,
                                           load_baseline, new_findings, write_baseline)
from repro_torch.analysis.lint import LintContext, run_lint

__all__ = [
    "Finding", "LintContext", "baseline_path", "filter_suppressed",
    "load_baseline", "new_findings", "run_lint", "write_baseline",
]
