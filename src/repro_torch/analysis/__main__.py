"""CLI: ``python -m repro_torch.analysis`` (the twin of ``python -m
repro.analysis``).

Default run = lint + trace rules, gated against the committed
``baseline.json``: exit 0 with no new finding, 1 on any NEW finding, 2
on a malformed baseline (an entry without a reason).  The wire matrix
(``--rules wire``) runs every strategy x codec cell once on a fake
process group of 8 ranks, started in this process, and is opt-in (about
half a minute).

  python -m repro_torch.analysis                      # gate (lint + trace)
  python -m repro_torch.analysis --json               # machine-readable report
  python -m repro_torch.analysis --rules host-sync    # one rule
  python -m repro_torch.analysis --rules wire         # the strategy x codec matrix
  python -m repro_torch.analysis --update-baseline    # rewrite baseline (reviewed!)
"""
from __future__ import annotations

import argparse
import json
import os
import sys

LINT_RULE_IDS = ("host-sync", "kernel-ref-pair", "refusal-matrix",
                 "catalogue-drift")
TRACE_RULE_IDS = ("host-callback-in-scan", "raw-fold-in", "pad-reuse",
                  "donation-miss")
WIRE_RULE_IDS = ("wire-dtype",)
RULE_GROUPS = {
    "lint": LINT_RULE_IDS,
    "trace": TRACE_RULE_IDS,
    "wire": WIRE_RULE_IDS,
    "all": LINT_RULE_IDS + TRACE_RULE_IDS + WIRE_RULE_IDS,
}
DEFAULT_RULES = LINT_RULE_IDS + TRACE_RULE_IDS


def _parse_rules(spec: str) -> tuple:
    if not spec:
        return DEFAULT_RULES
    out: list = []
    known = RULE_GROUPS["all"]
    for tok in spec.replace(",", " ").split():
        if tok in RULE_GROUPS:
            out.extend(RULE_GROUPS[tok])
        elif tok in known:
            out.append(tok)
        else:
            raise SystemExit(f"unknown rule {tok!r}; known rules: "
                             f"{', '.join(known)}; groups: "
                             f"{', '.join(RULE_GROUPS)}")
    return tuple(dict.fromkeys(out))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--json", action="store_true",
                    help="print the full JSON report to stdout")
    ap.add_argument("--rules", default="",
                    help="comma/space-separated rule ids or groups "
                         "(lint, trace, wire, all); default lint+trace")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite baseline.json from this run's findings "
                         "(entries need human reasons before the gate "
                         "accepts them)")
    ap.add_argument("--baseline", default="",
                    help="alternate baseline.json path")
    ap.add_argument("--out", default="",
                    help="also write the JSON report to this path")
    ap.add_argument("--root", default="",
                    help="repo root override (fixtures/tests)")
    args = ap.parse_args(argv)

    rules = _parse_rules(args.rules)
    want_wire = any(r in WIRE_RULE_IDS for r in rules)

    from repro_torch.analysis.findings import load_baseline, new_findings, write_baseline
    from repro_torch.analysis.lint import LintContext, repo_root_from_package, run_lint

    root = os.path.abspath(args.root) if args.root else repo_root_from_package()
    findings = []

    lint_rules = [r for r in rules if r in LINT_RULE_IDS]
    if lint_rules:
        findings += run_lint(LintContext.for_repo(root), rules=lint_rules)

    trace_rules = [r for r in rules if r in TRACE_RULE_IDS]
    if trace_rules:
        from repro_torch.analysis.trace import run_trace
        findings += [f for f in run_trace(root) if f.rule in trace_rules]

    cells = []
    if want_wire:
        from repro_torch.analysis.hotpath import run_wire_matrix
        cells, wire_findings = run_wire_matrix(root)
        findings += wire_findings

    if args.update_baseline:
        path = write_baseline(findings, args.baseline or None)
        print(f"wrote {len(findings)} finding(s) to {path}; fill in the "
              "'reason' field of each entry before the gate will accept it")
        return 0

    try:
        baseline = load_baseline(args.baseline or None)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    new = new_findings(findings, baseline)

    report = {
        "root": root,
        "rules": list(rules),
        "findings": [f.to_json() for f in findings],
        "new": [f.to_json() for f in new],
        "baselined": len(findings) - len(new),
    }
    if cells:
        report["wire_cells"] = [
            {"strategy": c.strategy, "class": c.cls_name, "codec": c.codec,
             "status": c.status, "reason": c.reason,
             "agent_bytes_once": c.agent_bytes_once, "billed": c.billed}
            for c in cells]

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=1)
            f.write("\n")

    if args.json:
        print(json.dumps(report, indent=1))
    else:
        for f in findings:
            marker = "" if f.key in {n.key for n in new} else " (baselined)"
            print(f.render() + marker)
        for c in cells:
            extra = c.reason if c.status == "refused" else (
                f"agent_bytes_once={c.agent_bytes_once} billed={c.billed}")
            print(f"[wire] {c.strategy:16s} x {c.codec:5s} {c.status:8s} {extra}")
        print(f"{len(findings)} finding(s), {len(new)} new vs baseline, "
              f"rules: {', '.join(rules)}")

    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
