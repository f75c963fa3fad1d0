"""Lint-rule registry.  A rule is ``fn(ctx: LintContext) -> list[Finding]``;
its dict key is the rule id used in findings, suppression comments, and
``--rules`` selection."""
from repro_torch.analysis.rules.consistency import check_catalogue_drift, check_refusal_matrix
from repro_torch.analysis.rules.hostsync import check_host_sync
from repro_torch.analysis.rules.kernels import check_kernel_ref_pairs

LINT_RULES = {
    "host-sync": check_host_sync,
    "kernel-ref-pair": check_kernel_ref_pairs,
    "refusal-matrix": check_refusal_matrix,
    "catalogue-drift": check_catalogue_drift,
}
