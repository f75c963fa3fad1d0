"""kernel-ref-pair: every hand-written kernel ships its plain version, its
CUDA source and a parity test.

A kernel pair of the port is ``kernels/<name>/kernel.py`` (the wrapper
that launches the CUDA kernel on a card tensor) with a sibling ``ref.py``
(the plain PyTorch version, the ground truth a CPU tensor takes) and the
source ``csrc/<name>.cu``; a test must name both ``kernels.<name>`` and
its ``ref``, or the plain version is an oracle nobody consults.
"""
from __future__ import annotations

import glob
import os
import re

RULE = "kernel-ref-pair"


def _test_texts(tests_dir: str) -> list:
    out = []
    for path in sorted(glob.glob(os.path.join(tests_dir, "**", "*.py"), recursive=True)):
        try:
            with open(path, encoding="utf-8") as f:
                out.append(f.read())
        except OSError:
            pass
    return out


def check_kernel_ref_pairs(ctx) -> list:
    kernels_dir = os.path.join(ctx.src, "kernels")
    if not os.path.isdir(kernels_dir):
        return []
    texts = _test_texts(ctx.tests)
    findings = []
    for kpath in sorted(glob.glob(os.path.join(kernels_dir, "*", "kernel.py"))):
        kname = os.path.basename(os.path.dirname(kpath))
        if not os.path.exists(os.path.join(os.path.dirname(kpath), "ref.py")):
            findings.append(ctx.finding(
                RULE, kpath, 1,
                f"kernels/{kname}/kernel.py has no sibling ref.py: every kernel needs "
                "its plain PyTorch version for the parity tests"))
            continue
        if not os.path.exists(os.path.join(ctx.src, "csrc", f"{kname}.cu")):
            findings.append(ctx.finding(
                RULE, kpath, 1,
                f"kernels/{kname}/kernel.py has no csrc/{kname}.cu: the wrapper "
                "launches no hand-written kernel"))
        mod_re = re.compile(rf"kernels\.{re.escape(kname)}\b")
        ref_re = re.compile(r"\bref\b")
        if not any(mod_re.search(t) and ref_re.search(t) for t in texts):
            findings.append(ctx.finding(
                RULE, kpath, 1,
                f"no test references both kernels.{kname} and its ref oracle; add a "
                "parity test"))
    return findings
