"""host-sync: no device->host synchronization in hot-path modules.

Each of these waits until the card has finished every queued kernel:
``.item()``, ``float(t)``/``int(t)``, ``.tolist()``, ``.cpu()``,
``.numpy()``, ``np.asarray(t)`` and ``torch.cuda.synchronize()``.  Inside
the round path they serialize the host's dispatch with the card's work,
the stall the asynchronous launch queue exists to hide.
``torch.as_tensor`` stays on its device; ``float(<literal>)`` and
``int(len(...))`` are host constants.  An AST cannot tell a tensor from a
Python number, so a conversion of a host value in a hot module carries an
``# analysis: allow(host-sync)`` comment saying so.

Documented host-side modules (``LintContext.host_side_modules``) are
skipped wholesale.
"""
from __future__ import annotations

import ast
import os

RULE = "host-sync"

_NP_ALIASES = ("np", "numpy", "onp")
# builtins whose result is a host number whatever their argument
_HOST_CALLS = ("len", "round", "abs", "min", "max", "sum", "str", "getattr")


def _is_constant(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, (ast.USub, ast.UAdd)):
        return _is_constant(node.operand)
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        return node.func.id in _HOST_CALLS
    return False


def _flag_call(node: ast.Call) -> str | None:
    fn = node.func
    if isinstance(fn, ast.Name) and fn.id in ("float", "int"):
        if node.args and not _is_constant(node.args[0]):
            return (f"{fn.id}() of a tensor waits for the device and copies to the "
                    "host; keep it a 0-d tensor (or move this to a documented "
                    "host-side module)")
        return None
    if not isinstance(fn, ast.Attribute):
        return None
    if fn.attr == "item" and not node.args and not node.keywords:
        return (".item() forces a device->host sync; keep the value on the device "
                "or fetch it once at the end of the run")
    if fn.attr in ("tolist", "cpu", "numpy") and not node.args:
        return (f".{fn.attr}() copies to the host and waits for the device; keep "
                "the value on the device or fetch it once at the end of the run")
    base = fn.value
    if fn.attr == "asarray" and isinstance(base, ast.Name) and base.id in _NP_ALIASES:
        return ("np.asarray on a tensor copies it to the host; use torch.as_tensor "
                "(stays on its device) or move this off the hot path")
    if (fn.attr == "synchronize" and isinstance(base, ast.Attribute)
            and base.attr == "cuda"):
        return ("torch.cuda.synchronize() blocks the host until the card is idle; "
                "synchronize once at the end of the run instead of per round/step")
    return None


def check_host_sync(ctx) -> list:
    findings = []
    for pkg in ctx.hot_packages:
        pkg_dir = os.path.join(ctx.src, pkg)
        if not os.path.isdir(pkg_dir):
            continue
        for dirpath, _, names in sorted(os.walk(pkg_dir)):
            for name in sorted(names):
                if not name.endswith(".py"):
                    continue
                path = os.path.join(dirpath, name)
                mod = os.path.relpath(path, ctx.src).replace(os.sep, "/")
                if mod not in ctx.host_side_modules:
                    findings.extend(_scan_file(ctx, path))
    return findings


def _scan_file(ctx, path: str) -> list:
    try:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
    except (OSError, SyntaxError):
        return []
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            msg = _flag_call(node)
            if msg:
                out.append(ctx.finding(RULE, path, node.lineno, msg))
    return out
