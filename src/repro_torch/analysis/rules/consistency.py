"""Cross-artifact consistency: refusal-matrix and registry<->docs drift (a
port of ``repro.analysis.rules.consistency``, run on ``src/repro_torch``
against the same ``docs/``).

The strategy x codec x privacy design space refuses incoherent
combinations with loud ``ValueError``s (docs/privacy.md's refusal
matrix).  Both artifacts, the docs tables and the ``validate()`` guards,
are hand-maintained, so these rules check them against each other in
both directions:

* ``refusal-matrix``: every mutually-exclusive knob *pair* named in a
  docs table row (a first cell containing " + ") must have a matching
  ``raise ValueError`` guard in strategies.py/collectives.py, and every
  guarded pair in the code must have a docs row.
* ``catalogue-drift``: every class registered in ``STRATEGIES`` has a row
  in the strategy catalogue table (and vice versa: no rows for ghost
  strategies); same for ``CODECS`` and the codec catalogue.

Everything is AST/text level: the rules never import the modules they
check, so planted-violation fixtures can feed them mini-trees.
"""
from __future__ import annotations

import ast
import os
import re

REFUSAL_RULE = "refusal-matrix"
CATALOGUE_RULE = "catalogue-drift"

# canonical knob tokens; pairs of these are the refusal-matrix vocabulary
_CODE_IDENT_TOKENS = {
    "codec": "codec",
    "sync_dtype": "sync_dtype",
    "secure_agg": "secure_agg",
    "reduce": "robust",
}
_CONTEXT_TOKENS = {
    "SubsampledFedAvg": "subsampled",
    "TrimmedMeanSync": "robust",
    "CoordinateMedianSync": "robust",
    "masked_sync": "secure_agg",
}
_TEXT_TOKENS = (
    ("sync_dtype", "sync_dtype"),
    ("codec", "codec"),
    ("secure", "secure_agg"),
    ("subsampl", "subsampled"),
    ("robust", "robust"),
    # matches "async" and "asynchronous" : the async-buffer refusal rows
    # (docs/scaling.md) vs the check_async_mergeable guards
    ("async", "async"),
)


def _text_tokens(text: str) -> set:
    low = text.lower()
    return {tok for sub, tok in _TEXT_TOKENS if sub in low}


# ---------------------------------------------------------------------------
# Markdown table parsing (shared)
# ---------------------------------------------------------------------------


def _cells(line: str) -> list:
    return [c.strip() for c in line.strip().strip("|").split("|")]


def _tables(lines):
    """Yield (header_lineno_1based, header_cells, rows) where rows is a
    list of (lineno_1based, cells) for each body row."""
    i = 0
    while i < len(lines):
        if lines[i].lstrip().startswith("|"):
            start = i
            while i < len(lines) and lines[i].lstrip().startswith("|"):
                i += 1
            block = lines[start:i]
            if len(block) >= 2 and set(block[1].replace("|", "").strip()) <= set("- :"):
                rows = [(start + 1 + j, _cells(block[j]))
                        for j in range(2, len(block))]
                yield start + 1, _cells(block[0]), rows
        else:
            i += 1


def _doc_files(ctx) -> list:
    if not os.path.isdir(ctx.docs):
        return []
    return sorted(os.path.join(ctx.docs, n) for n in os.listdir(ctx.docs)
                  if n.endswith(".md"))


def _read_lines(path: str) -> list:
    try:
        with open(path, encoding="utf-8") as f:
            return f.read().splitlines()
    except OSError:
        return []


# ---------------------------------------------------------------------------
# refusal-matrix
# ---------------------------------------------------------------------------

_REFUSAL_CODE_FILES = ("core/strategies.py", "dist/collectives.py")


def _doc_refusal_pairs(ctx):
    """{frozenset(pair) -> (file, line)} from docs table rows whose first
    cell names a combination ('a + b')."""
    pairs = {}
    for path in _doc_files(ctx):
        for _, _, rows in _tables(_read_lines(path)):
            for lineno, cells in rows:
                if not cells or " + " not in cells[0]:
                    continue
                toks = _text_tokens(cells[0])
                if len(toks) >= 2:
                    pairs.setdefault(frozenset(toks), (path, lineno))
    return pairs


def _resolve_raise_text(node: ast.Raise, const_strs: dict) -> str:
    """All string content reachable from the raised exception's args."""
    parts = []
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            parts.append(sub.value)
        elif isinstance(sub, ast.Name) and sub.id in const_strs:
            parts.append(const_strs[sub.id])
    return " ".join(parts)


def _code_refusal_pairs(ctx):
    """{frozenset(pair) -> (file, line)} from ``raise ValueError`` guards.

    Tokens for one raise come from (a) identifiers in every enclosing
    ``if`` test, (b) the enclosing function/class names, (c) the message
    text (module string constants resolved)."""
    pairs = {}
    for rel in _REFUSAL_CODE_FILES:
        path = os.path.join(ctx.src, rel)
        try:
            with open(path, encoding="utf-8") as f:
                tree = ast.parse(f.read(), filename=path)
        except (OSError, SyntaxError):
            continue
        const_strs = {t.targets[0].id: t.value.value
                      for t in tree.body
                      if isinstance(t, ast.Assign) and len(t.targets) == 1
                      and isinstance(t.targets[0], ast.Name)
                      and isinstance(t.value, ast.Constant)
                      and isinstance(t.value.value, str)}
        parents: dict = {}
        for parent in ast.walk(tree):
            for child in ast.iter_child_nodes(parent):
                parents[child] = parent
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Raise) and node.exc is not None):
                continue
            exc = node.exc
            name = (exc.func.id if isinstance(exc, ast.Call)
                    and isinstance(exc.func, ast.Name) else "")
            if name != "ValueError":
                continue
            toks = _text_tokens(_resolve_raise_text(node, const_strs))
            anc = node
            while anc in parents:
                anc = parents[anc]
                if isinstance(anc, ast.If):
                    for sub in ast.walk(anc.test):
                        if isinstance(sub, ast.Name):
                            toks |= ({_CODE_IDENT_TOKENS[sub.id]}
                                     if sub.id in _CODE_IDENT_TOKENS else set())
                        elif isinstance(sub, ast.Attribute):
                            toks |= ({_CODE_IDENT_TOKENS[sub.attr]}
                                     if sub.attr in _CODE_IDENT_TOKENS else set())
                elif isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.ClassDef)):
                    if anc.name in _CONTEXT_TOKENS:
                        toks.add(_CONTEXT_TOKENS[anc.name])
            if len(toks) >= 2:
                for pair in _all_pairs(toks):
                    pairs.setdefault(pair, (path, node.lineno))
    return pairs


def _all_pairs(tokens: set):
    toks = sorted(tokens)
    return [frozenset((a, b)) for i, a in enumerate(toks) for b in toks[i + 1:]]


def _pair_name(pair: frozenset) -> str:
    return " + ".join(sorted(pair))


def check_refusal_matrix(ctx) -> list:
    doc_pairs = _doc_refusal_pairs(ctx)
    code_pairs = _code_refusal_pairs(ctx)
    findings = []
    for pair, (path, lineno) in sorted(doc_pairs.items(),
                                       key=lambda kv: _pair_name(kv[0])):
        if pair not in code_pairs:
            findings.append(ctx.finding(
                REFUSAL_RULE, path, lineno,
                f"docs declare the refusal '{_pair_name(pair)}' but no "
                "matching ValueError guard exists in "
                "strategies.py/collectives.py : the incoherent combination "
                "would be accepted silently"))
    for pair, (path, lineno) in sorted(code_pairs.items(),
                                       key=lambda kv: _pair_name(kv[0])):
        if pair not in doc_pairs:
            findings.append(ctx.finding(
                REFUSAL_RULE, path, lineno,
                f"code refuses the combination '{_pair_name(pair)}' but no "
                "docs refusal-matrix row documents it : add the row (see "
                "docs/privacy.md)"))
    return findings


# ---------------------------------------------------------------------------
# catalogue-drift
# ---------------------------------------------------------------------------

_BACKTICK_CALL_RE = re.compile(r"`([A-Za-z_][A-Za-z0-9_]*)\(")
_BACKTICK_NAME_RE = re.compile(r"`([a-z0-9_+]+)`")


def _registry_literal(path: str, dict_name: str):
    """Parse ``NAME = {"key": Value, ...}`` -> {key: value-class-name-or-None}
    without importing the module (fixture-friendly, import-cycle-free)."""
    try:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
    except (OSError, SyntaxError):
        return None
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == dict_name
                and isinstance(node.value, ast.Dict)):
            out = {}
            for k, v in zip(node.value.keys, node.value.values):
                if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
                    continue
                cls = None
                if isinstance(v, ast.Name):
                    cls = v.id
                elif isinstance(v, ast.Lambda):
                    for sub in ast.walk(v.body):
                        if isinstance(sub, ast.Name):
                            cls = sub.id
                            break
                out[k.value] = cls
            return out
    return None


def _catalogue_tables(ctx, kind: str):
    """All docs tables whose header first cell is ``kind``."""
    out = []
    for path in _doc_files(ctx):
        for header_line, header, rows in _tables(_read_lines(path)):
            if header and header[0].strip("`* ").lower() == kind:
                out.append((path, header_line, rows))
    return out


def check_catalogue_drift(ctx) -> list:
    findings = []
    findings += _check_strategy_catalogue(ctx)
    findings += _check_codec_catalogue(ctx)
    return findings


def _check_strategy_catalogue(ctx) -> list:
    reg_path = os.path.join(ctx.src, "core", "strategies.py")
    registry = _registry_literal(reg_path, "STRATEGIES")
    if registry is None:
        return []
    reg_classes = {c for c in registry.values() if c}
    tables = _catalogue_tables(ctx, "strategy")
    anchor = (os.path.join(ctx.docs, "strategies.md"), 0)
    findings = []
    doc_classes = set()
    for path, header_line, rows in tables:
        anchor = (path, header_line)
        for lineno, cells in rows:
            if not cells:
                continue
            for cls in _BACKTICK_CALL_RE.findall(cells[0]):
                doc_classes.add(cls)
                if cls not in reg_classes:
                    findings.append(ctx.finding(
                        CATALOGUE_RULE, path, lineno,
                        f"catalogue row for `{cls}(...)` has no matching "
                        "entry in strategies.STRATEGIES : stale row (or an "
                        "unregistered strategy)"))
    for cls in sorted(reg_classes - doc_classes):
        names = sorted(n for n, c in registry.items() if c == cls)
        findings.append(ctx.finding(
            CATALOGUE_RULE, anchor[0], anchor[1],
            f"registered strategy `{cls}` ({'/'.join(names)}) has no row "
            "in the docs strategy catalogue table"))
    return findings


def _check_codec_catalogue(ctx) -> list:
    reg_path = os.path.join(ctx.src, "comm", "codecs.py")
    registry = _registry_literal(reg_path, "CODECS")
    if registry is None:
        return []
    tables = _catalogue_tables(ctx, "codec")
    anchor = (os.path.join(ctx.docs, "communication.md"), 0)
    findings = []
    doc_names = set()
    for path, header_line, rows in tables:
        anchor = (path, header_line)
        for lineno, cells in rows:
            if not cells:
                continue
            m = _BACKTICK_NAME_RE.search(cells[0])
            if not m:
                continue
            name = m.group(1)
            doc_names.add(name)
            if name not in registry:
                findings.append(ctx.finding(
                    CATALOGUE_RULE, path, lineno,
                    f"codec catalogue row for `{name}` has no matching "
                    "entry in codecs.CODECS : stale row"))
    for name in sorted(set(registry) - doc_names):
        findings.append(ctx.finding(
            CATALOGUE_RULE, anchor[0], anchor[1],
            f"registered codec `{name}` has no row in the docs codec "
            "catalogue table"))
    return findings
