"""repro_torch.analysis against repro.analysis, and every rule caught on
its planted fixture.

The findings and baseline logic and the consistency rules are held to
the reference's on the same inputs (the reference's own mini-trees under
``tests/fixtures/analysis/``, read, not changed).  The port's lint and
trace rules fire once at each planted line of ``tests/torch_fixtures/
analysis/`` (the port's sync forms, kernel layout and round-level
faults), and stay silent on the waived twins; the repo is clean against
the committed baseline.  The wire matrix runs on a fake process group of
8 ranks in one subprocess (a process group never lives in a pytest
worker), and its billed bytes are held to the reference's
``bytes_per_round`` cell by cell, computed directly without a compile.
"""
import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.analysis import findings as jfindings
from repro.analysis.lint import LintContext as JLintContext
from repro.analysis.rules import consistency as jconsistency

from repro_torch.analysis import findings as tfindings
from repro_torch.analysis.findings import Finding, filter_suppressed, load_baseline, new_findings
from repro_torch.analysis.lint import LintContext, run_lint

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SRC = os.path.join(ROOT, "src")
REF_FIX = os.path.join(HERE, "fixtures", "analysis")
FIX = os.path.join(HERE, "torch_fixtures", "analysis")
# one intra-op thread a subprocess: the tier-1 run shares the cores
ENV = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")


def line_of(root: str, rel: str, needle: str, nth: int = 0) -> int:
    with open(os.path.join(root, rel), encoding="utf-8") as f:
        hits = [i + 1 for i, ln in enumerate(f.read().splitlines()) if needle in ln]
    return hits[nth]


def _cli(*args, timeout=300):
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis", *args],
                          capture_output=True, text=True, env=ENV, timeout=timeout)


# ---------------------------------------------------------------------------
# findings, suppressions and the baseline, against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("line", [
    "x = 1  # analysis: allow(host-sync)",
    "<!-- analysis: allow(a-rule, b-rule) -->",
    "# analysis allow host-sync",
    "y = f()  # analysis:allow( pad-reuse ,raw-fold-in )",
    "no marker here",
])
def test_suppression_marker_forms_match_reference(line):
    assert tfindings.allowed_rules_on_line(line) == jfindings.allowed_rules_on_line(line)


def test_suppression_filter_matches_reference():
    """The same findings on the reference's refusal fixture (its docs row
    carries an inline allow marker) survive both filters alike."""
    root = os.path.join(REF_FIX, "refusal")
    raw = [("refusal-matrix", "docs/privacy.md", n, "m") for n in range(1, 9)]
    got = filter_suppressed([Finding(*r) for r in raw], root)
    want = jfindings.filter_suppressed([jfindings.Finding(*r) for r in raw], root)
    assert [f.key + (f.line,) for f in got] == [f.key + (f.line,) for f in want]
    assert 0 < len(raw) - len(got)


def test_baseline_refuses_entries_without_reason(tmp_path):
    p = tmp_path / "baseline.json"
    p.write_text(json.dumps({"findings": [{"rule": "host-sync", "file": "a.py",
                                           "message": "m"}]}))
    for mod in (tfindings, jfindings):
        with pytest.raises(ValueError, match="reason"):
            mod.load_baseline(str(p))
    p.write_text(json.dumps({"findings": [{"rule": "host-sync", "file": "a.py",
                                           "message": "m", "reason": "documented"}]}))
    assert tfindings.load_baseline(str(p)) == jfindings.load_baseline(str(p)) == \
        {("host-sync", "a.py", "m")}


def test_baseline_matching_is_line_independent():
    f = Finding(rule="r", file="a.py", line=10, message="m")
    g = Finding(rule="r", file="a.py", line=99, message="m")
    assert f.key == g.key == jfindings.Finding("r", "a.py", 3, "m").key
    assert new_findings([g], {f.key}) == [] == jfindings.new_findings(
        [jfindings.Finding("r", "a.py", 99, "m")], {f.key})


def test_update_baseline_output_matches_reference(tmp_path):
    rows = [("host-sync", "src/a.py", 3, "one"), ("pad-reuse", "", 0, "two")]
    tp, jp = tmp_path / "t.json", tmp_path / "j.json"
    tfindings.write_baseline([Finding(*r) for r in rows], str(tp))
    jfindings.write_baseline([jfindings.Finding(*r) for r in rows], str(jp))
    assert json.loads(tp.read_text())["findings"] == json.loads(jp.read_text())["findings"]
    with pytest.raises(ValueError, match="reason"):
        load_baseline(str(tp))


# ---------------------------------------------------------------------------
# the consistency rules on the reference's mini-trees
# ---------------------------------------------------------------------------


def _on_ref_fixture(name):
    root = os.path.join(REF_FIX, name)
    return (LintContext(root=root, src=os.path.join(root, "src", "repro"),
                        docs=os.path.join(root, "docs"), tests=os.path.join(root, "tests")),
            JLintContext.for_repo(root))


@pytest.mark.parametrize("name,rule", [
    ("refusal", "refusal-matrix"),
    ("refusal_async", "refusal-matrix"),
    ("catalogue", "catalogue-drift"),
])
def test_consistency_rules_match_reference(name, rule):
    tctx, jctx = _on_ref_fixture(name)
    check = {"refusal-matrix": "check_refusal_matrix",
             "catalogue-drift": "check_catalogue_drift"}[rule]
    got = run_lint(tctx, rules=[rule])
    want = jfindings.filter_suppressed(getattr(jconsistency, check)(jctx), jctx.root)
    assert got, "the planted drift must be found"
    assert sorted((f.rule, f.file, f.line) for f in got) == \
        sorted((f.rule, f.file, f.line) for f in want)
    # the same pairs and names are reported
    assert sorted(f.message.split("'")[1] if "'" in f.message else f.message.split("`")[1]
                  for f in got) == \
        sorted(f.message.split("'")[1] if "'" in f.message else f.message.split("`")[1]
               for f in want)


# ---------------------------------------------------------------------------
# the port's lint rules on its planted fixtures
# ---------------------------------------------------------------------------


def test_host_sync_catches_each_call_form_at_its_line():
    root = os.path.join(FIX, "hostsync")
    findings = run_lint(LintContext.for_repo(root), rules=["host-sync"])
    rel = "src/repro_torch/core/hot.py"
    planted = ["float(metrics", ".item()", "np.asarray(metrics", 'int(state["step"])',
               ".tolist()", 'state["params"].cpu()    ', ".numpy()",
               "torch.cuda.synchronize()"]
    assert sorted((f.file, f.line) for f in findings) == \
        sorted((rel, line_of(root, rel, p)) for p in planted), findings
    assert all(f.rule == "host-sync" for f in findings)
    # the waived twin, the constants and the host-side module are silent
    assert not any("evals" in f.file for f in findings)
    for fine in ("float(1e-3)", "int(len(state))", "# analysis: allow(host-sync)"):
        assert not any(f.line == line_of(root, rel, fine) for f in findings)


def test_kernel_ref_pair_flags_the_unpaired_kernels():
    root = os.path.join(FIX, "kernelpair")
    findings = run_lint(LintContext.for_repo(root), rules=["kernel-ref-pair"])
    by_file = {f.file: f for f in findings}
    assert sorted(by_file) == ["src/repro_torch/kernels/bad/kernel.py",
                               "src/repro_torch/kernels/nocsrc/kernel.py"], findings
    assert all(f.line == 1 for f in findings)
    assert "ref.py" in by_file["src/repro_torch/kernels/bad/kernel.py"].message
    assert "csrc/nocsrc.cu" in by_file["src/repro_torch/kernels/nocsrc/kernel.py"].message


def test_repo_lint_clean_vs_baseline():
    assert new_findings(run_lint(), load_baseline()) == []


def test_every_baseline_entry_has_a_reason():
    with open(os.path.join(SRC, "repro_torch", "analysis", "baseline.json")) as f:
        data = json.load(f)
    assert all(ent.get("reason") for ent in data["findings"])
    load_baseline()   # raises on an entry without one


# ---------------------------------------------------------------------------
# the trace rules on planted rounds
# ---------------------------------------------------------------------------


def _trace_mod():
    spec = importlib.util.spec_from_file_location("torch_trace_fixture",
                                                  os.path.join(FIX, "trace_mod.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _toy_round(strategy, K=2, A=3, b=4):
    from repro_torch.core import FedGAN, FedGANConfig, make_gan_task
    from repro_torch.models.gan_nets import Toy2DDiscriminator, Toy2DGenerator
    from repro_torch.optim import Adam, constant, equal_timescale
    task = make_gan_task(Toy2DGenerator(theta0=0.5), Toy2DDiscriminator(psi0=0.5))
    fed = FedGAN(task, FedGANConfig(agent_grid=(1, A), sync_interval=K, strategy=strategy),
                 opt_g=Adam(), opt_d=Adam(), scales=equal_timescale(constant(1e-3)))
    state = fed.init_state(torch.Generator().manual_seed(0), device="cpu")
    batches = {"x": torch.zeros((K, 1, A, b)), "z": torch.zeros((K, 1, A, b))}
    return fed.round, (state, batches)


@pytest.mark.parametrize("planted,rule,needle", [
    ("ItemInLoop", "host-callback-in-scan", "planted: host wait in the loop"),
    ("RawKeyInLoop", "raw-fold-in", "planted: raw seed in the loop"),
    ("pad_reuse", "pad-reuse", "planted: pad reuse"),
])
def test_trace_rule_fires_at_line_and_waived_twin_is_silent(planted, rule, needle):
    from repro_torch import prng
    from repro_torch.analysis.trace import TracedFn, audit_traced
    mod = _trace_mod()

    def target(name):
        if planted == "pad_reuse":
            return TracedFn(name, getattr(mod, name), (prng.key_t(prng.key(3), "cpu"),))
        fn, args = _toy_round(getattr(mod, name)())
        return TracedFn(name, fn, args)

    findings = filter_suppressed(audit_traced(target(planted), FIX), FIX)
    hits = [f for f in findings if f.rule == rule]
    assert len(hits) == 1, findings      # once, however many steps reach it
    assert (hits[0].file, hits[0].line) == ("trace_mod.py", line_of(FIX, "trace_mod.py", needle))
    waived = filter_suppressed(audit_traced(target(planted + "_waived" if planted == "pad_reuse"
                                                   else planted + "Waived"), FIX), FIX)
    assert not [f for f in waived if f.rule == rule], waived


def test_raw_key_helper_in_the_loop_is_flagged_outside_it_is_not():
    """``prng.key`` called from a step's gradient hook is a raw key in the
    loop; the same call in the round's sync is not."""
    from repro_torch import prng
    from repro_torch.analysis.trace import TracedFn, audit_traced
    from repro_torch.core.strategies import FedAvgSync

    class KeyInHook(FedAvgSync):
        def grad_hook(self, fed, gd, gg, state):
            prng.key(0)
            return gd, gg

    class KeyInSync(FedAvgSync):
        def round_sync(self, fed, state):
            prng.key(0)
            return super().round_sync(fed, state)

    for cls, want in ((KeyInHook, 1), (KeyInSync, 0)):
        fn, args = _toy_round(cls())
        hits = [f for f in audit_traced(TracedFn(cls.__name__, fn, args), ROOT)
                if f.rule == "raw-fold-in"]
        assert len(hits) == want, hits
        assert all(f.file == "tests/test_torch_analysis.py" for f in hits)


def test_donation_miss_and_round_donation_helper():
    from repro_torch.analysis.trace import audit_built
    from repro_torch.launch.steps import BuiltStep, round_donation
    built = BuiltStep(fn=lambda s, x: ({"p": s["p"] + x}, x),
                      input_sds=({"p": torch.zeros(())}, torch.zeros(())),
                      in_shardings=None, out_shardings=None, meta={"kind": "train"})
    assert round_donation(built) == (0,)
    assert round_donation(BuiltStep(None, (), None, None, meta={"kind": "prefill"})) == ()
    args = ({"p": torch.zeros(())}, torch.zeros(()))
    missed = audit_built(built, donate_argnums=(), args=args)
    assert [f.rule for f in missed] == ["donation-miss"], missed
    assert not audit_built(built, donate_argnums=round_donation(built), args=args)


def test_repo_trace_clean_vs_baseline():
    """The stream, secure-sum and device rounds: no host wait and no raw
    key inside the loop, no pad reuse, the state donated."""
    from repro_torch.analysis.trace import run_trace
    assert new_findings(run_trace(), load_baseline()) == []


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_gate_exits_zero_on_the_repo(tmp_path):
    report = tmp_path / "report.json"
    res = _cli("--json", "--out", str(report))
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    data = json.loads(report.read_text())
    assert data["new"] == [] and data["findings"] == []
    assert set(data["rules"]) == {"host-sync", "kernel-ref-pair", "refusal-matrix",
                                  "catalogue-drift", "host-callback-in-scan", "raw-fold-in",
                                  "pad-reuse", "donation-miss"}


def test_cli_exits_one_on_new_findings_and_two_on_a_bad_baseline(tmp_path):
    root = os.path.join(FIX, "hostsync")
    res = _cli("--rules", "host-sync", "--root", root)
    assert res.returncode == 1, res.stdout[-2000:] + res.stderr[-2000:]
    assert "8 new vs baseline" in res.stdout
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"findings": [{"rule": "host-sync", "file": "a.py",
                                             "message": "m"}]}))
    res = _cli("--rules", "host-sync", "--root", root, "--baseline", str(bad))
    assert res.returncode == 2 and "reason" in res.stderr


def test_cli_update_baseline_needs_human_reasons(tmp_path):
    out = tmp_path / "b.json"
    res = _cli("--rules", "host-sync", "--root", os.path.join(FIX, "hostsync"),
               "--update-baseline", "--baseline", str(out))
    assert res.returncode == 0, res.stderr[-2000:]
    with pytest.raises(ValueError, match="reason"):
        load_baseline(str(out))


def test_cli_rejects_unknown_rule():
    res = _cli("--rules", "no-such-rule", timeout=60)
    assert res.returncode != 0 and "unknown rule" in (res.stdout + res.stderr)


# ---------------------------------------------------------------------------
# the wire matrix on a fake process group of 8 ranks
# ---------------------------------------------------------------------------

_WIRE = r"""
import dataclasses, json, sys
import torch
from repro_torch.analysis.hotpath import (WireCell, _build_cell, _cell_findings,
                                          _tiny_cfg, run_wire_matrix)
from repro_torch.core.strategies import FedAvgSync
from repro_torch.launch.mesh import make_mesh

cells, findings = run_wire_matrix(K=1)
out = {"cells": [dict(dataclasses.asdict(c), agent_records=None) for c in cells],
       "findings": [f.to_json() for f in findings]}

# planted faults: a float64 leaf on the wire, a codec the bill ignores
mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
cfg, shape = _tiny_cfg()


class Float64Wire(FedAvgSync):
    def round_sync(self, fed, state):
        from repro_torch.dist.sharding import full_tree
        from repro_torch.tree import tree_leaves
        full_tree(tree_leaves(state["params"]["disc"])[0].to(torch.float64))  # planted
        return super().round_sync(fed, state)


class LazyCodec(FedAvgSync):
    def bytes_per_round(self, cfg, params, opt=None):
        return FedAvgSync().bytes_per_round(cfg, params, opt)


def cell(cls, codec, name):
    import repro_torch.analysis.hotpath as hp
    made = hp._make_strategy
    hp._make_strategy = lambda c, k: (cls(codec=made(FedAvgSync, k).codec)
                                      if k != "none" else cls())
    try:
        return _build_cell(name, cls, codec, mesh, cfg, shape, 1, ".")
    finally:
        hp._make_strategy = made


wide = {"none": cell(Float64Wire, "none", "float64_wire")}
lazy = {"none": cell(FedAvgSync, "none", "lazy"), "int8": cell(LazyCodec, "int8", "lazy")}
out["planted"] = {"float64": [f.message for f in _cell_findings(wide, Float64Wire, ".")],
                  "lazy": [f.message for f in _cell_findings(lazy, LazyCodec, ".")]}
print("WIRE " + json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def _wire_run():
    """The matrix's subprocess, started with the module's first test so it
    runs beside the others; killed if still running at the end."""
    proc = subprocess.Popen([sys.executable, "-c", _WIRE], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=ENV)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def wire(_wire_run):
    out, err = _wire_run.communicate(timeout=600)
    assert _wire_run.returncode == 0, err[-3000:]
    line = [ln for ln in out.splitlines() if ln.startswith("WIRE ")][-1]
    return json.loads(line[5:])


def _ref_bill(codec, cls_name, K=1):
    """The reference's ``bytes_per_round`` of a cell, from its strategy and
    the LM GAN params' shapes on the (1, 4) agent grid: no mesh, no
    compile."""
    from repro.analysis.hotpath import _make_strategy, _tiny_cfg
    from repro.core.fedgan import FedGANConfig
    from repro.core.strategies import STRATEGIES
    from repro.launch.steps import make_lm_gan_task
    cls = next(c for c in STRATEGIES.values() if c.__name__ == cls_name)
    strategy = _make_strategy(cls, codec)     # raises on a refused cell
    cfg, _ = _tiny_cfg()
    one = jax.eval_shape(make_lm_gan_task(cfg).init, jax.random.key(0))
    params = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct((1, 4) + tuple(x.shape), x.dtype), one)
    return int(strategy.bytes_per_round(
        FedGANConfig(agent_grid=(1, 4), sync_interval=K, strategy=strategy), params))


def test_wire_matrix_clean_and_complete(wire):
    assert wire["findings"] == [], wire["findings"]
    from repro_torch.analysis.hotpath import _canonical_strategies
    cells = {(c["strategy"], c["codec"]): c for c in wire["cells"]}
    for name, _ in _canonical_strategies():
        for codec in ("none", "int8", "int4"):
            assert (name, codec) in cells, (name, codec)
    for codec in ("bf16", "int8_composed", "int4_composed"):
        assert cells[("fedgan", codec)]["status"] == "ok", cells[("fedgan", codec)]
    # the bf16 cell's sync gathers bfloat16 (its cast reached the wire):
    # half the none cell's float32 gather of the same leaves
    for codec in ("int8", "int4"):
        assert cells[("fedgan", codec)]["billed"] == cells[("fedgan", f"{codec}_composed")][
            "billed"]


def test_wire_matrix_bills_and_refuses_as_the_reference(wire):
    """Every cell's billed bytes equal the reference's ``bytes_per_round``;
    the cells the port refuses are the reference's refusals."""
    jnp.zeros(())   # the reference's side runs on the CPU backend
    for c in wire["cells"]:
        try:
            want = _ref_bill(c["codec"], c["cls_name"])
        except (TypeError, ValueError) as e:
            assert c["status"] == "refused", (c, e)
            assert type(e).__name__ in c["reason"], (c, e)
            continue
        assert c["status"] == "ok", c
        assert c["billed"] == want, (c["strategy"], c["codec"], c["billed"], want)


def test_wire_matrix_codec_cells_bill_less_than_none(wire):
    cells = {(c["strategy"], c["codec"]): c for c in wire["cells"]}
    for (name, codec), c in cells.items():
        none = cells[(name, "none")]
        if codec.startswith(("int8", "int4")) and c["status"] == "ok" and none["billed"]:
            assert c["billed"] < none["billed"], c
    for name in ("local_only", "distributed"):
        for codec in ("int8", "int4"):
            assert cells[(name, codec)]["status"] == "refused"
            assert "TypeError" in cells[(name, codec)]["reason"]


def test_planted_float64_leaf_on_the_wire_is_found(wire):
    hits = wire["planted"]["float64"]
    assert len(hits) == 1 and "float64" in hits[0] and "wider than" in hits[0], hits


def test_planted_ignored_codec_is_found(wire):
    hits = wire["planted"]["lazy"]
    assert len(hits) == 1 and "silently ignored" in hits[0], hits


def test_wire_cell_findings_logic():
    """Every wire check on hand-built records (the twin of the reference's
    ``test_wire_cell_findings_logic``)."""
    from repro_torch.analysis.hotpath import WireCell, _cell_findings
    from repro_torch.launch.hlo_analysis import CollectiveRecord

    def rec(dtypes, nbytes=100, in_loop=False):
        return CollectiveRecord(op="all_reduce", bytes=nbytes, mesh_axes=("data",),
                                operand_dtypes=tuple(dtypes), in_loop=in_loop, group_size=4)

    class S:
        pass

    def cell(codec, records, billed, status="ok"):
        return WireCell("s", "S", codec, status, agent_bytes_once=sum(r.bytes for r in records),
                        billed=billed, agent_records=tuple(records))

    none = cell("none", [rec(["float32"])], 1000)
    wide = _cell_findings({"none": none, "int8": cell("int8", [rec(["float64"])], 500)}, S, ROOT)
    assert any("wider than" in f.message for f in wide), wide
    leak = _cell_findings({"none": none, "int8": cell("int8", [rec(["uint8"])], 500)}, S, ROOT)
    assert any("crossed the agent axis" in f.message for f in leak), leak
    none_b = cell("none", [rec(["float32", "bool"])], 1000)
    assert _cell_findings({"none": none_b, "int8": cell("int8", [rec(["float32", "bool"])],
                                                        500)}, S, ROOT) == []
    lazy = _cell_findings({"none": none, "int4": cell("int4", [rec(["float32"])], 1000)}, S, ROOT)
    assert any("silently ignored" in f.message for f in lazy), lazy
    assert _cell_findings({"none": none, "bf16": cell("bf16", [rec(["bfloat16"])], 500)},
                          S, ROOT) == []
    bad16 = _cell_findings({"none": none, "bf16": cell("bf16", [rec(["float32"])], 500)}, S, ROOT)
    assert any("never reached" in f.message for f in bad16), bad16
    assert _cell_findings({"none": none, "int8": cell("int8", [], 0, status="refused")},
                          S, ROOT) == []
