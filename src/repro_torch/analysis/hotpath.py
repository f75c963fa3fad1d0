"""Layer 1b: the wire auditor, the strategy x codec matrix (the twin of
``repro.analysis.hotpath``).

Every registered strategy x {none, int8, int4} (+ fedgan's bf16 cell and
its ``int8_composed``/``int4_composed`` cells) is built with
``launch.steps.build_train_round`` on the reference's (4, 2) mesh, run
once over a fake process group of 8 ranks in this process, and its
collectives read through ``launch.hlo_analysis.collective_records``.  The
values are not used (a fake group moves nothing): only what crosses the
mesh is counted.  The checks are the reference's:

* ``wire-dtype`` / widening: no agent-axis collective may carry an
  operand wider than 4 B: a float64 (or int64) leak on the wire path
  doubles the §3.2 budget silently.
* codec cells: the port's coded syncs reduce gathered inputs, so the
  agent axis still moves float32: no once-per-round agent-axis operand
  may be narrower than 4 B unless the none cell carries it too (the
  encode escaped onto the wire), and the billed
  ``strategy.bytes_per_round`` must be strictly LESS than the none
  cell's (equality means the codec is silently ignored).
* bf16 cell: the dominant once-per-round agent-axis collective must carry
  bfloat16 (the declared cast reached the wire).
* fused and composed: the plain int8/int4 cells run the fused sync (the
  default), fedgan's ``*_composed`` cells the per-leaf composed one; both
  face the same checks.

Cells the design space refuses (``TypeError`` at construction,
``ValueError`` from ``validate``) are recorded as ``refused``; the
refusal-matrix rule checks those separately.

Needs a fake group of 8 ranks and no other group in the process: the CLI
starts one; tests run this in a subprocess.
"""
from __future__ import annotations

import dataclasses
import inspect
import os

import torch

from repro_torch.analysis.findings import Finding, filter_suppressed
from repro_torch.analysis.lint import repo_root_from_package

WIRE_RULE = "wire-dtype"

CODEC_CELLS = ("none", "int8", "int4")
MESH_SHAPE = (4, 2)           # ("data", "model") -> 4 agents, TP-2
_F32_BYTES = 4


@dataclasses.dataclass
class WireCell:
    strategy: str             # registry name (canonical, first alias)
    cls_name: str
    codec: str                # none | int8 | int4 | bf16 | int8_composed | int4_composed
    status: str               # ok | refused
    reason: str = ""
    agent_bytes_once: int = 0  # once-per-round agent-axis collective bytes
    billed: int = 0           # strategy.bytes_per_round
    agent_records: tuple = ()


def _tiny_cfg():
    from repro_torch.models.config import ArchConfig, ShapeConfig
    cfg = ArchConfig(name="t", family="dense", num_layers=1, d_model=32, num_heads=2,
                     num_kv_heads=2, d_ff=64, vocab_size=128, dtype=torch.float32,
                     remat=False, disc_layers=1, disc_d_model=32, disc_heads=2)
    return cfg, ShapeConfig("t", 16, 8, "train")   # seq 16, global batch 8


def _canonical_strategies():
    """[(canonical registry name, cls)]: classes deduped (ps_fedgan and
    partial_sharing share PartialSharing), the first alias wins."""
    from repro_torch.core.strategies import STRATEGIES
    out, seen = [], set()
    for name, cls in STRATEGIES.items():
        if cls not in seen:
            seen.add(cls)
            out.append((name, cls))
    return out


def _make_strategy(cls, codec: str):
    """May raise TypeError (field absent) or ValueError: a refused cell.
    A ``_composed`` suffix pins ``fused_sync=False``."""
    from repro_torch.comm.codecs import CODECS
    kwargs = {}
    if cls.__name__ == "Hierarchical":
        kwargs["intra_interval"] = 1
    if codec == "bf16":
        kwargs["sync_dtype"] = torch.bfloat16
    elif codec != "none":
        base, _, variant = codec.partition("_")
        kwargs["codec"] = CODECS[base]()
        if variant == "composed":
            kwargs["fused_sync"] = False
    return cls(**kwargs)


def _is_agent(rec) -> bool:
    return bool(rec.mesh_axes) and set(rec.mesh_axes) <= {"pod", "data"}


def _dtype_bytes(name: str) -> int:
    return torch.empty((), dtype=getattr(torch, name)).element_size()


def _class_anchor(cls, root: str):
    try:
        path = inspect.getsourcefile(cls)
        line = inspect.getsourcelines(cls)[1]
        rel = os.path.relpath(os.path.abspath(path), root)
        if not rel.startswith(".."):
            return rel.replace(os.sep, "/"), line
    except (OSError, TypeError, ValueError):
        pass
    return "src/repro_torch/core/strategies.py", 1


def _record_anchor(rec, cls, root: str):
    if rec is not None and rec.source_file:
        return rec.source_file, rec.source_line
    return _class_anchor(cls, root)


def _fed_cfg_for(mesh, K: int, strategy):
    from repro_torch.core.fedgan import FedGANConfig
    from repro_torch.launch.mesh import mesh_dims
    dims = mesh_dims(mesh)
    return FedGANConfig(agent_grid=(dims.get("pod", 1), dims["data"]), sync_interval=K,
                        strategy=strategy)


def _build_cell(name: str, cls, codec: str, mesh, cfg, shape, K: int, root: str):
    """Build and run one cell once; returns a WireCell."""
    from repro_torch.launch.dryrun import place_local
    from repro_torch.launch.hlo_analysis import collective_records
    from repro_torch.launch.steps import build_train_round

    cell = WireCell(strategy=name, cls_name=cls.__name__, codec=codec, status="ok")
    try:
        strategy = _make_strategy(cls, codec)
        built = build_train_round(cfg, shape, mesh, K=K, strategy=strategy)
        state = built.fed.init_state(torch.Generator().manual_seed(0), device="cpu")
        tokens = torch.zeros(tuple(built.input_sds[1]["tokens"].shape), dtype=torch.int64)
        args = place_local(built, (state, {"tokens": tokens}))
        recs = collective_records(built.fn, *args, mesh=mesh, root=root)
    except (TypeError, ValueError) as e:
        cell.status = "refused"
        cell.reason = f"{type(e).__name__}: {e}"
        return cell
    cell.agent_records = tuple(r for r in recs if _is_agent(r))
    cell.agent_bytes_once = sum(r.bytes for r in cell.agent_records if not r.in_loop)
    cell.billed = int(strategy.bytes_per_round(_fed_cfg_for(mesh, K, strategy),
                                               built.input_sds[0]["params"]))
    return cell


def run_wire_matrix(root: str | None = None, *, names=None, codecs=None, K: int = 2):
    """Returns ``(cells, findings)``; findings are suppression-filtered.
    ``names``/``codecs`` restrict the matrix."""
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_mesh

    root = root or repo_root_from_package()
    fake_world(MESH_SHAPE[0] * MESH_SHAPE[1])
    mesh = make_mesh(MESH_SHAPE, ("data", "model"), device="cpu")
    cfg, shape = _tiny_cfg()
    codec_cells = tuple(c for c in CODEC_CELLS if not codecs or c in codecs)

    cells: list = []
    findings: list = []
    for name, cls in _canonical_strategies():
        if names and name not in names:
            continue
        per_codec = {}
        extra = ("bf16", "int8_composed", "int4_composed") if name == "fedgan" else ()
        for codec in codec_cells + tuple(c for c in extra if not codecs or c in codecs):
            per_codec[codec] = _build_cell(name, cls, codec, mesh, cfg, shape, K, root)
            cells.append(per_codec[codec])
        findings.extend(_cell_findings(per_codec, cls, root))
    findings.sort(key=lambda f: (f.file, f.line, f.message))
    return cells, filter_suppressed(findings, root)


def _cell_findings(per_codec: dict, cls, root: str) -> list:
    findings = []
    none_cell = per_codec.get("none")

    for codec, cell in per_codec.items():
        if cell.status != "ok":
            continue
        # (1) widening: no agent-axis operand wider than 4 bytes
        for rec in cell.agent_records:
            wide = [dt for dt in rec.operand_dtypes if _dtype_bytes(dt) > _F32_BYTES]
            if wide:
                f, line = _record_anchor(rec, cls, root)
                findings.append(Finding(
                    rule=WIRE_RULE, file=f, line=line,
                    message=f"[{cell.strategy}+{codec}] agent-axis {rec.op} carries "
                            f"{'/'.join(wide)} operands: wider than the declared float32 "
                            "wire (silent widening doubles the §3.2 bytes)"))

        if codec.startswith(("int8", "int4")) and none_cell is not None \
                and none_cell.status == "ok":
            # (2) the encoded image must not cross the agent axis: a narrow
            # operand the none cell does not carry too means it escaped
            allowed = {dt for r in none_cell.agent_records for dt in r.operand_dtypes}
            for rec in cell.agent_records:
                if rec.in_loop:
                    continue
                narrow = [dt for dt in rec.operand_dtypes
                          if _dtype_bytes(dt) < _F32_BYTES and dt not in allowed]
                if narrow:
                    f, line = _record_anchor(rec, cls, root)
                    findings.append(Finding(
                        rule=WIRE_RULE, file=f, line=line,
                        message=f"[{cell.strategy}+{codec}] agent-axis {rec.op} carries "
                                f"{'/'.join(narrow)} operands: the codec's encoded image "
                                "crossed the agent axis (codecs encode and decode "
                                "locally; the wire moves float32)"))
            # (3) the billed budget must shrink
            if none_cell.billed and cell.billed >= none_cell.billed:
                f, line = _class_anchor(cls, root)
                findings.append(Finding(
                    rule=WIRE_RULE, file=f, line=line,
                    message=f"[{cell.strategy}+{codec}] billed bytes_per_round "
                            f"{cell.billed} is not < the none cell's {none_cell.billed}: "
                            "the codec is being silently ignored in the §3.2 budget"))

        if codec == "bf16":
            once = [r for r in cell.agent_records if not r.in_loop]
            if not once:
                f, line = _class_anchor(cls, root)
                findings.append(Finding(
                    rule=WIRE_RULE, file=f, line=line,
                    message=f"[{cell.strategy}+bf16] no once-per-round agent-axis "
                            "collective found: the sync vanished from the round"))
            else:
                biggest = max(once, key=lambda r: r.bytes)
                if any(dt != "bfloat16" for dt in biggest.operand_dtypes):
                    f, line = _record_anchor(biggest, cls, root)
                    findings.append(Finding(
                        rule=WIRE_RULE, file=f, line=line,
                        message=f"[{cell.strategy}+bf16] dominant once-per-round "
                                f"agent-axis {biggest.op} carries "
                                f"{'/'.join(biggest.operand_dtypes)} operands, not "
                                "bfloat16: the declared sync_dtype cast never reached "
                                "the wire"))
    return findings
