"""repro_torch.launch.hlo_analysis: the collective and cost accounting of
a built step (the twins of tests/test_hlo_analysis.py and of
tests/test_sharding_launch.py's DP-plan and partial-sharing checks).

Every measurement runs over a fake process group of 8 ranks in a
subprocess (never a process group in a pytest worker); each test reads
its numbers.  Rounds run on fake tensors
(``FakeTensorMode``) at the reference's small configs."""
import contextlib
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.launch.hlo_analysis import (CollectiveRecord, CollectiveStats, in_round_loop,
                                             tensor_bytes)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# one intra-op thread a subprocess: the tier-1 run shares the cores
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")

_COMMON = r"""
import json, torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.launch.dryrun import fake_world, fake_inputs
from repro_torch.launch.mesh import make_mesh, mesh_dims
from repro_torch.launch.hlo_analysis import CollectiveStats, count_dispatch
from repro_torch.launch.steps import AGENTS_DATA, AGENTS_DATA_DP, build_step
from repro_torch.models.config import ArchConfig, ShapeConfig
fake_world(8)
mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
TR = ShapeConfig("train", 128, 8, "train")


def tiny(dtype, remat):
    return ArchConfig(name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
                      num_kv_heads=2, d_ff=128, vocab_size=512, dtype=dtype, remat=remat,
                      disc_layers=2, disc_d_model=32, disc_heads=2)


def run(cfg, K, **kw):
    built = build_step(cfg, TR, mesh, K=K, **kw)
    with FakeTensorMode():
        args = fake_inputs(built)
        _, counts = count_dispatch(built.fn, *args, mesh=mesh)
    return built, counts
"""

# records, signatures, FLOPs by K, packed int4, partial sharing
_A = _COMMON + r"""
from repro_torch.core.strategies import FedAvgSync, PartialSharing
from repro_torch.dist.collectives import tree_bytes
from repro_torch.kernels.qpack.ref import pack4_ref
import torch.distributed._functional_collectives as funcol
out = {}
cfg = tiny(torch.float32, False)
_, one = run(cfg, 1)
built, full = run(cfg, 2, strategy=FedAvgSync())
out["flops"] = [one.flops, full.flops]
out["records"] = [dict(op=r.op, bytes=r.bytes, axes=list(r.mesh_axes), in_loop=r.in_loop,
                       file=r.source_file, line=r.source_line, dtypes=list(r.operand_dtypes))
                  for r in full.records]
_, part = run(cfg, 2, strategy=PartialSharing())
params = built.input_sds[0]["params"]
out["gen_frac"] = tree_bytes(params["gen"]) / tree_bytes(params)
dims = mesh_dims(mesh)
out["sync"] = {k: [CollectiveStats.from_records(c.records, skip_loops=True).bytes_by_axis(dims)
                   ["agent"], CollectiveStats.from_records(c.records).bytes_by_axis(dims)["agent"]]
               for k, c in (("full", full), ("partial", part))}

# group signatures: the two axes of a (2, 2) mesh have one size
sq = make_mesh((2, 2), ("data", "model"), device="cpu", ranks=[0, 1, 2, 3])
x = torch.ones(8, 8)
def reduce_both(t):
    return funcol.all_reduce(funcol.all_reduce(t, "sum", (sq, 0)), "sum", (sq, 1))
_, c = count_dispatch(reduce_both, x, mesh=sq)
out["square"] = [[list(r.mesh_axes), r.bytes] for r in c.records]
out["square_axis"] = CollectiveStats.from_records(c.records).bytes_by_axis(mesh_dims(sq))

# packed int4: 1,000 codes a rank, two a byte, gathered over "data"
codes = torch.randint(-7, 8, (1, 1000), dtype=torch.int8)
packed = pack4_ref(codes)
_, c = count_dispatch(lambda p: funcol.all_gather_tensor(p, 0, (mesh, 0)), packed, mesh=mesh)
out["int4"] = [c.records[0].bytes, packed.numel(), list(c.records[0].mesh_axes)]
print("HLO " + json.dumps(out))
"""

# the DP plan against agents-data
_B = _COMMON + r"""
cfg = tiny(torch.bfloat16, True)
out = {}
for plan in (AGENTS_DATA, AGENTS_DATA_DP):
    _, c = run(cfg, 2, plan=plan)
    out[plan.name] = [CollectiveStats.from_records(c.records).total_bytes, c.flops]
print("HLO " + json.dumps(out))
"""


def _run(code):
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=ENV, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads([ln for ln in res.stdout.splitlines() if ln.startswith("HLO ")][-1][4:])


@pytest.fixture(scope="module")
def a():
    return _run(_A)


@pytest.fixture(scope="module")
def b():
    return _run(_B)


def _line_of(rel, needle):
    with open(os.path.join(ROOT, rel), encoding="utf-8") as f:
        return next(i + 1 for i, ln in enumerate(f.read().splitlines()) if needle in ln)


def test_records_carry_loop_context_and_source_line(a):
    recs = a["records"]
    loop = [r for r in recs if r["in_loop"]]
    once = [r for r in recs if not r["in_loop"]]
    assert loop and once
    # the per-step tensor parallelism is issued from the model's code
    assert all(r["axes"] == ["model"] for r in loop)
    assert all(r["file"].startswith("src/repro_torch/") and r["line"] > 0 for r in loop)
    # the once-a-round sync: the agent reduce (Partial -> Replicate) over
    # "data", anchored at its redistribute in dist/collectives.py
    sync_line = _line_of("src/repro_torch/dist/collectives.py",
                         "return m.redistribute(m.device_mesh, tuple(Replicate()")
    assert all((r["op"], r["axes"], r["file"], r["line"]) ==
               ("all_reduce", ["data"], "src/repro_torch/dist/collectives.py", sync_line)
               for r in once), once
    assert all(r["dtypes"] == ["float32"] for r in once)


def test_group_signatures_tell_data_from_model(a):
    """On a (2, 2) mesh both axes have two ranks: the axes are told apart
    by the ranks' coordinates, not by the group's size."""
    assert a["square"] == [[["data"], 256], [["model"], 256]]
    assert a["square_axis"] == {"model": 256, "agent": 256, "other": 0}


def test_k2_counts_twice_the_step_flops_of_k1(a):
    k1, k2 = a["flops"]
    assert k1 > 0 and k2 == 2 * k1


def test_packed_int4_bills_half_a_byte_a_code(a):
    gathered, packed_bytes, axes = a["int4"]
    assert packed_bytes == 500 and gathered == 2 * 500 and axes == ["data"]


def test_partial_sharing_shrinks_agent_axis_bytes(a):
    """Generator-only sync moves strictly fewer once-a-round agent-axis
    bytes than FedAvg, by about the generator's share of the parameter
    bytes (the twin of the reference's HLO audit)."""
    full, part = a["sync"]["full"], a["sync"]["partial"]
    assert 0 < part[0] < full[0]
    assert part[1] < full[1]
    ratio = part[0] / full[0]
    assert abs(ratio - a["gen_frac"]) < 0.15, (ratio, a["gen_frac"])


def test_dp_plan_reduces_collectives(b):
    """The intra-agent DP plan moves at most half of agents-data's
    collective bytes."""
    base, dp = b["agents-data"], b["agents-data-dp"]
    assert dp[0] <= base[0] * 0.5, (dp[0], base[0])


def test_dp_plan_flops_within_20_percent_of_agents_data(b):
    """...at per-rank FLOPs within 20% of agents-data's (the reference's
    bound: both plans split the same work over the same ranks)."""
    base, dp = b["agents-data"], b["agents-data-dp"]
    assert abs(dp[1] - base[1]) < 0.2 * base[1], (dp[1], base[1])


# ---------------------------------------------------------------------------
# in-process: the aggregate and the byte counts
# ---------------------------------------------------------------------------


def _rec(axes, nbytes, in_loop=False, size=4):
    return CollectiveRecord(op="all_reduce", bytes=nbytes, mesh_axes=tuple(axes),
                            operand_dtypes=("float32",), in_loop=in_loop, group_size=size)


def test_bytes_by_axis_classifies_agent_model_and_other():
    st = CollectiveStats.from_records([
        _rec(("data",), 10), _rec(("pod",), 20), _rec(("pod", "data"), 40),
        _rec(("model",), 100), _rec(("data", "model"), 1000), _rec((), 7, size=3)])
    dims = {"pod": 2, "data": 4, "model": 2}
    assert st.bytes_by_axis(dims) == {"agent": 70, "model": 100, "other": 1007}
    assert st.total_bytes == 1177
    assert st.summary()["by_group"]["group3"] == 7


def test_skip_loops_keeps_the_once_per_round_traffic():
    recs = [_rec(("data",), 10), _rec(("model",), 100, in_loop=True),
            _rec(("data",), 5, in_loop=True)]
    assert CollectiveStats.from_records(recs, skip_loops=True).bytes_by_axis(
        {"data": 4, "model": 2}) == {"agent": 10, "model": 0, "other": 0}
    assert CollectiveStats.from_records(recs).count_by_op == {"all_reduce": 3}


@pytest.mark.parametrize("n", [1000, 7])
def test_sub_byte_dtypes_bill_by_bits(n):
    assert tensor_bytes(torch.empty(n, dtype=torch.uint8)) == n
    assert tensor_bytes(torch.empty(n, dtype=torch.float32)) == 4 * n
    if hasattr(torch, "uint4"):
        from repro_torch.launch.hlo_analysis import _SUB_BYTE_BITS
        assert _SUB_BYTE_BITS[torch.uint4] == 4


def test_in_round_loop_sees_only_the_steps():
    from repro_torch.core import FedGAN, FedGANConfig, make_gan_task
    from repro_torch.core.strategies import FedAvgSync
    from repro_torch.models.gan_nets import Toy2DDiscriminator, Toy2DGenerator
    seen = {}

    class Probe(FedAvgSync):
        def grad_hook(self, fed, gd, gg, state):
            seen["hook"] = in_round_loop()
            return gd, gg

        def round_sync(self, fed, state):
            seen["sync"] = in_round_loop()
            return super().round_sync(fed, state)

    task = make_gan_task(Toy2DGenerator(theta0=0.5), Toy2DDiscriminator(psi0=0.5))
    fed = FedGAN(task, FedGANConfig(agent_grid=(1, 2), sync_interval=1, strategy=Probe()))
    state = fed.init_state(torch.Generator().manual_seed(0), device="cpu")
    fed.round(state, {"x": torch.zeros((1, 1, 2, 4)), "z": torch.zeros((1, 1, 2, 4))})
    assert seen == {"hook": True, "sync": False}


# two calls whose outputs view or write their argument's storage: the row
# views (2 x 4,000 B read, 2 x 4,000 B made) and the in-place add (no new
# storage, then one 32,000 B product)
PEAK_CASES = {
    "views": (lambda x: [x[i] * 1 for i in range(2)], 8000),
    "in_place": (lambda x: (x.add_(1), x * 2)[1], 32000),
    "out_argument": (lambda x: torch.mul(x, 2, out=torch.empty_like(x)), 32000),
}


@pytest.mark.parametrize("fake", [False, True], ids=["real", "fake"])
@pytest.mark.parametrize("case", sorted(PEAK_CASES))
def test_peak_counts_only_the_storages_an_op_made(case, fake):
    """``peak_bytes`` holds what the call allocates: a view of an argument,
    an in-place result and an ``out=`` result are no new storage, on real
    tensors and on fake ones (``lm_gan_round_peak`` runs on fake tensors).
    The FLOPs and operand bytes count every op as before."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.hlo_analysis import count_dispatch
    fn, want = PEAK_CASES[case]
    ctx = FakeTensorMode() if fake else contextlib.nullcontext()
    with ctx:
        _, mode = count_dispatch(fn, torch.zeros(8, 1000))
    assert mode.peak_bytes == want
    assert mode.live_bytes <= want
