"""repro_torch.launch.dryrun: the production dry run over a fake process
group (the twin of tests/test_launch_cli.py's dry-run checks).

A fake group of 256 ranks lives only in a subprocess (a process group is
never started in a pytest worker).  The step runs on fake tensors, so
the (16, 16) mesh costs nothing to allocate; the config is the
reference's tiny one (2 layers, d_model 64)."""
import json
import math
import os
import subprocess
import sys

import pytest

from repro_torch.launch import mesh as tmesh

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# one intra-op thread a subprocess: the tier-1 run shares the cores
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")

_PAIR = r"""
import json, math, torch
from repro_torch.launch.dryrun import run_pair
from repro_torch.launch.steps import build_step, PLANS
from repro_torch.models.config import ArchConfig, ShapeConfig
from repro_torch.launch.mesh import make_mesh, mesh_dims
from repro_torch.tree import tree_leaves
cfg = ArchConfig(name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
                 num_kv_heads=2, d_ff=128, vocab_size=256, dtype=torch.float32, remat=False,
                 disc_layers=2, disc_d_model=32, disc_heads=2)
# one sequence an agent: 4 heads on the 16-way "model" axis, which neither
# heads nor the batch can split (the attention is whole on every rank)
shape = ShapeConfig("train_tiny", 64, 16, "train")
rec = run_pair("tiny", "train_tiny", cfg=cfg, shape=shape, K=2, analyze=True)
rec["serving"] = {}
for sh in (ShapeConfig("prefill_tiny", 64, 32, "prefill"),
           ShapeConfig("decode_tiny", 64, 32, "decode")):
    r = run_pair("tiny", sh.name, cfg=cfg, shape=sh)
    rec["serving"][sh.kind] = [r["status"], r["collective_by_axis"]["model"],
                               r["memory"]["argument_bytes"] == r["memory"]["shard_sum_bytes"]]

# the local shards' sum, from the specs alone: rank 0 holds the first
# chunk of every sharded dim (torch.chunk: ceil(size / n) elements)
mesh = make_mesh((16, 16), ("data", "model"), device="cpu")
built = build_step(cfg, shape, mesh, K=2, plan=PLANS["agents-data"])
dims = mesh_dims(mesh)
def local_bytes(sds, sh):
    n = sds.element_size()
    for d, size in enumerate(sds.shape):
        entry = sh.spec[d] if d < len(sh.spec) else None
        axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        parts = math.prod(dims[a] for a in axes)
        n *= math.ceil(size / parts)
    return n
want = sum(local_bytes(x, s) for tree, shs in zip(built.input_sds, built.in_shardings)
           for x, s in zip(tree_leaves(tree), tree_leaves(shs)))
rec["want_argument_bytes"] = want
print("DRY " + json.dumps(rec))
"""

# the CPU rehearsal of the card's memory check: the predicted argument
# bytes of a (1, 1) mesh equal the bytes of the storages the placed state
# and batches really hold
_ONE = r"""
import json, torch
from repro_torch.launch.dryrun import fake_world, place_local, run_pair
from repro_torch.launch.steps import build_step, PLANS
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.config import ArchConfig, ShapeConfig
from repro_torch.tree import tree_leaves
cfg = ArchConfig(name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
                 num_kv_heads=2, d_ff=128, vocab_size=256, dtype=torch.float32, remat=False,
                 disc_layers=2, disc_d_model=32, disc_heads=2)
shape = ShapeConfig("train_tiny", 64, 8, "train")
rec = run_pair("tiny", "train_tiny", cfg=cfg, shape=shape, K=2, mesh_shape=(1, 1))
mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
built = build_step(cfg, shape, mesh, K=2, plan=PLANS["agents-data"])
state = built.fed.init_state(torch.Generator().manual_seed(0), device="cpu")
tokens = torch.zeros(tuple(built.input_sds[1]["tokens"].shape), dtype=torch.int64)
args = place_local(built, (state, {"tokens": tokens}))
storages = {}
for x in tree_leaves(args):
    st = x._local_tensor.untyped_storage() if hasattr(x, "_local_tensor") else x.untyped_storage()
    storages[st.data_ptr()] = st.nbytes()
print("ONE " + json.dumps({"rec": rec, "held": sum(storages.values())}))
"""

_REFUSE = r"""
import torch, torch.distributed as dist
dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
from repro_torch.launch.dryrun import fake_world
try:
    fake_world(256)
except RuntimeError as e:
    print("REFUSED", e)
"""


def _run(code, tag):
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=ENV, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return [ln for ln in res.stdout.splitlines() if ln.startswith(tag)][-1][len(tag):].strip()


@pytest.fixture(scope="module")
def pair():
    return json.loads(_run(_PAIR, "DRY "))


def test_dryrun_help_shows_analyze():
    code = ("import inspect, sys\n"
            "from repro_torch.launch.dryrun import main, run_pair\n"
            "assert 'analyze' in inspect.signature(run_pair).parameters\n"
            "sys.argv = ['dryrun', '--help']\n"
            "try:\n    main()\nexcept SystemExit as e:\n    assert e.code in (0, None)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=ENV, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    for flag in ("--analyze", "--all", "--both-meshes", "--multi-pod", "--plan", "--out"):
        assert flag in res.stdout


def test_cli_records_a_pair_and_resumes_from_its_cache(tmp_path):
    """A pair the registry rules out (whisper-medium's 500k decode) is
    recorded as skipped without a process group; the second run reads the
    cache."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "whisper-medium",
           "--shape", "long_500k", "--out", str(tmp_path)]
    first = subprocess.run(cmd, capture_output=True, text=True, env=ENV, timeout=120)
    assert first.returncode == 0, first.stderr[-2000:]
    assert "[skipped] baseline__whisper-medium__long_500k__16x16" in first.stdout
    rec = json.loads((tmp_path / "baseline__whisper-medium__long_500k__16x16.json").read_text())
    assert rec["status"] == "skipped" and "audio" in rec["reason"]
    again = subprocess.run(cmd, capture_output=True, text=True, env=ENV, timeout=120)
    assert "[cached]" in again.stdout


def test_run_pair_tiny_on_16x16_is_ok(pair):
    assert pair["status"] == "ok", pair
    assert pair["mesh"] == "16x16" and pair["steps_per_call"] == 2
    assert pair["analysis"] == []


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_serving_pairs_split_heads_on_16_ranks(pair, kind):
    """The serving builders on (16, 16): q/k/v projections sharded over 16
    ranks are gathered before the split into 4 (or 2) heads."""
    status, model_bytes, args_match = pair["serving"][kind]
    assert status == "ok" and model_bytes > 0 and args_match


def test_argument_bytes_equal_the_local_shards(pair):
    assert pair["memory"]["argument_bytes"] == pair["want_argument_bytes"]
    assert pair["memory"]["shard_sum_bytes"] == pair["want_argument_bytes"]
    assert pair["memory"]["peak_bytes"] > pair["memory"]["argument_bytes"]
    assert pair["memory"]["fits"] is (pair["memory"]["peak_bytes"] <= tmesh.HBM_BYTES) is True


def test_collective_bytes_on_both_axes(pair):
    by = pair["collective_by_axis"]
    assert by["agent"] > 0 and by["model"] > 0
    # the once-a-round traffic is the agent reduce alone
    once = pair["once_per_call_by_axis"]
    assert once["agent"] > 0 and once["model"] == 0


def test_roofline_terms_with_h100_constants(pair):
    r = pair["roofline_per_step"]
    steps = pair["steps_per_call"]
    assert r["compute_s"] == pytest.approx(pair["flops"] / steps / tmesh.PEAK_FLOPS_BF16)
    assert r["memory_s"] == pytest.approx(pair["bytes_accessed"] / steps / tmesh.HBM_BW)
    by = pair["collective_by_axis"]
    # on (16, 16) both axes cross nodes: every byte at the per-card NIC rate
    assert pair["node_crossing_axes"] == ["data", "model"]
    assert r["collective_s"] == pytest.approx(sum(by.values()) / steps / tmesh.NODE_BW)
    assert r["collective_s_nvlink"] == pytest.approx(sum(by.values()) / steps / tmesh.NVLINK_BW)
    assert r["dominant"] in ("compute_s", "memory_s", "collective_s")


def test_one_card_argument_bytes_are_the_placed_storages():
    got = json.loads(_run(_ONE, "ONE "))
    mem = got["rec"]["memory"]
    assert got["rec"]["status"] == "ok" and got["rec"]["mesh"] == "1x1"
    assert mem["argument_bytes"] == got["held"]


def test_fake_world_refuses_a_running_group():
    assert "run it in its own process" in _run(_REFUSE, "REFUSED")


@pytest.mark.parametrize("shape,axes,want", [
    ((16, 16), ("data", "model"), ("data", "model")),
    ((2, 16, 16), ("pod", "data", "model"), ("pod", "data", "model")),
    ((1, 8), ("data", "model"), ()),
    ((2, 4), ("data", "model"), ()),
    ((4, 4), ("data", "model"), ("data",)),
    ((1, 1), ("data", "model"), ()),
])
def test_node_crossing_axes(shape, axes, want):
    assert tmesh.node_crossing_axes(shape, axes) == want


def test_h100_constants():
    assert tmesh.PEAK_FLOPS_BF16 == 989e12 and tmesh.HBM_BW == 3.35e12
    assert tmesh.NVLINK_BW == 450e9 and tmesh.NODE_BW == 50e9
    assert tmesh.CARDS_PER_NODE == 8 and math.isclose(tmesh.HBM_BYTES, 80e9)


def _tiny_cfg(layers, remat):
    import torch
    from repro_torch.models.config import ArchConfig
    return ArchConfig(name="t", family="dense", num_layers=layers, d_model=64, num_heads=4,
                      num_kv_heads=2, d_ff=128, vocab_size=256, dtype=torch.float32,
                      remat=remat, disc_layers=2, disc_d_model=32, disc_heads=2)


def test_round_peak_with_remat_frees_the_layers_and_counts_the_recompute():
    """``lm_gan_round_peak`` (one device, fake tensors, 2 agents, batch 2 x
    128, K = 2) of a tiny dense config at 1 and 2 layers: with remat the
    predicted peak above resident is lower, by more at 2 layers (each
    layer's intermediates are freed under the op), and the FLOPs exceed
    those without remat by exactly K forwards of every wrapped layer (the
    recompute is counted, as XLA's cost analysis counts the reference's
    rematerialised forward)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.dryrun import lm_gan_round_peak
    from repro_torch.launch.hlo_analysis import count_dispatch
    from repro_torch.models.transformer import DecoderBlock
    r = {(L, remat): lm_gan_round_peak(_tiny_cfg(L, remat), agents=2, batch=2, seq=128, K=2)
         for L in (1, 2) for remat in (False, True)}
    saved = {L: r[L, False]["peak_above_bytes"] - r[L, True]["peak_above_bytes"]
             for L in (1, 2)}
    assert 0 < saved[1] < saved[2]
    assert r[1, True]["resident_bytes"] == r[1, False]["resident_bytes"]
    block = DecoderBlock(_tiny_cfg(1, False))
    with FakeTensorMode():
        p = block.init(torch.Generator().manual_seed(0))
        _, fwd = count_dispatch(lambda: block.apply(p, torch.zeros(2 * 2, 128, 64)))
    for L in (1, 2):
        assert r[L, True]["flops"] - r[L, False]["flops"] == 2 * L * fwd.flops


def test_round_peak_cli_prints_both_routes(capsys):
    from repro_torch.launch import dryrun
    from repro_torch.configs import registry
    small = registry.get_config("qwen3-8b").smoke()
    orig = registry.get_config
    try:
        registry.get_config = lambda name: small
        dryrun.main(["--arch", "qwen3-8b", "--round-peak", "1"])
    finally:
        registry.get_config = orig
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["remat"] for r in recs] == [False, True]
    assert recs[1]["peak_above_bytes"] < recs[0]["peak_above_bytes"]
