"""The port's sharded paths on CPU ranks: four gloo processes build a
``DeviceMesh`` and hold serving and the LM GAN round on it against the
unsharded port.

Every rank runs the same program (every collective, ``full_tensor``
included, is called by all of them); each test's ranks meet through a
``file://`` store under its ``tmp_path``, and the test bounds its wait
with a join timeout, so a hung rank fails that test alone.  The arch is
the reference test's dense one (2 layers, d_model 64, 4/2 heads, d_ff
128, vocab 256, float32)."""
import multiprocessing as mp
import os
import queue
import traceback

import pytest
import torch

WORLD = 4
JOIN_TIMEOUT = 240


def _cfg(**kw):
    from repro_torch.models.config import ArchConfig
    base = dict(name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
                num_kv_heads=2, d_ff=128, vocab_size=256, dtype=torch.float32, remat=False,
                disc_layers=2, disc_d_model=32, disc_heads=2)
    return ArchConfig(**{**base, **kw})


def _rank_main(rank, store, body, args, results):
    try:
        import torch.distributed as dist
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=WORLD)
        try:
            out = body(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:
        results.put((rank, False, traceback.format_exc()))


def run_ranks(tmp_path, body, *args):
    """``body(rank, *args)`` on WORLD gloo ranks; returns rank 0's result.
    A rank's exception, a hang or a crash fails the calling test."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = os.path.join(str(tmp_path), "store")
    procs = [ctx.Process(target=_rank_main, args=(r, store, body, args, results))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(WORLD):
            rank, ok, out = results.get(timeout=JOIN_TIMEOUT)
            assert ok, f"rank {rank} failed:\n{out}"
            got[rank] = out
    except queue.Empty:
        pytest.fail(f"ranks {sorted(set(range(WORLD)) - set(got))} gave no result "
                    f"within {JOIN_TIMEOUT} s")
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    return got[0]


# ---------------------------------------------------------------------------
# serving on a (2, 2) ("data", "model") mesh
# ---------------------------------------------------------------------------


def _greedy(bb, params, prompt, n, tol):
    """Batch-1 greedy decode of ``n`` tokens and, per step, whether its
    top-two logit gap exceeds ``tol`` times the largest |logit|."""
    cache = bb.init_cache(1, len(prompt) + n, device="cpu")
    toks, out, clear = list(prompt), [], []
    for i in range(len(prompt) + n - 1):
        lg, cache = bb.decode(params, torch.tensor([[toks[i]]]), cache, i)
        if i >= len(prompt) - 1:
            row = lg[0, 0, :bb.cfg.vocab_size]
            top = torch.topk(row, 2).values
            clear.append(bool(top[0] - top[1] > tol * row.abs().max()))
            out.append(int(row.argmax()))
            toks.append(out[-1])
    return out, clear


def _serving_body(rank):
    from repro_torch.dist.sharding import (full_tree, named_shardings, param_specs, place,
                                           use_mesh)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import build_decode, build_prefill
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.transformer import Backbone
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.tree import tree_leaves

    tol = 1e-5
    mesh = make_test_mesh((2, 2))
    cfg = _cfg()
    bb = Backbone(cfg)
    params = bb.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (4, 16), generator=torch.Generator().manual_seed(1))
    errs = {}

    built = build_prefill(cfg, ShapeConfig("p", 16, 4, "prefill"), mesh)
    out = built.fn(place(params, built.in_shardings[0]), place(tokens, built.in_shardings[1]))
    want = bb.prefill(params, tokens, logits_mode="last")["logits"]
    errs["prefill"] = float((out["logits"].full_tensor() - want).abs().max() /
                            want.abs().max())
    sharded = [type(x).__name__ for x in tree_leaves(out["cache"])]

    built = build_decode(cfg, ShapeConfig("d", 24, 4, "decode"), mesh)
    ref = bb.prefill(params, tokens, max_seq=24)
    cache = place(ref["cache"], built.in_shardings[2])
    lg, new_cache = built.fn(place(params, built.in_shardings[0]),
                             place(tokens[:, :1], built.in_shardings[1]), cache,
                             torch.tensor(16))
    want, want_cache = bb.decode(params, tokens[:, :1], ref["cache"], 16)
    errs["decode"] = float((lg.full_tensor() - want).abs().max() / want.abs().max())
    errs["decode_cache"] = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(full_tree(new_cache)), tree_leaves(want_cache)))

    # the kernel routes on local shards: flash with q and kv heads sharded
    # over "model", the SSD scan with its heads sharded (their plain
    # versions here, called on each rank's shards as the kernels are)
    flash = Backbone(cfg, use_flash=True)
    with use_mesh(mesh):
        got = flash.prefill(place(params, named_shardings(mesh, param_specs(params, mesh))),
                            tokens)["logits"]
    want = bb.prefill(params, tokens)["logits"]
    errs["flash_prefill"] = float((got.full_tensor() - want).abs().max() / want.abs().max())
    scfg = _cfg(family="ssm", ssm_state=16, ssm_heads=8, ssm_chunk=8)
    sparams = Backbone(scfg).init(torch.Generator().manual_seed(2))
    with use_mesh(mesh):
        got = Backbone(scfg, use_ssd_kernel=True).prefill(
            place(sparams, named_shardings(mesh, param_specs(sparams, mesh))), tokens)
    want = Backbone(scfg).prefill(sparams, tokens)
    errs["ssd_prefill"] = float((got["logits"].full_tensor() - want["logits"]).abs().max() /
                                want["logits"].abs().max())
    errs["ssd_state"] = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(full_tree(got["cache"])), tree_leaves(want["cache"])))

    eng = ServeEngine(cfg, max_batch=2, max_seq=32, min_bucket=8, params=params, mesh=mesh,
                      device="cpu")
    placements = {str(x.placements) for x in tree_leaves(eng.cache)}
    work = [(list(range(1, 5)), 6), (list(range(3, 12)), 5), (list(range(7, 10)), 4)]
    rids = [eng.submit(p, max_new_tokens=n) for p, n in work]
    done = eng.run()
    engine = []
    for rid, (prompt, n) in zip(rids, work):
        ref_toks, clear = _greedy(bb, params, prompt, n, tol)
        engine.append((done[rid].generated, ref_toks, clear))
    return {"errs": errs, "cache_types": sharded, "engine": engine,
            "placements": placements}


def test_serving_on_a_2x2_mesh_matches_unsharded(tmp_path):
    res = run_ranks(tmp_path, _serving_body)
    for name, err in res["errs"].items():
        assert err <= 1e-5, (name, err)
    assert set(res["cache_types"]) == {"DTensor"}
    # the engine's cache is sharded: batch over "data", kv heads over "model"
    assert "(Shard(dim=1), Shard(dim=3))" in res["placements"]
    for got, want, clear in res["engine"]:
        n = clear.index(False) + 1 if False in clear else len(want)
        assert got[:n] == want[:n], (got, want, clear)


# ---------------------------------------------------------------------------
# one LM GAN round (K = 2) on agent-sharded meshes
# ---------------------------------------------------------------------------


def _recording_sync():
    """A FedAvgSync that keeps the first step's fused gradients, gathered
    (the grad hook sees every agent's), in its ``seen``."""
    from repro_torch.core.strategies import FedAvgSync
    from repro_torch.dist.sharding import full_tree

    class Recording(FedAvgSync):
        def grad_hook(self, fed, grad_disc, grad_gen, state):
            if not self.seen:
                self.seen.append(full_tree({"disc": grad_disc, "gen": grad_gen}))
            return grad_disc, grad_gen

    strat = Recording()
    object.__setattr__(strat, "seen", [])
    return strat


def _skip_cross_rank_sum(m):
    """The planted fault: the partial means relabelled as the total, with
    no reduce across ranks."""
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(m.to_local(), m.device_mesh,
                              [Replicate() if p.is_partial() else p for p in m.placements],
                              run_check=False)


def _round_body(rank, shape, axes, plan, fault):
    from repro_torch.dist import collectives
    from repro_torch.dist.sharding import full_tree, place
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import PLANS, build_train_round
    from repro_torch.models.config import ShapeConfig
    from repro_torch.tree import tree_leaves

    if fault:
        collectives._sum_over_agents = _skip_cross_rank_sum
    mesh = make_test_mesh(shape, axes)
    cfg = _cfg()
    K = 2
    shape_cfg = ShapeConfig("train", 16, 4, "train")
    out = {}
    for name in ("mesh", "plain"):
        strat = _recording_sync()
        built = build_train_round(cfg, shape_cfg, mesh, plan=PLANS[plan], K=K, strategy=strat)
        fed = built.fed
        state = fed.init_state(torch.Generator().manual_seed(0), device="cpu")
        tokens = torch.randint(0, cfg.vocab_size, tuple(built.input_sds[1]["tokens"].shape),
                               generator=torch.Generator().manual_seed(1))
        if name == "mesh":
            placed = place(state, built.in_shardings[0])
            sharded = sum(any(p.is_shard() for p in x.placements)
                          for x in tree_leaves(placed["params"]))
            new, _ = built.fn(placed, place({"tokens": tokens}, built.in_shardings[1]))
            new = full_tree(new)
        else:
            new, _ = fed.round(state, {"tokens": tokens})
        out[name] = {"params": new["params"], "grads": strat.seen[0]}
    grad_err = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                   for a, b in zip(tree_leaves(out["mesh"]["grads"]),
                                   tree_leaves(out["plain"]["grads"])))
    lr = 1e-4  # build_train_round's constant step size
    bound = 2 * K * lr
    step_err = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(out["mesh"]["params"]), tree_leaves(out["plain"]["params"])))
    agents_equal = all(bool((x == x[:1, :1]).all()) for x in tree_leaves(out["mesh"]["params"]))
    return {"grad_err": grad_err, "step_err": step_err, "bound": bound,
            "agents_equal": agents_equal, "sharded_leaves": sharded,
            "agents": tuple(tree_leaves(out["mesh"]["params"])[0].shape[:2])}


ROUND_CASES = [((2, 2), ("data", "model"), "agents-data"),
               ((2, 2), ("data", "model"), "agents-data-dp"),
               ((2, 2, 1), ("pod", "data", "model"), "agents-pod-fsdp")]


@pytest.mark.parametrize("shape,axes,plan", ROUND_CASES, ids=[c[2] for c in ROUND_CASES])
def test_lm_gan_round_on_a_mesh_matches_unsharded(tmp_path, shape, axes, plan):
    res = run_ranks(tmp_path, _round_body, shape, axes, plan, False)
    assert res["agents"] == ((2, 1) if plan == "agents-pod-fsdp" else (1, 2))
    assert res["sharded_leaves"] > 0
    assert res["grad_err"] <= 1e-5, res
    assert res["step_err"] <= res["bound"], res
    assert res["agents_equal"], res


def test_planted_fault_skipping_the_cross_rank_sum_fails(tmp_path):
    """A sync that takes each rank's partial mean for the total must break
    the round bound: the check above has teeth."""
    res = run_ranks(tmp_path, _round_body, (2, 2), ("data", "model"), "agents-data", True)
    assert res["grad_err"] <= 1e-5           # the local steps are untouched
    assert res["step_err"] > res["bound"], res
    assert not res["agents_equal"]


def _coded_sync_body(rank):
    """One FedAvgSync(codec=IntQuant(8)) sync of a trained-looking state:
    on the mesh it runs on gathered inputs, so it equals the unsharded
    sync bit for bit, and so does the plain float32 sync (two agents, one
    a rank: the cross-rank sum adds in agent order)."""
    from repro_torch.comm import IntQuant
    from repro_torch.core.strategies import FedAvgSync
    from repro_torch.dist.sharding import full_tree, place, use_mesh
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import AGENTS_DATA, build_train_round
    from repro_torch.models.config import ShapeConfig
    from repro_torch.tree import tree_leaves, tree_map

    mesh = make_test_mesh((2, 2))
    res = {}
    for name, strat in (("int8", FedAvgSync(codec=IntQuant(8))), ("plain", FedAvgSync())):
        built = build_train_round(_cfg(), ShapeConfig("train", 16, 4, "train"), mesh,
                                  plan=AGENTS_DATA, K=2, strategy=strat)
        fed = built.fed
        state = fed.init_state(torch.Generator().manual_seed(0), device="cpu")
        gen = torch.Generator().manual_seed(3)
        state["params"] = tree_map(
            lambda x: x + 0.01 * torch.randn(x.shape, generator=gen), state["params"])
        want = strat.round_sync(fed, state)
        with use_mesh(mesh):
            got = full_tree(strat.round_sync(fed, place(state, built.in_shardings[0])))
        res[name] = all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want)))
    return res


def test_coded_sync_on_gathered_inputs_matches_unsharded(tmp_path):
    assert run_ranks(tmp_path, _coded_sync_body) == {"int8": True, "plain": True}


# ---------------------------------------------------------------------------
# device-resident data placement
# ---------------------------------------------------------------------------


def _place_body(rank):
    from repro_torch.data import DeviceFederatedData
    from repro_torch.launch.mesh import make_test_mesh

    mesh = make_test_mesh((2, 2, 1), ("pod", "data", "model"))
    agent_data = [{"x": torch.full((3 + i, 2), float(i))} for i in range(4)]
    data = DeviceFederatedData.from_agent_data(agent_data, (2, 2), 2, device="cpu", mesh=mesh)
    p, a = mesh.get_local_rank("pod"), mesh.get_local_rank("data")
    local = data.data["x"].to_local()
    # every rank checks that it holds agent (p, a), and only that agent
    assert tuple(local.shape) == (1, 1, 6, 2), local.shape
    assert bool((local[0, 0] == float(2 * p + a)).all()), (rank, p, a, local)
    assert int(data.sizes.to_local()[0, 0]) == 3 + 2 * p + a
    assert data.sizes.shape == (2, 2)
    return True


def test_device_data_place_puts_each_agent_on_its_rank(tmp_path):
    assert run_ranks(tmp_path, _place_body)
