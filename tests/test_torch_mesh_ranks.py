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


def _kv_grad_replicated(want, kv):
    """The planted fault: a query-row split attention's k and v gradients
    labelled replicated, each rank's share of them taken for the sum."""
    return kv


def _round_body(rank, shape, axes, plan, fault, cfg_kw=None, seq=16, batch=4):
    from repro_torch.dist import collectives
    from repro_torch.dist.sharding import full_tree, place
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import PLANS, build_train_round
    from repro_torch.models import layers
    from repro_torch.models.config import ShapeConfig
    from repro_torch.tree import tree_leaves

    if fault == "sum":
        collectives._sum_over_agents = _skip_cross_rank_sum
    kv_grad = _kv_grad_replicated if fault == "kv_grad" else layers._kv_grad
    splits = []   # attention calls split by query rows
    layers._kv_grad = lambda want, kv: splits.append(1) or kv_grad(want, kv)
    mesh = make_test_mesh(shape, axes)
    cfg = _cfg(**(cfg_kw or {}))
    K = 2
    shape_cfg = ShapeConfig("train", seq, batch, "train")
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
            "agents_equal": agents_equal, "sharded_leaves": sharded, "row_splits": len(splits),
            "agents": tuple(tree_leaves(out["mesh"]["params"])[0].shape[:2])}


ROUND_CASES = [((2, 2), ("data", "model"), "agents-data"),
               ((2, 2), ("data", "model"), "agents-data-dp"),
               ((2, 2, 1), ("pod", "data", "model"), "agents-pod-fsdp")]


@pytest.mark.parametrize("shape,axes,plan", ROUND_CASES, ids=[c[2] for c in ROUND_CASES])
def test_lm_gan_round_on_a_mesh_matches_unsharded(tmp_path, shape, axes, plan):
    res = run_ranks(tmp_path, _round_body, shape, axes, plan, None)
    assert res["agents"] == ((2, 1) if plan == "agents-pod-fsdp" else (1, 2))
    assert res["sharded_leaves"] > 0
    assert res["grad_err"] <= 1e-5, res
    assert res["step_err"] <= res["bound"], res
    assert res["agents_equal"], res
    assert res["row_splits"] == 0, res       # heads or batch split every attention


def test_planted_fault_skipping_the_cross_rank_sum_fails(tmp_path):
    """A sync that takes each rank's partial mean for the total must break
    the round bound: the check above has teeth."""
    res = run_ranks(tmp_path, _round_body, (2, 2), ("data", "model"), "agents-data", "sum")
    assert res["grad_err"] <= 1e-5           # the local steps are untouched
    assert res["step_err"] > res["bound"], res
    assert not res["agents_equal"]


# 3 query heads of 16 and one kv head, one example an agent: on each
# agent's "model" submesh of 2 ranks neither the heads nor the batch
# divide, so the generator's attention splits its 15 query rows (8 and 7)
ROW_SPLIT = (dict(d_model=48, num_heads=3, num_kv_heads=1), 15, 2)


@pytest.mark.parametrize("fault", [None, "kv_grad"])
def test_lm_gan_round_split_by_query_rows_matches_unsharded(tmp_path, fault):
    """The round with attention split by query rows meets the round
    bounds; with the ranks' k and v gradients labelled replicated instead
    of partial (each rank's rows' share taken for the whole) it fails
    them."""
    res = run_ranks(tmp_path, _round_body, (2, 2), ("data", "model"), "agents-data", fault,
                    *ROW_SPLIT)
    assert res["agents"] == (1, 2)
    assert res["row_splits"] > 0, res
    if fault is None:
        assert res["grad_err"] <= 1e-5, res
        assert res["step_err"] <= res["bound"], res
        assert res["agents_equal"], res
    else:
        # the gradients miss by far (Adam steps each element by about lr
        # whatever its gradient, so the step bound alone is no test here)
        assert res["grad_err"] > 1e-3, res


# 3 query heads of 16 and one kv head: a batch-1 decode's cache on the
# (2, 2) mesh has its keys on "data" and head_dim on "model", and neither
# the heads nor the batch divide either axis
SPLIT_DECODE = dict(d_model=48, num_heads=3, num_kv_heads=1)


def _decode_split_body(rank, steps=4, seq=16):
    """The serving decode step (``build_decode``) on the (2, 2) ranks for
    ``steps`` greedy steps after an 8-token prefill, against the
    unsharded decode fed the same tokens (the unsharded greedy choice):
    each step's largest logit error over max |logit|, the new cache's
    largest error, the decode splits taken and the cache's placements.
    "split": the batch-1 decode at 3/1 heads; "fault": the same with the
    key slices' parts merged without rescaling to their max; "heads": 4/2
    heads at batch 2 (heads and batch split, no new split)."""
    from repro_torch.dist.sharding import full_tree, place
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import build_decode
    from repro_torch.models import layers
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.transformer import Backbone
    from repro_torch.tree import tree_leaves

    mesh = make_test_mesh((2, 2))
    merge, res = layers._merge_keys, {}
    for name, kw, batch in (("split", SPLIT_DECODE, 1), ("fault", SPLIT_DECODE, 1),
                            ("heads", {}, 2)):
        if name == "fault":
            layers._merge_keys = lambda top, part, reduce: reduce(part, "sum")
        cfg = _cfg(**kw)
        bb = Backbone(cfg)
        params = bb.init(torch.Generator().manual_seed(0))
        prompt = torch.randint(0, cfg.vocab_size, (batch, 8),
                               generator=torch.Generator().manual_seed(1))
        ref = bb.prefill(params, prompt, max_seq=seq)
        built = build_decode(cfg, ShapeConfig("d", seq, batch, "decode"), mesh)
        placed = place(params, built.in_shardings[0])
        want_cache = ref["cache"]
        cache = place(want_cache, built.in_shardings[2])
        tok = ref["logits"][:, -1:, :cfg.vocab_size].argmax(-1)
        splits, errs = dict(layers.DECODE_SPLITS), []
        for i in range(8, 8 + steps):
            lg, cache = built.fn(placed, place(tok, built.in_shardings[1]), cache,
                                 torch.tensor(i))
            want, want_cache = bb.decode(params, tok, want_cache, i)
            errs.append(float((lg.full_tensor() - want).abs().max() / want.abs().max()))
            tok = want[:, :, :cfg.vocab_size].argmax(-1)
        layers._merge_keys = merge
        res[name] = {
            "errs": errs,
            "cache_err": max(float((a - b).abs().max()) for a, b in zip(
                tree_leaves(full_tree(cache)), tree_leaves(want_cache))),
            "splits": {k: v - splits[k] for k, v in layers.DECODE_SPLITS.items()},
            "placements": str(tree_leaves(cache)[0].placements)}
    return res


def test_batch1_decode_split_by_keys_and_head_dim_matches_unsharded(tmp_path):
    """The batch-1 serving decode with the cache's keys on "data" and
    head_dim on "model" (2 layers: one key split and one head_dim split
    a layer a step) within 1e-5 of the unsharded decode at every step, its
    cache too; with the parts merged unrescaled it misses; 4/2 heads at
    batch 2 take no new split."""
    res = run_ranks(tmp_path, _decode_split_body)
    split, fault, heads = res["split"], res["fault"], res["heads"]
    assert split["placements"] == "(Shard(dim=2), Shard(dim=4))", split
    assert max(split["errs"]) <= 1e-5 and split["cache_err"] <= 1e-5, split
    assert split["splits"] == {"keys": 8, "head_dim": 8}, split
    assert not max(fault["errs"]) <= 1e-3, fault
    assert max(heads["errs"]) <= 1e-5 and heads["cache_err"] <= 1e-5, heads
    assert heads["splits"] == {"keys": 0, "head_dim": 0}, heads


def _remat_round_body(rank, shape, axes, plan):
    """The built round on the mesh with the config's remat off and on, from
    one state and one set of tokens: (every leaf of the two new states and
    of the two first steps' gradients bit for bit, the remat op's calls)."""
    from repro_torch.dist.sharding import full_tree, place
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import PLANS, build_train_round
    from repro_torch.models import remat as remat_op
    from repro_torch.models.config import ShapeConfig
    from repro_torch.tree import tree_leaves

    mesh = make_test_mesh(shape, axes)
    out, calls = {}, {}
    for remat in (False, True):
        strat = _recording_sync()
        built = build_train_round(_cfg(remat=remat), ShapeConfig("train", 16, 4, "train"),
                                  mesh, plan=PLANS[plan], K=2, strategy=strat)
        state = built.fed.init_state(torch.Generator().manual_seed(0), device="cpu")
        tokens = torch.randint(0, 256, tuple(built.input_sds[1]["tokens"].shape),
                               generator=torch.Generator().manual_seed(1))
        remat_op.reset_calls()
        new, _ = built.fn(place(state, built.in_shardings[0]),
                          place({"tokens": tokens}, built.in_shardings[1]))
        calls[remat] = dict(remat_op.CALLS)
        out[remat] = tree_leaves((full_tree(new), strat.seen[0]))
    same = len(out[False]) == len(out[True]) and all(
        torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
        for a, b in zip(out[False], out[True]))
    return {"same": same, "calls": calls}


def test_remat_round_on_a_tensor_parallel_mesh_is_bit_for_bit(tmp_path):
    """The LM GAN round under agents-data on the (2, 2) ranks, whose agents'
    gradients run by ``torch.autograd`` on DTensors (the "model" submesh
    has 2 ranks): with the config's remat (the op recomputes on DTensors,
    the layout constraints acting) the new state and the gradients equal
    those without, bit for bit."""
    res = run_ranks(tmp_path, _remat_round_body, (2, 2), ("data", "model"), "agents-data")
    assert res["calls"] == {False: {}, True: {"decoder": 2 * 2}}, res
    assert res["same"], res


# ---------------------------------------------------------------------------
# one DP-SGD round (K = 1, SGD) on agent-sharded meshes
# ---------------------------------------------------------------------------

DP_CLIP = 0.05   # well under the per-example norms, so the clip bites


def _noise_on_every_rank(noise, like):
    """The planted fault: each rank adds the whole noise of a weight, its
    shard of the agent grid kept but every other mesh dim summed."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

    from repro_torch.tree import tree_map

    def one(z, p):
        agent = [q if isinstance(q, Shard) and q.dim < 2 else Replicate() for q in p.placements]
        whole = distribute_tensor(z, p.device_mesh, agent, src_data_rank=None)
        return DTensor.from_local(whole.to_local(), p.device_mesh,
                                  [q if isinstance(q, Shard) else Partial() for q in agent],
                                  run_check=False)

    return tree_map(one, noise, like)


def _shard_norm(global_norm):
    """The planted fault: a clip norm taken from each rank's own shards."""
    from repro_torch.dist.sharding import is_sharded
    from repro_torch.tree import tree_map
    return lambda tree: global_norm(tree_map(lambda x: x.to_local() if is_sharded(x) else x,
                                             tree))


def _dp_round_body(rank, shape, axes, plan, fault):
    import dataclasses

    from repro_torch.core import fedgan as fedgan_mod
    from repro_torch.dist.sharding import (AgentShards, batch_axes, full_tree,
                                           named_shardings, place, use_mesh)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import PLANS, build_train_round
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import SGD, optimizer
    from repro_torch.privacy import DPSGD
    from repro_torch.tree import tree_leaves, tree_map

    if fault == "noise":
        fedgan_mod.placed_noise = _noise_on_every_rank
    elif fault == "norm":
        optimizer.global_norm = _shard_norm(optimizer.global_norm)
    mesh = make_test_mesh(shape, axes)
    cfg, K, lr = _cfg(), 1, 1e-4
    out = {}
    for name in ("mesh", "plain"):
        strat = _recording_sync()
        built = build_train_round(cfg, ShapeConfig("train", 16, 4, "train"), mesh,
                                  plan=PLANS[plan], K=K, strategy=strat)
        fed = dataclasses.replace(
            built.fed, cfg=dataclasses.replace(built.fed.cfg, dp=DPSGD(
                clip=DP_CLIP, noise_multiplier=1.0)), opt_g=SGD(), opt_d=SGD())
        state = fed.init_state(torch.Generator().manual_seed(0), device="cpu")
        tokens = torch.randint(0, cfg.vocab_size, tuple(built.input_sds[1]["tokens"].shape),
                               generator=torch.Generator().manual_seed(1))
        gen = torch.Generator().manual_seed(2)
        if name == "mesh":
            specs = built.meta["state_specs"]
            specs = {**specs, **{k: PLANS[plan].specs(state[k], mesh) for k in ("opt_g", "opt_d")}}
            placed = place(state, named_shardings(mesh, specs))
            assert AgentShards.of(placed["params"]) is not None
            with use_mesh(mesh), batch_axes(*PLANS[plan].act_batch_axes):
                new, metrics = fed.round(placed, place({"tokens": tokens},
                                                       built.in_shardings[1]), gen)
            new = full_tree(new)
            metrics = full_tree(metrics)
        else:
            new, metrics = fed.round(state, {"tokens": tokens}, gen)
        out[name] = {"params": new["params"], "grads": strat.seen[0], "metrics": metrics}
    grad_err = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                   for a, b in zip(tree_leaves(out["mesh"]["grads"]),
                                   tree_leaves(out["plain"]["grads"])))
    step_err = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(out["mesh"]["params"]), tree_leaves(out["plain"]["params"])))
    m = tree_map(float, out["plain"]["metrics"])
    return {"grad_err": grad_err, "step_err": step_err, "bound": 2 * K * lr,
            "finite": all(bool(torch.isfinite(x).all())
                          for x in tree_leaves(out["mesh"]["params"])),
            "joint_norm": (m["dp_grad_norm_d"] ** 2 + m["dp_grad_norm_g"] ** 2) ** 0.5,
            "metrics_err": max(abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
                               for a, b in zip(tree_leaves(out["mesh"]["metrics"]),
                                               tree_leaves(out["plain"]["metrics"])))}


@pytest.mark.parametrize("shape,axes,plan", ROUND_CASES, ids=[c[2] for c in ROUND_CASES])
def test_dp_round_on_a_mesh_matches_unsharded(tmp_path, shape, axes, plan):
    """A DP-SGD round (clip and noise) on the agent-sharded state: the
    tensor-parallel plan takes its examples one at a time on the DTensors,
    the data-parallel plans each rank's own examples, summed across the
    ranks; each is the unsharded DP round with the same noise tensors, at
    the round test's tolerance."""
    res = run_ranks(tmp_path, _dp_round_body, shape, axes, plan, None)
    assert res["joint_norm"] > 4 * DP_CLIP, res    # the clip bites
    assert res["finite"], res
    assert res["grad_err"] <= 1e-5, res
    assert res["metrics_err"] <= 1e-5, res
    assert res["step_err"] <= res["bound"], res


@pytest.mark.parametrize("fault", ["noise", "norm"])
def test_planted_dp_mesh_faults_fail(tmp_path, fault):
    """Noise added whole on every tensor-parallel rank, or a clip norm
    taken from a rank's own shards: either breaks the gradient hold above
    on the tensor-parallel plan."""
    res = run_ranks(tmp_path, _dp_round_body, (2, 2), ("data", "model"), "agents-data", fault)
    assert res["grad_err"] > 1e-3, res


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
