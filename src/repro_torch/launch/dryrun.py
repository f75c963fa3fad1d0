"""The production dry run (the twin of ``repro.launch.dryrun``).

For every (architecture x input shape), build the step on the production
mesh, 16x16 (one pod) or 2x16x16 (two pods), and run it once over a fake
process group of 256 or 512 ranks (``torch.testing``'s ``FakeStore`` and
the ``"fake"`` backend: every collective returns at once and moves
nothing) with every input a fake tensor (``FakeTensorMode``): nothing is
allocated at full size.  It records, per rank:

  * memory: the argument bytes (the local shards of the placed inputs;
    ``shard_sum_bytes`` is the same from the specs' arithmetic alone), the
    output bytes, the peak (the arguments plus the high-water mark of what
    the step allocates, ``hlo_analysis.DispatchCount.peak_bytes``) and
    whether it fits one card (``launch.mesh.HBM_BYTES``);
  * FLOPs and bytes of the local ops (``launch.hlo_analysis.program_costs``);
  * collective bytes by mesh axis (``launch.hlo_analysis``);
  * the roofline terms per local step, with the H100 constants of
    ``launch.mesh``.

The mesh is a CPU-typed ``DeviceMesh`` over the fake group, so kernel
wrappers take their plain versions (a fake tensor runs no kernel), and
DTensor moves a shard from one tensor dim to another by an all-gather
and a chunk (its CPU route) where a card mesh runs an all-to-all: those
records bill the gathered bytes.

A fake group cannot share a process with a real one: run the dry run in
its own process (this CLI does; tests start a subprocess).  Results are
cached as JSON under ``--out``, so a sweep resumes.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-4b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes] [--plan agents-data]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-2.7b --round-peak 2 5

``--round-peak`` needs no process group: it predicts one card's LM GAN
round (``lm_gan_round_peak``) with remat off and on.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

def fake_world(world_size: int) -> None:
    """Start a fake process group of ``world_size`` ranks, this process rank
    0, unless one of that size is already up."""
    import torch.distributed as dist
    if dist.is_initialized():
        backend = dist.get_backend()
        if backend != "fake" or dist.get_world_size() != world_size:
            raise RuntimeError(
                f"a {backend} process group of {dist.get_world_size()} ranks is running; "
                f"the dry run needs a fake group of {world_size}: run it in its own process")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def place_local(built, args):
    """``args`` (full tensors, one tree per input of ``built``) placed by the
    step's ``in_shardings``, each rank keeping its own chunk
    (``distribute_tensor`` with no source rank: nothing moves between
    ranks, so a fake group serves); leaves with no sharding as they are."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.dist.sharding import _zip_place
    from repro_torch.tree import tree_map

    def one(x, sh):
        if sh is None or x is None:
            return x
        return distribute_tensor(x, sh.mesh, sh.placements, src_data_rank=None)

    return tuple(_zip_place(one, a, sh if sh is not None else tree_map(lambda _: None, a))
                 for a, sh in zip(args, built.in_shardings))


def fake_inputs(built):
    """Fake tensors for every input of ``built``, placed by its shardings
    (DTensors of this rank's local shards).  Call under ``FakeTensorMode``."""
    from repro_torch.tree import tree_map
    return place_local(built, [tree_map(lambda s: torch.empty(tuple(s.shape), dtype=s.dtype),
                                        sds) for sds in built.input_sds])


def spec_local_bytes(built) -> int:
    """Bytes of this rank's (rank 0's) shards of every input of ``built``,
    from the shapes and the partition specs alone: a dim sharded over axes
    of n ranks in all keeps its first chunk, ceil(size / n) elements (the
    chunking of ``torch.chunk``)."""
    from torch.utils._pytree import tree_leaves

    from repro_torch.dist.sharding import mesh_dims
    total = 0
    for sds, shs in zip(built.input_sds, built.in_shardings):
        leaves = tree_leaves(sds)
        specs = tree_leaves(shs) if shs is not None else [None] * len(leaves)
        for x, sh in zip(leaves, specs):
            n = x.element_size()
            dims = mesh_dims(sh.mesh) if sh is not None else {}
            for d, size in enumerate(x.shape):
                entry = sh.spec[d] if sh is not None and d < len(sh.spec) else None
                axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
                n *= math.ceil(size / math.prod(dims[a] for a in axes))
            total += n
    return total


def _roofline(flops, hbm_bytes, by_axis, crossing: tuple) -> dict:
    """Seconds of one local step on one H100 by each bound.  Collectives on
    axes that cross nodes (``crossing``: "agent" and/or "model") run at the
    per-card NIC rate, the rest at NVLink's; ``collective_s_nvlink`` is
    the all-NVLink figure for comparison."""
    from repro_torch.launch.mesh import HBM_BW, NODE_BW, NVLINK_BW, PEAK_FLOPS_BF16
    total = sum(by_axis.values())
    slow = sum(v for k, v in by_axis.items() if k in crossing or k == "other")
    terms = {"compute_s": flops / PEAK_FLOPS_BF16, "memory_s": hbm_bytes / HBM_BW,
             "collective_s": (total - slow) / NVLINK_BW + slow / NODE_BW,
             "collective_s_nvlink": total / NVLINK_BW}
    terms["dominant"] = max(("compute_s", "memory_s", "collective_s"), key=terms.get)
    return terms


def run_pair(arch: str, shape_name: str, *, multi_pod: bool = False,
             plan: str = "agents-data", mode: str = "fedgan", K: int = 20,
             ring_cache: bool = False, fsdp: bool = False, sync_dtype: str = "",
             intra: int = 0, analyze: bool = False, cfg=None, shape=None,
             mesh_shape=None) -> dict:
    """Dry-run one (arch x shape) pair on the production mesh (a fake group
    of its size is started if none is up).  ``cfg``/``shape``/``mesh_shape``
    override the registry's config (a cut one: ``get_config(arch).scaled(
    num_layers=n)``), shape and the production mesh."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs.registry import get_config, get_shape, pair_supported
    from repro_torch.launch.hlo_analysis import CollectiveStats, count_dispatch, tree_bytes
    from repro_torch.launch.mesh import HBM_BYTES, make_mesh, mesh_dims, node_crossing_axes
    from repro_torch.launch.steps import PLANS, build_step, round_donation

    rec = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod, "plan": plan,
           "mode": mode, "ring_cache": ring_cache, "fsdp": fsdp, "sync_dtype": sync_dtype,
           "intra_interval": intra}
    if cfg is None:
        ok, why = pair_supported(arch, shape_name)
        if not ok:
            rec.update(status="skipped", reason=why)
            return rec
        cfg = get_config(arch)
    shape = shape or get_shape(shape_name)
    mshape = tuple(mesh_shape or ((2, 16, 16) if multi_pod else (16, 16)))
    axes = ("pod", "data", "model") if len(mshape) == 3 else ("data", "model")
    fake_world(math.prod(mshape))
    mesh = make_mesh(mshape, axes, device="cpu")

    kw = {}
    if shape.kind == "train":
        kw = dict(plan=PLANS[plan], K=K, mode=mode, intra_interval=intra,
                  sync_dtype=torch.bfloat16 if sync_dtype == "bf16" else None)
    elif shape.kind == "decode":
        kw = dict(ring_cache=ring_cache, fsdp=fsdp)
    else:
        kw = dict(fsdp=fsdp)

    t0 = time.perf_counter()
    built = build_step(cfg, shape, mesh, **kw)
    t_build = time.perf_counter() - t0
    with FakeTensorMode():
        args = fake_inputs(built)
        audit = None
        if analyze:
            from repro_torch.analysis.trace import TraceAudit
            audit = TraceAudit(f"built.{built.meta.get('kind', 'step')}")
        t1 = time.perf_counter()
        if audit is None:
            out, counts = count_dispatch(built.fn, *args, mesh=mesh)
        else:
            with audit:
                out, counts = count_dispatch(built.fn, *args, mesh=mesh)
        t_run = time.perf_counter() - t1
    arg_bytes = tree_bytes(args)
    peak = arg_bytes + counts.peak_bytes
    mem = {"argument_bytes": arg_bytes, "shard_sum_bytes": spec_local_bytes(built),
           "output_bytes": tree_bytes(out), "peak_bytes": peak, "fits": peak <= HBM_BYTES}
    if analyze:
        from repro_torch.analysis.trace import donation_findings
        rec["analysis"] = [f.to_json() for f in audit.findings + donation_findings(
            built, round_donation(built))]

    dims = mesh_dims(mesh)
    stats = CollectiveStats.from_records(counts.records)
    by_axis = stats.bytes_by_axis(dims)
    steps = K if shape.kind == "train" else 1
    crossing = node_crossing_axes(mshape, axes)
    roof = _roofline(counts.flops / steps, counts.hbm_bytes / steps,
                     {k: v / steps for k, v in by_axis.items()},
                     tuple(sorted({"agent" if a in ("pod", "data") else "model"
                                   for a in crossing})))
    rec.update(
        status="ok", mesh="x".join(map(str, mshape)), build_s=round(t_build, 2),
        run_s=round(t_run, 2), memory=mem, flops=counts.flops,
        bytes_accessed=counts.hbm_bytes, op_count=counts.op_count, steps_per_call=steps,
        collectives=stats.summary(), collective_by_axis=by_axis,
        once_per_call_by_axis=CollectiveStats.from_records(
            counts.records, skip_loops=True).bytes_by_axis(dims),
        node_crossing_axes=list(crossing), roofline_per_step=roof,
        meta={k: v for k, v in built.meta.items() if k != "state_specs"})
    return rec


def lm_gan_round_peak(cfg, *, agents: int = 2, batch: int = 2, seq: int = 2048,
                      K: int = 2) -> dict:
    """One LM GAN round (``make_lm_gan_task``, ``agents`` on a (1, agents)
    grid, K steps, Adam, ``FedAvgSync``) of the ArchConfig ``cfg`` on one
    device without a mesh, run on fake tensors under
    ``hlo_analysis.count_dispatch``: its state's and batches' bytes
    (resident before the round), the high-water mark of what the round
    allocates beside them, and its FLOPs.  What one card would hold for
    such a round, with ``cfg.remat`` on or off, before any card runs it."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.core import FedGAN, FedGANConfig
    from repro_torch.launch.hlo_analysis import count_dispatch, tensor_bytes
    from repro_torch.launch.steps import make_lm_gan_task
    from repro_torch.optim import Adam
    from repro_torch.tree import tree_leaves
    fed = FedGAN(make_lm_gan_task(cfg), FedGANConfig(agent_grid=(1, agents), sync_interval=K),
                 opt_g=Adam(), opt_d=Adam())
    with FakeTensorMode():
        state = fed.init_state(torch.Generator().manual_seed(0), device="cpu")
        batches = {"tokens": torch.zeros((K, 1, agents, batch, seq), dtype=torch.int64)}
        _, counts = count_dispatch(fed.round, state, batches)
        resident = sum(tensor_bytes(x) for x in tree_leaves((state, batches)))
    return {"arch": cfg.name, "layers": cfg.num_layers, "remat": cfg.remat, "agents": agents,
            "batch": batch, "seq": seq, "K": K, "resident_bytes": resident,
            "peak_above_bytes": counts.peak_bytes, "flops": counts.flops}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun",
                                 description="Dry-run (arch x shape) pairs on the production "
                                             "mesh over a fake process group.")
    ap.add_argument("--arch", default="")
    ap.add_argument("--shape", default="")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--plan", default="agents-data")
    ap.add_argument("--mode", default="fedgan")
    ap.add_argument("--K", type=int, default=20)
    ap.add_argument("--ring-cache", action="store_true")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--sync-dtype", default="")
    ap.add_argument("--intra", type=int, default=0)
    ap.add_argument("--out", default="results/dryrun",
                    help="directory of the JSON records, one a pair (a pair already "
                         "there is not run again)")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--analyze", action="store_true",
                    help="run the repro_torch.analysis trace audit on each built step "
                         "and record its findings in the JSON")
    ap.add_argument("--round-peak", metavar="LAYERS", type=int, nargs="+",
                    help="instead: the memory of --arch's LM GAN round on one device at "
                         "each depth, with remat off and on (lm_gan_round_peak: 2 agents, "
                         "batch 2 x 2,048 tokens, K = 2, Adam); one JSON line each")
    args = ap.parse_args(argv)
    if args.round_peak:
        from repro_torch.configs.registry import get_config
        for layers in args.round_peak:
            for remat in (False, True):
                cfg = get_config(args.arch).scaled(num_layers=layers, remat=remat)
                print(json.dumps(lm_gan_round_peak(cfg)), flush=True)
        return

    from repro_torch.configs.registry import list_archs
    from repro_torch.models.config import SHAPES

    os.makedirs(args.out, exist_ok=True)
    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    if args.both_meshes:
        # one fake group a process: each mesh size runs in a process of its own
        import subprocess
        import sys
        for mp in (False, True):
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   *[a for a in (argv if argv is not None else sys.argv[1:])
                     if a not in ("--both-meshes", "--multi-pod")]] + (
                       ["--multi-pod"] if mp else [])
            subprocess.run(cmd, check=True)
        return
    mp = args.multi_pod
    for arch in archs:
        for shape in shapes:
            key = f"{args.tag}__{arch}__{shape}__{'2x16x16' if mp else '16x16'}"
            path = os.path.join(args.out, key + ".json")
            if os.path.exists(path):
                print(f"[cached] {key}")
                continue
            print(f"[run]    {key} ...", flush=True)
            try:
                rec = run_pair(arch, shape, multi_pod=mp, plan=args.plan,
                               mode=args.mode, K=args.K, ring_cache=args.ring_cache,
                               fsdp=args.fsdp, sync_dtype=args.sync_dtype,
                               intra=args.intra, analyze=args.analyze)
            except Exception as e:  # a failed pair is recorded: it is a bug to fix
                rec = {"arch": arch, "shape": shape, "multi_pod": mp, "status": "error",
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-4000:]}
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            extra = ""
            if rec["status"] == "ok":
                r = rec["roofline_per_step"]
                extra = (f" run={rec['run_s']}s dom={r['dominant']}"
                         f" c={r['compute_s'] * 1e3:.2f}ms m={r['memory_s'] * 1e3:.2f}ms"
                         f" coll={r['collective_s'] * 1e3:.2f}ms"
                         f" peak/rank={rec['memory']['peak_bytes'] / 2 ** 30:.2f}GiB"
                         f"{'' if rec['memory']['fits'] else ' (over one card)'}")
            elif rec["status"] == "error":
                extra = " " + rec["error"][:160]
            else:
                extra = " " + rec.get("reason", "")
            print(f"[{rec['status']}] {key}{extra}", flush=True)


if __name__ == "__main__":
    main()
