"""Where a round's time goes: rounds of an experiment under
``torch.profiler``, on the card unless told otherwise.

    PYTHONPATH=src python -m repro_torch.run.profile --experiment image_acgan
    PYTHONPATH=src python -m repro_torch.run.profile --experiment image_acgan --codec int8
    PYTHONPATH=src python -m repro_torch.run.profile --experiment image_acgan \
        --codec int4 --topk 0.25             # the composed coded sync
    PYTHONPATH=src python -m repro_torch.run.profile --experiment image_acgan \
        --codec int8 --composed              # int8, fused_sync=False
    PYTHONPATH=src python -m repro_torch.run.profile --experiment image_acgan \
        --strategy distributed [--sync-dtype bf16]   # the per-step baseline
    PYTHONPATH=src python -m repro_torch.run.profile --experiment mixed_gaussian  # any of the six
    PYTHONPATH=src python -m repro_torch.run.profile --arch gemma3-4b    # prefill + decode
    PYTHONPATH=src python -m repro_torch.run.profile --arch mamba2-2.7b  # forward
    PYTHONPATH=src python -m repro_torch.run.profile --arch zamba2-7b    # forward

One warm-up round, then ``--rounds`` rounds timed on the host clock
without the profiler, then the same number under it (CPU and CUDA
activities).  With ``--captured`` (the card only) the warm-up round also
captures the round in a CUDA graph (``repro_torch.run.graph``) and the
timed rounds are replays, as the driver runs a chunk of
``rounds_per_chunk``.  Prints one JSON object: milliseconds per round with and
without the profiler, the device busy share (the time in which some
device kernel ran, the union of the kernels' intervals, over the profiled
wall time), the number of device streams the kernels ran on, the summed
kernel time split into convolutions and matrix products, the sync kernels
and everything else (kernels that overlap count in each), and the kernels
that take the most device time, and each sync kernel's calls and device
ms per round.  The sync
kernels are fedavg (all three routes), qsync and the four qpack kernels; the top-k
selection's sort and the composed path's small PyTorch operations count as
everything else.  On the CPU the device numbers are null.

``--arch`` profiles a backbone at full width instead (random weights from
a seed, bfloat16 compute, through its kernels: ``use_flash`` for the
attention archs, ``use_ssd_kernel`` for the SSM and the hybrid), at
``chip_smoke.py``'s shapes: for gemma3-4b one prefill of 2 x 2,048 tokens
and decode steps with a per-row index, for mamba2-2.7b and zamba2-7b one
forward, whose kernel is the SSD scan's three phases; each part timed
without the profiler, then under it, with its device busy share, the
device time of its kernel, of the bfloat16 copy kernels (the
float32-to-bfloat16 casts: of the weights, which the reference's
``.astype`` asks for on every call, and of activations such as RoPE's
outputs and the probabilities), and of everything else, and its top
kernels.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.comm import codec_from_flags
from repro_torch.configs.paper_gans import ALL_EXPERIMENTS
from repro_torch.configs.registry import list_archs
from repro_torch.core import STRATEGIES, FedAvgSync, get_strategy
from repro_torch.data.federated import round_key_schedule
from repro_torch.launch.train import _SYNC_DTYPES, experiment_spec
from repro_torch.run.graph import CapturedRound

SYNC_KERNELS = ("fedavg_", "qsync_kernel", "qpack_")
MATMUL_MARKS = ("conv", "gemm", "xmma", "cudnn", "cutlass", "wgrad", "dgrad", "nvjet")


def _category(name: str) -> str:
    low = name.lower()
    if any(k in name for k in SYNC_KERNELS):
        return "sync"
    if any(k in low for k in MATMUL_MARKS):
        return "conv_matmul"
    return "other"


def profile_rounds(name="image_acgan", *, codec="", topk=0.0, composed=False,
                   strategy=None, rounds=2, top=12, device="cuda", captured=False,
                   **spec_kw) -> dict:
    """``codec`` and ``topk`` as the training CLI's flags (error feedback
    on); ``composed`` forces the per-leaf pipeline (``fused_sync=False``).
    ``strategy`` (a ``SyncStrategy``) profiles that sync instead, and
    does not combine with the coded sync's knobs.  ``captured`` replays
    a captured graph of the round (the card only)."""
    if strategy is not None and (codec or topk or composed):
        raise ValueError("codec, topk and composed build the coded FedAvgSync; "
                         f"they do not combine with strategy={strategy.name!r}")
    c = codec_from_flags(codec, topk=topk)
    if strategy is None and c is not None:
        strategy = FedAvgSync(codec=c, fused_sync=False if composed else None)
    spec, _ = experiment_spec(name, strategy=strategy, log_every=0, device=device,
                              **spec_kw)
    fed = spec.build()
    return {"experiment": name, "codec": c.name if c is not None else None,
            "strategy": fed.cfg.resolve_strategy().name, "captured": captured,
            "fused_sync": None if c is None else not composed and c.fused_sync_spec() is not None,
            **profile_spec(spec, rounds=rounds, top=top, captured=captured)}


def profile_spec(spec, *, rounds=2, top=12, captured=False) -> dict:
    """Where the rounds of ``spec`` (a ``launch.train.RunSpec``: an
    experiment's, or the LM GAN's of ``arch_smoke_spec`` or one built at
    another width) spend their time, as the module's docstring says."""
    dev = torch.device(spec.device)
    fed, data = spec.build(), spec.build_data()
    state = fed.init_state(torch.Generator().manual_seed(spec.seed), device=dev)
    gens = iter(round_key_schedule(spec.seed + 1, 2 * rounds + 1, dev))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if captured and dev.type != "cuda":
        raise ValueError("captured rounds need the card")
    runner = None

    def run(n):
        """Milliseconds per round over ``n`` rounds."""
        nonlocal state
        t0 = time.perf_counter()
        for _ in range(n):
            if runner is not None:
                runner.replay(next(gens))
            else:
                state, _ = fed.round_from_data(state, data, next(gens))
        sync()
        return (time.perf_counter() - t0) / n * 1e3

    if captured:                            # warm-up round, then the capture
        runner = CapturedRound(fed, data, state, next(gens))
    else:
        run(1)                              # warm-up: cuDNN picks algorithms
    plain_ms = run(rounds)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        profiled_ms = run(rounds)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = _busy_us(prof)
    split = {"conv_matmul": 0.0, "sync": 0.0, "other": 0.0}
    for e in kernels:
        split[_category(e.key)] += e.self_device_time_total / 1e3 / rounds
    on_card = dev.type == "cuda"
    return {
        "rounds": rounds,
        "K": spec.K, "agents": fed.cfg.num_agents, "batch": spec.batch_size,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "ms_per_round": plain_ms, "ms_per_round_profiled": profiled_ms,
        "device_busy_share": busy_us / 1e3 / (profiled_ms * rounds) if on_card else None,
        "device_streams": len({e.device_resource_id for e in prof.events()
                               if e.device_type == torch.autograd.DeviceType.CUDA})
        if on_card else None,
        "device_ms_per_round": split if on_card else None,
        "sync_kernels": {e.key[:120]: {"calls_per_round": e.count / rounds,
                                       "ms_per_round": e.self_device_time_total / 1e3 / rounds}
                         for e in kernels if _category(e.key) == "sync"} if on_card else None,
        "top_kernels": [{"name": e.key[:120], "calls_per_round": e.count / rounds,
                         "ms_per_round": e.self_device_time_total / 1e3 / rounds}
                        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]],
    }


def _busy_us(prof) -> float:
    """Microseconds in which some device kernel ran: the union of the
    kernels' intervals, so kernels that overlap (a graph's parallel
    branches, several streams) count once."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


BF16_COPY_MARK = "bfloat16_copy_kernel"


def _device_split(prof, calls, kernel_mark, top):
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / 1e3 / calls
    kern = sum(e.self_device_time_total for e in kernels if kernel_mark in e.key) / 1e3 / calls
    copy = sum(e.self_device_time_total for e in kernels if BF16_COPY_MARK in e.key) / 1e3 / calls
    return total, {
        "device_ms": total, "kernel_ms": kern, "bf16_copy_ms": copy,
        "other_ms": total - kern - copy,
        "launches": sum(e.count for e in kernels) / calls,
        "top_kernels": [{"name": e.key[:120], "calls": e.count / calls,
                         "ms": e.self_device_time_total / 1e3 / calls}
                        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]]}


def profile_backbone(arch="gemma3-4b", *, batch=2, seq=2048, steps=4, top=8,
                     device="cuda") -> dict:
    """Where a backbone's time goes at full width (see the module's
    docstring).  Needs the card: the device times are the point."""
    from repro_torch import resolve_device
    from repro_torch.configs.registry import get_config
    from repro_torch.models import Backbone
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("profile --arch measures device time: it needs the card")
    cfg = get_config(arch)
    ssm = cfg.family in ("ssm", "hybrid")   # one forward, the SSD scan's device time
    bb = Backbone(cfg, use_ssd_kernel=ssm, use_flash=cfg.family != "ssm")
    mark = "::ssd_" if ssm else "flash_fwd"   # the SSD scan's three phase kernels
    params = bb.init(torch.Generator(device=dev).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (batch, seq),
                         generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def timed(fn, calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e3

    def part(fn, calls):
        fn(0)                                   # warm-up: cuBLAS picks its kernels
        ms = timed(fn, calls)
        with profile(activities=acts) as prof:
            profiled = timed(fn, calls)
        busy, split = _device_split(prof, calls, mark, top)
        return {"ms": ms, "ms_profiled": profiled, "device_busy_share": busy / profiled,
                **split}

    out = {"arch": arch, "batch": batch, "seq": seq,
           "device": torch.cuda.get_device_name(dev)}
    if ssm:
        out["forward"] = part(lambda i: bb.apply(params, toks), 1)
        return out
    out["prefill"] = part(lambda i: bb.prefill(params, toks, max_seq=seq + 3 * steps + 1), 1)
    cache = bb.prefill(params, toks, max_seq=seq + 3 * steps + 1)["cache"]
    tok = toks[:, -1:]
    state = {"cache": cache, "pos": seq}

    def step(i):
        index = torch.full((batch,), state["pos"], device=dev)
        _, state["cache"] = bb.decode(params, tok, state["cache"], index)
        state["pos"] += 1

    out["decode_step"] = part(step, steps)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.run.profile")
    ap.add_argument("--experiment", default="image_acgan", choices=sorted(ALL_EXPERIMENTS))
    ap.add_argument("--codec", default="",
                    help="wire codec spec, as the training CLI's --codec")
    ap.add_argument("--topk", type=float, default=0.0,
                    help="top-k fraction, as the training CLI's --topk")
    ap.add_argument("--composed", action="store_true",
                    help="the composed per-leaf coded sync (fused_sync=False)")
    ap.add_argument("--strategy", default="", choices=["", *sorted(STRATEGIES)],
                    help="profile this sync strategy (its defaults) instead")
    ap.add_argument("--sync-dtype", default="", choices=sorted(_SYNC_DTYPES),
                    help="the strategy's sync_dtype, as the training CLI's")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--captured", action="store_true",
                    help="replay the round as a captured CUDA graph (the card only)")
    ap.add_argument("--arch", default="", choices=["", *list_archs()],
                    help="profile this backbone at full width instead of an experiment")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.arch:
        out = profile_backbone(args.arch, device=args.device)
    else:
        if args.sync_dtype and not args.strategy:
            raise ValueError("--sync-dtype is a knob of --strategy; name the strategy")
        kw = {"sync_dtype": _SYNC_DTYPES[args.sync_dtype]} if args.sync_dtype else {}
        strategy = get_strategy(args.strategy, **kw) if args.strategy else None
        out = profile_rounds(args.experiment, codec=args.codec, topk=args.topk,
                             composed=args.composed, strategy=strategy,
                             rounds=args.rounds, device=args.device,
                             captured=args.captured)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
