"""Where a round's time goes: rounds of an experiment under
``torch.profiler``, on the card unless told otherwise.

    PYTHONPATH=src python -m repro_torch.run.profile --experiment image_acgan
    PYTHONPATH=src python -m repro_torch.run.profile --experiment image_acgan --codec int8
    PYTHONPATH=src python -m repro_torch.run.profile --experiment image_acgan \
        --codec int4 --topk 0.25             # the composed coded sync
    PYTHONPATH=src python -m repro_torch.run.profile --experiment image_acgan \
        --codec int8 --composed              # int8, fused_sync=False

One warm-up round, then ``--rounds`` rounds timed on the host clock
without the profiler, then the same number under it (CPU and CUDA
activities).  Prints one JSON object: milliseconds per round with and
without the profiler, the device busy share (the summed time of the
device kernels over the profiled wall time; one stream, so kernels do not
overlap), that time split into convolutions and matrix products, the sync
kernels and everything else, and the kernels that take the most device
time.  The sync kernels are fedavg, qsync and the four qpack kernels; the
top-k selection's sort and the composed path's small PyTorch operations
count as everything else.  On the CPU the device numbers are null.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.comm import codec_from_flags
from repro_torch.core import FedAvgSync
from repro_torch.data.federated import round_key_schedule
from repro_torch.launch.train import experiment_spec

SYNC_KERNELS = ("fedavg_kernel", "qsync_kernel", "qpack_")
MATMUL_MARKS = ("conv", "gemm", "xmma", "cudnn", "cutlass", "wgrad", "dgrad")


def _category(name: str) -> str:
    low = name.lower()
    if any(k in name for k in SYNC_KERNELS):
        return "sync"
    if any(k in low for k in MATMUL_MARKS):
        return "conv_matmul"
    return "other"


def profile_rounds(name="image_acgan", *, codec="", topk=0.0, composed=False,
                   rounds=2, top=12, device="cuda", **spec_kw) -> dict:
    """``codec`` and ``topk`` as the training CLI's flags (error feedback
    on); ``composed`` forces the per-leaf pipeline (``fused_sync=False``)."""
    c = codec_from_flags(codec, topk=topk)
    strategy = (FedAvgSync(codec=c, fused_sync=False if composed else None)
                if c is not None else None)
    spec = experiment_spec(name, strategy=strategy, log_every=0, device=device,
                           **spec_kw)
    dev = torch.device(spec.device)
    fed, data = spec.build(), spec.build_data()
    state = fed.init_state(torch.Generator().manual_seed(spec.seed), device=dev)
    gens = iter(round_key_schedule(spec.seed + 1, 2 * rounds + 1, dev))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def run(n):
        """Milliseconds per round over ``n`` rounds."""
        nonlocal state
        t0 = time.perf_counter()
        for _ in range(n):
            state, _ = fed.round_from_data(state, data, next(gens))
        sync()
        return (time.perf_counter() - t0) / n * 1e3

    run(1)                                  # warm-up: cuDNN picks algorithms
    plain_ms = run(rounds)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        profiled_ms = run(rounds)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    split = {"conv_matmul": 0.0, "sync": 0.0, "other": 0.0}
    for e in kernels:
        split[_category(e.key)] += e.self_device_time_total / 1e3 / rounds
    on_card = dev.type == "cuda"
    return {
        "experiment": name, "codec": c.name if c is not None else None,
        "fused_sync": None if c is None else not composed and c.fused_sync_spec() is not None,
        "rounds": rounds,
        "K": spec.K, "agents": fed.cfg.num_agents, "batch": spec.batch_size,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "ms_per_round": plain_ms, "ms_per_round_profiled": profiled_ms,
        "device_busy_share": busy_us / 1e3 / (profiled_ms * rounds) if on_card else None,
        "device_ms_per_round": split if on_card else None,
        "top_kernels": [{"name": e.key[:120], "calls_per_round": e.count / rounds,
                         "ms_per_round": e.self_device_time_total / 1e3 / rounds}
                        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.run.profile")
    ap.add_argument("--experiment", default="image_acgan", choices=["image_acgan"])
    ap.add_argument("--codec", default="",
                    help="wire codec spec, as the training CLI's --codec")
    ap.add_argument("--topk", type=float, default=0.0,
                    help="top-k fraction, as the training CLI's --topk")
    ap.add_argument("--composed", action="store_true",
                    help="the composed per-leaf coded sync (fused_sync=False)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = profile_rounds(args.experiment, codec=args.codec, topk=args.topk,
                         composed=args.composed, rounds=args.rounds,
                         device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
