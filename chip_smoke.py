#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of FedGAN on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card and the
CUDA toolkit.  Phases, each of which fails the run when it fails:

1. Build both kernels from ``src/repro_torch/csrc`` (one ``nvcc`` each, in
   parallel) and print the card's name and power limit.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it: the bucketed generator and discriminator
   streams of the image experiment's ACGAN nets, B = 5 agents.  fedavg
   within 1e-6 of sum_b |w_b x_bn| in float32 (the plain version's library
   sum groups the B products in another order), one bfloat16 ulp more in
   bfloat16; qsync at 8 and 4 bits, with and without error feedback,
   bit-identical (both sum in agent order).  Time kernel, plain version
   and (fedavg) the one PyTorch call that computes the same function, with
   CUDA events, median of 20 L2-cold launches.
3. Check one small round on the card against the same round on the CPU.
4. Drive the main path, ``experiment_spec("image_acgan")`` at full width
   (B = 5, K = 20, batch 64) for 3 rounds, once with the plain
   ``FedAvgSync()`` and once with ``FedAvgSync(codec=IntQuant(8))`` (error
   feedback on).  The kernel launch counters are set to 0 just before each
   run and read just after it: the plain run must launch fedavg twice a
   round (one launch per subtree), the int8 run qsync twice a round.
   Losses and parameters must be finite and every agent must hold the
   synced parameters after every round.

The second-to-last line is the kernels' record as one JSON object, the
last line ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without ``src/repro_torch`` beside this file, the script exits non-zero and
prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM float32 peak outside the tensor cores
B = 5                          # agents of the image experiment
REPS = 20


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, flush):
    """Median milliseconds of ``fn`` over REPS launches on the current
    stream, each after overwriting ``flush`` (larger than the 50 MB L2) so
    the inputs come from device memory, as they do after the local steps."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes, ops):
    """The least time the card could take: bytes over the memory rate or
    float32 operations over their peak, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stream_shapes():
    """Per-agent leaf shapes of the image experiment's ACGAN nets."""
    import torch
    from repro_torch.launch.train import acgan_task
    from repro_torch.tree import tree_leaves
    task, _ = acgan_task(hw=16, num_classes=10, latent=62)
    params = task.init(torch.Generator().manual_seed(0))
    return {k: [tuple(x.shape) for x in tree_leaves(params[k])] for k in ("gen", "disc")}


def check_fedavg(torch, shapes, dev, flush):
    from repro_torch.kernels.fedavg.kernel import fedavg_flat
    from repro_torch.kernels.fedavg.ref import fedavg_flat_ref
    gen = torch.Generator(device=dev).manual_seed(1)
    w = torch.rand((1, B), generator=gen, device=dev) + 0.1
    w = w / w.sum()
    record = None
    for name, leaves in shapes.items():
        N = sum(math.prod(s) for s in leaves)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((B, N), generator=gen, device=dev).to(dtype)
            got, want = fedavg_flat(w, x).float(), fedavg_flat_ref(w, x).float()
            torch.cuda.synchronize()
            tol = 1e-6 * (w.reshape(-1, 1) * x.float()).abs().sum(0)
            if dtype == torch.bfloat16:
                tol = tol + torch.maximum(got.abs(), want.abs()) * 2.0 ** -7
            err = float((got - want).abs().max())
            check(bool(((got - want).abs() <= tol).all()),
                  f"fedavg {name} {dtype}: kernel disagrees with plain (max {err})")
            log(f"fedavg {name} stream ({B}, {N}) {dtype}: max_abs_err={err}")
            if name == "gen" and dtype == torch.float32:
                wf = w.reshape(-1)
                ms = time_ms(torch, lambda: fedavg_flat(w, x), flush)
                plain = time_ms(torch, lambda: fedavg_flat_ref(w, x), flush)
                lib = time_ms(torch, lambda: torch.mv(x.t(), wf), flush)
                b_ms, b_by = bound((B * N + N + B) * 4, 2 * B * N)
                record = {"name": "fedavg", "route": "cuda",
                          "source": "src/repro_torch/csrc/fedavg.cu",
                          "replaces": "src/repro/kernels/fedavg/kernel.py:24",
                          "max_abs_err": err, "ms": ms, "plain_ms": plain,
                          "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}
                log(f"fedavg timing ({B}, {N}) f32: kernel {ms:.4f} ms, plain "
                    f"{plain:.4f} ms, torch.mv {lib:.4f} ms, bound {b_ms:.4f} ms")
    try:
        fedavg_flat(w, x.t().contiguous().t())
    except ValueError:
        pass
    else:
        raise SmokeFailure("fedavg took a non-contiguous CUDA tensor")
    return record


def _padded(leaves, block=128):
    return sum(-(-math.prod(s) // block) * block for s in leaves)


def check_qsync(torch, shapes, dev, flush):
    from repro_torch.kernels.qsync.kernel import qsync_flat
    from repro_torch.kernels.qsync.ref import qsync_flat_ref
    gen = torch.Generator(device=dev).manual_seed(2)
    w = torch.rand((1, B), generator=gen, device=dev) + 0.1
    w = w / w.sum()
    record = None
    for name, leaves in shapes.items():
        N = _padded(leaves)
        x = 0.05 * torch.randn((B, N), generator=gen, device=dev)
        e = 1e-3 * torch.randn((B, N), generator=gen, device=dev)
        ed = 1e-3 * torch.randn(N, generator=gen, device=dev)
        for bits in (8, 4):
            qmax = 2 ** (bits - 1) - 1
            for ef in (True, False):
                args = (w, x, e, ed) if ef else (w, x, None, None)
                got = qsync_flat(*args, qmax=qmax)
                want = qsync_flat_ref(*args, qmax=qmax, block=128)
                torch.cuda.synchronize()
                # both sum the rounded products in agent order and round
                # every step alike, so every output is bit-identical
                err = 0.0
                for i, what in enumerate(("synced", "new_ef", "new_ef_down")):
                    check((got[i] is None) == (want[i] is None),
                          f"qsync {name} int{bits} ef={ef}: {what} missing")
                    if want[i] is None:
                        continue
                    err = max(err, float((got[i] - want[i]).abs().max()))
                    check(torch.equal(got[i], want[i]),
                          f"qsync {name} int{bits} ef={ef}: {what} is not "
                          f"bit-identical (max {err})")
                log(f"qsync {name} stream ({B}, {N}) int{bits} ef={ef}: "
                    f"max_abs_err={err}")
                if name == "gen" and bits == 8 and ef:
                    ms = time_ms(torch, lambda: qsync_flat(*args, qmax=qmax), flush)
                    plain = time_ms(torch, lambda: qsync_flat_ref(
                        *args, qmax=qmax, block=128), flush)
                    # read x, ef, ef_down, w; write synced, new_ef, new_ef_down
                    nbytes = (3 * B * N + 3 * N + B) * 4
                    b_ms, b_by = bound(nbytes, 11 * B * N + 11 * N)
                    record = {"name": "qsync", "route": "cuda",
                              "source": "src/repro_torch/csrc/qsync.cu",
                              "replaces": "src/repro/kernels/qsync/kernel.py:37",
                              "max_abs_err": err, "ms": ms, "plain_ms": plain,
                              "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
                    log(f"qsync timing ({B}, {N}) int8+EF: kernel {ms:.4f} ms, "
                        f"plain {plain:.4f} ms, bound {b_ms:.4f} ms")
    try:
        qsync_flat(w, x.t().contiguous().t(), qmax=127)
    except ValueError:
        pass
    else:
        raise SmokeFailure("qsync took a non-contiguous CUDA tensor")
    return record


def check_small_round(torch, dev):
    """One K = 2 round of the image experiment's nets at 8x8, SGD, from the
    same weights and batches on the card and on the CPU (the plain
    versions): plain sync within 1e-4 of each leaf's magnitude (float32
    roundoff of cuDNN against the CPU library); int8 sync additionally
    within 1.5 quanta of the leaf's coarsest block on at most 2% of the
    elements (values at a rounding tie may take the neighbouring code)."""
    from repro_torch.comm import IntQuant
    from repro_torch.core import FedAvgSync, FedGAN, FedGANConfig
    from repro_torch.launch.train import acgan_task
    from repro_torch.optim import SGD, constant, equal_timescale
    from repro_torch.tree import tree_leaves, tree_map
    K, grid, b = 2, (1, B), 8
    g = torch.Generator().manual_seed(3)
    batches = {"x": torch.rand((K,) + grid + (b, 8, 8, 3), generator=g) * 2 - 1,
               "y": torch.randint(0, 10, (K,) + grid + (b,), generator=g),
               "z": torch.randn((K,) + grid + (b, 62), generator=g)}
    for codec in (None, IntQuant(8)):
        task, _ = acgan_task(hw=8)
        fed = FedGAN(task, FedGANConfig(agent_grid=grid, sync_interval=K,
                                        strategy=FedAvgSync(codec=codec)),
                     opt_g=SGD(), opt_d=SGD(), scales=equal_timescale(constant(0.05)))
        out = {}
        for d in ("cpu", dev):
            state = fed.init_state(torch.Generator().manual_seed(4), device=d)
            out[str(d)], _ = fed.round(state, tree_map(lambda x: x.to(d), batches))
        over = total = 0
        for c, k in zip(tree_leaves(out["cpu"]["params"]),
                        tree_leaves(out[str(dev)]["params"])):
            k = k.cpu()
            diff = (c - k).abs()
            tol = 1e-4 * max(1.0, float(c.abs().max()))
            if codec is not None:
                # a downlink code flip moves one quantum; an uplink flip
                # adds w_b = 1/B of an agent's quantum on top
                check(bool((diff <= tol + 1.5 * float(c.abs().max()) / 127).all()),
                      "small int8 round: card and CPU differ by more than a quantum")
                over += int((diff > tol).sum())
                total += diff.numel()
            else:
                check(bool((diff <= tol).all()),
                      f"small plain round: card and CPU differ by {float(diff.max())}")
        check(over <= 0.02 * max(total, 1), f"small int8 round: {over} codes moved")
        log(f"small round card vs CPU ({'int8' if codec else 'plain'}): agree")


def run_main_path(torch, dev, strategy, label):
    from repro_torch.kernels.fedavg.kernel import fedavg_flat
    from repro_torch.kernels.qsync.kernel import qsync_flat
    from repro_torch.launch.train import experiment_spec
    from repro_torch.tree import tree_leaves
    from repro_torch.core import FedAvgSync
    rounds, K = 3, 20
    # warm-up round: cuDNN's first calls pick algorithms; not counted
    experiment_spec("image_acgan", steps=K, strategy=strategy, log_every=0,
                    device=dev).run_result()
    spec = experiment_spec("image_acgan", steps=rounds * K, strategy=strategy,
                           log_every=1, device=dev)
    check((spec.K, spec.batch_size, spec.agent_grid) == (K, 64, (1, B)),
          "image_acgan is not at the experiment's width")
    mismatched = []

    def synced(fed, state, r):
        # stays on the device; read once after the run
        mismatched.append(torch.stack([(x != x[:1, :1]).any()
                                       for x in tree_leaves(state["params"])]).any())
        return {}

    spec = dataclasses.replace(spec, eval_every=1, eval_hooks=(synced,))
    fedavg_flat.launches = 0
    qsync_flat.launches = 0
    result = spec.run_result()
    torch.cuda.synchronize()
    counts = {"fedavg": fedavg_flat.launches, "qsync": qsync_flat.launches}
    check(len(mismatched) == rounds and not any(bool(m) for m in mismatched),
          f"{label}: agents do not hold identical params after a sync")
    check(all(torch.isfinite(torch.tensor(list(m.values()))).all()
              for m in result.history), f"{label}: non-finite losses")
    check(all(bool(torch.isfinite(x).all()) for x in tree_leaves(result.state)
              if x.is_floating_point()), f"{label}: non-finite state")
    coded = isinstance(strategy, FedAvgSync) and strategy.codec is not None
    if coded:
        check(counts["qsync"] == 2 * rounds,
              f"{label}: qsync launched {counts['qsync']} times in {rounds} rounds")
    else:
        check(counts["fedavg"] >= 2 * rounds,
              f"{label}: fedavg launched {counts['fedavg']} times in {rounds} rounds")
    t = result.timings
    log(f"main path {label}: {rounds} rounds x K={K}, B={B}, batch 64: "
        f"{t['steps_per_s']:.3f} steps/s, {t['total_s'] / rounds * 1e3:.1f} ms/round, "
        f"round gap {t['round_gap_s'] * 1e3:.2f} ms, launches {counts}, "
        f"last losses {result.history[-1]}")
    return counts, t


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "needs one CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    import repro_torch  # noqa: F401  (turns TF32 off)
    from repro_torch.comm import IntQuant
    from repro_torch.core import FedAvgSync
    from repro_torch.kernels import _build
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    per_source = _build.build(["fedavg", "qsync"])
    log(f"nvcc build: {time.perf_counter() - t0:.1f} s wall "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in per_source.items()) or 'cached'})")

    shapes = stream_shapes()
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    records = [check_fedavg(torch, shapes, dev, flush),
               check_qsync(torch, shapes, dev, flush)]
    del flush
    check_small_round(torch, dev)

    plain_counts, _ = run_main_path(torch, dev, None, "FedAvgSync()")
    int8_counts, _ = run_main_path(
        torch, dev, FedAvgSync(codec=IntQuant(bits=8), error_feedback=True),
        "FedAvgSync(codec=IntQuant(8), error_feedback=True)")
    records[0]["launches"] = plain_counts["fedavg"]
    records[1]["launches"] = int8_counts["qsync"]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(card_line(), flush=True)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
