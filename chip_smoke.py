#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of FedGAN on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card and the
CUDA toolkit.  Phases, each of which fails the run when it fails:

1. Build the five kernel libraries from ``src/repro_torch/csrc`` (fedavg,
   qsync, qpack, flash_attention, ssd_scan; one ``nvcc`` each, in parallel)
   and print the card's name and power limit.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it.  fedavg and qsync at the bucketed
   generator and discriminator streams of the image experiment's ACGAN
   nets, B = 5 agents: fedavg within 1e-6 of sum_b |w_b x_bn| in float32
   (the plain version sums the rounded products in the kernel's agent
   order too, so the error reads 0), one bfloat16 ulp more in bfloat16; fedavg's wire route (the
   reference's weighted_mean in bfloat16 and float16, each product
   rounded to the type) at the generator stream and its pod route (the
   fused multiply-add chain of average_intra_pod) at that stream on a
   (2, 4) grid, bit-identical; qsync at 8 and 4 bits, with
   and without error feedback, bit-identical (both sum in agent order).
   The four qpack kernels bit-identical (elementwise): quant and dequant at
   the largest ACGAN leaf, (5, 2,097,152) float32, at 8 and 4 bits; pack4
   and unpack4 at that leaf's int4 codes after top-k 0.25, (5, 524,288),
   on their vector routes and on their general routes (a view one byte
   past alignment); every row holds an all-zero block, an overflowing
   block and a block of exact .5 ties; dequant also at those int4 codes,
   (5, 524,288), the shape of the main path's dequant launches.  Each
   qpack kernel's registers and local (spill) bytes (no local bytes
   allowed), and one empty launch through the same timing: the floor of a
   kernel this small.  With ``--qpack-parent DIR`` (repeatable), time that
   checkout's dequant, pack4 and unpack4 beside this one's through each
   one's own ``check_qpack``, in turns, one process each.  The fused Adam
   step with the uplink quantize (``adam_sync_tree``, kernel 7) on the
   ACGAN generator and discriminator trees after one round of training,
   one launch per tree, every output bit-identical to its plain version
   and to ``Adam.update`` followed by the qpack quantize.  Time each
   kernel, its plain version and (fedavg) the one PyTorch call that
   computes the same function, with CUDA events, median of 20 L2-cold
   launches; adam_sync also beside the composed form it replaces
   (``Adam.update`` then ``quantize_blocks``).
3. Composed vs fused: from the full-width state after one int8 round with
   error feedback, ``coded_sync`` of each subtree both ways, for
   IntQuant(8) and IntQuant(4) with the residuals and the experiment's
   weights: ``synced``, ``new_ef`` and ``new_ef_down`` bit-identical.  Then
   one small round (K = 1) on the card against the same round on the CPU,
   and one round (K = 1) of each of the six paper experiments at test
   size (ACGAN nets at 8x8) on the card against the CPU port, within the
   bounds the CPU round is held to against the reference
   (``tests/torch_shared.py``, which imports no JAX on this path); each
   prints its largest ratio of a difference to its limit, and that ratio
   at K = 2, not held.
4. Drive the main paths, ``experiment_spec("image_acgan")`` at full width
   (B = 5, K = 20, batch 64) for 3 rounds each: ``FedAvgSync()``,
   ``FedAvgSync(codec=IntQuant(8))`` (fused), ``FedAvgSync(codec=TopK(0.25)
   + IntQuant(4))`` and ``FedAvgSync(codec=IntQuant(8), fused_sync=False)``
   (composed), error feedback on.  Every kernel launch counter is set to 0
   just before each run and read just after it, and must equal the count
   the path implies: per round, the plain run one fedavg per subtree, the
   fused run one qsync per subtree, the composed runs per float32 leaf one
   fedavg and, per direction, one quant and one dequant (and for int4 one
   pack4 and one unpack4).  Losses and parameters must be finite and every
   agent must hold the synced parameters after every round.  Then the
   other sync schedules, 3 rounds each the same way, with their launches
   and their agents' agreement after every round: ``PerStepGradAvg()``
   (2 fedavg a step, agents identical), ``PerStepGradAvg(sync_dtype=
   bfloat16)`` (2 wire launches a step), ``FedAvgSync(sync_dtype=
   bfloat16)`` (2 wire a round), ``Hierarchical(intra_interval=5)`` on
   a (2, 4) grid of 8 agents (4 pod and 2 fedavg a round; each pod's
   agents agree after every segment), ``SubsampledFedAvg(fraction=0.6)``
   (2 fedavg a round; exactly the schedule's cohort agrees) and
   ``AdaptiveK(warmup_rounds=1, sync_every=2)`` (fedavg on rounds 0 and
   2 only).  Checkpoints: 4 rounds saved every 2, LATEST restored on the
   card bit for bit, a run resumed from the first.  The twin of
   ``examples/federated_images.py`` at 40 steps: FedGAN against the
   per-step baseline, the checkpoint restored bit for bit.
   A. The host-streaming pipeline (``data_mode="stream"``): image_acgan at
   full width, 3 rounds streamed beside 3 on the device path under
   ``FedAvgSync()`` and fused int8 + EF, launches exact and equal, ms a
   round, steps/s and the round gap of both; every uploaded round
   (pinned, side stream) bit-identical to the blocking
   ``FederatedRounds.round_batches`` at prefetch 1, 2 and 4; mixed_gaussian
   streamed at prefetch 2 bit-identical to the blocking loop.
   B. Rounds in chunks through the captured CUDA graph
   (``rounds_per_chunk``): toy_2d, mixed_gaussian and swiss_roll, 12
   rounds at K = 5, bit-identical at 1, 4 and 12 rounds a chunk with
   exact launches; image_acgan at full width, 3 rounds captured against
   3 eager under ``FedAvgSync()`` and fused int8 + EF with
   ``cudnn.deterministic`` set for the two runs and restored, states
   bit-identical, launches exact; mixed_gaussian (K = 10, 8 rounds) under
   ``PerStepGradAvg``, ``PartialSharing``, ``FedAvgSync(sync_dtype=
   bfloat16)``, top-k + int4, composed int8 and ``Hierarchical`` on a (2,
   4) grid captured in one chunk, bit-identical to its eager rounds with
   the same launches; ``AdaptiveK`` and ``SubsampledFedAvg``
   at 4 rounds a chunk run eagerly and report ``captured: False``; ms a
   round and the profiler's busy share of the eager and the captured
   round of toy_2d, mixed_gaussian and image_acgan.

5. The paper's own experiments: ``python -m repro_torch.quickstart`` at
   its defaults (B = 5, K = 20, 3,000 SGD steps), ending within 0.1 of
   (theta, psi) = (1, 0); ``mixed_gaussian``, ``swiss_roll``,
   ``celeba_acgan`` and ``timeseries_cgan`` through ``experiment_spec`` at
   full width for a few rounds with the suite's eval at the end (finite
   FD, mode coverage on mixed_gaussian, agents synced after every round);
   the K-sweep ``run_sweep("toy_2d", Ks=(5, 20, 50), codec_names=("none",
   "int8"))`` at 1,000 steps a cell with its summary table, at the
   sweep's default of 8 rounds a captured chunk.  Exact launch
   counts: one fedavg (or, int8, one qsync) per subtree per round, plus
   one fedavg per parameter leaf for each ``averaged_params`` of an eval.
   Every depth cut is printed on its own line.
6. Flash attention against its plain version on the card: at gemma3-4b's
   shapes in bfloat16 (B = 2, q (2, 8, 2000, 256), k and v (2, 4, 2000,
   256), causal, window 1024 and 0; the tensor-core kernel) and in float32
   with nh = nkv and with GQA 4:1, T a multiple of no tile.  float32
   within 1e-5 of max |o|; bfloat16 that plus two bfloat16 ulps of the
   element.  The tensor-core kernel's registers, local (spill) bytes,
   shared bytes and blocks per SM at every head_dim it is built for, with
   no local bytes at hd 256.  Time the kernel, its plain version and
   ``F.scaled_dot_product_attention`` with ``enable_gqa=True`` and the
   same boolean mask (named by the kernel the profiler sees; timed only,
   never on the path), and log the kernel's speed against it.
7. The SSD scan against its plain version at mamba2-2.7b's shapes (x (2,
   2048, 80, 64) bfloat16, state 128, chunk 128), with the same tolerance;
   time both, and each of the kernel's three phases (chunk states, state
   pass, chunk outputs) alone, which run in turn must give the scan's
   output bit for bit.  Print each phase's registers, local (spill) bytes,
   shared bytes and blocks an SM (no local bytes allowed) and the
   workspace's bytes.  With ``--ssd-parent DIR`` (a checkout of another
   commit, e.g. ``git archive`` of the parent unpacked under ``build/``),
   time that checkout's SSD kernel beside this one's through each one's own
   ``check_ssd``, in turns (other, this, this, other), one process each.
8. gemma3-4b at full width (34 layers, d_model 2560, vocab 262,144): init
   on the card from a seeded generator; ``prefill`` of 2 prompts of 2,048
   tokens with ``max_seq`` 2,064 through ``use_flash=True`` (34 flash
   launches), 16 greedy ``decode`` steps with a per-row index (0 flash
   launches: decode attends through ``_decode_attend``), and the same
   prefill with ``use_flash=False``: last-token logits within 2^-5 of the
   largest |logit| (the plain route rounds scores and probabilities to
   bfloat16, the kernel does not).  Every logit finite.
9. mamba2-2.7b at full width (64 layers, d_inner 5120, vocab 50,280):
   ``apply`` on 2 x 2,048 tokens through ``use_ssd_kernel=True`` in
   bfloat16 (64 SSD launches, every logit finite), held to
   ``use_ssd_kernel=False`` layer by layer in bfloat16 (each layer's
   mixer, ``Mamba2Block.apply`` without the residual, from the same normed
   input, within 2^-5 of that mixer's largest |output|) and at the
   logits in float32 compute on the same weights (within 2^-6 of the
   largest |logit|): at bfloat16 the random-init model amplifies the two
   scans' last-bit differences over 64 layers.
10. Serving at full width (``repro_torch.serve``; no kernel of the port is
   on this path: the reference's engine builds its Backbone without kernel
   flags and its SSM prefill state scans through the plain ``ssd_ref``).
   gemma3-4b on phase 8's params: ``ServeEngine`` with max_batch 4,
   max_seq 4,096, min_bucket 16, six greedy requests of 1,500, 300,
   2,100, 40, 700 and 1,100 prompt tokens, 24 new tokens each (two
   admitted mid-stream, three prompts over the 1,024 window), in the full
   and the ring layout, each run eagerly and with the captured decode
   tick: the captured run equal to the eager one bit for bit (every
   sampled logits row, the tokens, the tick count, the final cache), every
   launch counter 0 over each run; each request's logits held
   teacher-forced (a batch-1 ``prefill`` of the prompt, then ``decode``
   with a scalar index over the engine's own tokens) within 2^-5 of the
   largest |logit|; the ring engine's held so to the full engine's on the
   steps whose earlier tokens agree.  mamba2-2.7b on phase 9's params:
   max_batch 4, max_seq 1,536, five requests of 1,000, 77 (under one
   chunk: a fresh slot, the whole prompt through decode), 300, 640 and 129
   prompt tokens, 16 new each (exact-prefix prefill, the rest of the
   prompt through the shared decode tick), the same checks.  Printed with
   the card's name and power limit: prefill ms per request and bucket,
   tick ms p50/p99 eager and captured, kernels and device ms a tick
   (profiler), the captured tick's longest kernels, the device ms of the
   alternative the engine does not take (the functional decode with its
   new cache copied into the static one), decode tokens/s, mean
   occupancy, peak memory and wall time.  Hot reload at gemma3-4b's ``.smoke()`` config:
   a captured engine polling a checkpoint directory picks up a step
   written mid-stream by ``save_checkpoint``, into the same param and
   cache tensors, and then serves what a fresh engine on the new weights
   serves.

11. The LM GAN (FedGAN's Algorithm 1 with a backbone as the generator,
   ``repro_torch.launch.steps.make_lm_gan_task``) at granite-moe-3b-a800m's
   full width (d_model 1,536, 40 experts top-8, vocab 49,408 padded; the
   discriminator at its config), 4 agents on a (1, 4) grid, batch 8 of
   T = 256 tokens from ``sample_agent_tokens``, K = 5, Adam at 1e-3,
   through ``RunSpec.run_result``: 2 rounds at 2 of its 32 layers under
   ``FedAvgSync()`` (2 fedavg launches a round: the sync buckets each of
   G and D into one launch), and at 1 layer (the error-feedback residuals
   add half a state) 1 round under top-k 0.25 + int4 composed (per
   float32 leaf one fedavg and, per direction, one quant, pack4, unpack4
   and dequant) and 2 rounds under fused int8 + error feedback (2 qsync a
   round).  Deeper rounds pass 72 GB of the card's 80 (NVIDIA H100 80GB
   HBM3, 700 W): a round holds its input state beside the steps' (the
   functional API, as the reference's undonated jit), and Adam's update
   the old and the new state.  The five new archs' ``.smoke()`` rounds
   and one step of each sync at smoke width run first: a process's first
   local step leaves its input state in a garbage cycle once (torch's
   first-call set-up keeps a list of frames), a full state at full width.
   Every sync kernel launch of those rounds is held in place against its
   plain version on its own
   inputs (``torch_shared.held_sync_kernels``: fedavg within 1e-6 of
   sum_b |w_b x_bn|, qsync and the qpack kernels bit for bit), embed's
   (4, 75,890,688) among them; launches exact, agents equal after every
   sync, every loss finite; printed: lm per round, ms a round, steps/s,
   peak memory per round and, for the plain run, ``run.profile``'s ms a
   round and device busy share.  The smoke rounds: one LM GAN round (K =
   1, SGD) of each of the five archs the registry gained at ``.smoke()``
   on the card against the CPU port, within the CPU-vs-JAX bounds of
   ``tests/torch_shared.py``.  Last, granite-moe-3b-a800m at full size (32
   layers) served by ``ServeEngine`` (max_batch 4, four requests of 400,
   40, 150 and 250 prompt tokens, 16 new each), the captured tick
   bit-identical to the eager one, with tokens/s, tick ms p50/p99 and
   peak memory.

12. The hybrid, audio and vlm families at full width.  Phase 6 also
   holds flash at zamba2-7b's shared attention (q, k, v (2, 32, 2048,
   112) bfloat16, causal; head_dim 112, whose 14 16-byte chunks a row do
   not divide the block's 128 threads) and whisper-medium's encoder ((2,
   16, 1500, 64), non-causal), and float32 at 112, each timed against its
   plain version and ``scaled_dot_product_attention`` with its bound; phase
   7 the SSD scan at zamba2-7b's shapes (x (2, 2048, 112, 64) bfloat16,
   state 64, chunk 128, the generic instantiation) with its final state,
   the output and the state against ``ssd_ref(return_final_state=True)``.
   zamba2-7b at full size (81 blocks, 5.7 G float32 params): ``apply`` on
   2 x 2,048 tokens through both kernels (13 flash and 68 SSD launches),
   held to the flag-free route block by block in bfloat16 (each shared
   attention application and each mixer from the same normed input,
   within 2^-5 of its largest |output|) and at the logits in float32
   compute (2^-6); ``prefill`` with max_seq 2,064 (13 and 68 launches,
   every scan returning its final state) and 16 greedy decode steps, held
   to the flag-free prefill and decode within 2^-5 of the largest |logit|
   in float32 compute (the bfloat16 gap, which the random-init model
   amplifies over 81 layers as phase 9 shows, printed).  Served at full
   size (max_batch 4, max_seq 1,536, the requests of phase 10's
   mamba2-2.7b), eager and captured bit for bit, each request held
   teacher-forced within 2^-5 in float32 compute (a float32 engine,
   captured).  whisper-medium at full size (24 + 24 layers): ``encode``
   of seeded frames (2, 1,500, 1,024) through flash (24 non-causal launches), a
   prefill of 2 x 448 tokens with them (48: the encoder's 24 and the
   decoder's 24 causal), ``build_cross_cache`` equal to the prefill's
   cross caches, 16 greedy decode steps, held to ``use_flash=False``
   within 2^-5 of the largest |logit| in bfloat16; served (max_batch 4,
   max_seq 448, four requests of 5, 60, 200 and 400 prompt tokens, each
   with its own frames, the last two submitted after four ticks), eager
   and captured bit for bit, teacher-forced within 2^-5.
   chameleon-34b at full width, cut in depth to the deepest cut whose
   float32 params and a 12 GB reserve fit 72 GiB (printed): a prefill of
   2 x 2,048 tokens through flash (one launch a layer), 16 greedy decode
   steps, held to the plain route within 2^-5 in bfloat16, its peak
   memory under 72 GiB.  Phase 11's ``.smoke()`` LM GAN rounds on the card
   against the CPU port take zamba2-7b, whisper-medium (with frames) and
   chameleon-34b too.

13. Privacy and robustness (``run_privacy``): ``experiment_spec(
   "image_acgan")`` at full width (B = 5, K = 20, batch 64, Adam), one
   round of each path from one state with the same batches, with
   ``cudnn.deterministic`` set and exact launches: ``FedAvgSync()`` and
   ``FedAvgSync(secure_agg=SecureAgg(0))`` (2 fedavg each), params bit
   for bit equal, the generator's wire image (masks drawn on the card)
   not the plaintext and summing to it mod 2^32; the trimmed mean on the
   composed int8 sync under one sign-flipper and the median on top-k 0.25
   + int4 under two NaN agents (qpack launches only, no fedavg), every
   aggregate coordinate finite and inside the honest agents' envelope;
   DP-SGD (clip 1, sigma 1) under the fused int8 sync (2 qsync), finite,
   its epsilon, and every per-example joint norm of one full-width step at
   most C.  Printed: each path's ms a round beside the plain round's, each
   ``round_sync`` alone and the robust reduces against fedavg (CUDA
   events), peaks, and one K = 1 round of the secure, trimmed-mean, median
   and clip-only DP paths at 8x8 on the card against the CPU port within
   ``tests/torch_shared.py``'s bounds.

14. The virtual-client fleet (``run_fleet``) at image_acgan's full width
   (5 slots, K = 20, batch 64, Adam): (a) ``a_total = a_active = 5``, 3
   rounds, bit-identical to the dense stream ``RoundDriver`` (params, Adam
   state, metrics; ``cudnn.deterministic`` set), both rounds/s printed;
   (b) ``a_total = 1024``, ``participation_seed = 0``, 6 rounds under
   ``FedAvgSync()`` (2 fedavg a round) and the fused int8 + EF sync (2
   qsync a round), every launch held in place to its plain version
   (``torch_shared.held_sync_kernels``), with ``store_rows``,
   ``swapped_rows``, rounds/s, the round gap, the host's peak RSS and the
   card's peak; (c) ``straggler_policy="defer"`` with a planted
   ``late:1`` and ``drop`` in round 1 of 3: the merges' fedavg launches
   (one a leaf a round) held in place, and one such round at K = 1 on the
   8x8 nets against the CPU port within ``tests/torch_shared.py``'s
   bounds; (d) ``AsyncAggDriver`` buffered over 64 clients, cohort 5, goal
   2, the demo's latency model, 6 flushes: the flushes' fedavg launches
   held in place, the journal equal to the CPU port's run apart from the
   params digests, flushes, timeouts, retries, the makespan and the wall
   time printed; ``demo_driver`` twice on the card, byte-identical
   journals.

15. The mesh on one card (``run_mesh``), on ``make_serving_mesh()`` (a
   (1, 1) ("data", "model") ``DeviceMesh`` over a one-rank NCCL group;
   every spec filters to replicated, so the mesh path must equal the
   unsharded one bit for bit): (a) gemma3-4b at full width on phase 8's
   params placed by ``param_specs`` (DTensors): a prefill of 2 x 2,048
   tokens through ``Backbone(cfg, use_flash=True)`` under ``use_mesh``,
   exactly 34 flash launches, logits bit-identical to the unsharded
   prefill; ``build_prefill`` and ``build_decode`` (flash off, as the
   reference's builders) bit-identical to the unsharded backbone; (b)
   ``ServeEngine(cfg, mesh=make_serving_mesh())`` on those params serving
   GEMMA_WORK's first two requests, eager and captured: the captured tick
   bit-identical to the eager one, the tokens the unsharded engine's; (c)
   the LM GAN round ``build_step(granite-moe-3b-a800m cut to 2 layers,
   ShapeConfig("train_card", 256, 8, "train"), mesh, K=5,
   plan=AGENTS_DATA)`` (one agent) against ``FedGAN.round`` on the same
   state and batches without a mesh: the new state bit-identical, 2
   fedavg launches each and no other kernel; (d) ``run_experiment(
   "toy_2d")`` for 4 rounds, its history ``experiment_spec(...).run()``'s.
   Each part's wall time and the card's peak memory are printed.

In every main-path run each kernel's launch counter is set to 0 just
before it and read just after it, and the kernels the path does not run
must read 0.  The second-to-last line is the kernels' record as one JSON
object, the last line ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
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

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM float32 peak outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM dense bfloat16 tensor-core peak
B = 5                          # agents of the image experiment
REPS = 20
SPIN_CYCLES = 4_000_000        # about 2 ms at the H100's clocks


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
    the inputs come from device memory, as they do after the local steps.
    A spin of about 2 ms is queued after the flush: the device is still
    busy with it while the host records the start event and dispatches
    ``fn``, so the events time the device's work and not the host's
    dispatch."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes, ops, ops_per_s=F32_OPS_PER_S):
    """The least time the card could take: bytes over the memory rate or
    operations over their peak (float32 unless given), whichever is
    larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
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


def check_fedavg_routes(torch, shapes, dev, flush):
    """fedavg's wire route (the reference's weighted_mean in bfloat16 and
    float16: products rounded to the type) at the generator bucket, and
    its pod route (average_intra_pod: a fused multiply-add chain per pod)
    at that bucket on a (2, 4) grid, each bit-identical to its plain
    version and timed, beside one library call of the same function
    (``torch.mv`` in bfloat16; ``torch.einsum`` on the row-normalised
    weights), which the port never calls.  Returns the two records."""
    from repro_torch.kernels.fedavg.kernel import fedavg_pod_flat, fedavg_wire_flat
    from repro_torch.kernels.fedavg.ref import fedavg_pod_ref, fedavg_wire_ref
    gen = torch.Generator(device=dev).manual_seed(2)
    N = sum(math.prod(s) for s in shapes["gen"])
    w = torch.rand((1, B), generator=gen, device=dev) + 0.1
    w = w / w.sum()
    records = {}
    for dtype in (torch.bfloat16, torch.float16):
        x = torch.randn((B, N), generator=gen, device=dev).to(dtype)
        got, want = fedavg_wire_flat(w, x), fedavg_wire_ref(w, x)
        torch.cuda.synchronize()
        check(same_bits(torch, got, want),
              f"fedavg_wire {dtype}: kernel differs from plain on "
              f"{int((got != want).sum())} elements")
        log(f"fedavg_wire ({B}, {N}) {dtype}: bit-identical to plain")
        if dtype == torch.bfloat16:
            ms = time_ms(torch, lambda: fedavg_wire_flat(w, x), flush)
            plain = time_ms(torch, lambda: fedavg_wire_ref(w, x), flush)
            wb = w.reshape(-1).to(dtype)
            lib = time_ms(torch, lambda: torch.mv(x.t(), wb), flush)
            b_ms, b_by = bound(2 * (B + 1) * N + 4 * B, 2 * B * N)
            records["fedavg_wire"] = {
                "name": "fedavg_wire", "route": "cuda", "source": "src/repro_torch/csrc/fedavg.cu",
                "replaces": "src/repro/dist/collectives.py:43", "max_abs_err": 0.0, "ms": ms,
                "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}
            log(f"fedavg_wire timing ({B}, {N}) bf16: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                f"torch.mv {lib:.4f} ms, bound {b_ms:.4f} ms")
    P, A = 2, 4
    w = torch.rand((P, A), generator=gen, device=dev) + 0.1
    w = w / w.sum()
    x = torch.randn((P, A, N), generator=gen, device=dev)
    got, want = fedavg_pod_flat(w, x), fedavg_pod_ref(w, x)
    torch.cuda.synchronize()
    check(same_bits(torch, got, want),
          f"fedavg_pod: kernel differs from plain on {int((got != want).sum())} elements")
    ms = time_ms(torch, lambda: fedavg_pod_flat(w, x), flush)
    plain = time_ms(torch, lambda: fedavg_pod_ref(w, x), flush)
    w_intra = w / w.sum(1, keepdim=True)
    lib = time_ms(torch, lambda: torch.einsum("pa,pan->pn", w_intra, x), flush)
    b_ms, b_by = bound(4 * (P * A + P) * N + 4 * P * A, 2 * P * A * N)
    records["fedavg_pod"] = {
        "name": "fedavg_pod", "route": "cuda", "source": "src/repro_torch/csrc/fedavg.cu",
        "replaces": "src/repro/dist/collectives.py:205", "max_abs_err": 0.0, "ms": ms,
        "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}
    log(f"fedavg_pod ({P}, {A}, {N}) f32: bit-identical to plain; kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, torch.einsum {lib:.4f} ms, bound {b_ms:.4f} ms")
    return [records["fedavg_wire"], records["fedavg_pod"]]


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


QPACK_LEAF = (B, 2_097_152)    # gen.fc2.w and disc.fc.w, the largest ACGAN leaves


def same_bits(torch, a, b):
    """Equal in every byte: a comparison that sees the sign of zero."""
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8), b.contiguous().reshape(-1).view(torch.uint8))


def _planted(torch, gen, dev, shape, qmax, block=128):
    """float32 of mixed magnitudes with, in every row, an all-zero block,
    an overflowing block (max-abs / qmax beyond float16: the scale clamps
    to 65504 and the codes clip) and a block of exact .5 ties (max-abs
    qmax / 2 gives the scale 0.5; odd multiples of 0.25 sit halfway)."""
    rows, n = shape
    scale = torch.tensor([1e-3, 1.0, 30.0], device=dev)[
        torch.randint(0, 3, shape, generator=gen, device=dev)]
    x = 0.02 * torch.randn(shape, generator=gen, device=dev) * scale
    x[:, :block] = 0.0
    x[:, block:2 * block] = 1e7 * torch.randn((rows, block), generator=gen, device=dev)
    odd = 2 * torch.randint(-qmax, qmax, (rows, block), generator=gen, device=dev) + 1
    x[:, 2 * block:3 * block] = 0.25 * odd.float()
    x[:, 2 * block] = qmax / 2
    return x


def check_qpack(torch, dev, flush):
    """The four qpack kernels against their plain versions, bit for bit,
    at the main path's shapes; one timing record each."""
    from repro_torch.comm import TopK
    from repro_torch.kernels.qpack import kernel as pk
    from repro_torch.kernels.qpack import ref as pr
    gen = torch.Generator(device=dev).manual_seed(5)
    records, errs = {}, dict.fromkeys(("quant", "dequant", "pack4", "unpack4"), 0.0)
    diff = lambda a, b: (a.double() - b.double()).abs().max().item()  # noqa: E731
    R, N = QPACK_LEAF
    for bits in (8, 4):
        qmax = 2 ** (bits - 1) - 1
        x = _planted(torch, gen, dev, QPACK_LEAF, qmax)
        q, s = pk.quant_flat(x, qmax=qmax)
        wq, ws = pr.quant_blocks_ref(x, qmax=qmax, block=128)
        out = pk.dequant_flat(q, s)
        want = pr.dequant_blocks_ref(q, s, block=128)
        torch.cuda.synchronize()
        check(bool((s[:, 0] == 0).all() & (s[:, 1] == 65504).all() & (s[:, 2] == 0.5).all()),
              f"qpack int{bits}: the planted zero, overflow and tie blocks are not there")
        check(same_bits(torch, q, wq) and same_bits(torch, s, ws),
              f"quant int{bits} ({R}, {N}): codes or scales are not bit-identical "
              f"({int((q != wq).sum())} codes, {int((s != ws).sum())} scales differ)")
        check(same_bits(torch, out, want),
              f"dequant int{bits} ({R}, {N}): not bit-identical "
              f"(max {float((out - want).abs().max())})")
        errs["quant"] = max(errs["quant"], diff(q, wq), diff(s, ws))
        errs["dequant"] = max(errs["dequant"], diff(out, want))
        log(f"quant + dequant ({R}, {N}) int{bits}: bit-identical")
        if bits == 8:
            nbytes_q = R * N * 4 + R * N + R * (N // 128) * 2
            ms = time_ms(torch, lambda: pk.quant_flat(x, qmax=qmax), flush)
            plain = time_ms(torch, lambda: pr.quant_blocks_ref(x, qmax=qmax, block=128), flush)
            b_ms, b_by = bound(nbytes_q, 6 * R * N)
            records["quant"] = _record("quant", 37, ms, plain, b_ms, b_by)
            ms = time_ms(torch, lambda: pk.dequant_flat(q, s), flush)
            plain = time_ms(torch, lambda: pr.dequant_blocks_ref(q, s, block=128), flush)
            b_ms, b_by = bound(nbytes_q, R * N)
            records["dequant"] = _record("dequant", 48, ms, plain,
                                         b_ms, b_by)
            # a yardstick, not the same function: PyTorch's int8 -> float32
            # cast moves the same bytes
            cast = time_ms(torch, lambda: q.float(), flush)
            log(f"dequant yardstick: q.float() alone, the same bytes, {cast:.4f} ms")
        else:
            # the int4 codes of the leaf's top-k 0.25 values, as the main
            # path's uplink packs them
            vals, _ = TopK(0.25).encode(x, batch_ndims=1)
            k = vals.shape[1]
            codes, cs = pk.quant_flat(vals.contiguous(), qmax=qmax)
            p = pk.pack4_flat(codes)
            back = pk.unpack4_flat(p)
            dq = pk.dequant_flat(codes, cs)
            torch.cuda.synchronize()
            check(same_bits(torch, dq, pr.dequant_blocks_ref(codes, cs, block=128)),
                  f"dequant int4 ({R}, {k}): not bit-identical")
            check(same_bits(torch, p, pr.pack4_ref(codes)),
                  f"pack4 ({R}, {k}): not bit-identical")
            check(torch.equal(back, codes) and torch.equal(back, pr.unpack4_ref(p)),
                  f"unpack4 ({R}, {k // 2}): not bit-identical")
            check(bool((codes == -qmax).any() & (codes == qmax).any()),
                  "pack4: the codes do not reach both -7 and 7")
            # the general routes: the same codes and bytes one byte past
            # 16-byte alignment
            for t, fn, plain in ((codes, pk.pack4_flat, pr.pack4_ref),
                                 (p, pk.unpack4_flat, pr.unpack4_ref)):
                buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=dev)
                shifted = buf[1:1 + t.numel()].view(t.shape)
                shifted.copy_(t)
                check(same_bits(torch, fn(shifted), plain(t)),
                      f"{fn.__name__} at a misaligned view: not bit-identical")
            errs["pack4"] = diff(p, pr.pack4_ref(codes))
            errs["unpack4"] = max(diff(back, codes), diff(back, pr.unpack4_ref(p)))
            log(f"pack4 + unpack4 ({R}, {k}) int4, both routes: bit-identical")
            nbytes_p = R * k + R * k // 2
            ms = time_ms(torch, lambda: pk.pack4_flat(codes), flush)
            plain = time_ms(torch, lambda: pr.pack4_ref(codes), flush)
            b_ms, b_by = bound(nbytes_p, 4 * R * k // 2)
            records["pack4"] = _record("pack4", 53, ms, plain, b_ms, b_by)
            ms = time_ms(torch, lambda: pk.unpack4_flat(p), flush)
            plain = time_ms(torch, lambda: pr.unpack4_ref(p), flush)
            b_ms, b_by = bound(nbytes_p, 6 * R * k // 2)
            records["unpack4"] = _record("unpack4", 61, ms, plain,
                                         b_ms, b_by)
            # dequant at the chain's shape, where the main path's launches run
            ms = time_ms(torch, lambda: pk.dequant_flat(codes, cs), flush)
            b_ms, _ = bound(R * k * 5 + cs.numel() * 2, R * k)
            log(f"dequant at the top-k + int4 chain's shape ({R}, {k}): kernel {ms:.4f} ms, "
                f"bound {b_ms:.4f} ms ({100 * b_ms / ms:.1f}% of it)")
    for r in records.values():
        r["max_abs_err"] = errs[r["name"]]
        log(f"{r['name']} timing: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    floor = time_ms(torch, lambda: torch.cuda._sleep(1), flush)
    log(f"one empty launch (torch.cuda._sleep(1)) through the same timing: {floor:.4f} ms")
    for name in pk.KERNELS:
        a = pk.kernel_attrs(name)
        log(f"qpack {name}: {a['num_regs']} registers, {a['local_bytes']} local bytes a thread")
        check(a["local_bytes"] == 0, f"qpack {name} spills: {a['local_bytes']} local bytes")
    try:
        pk.quant_flat(x.t().contiguous().t(), qmax=127)
    except ValueError:
        pass
    else:
        raise SmokeFailure("quant took a non-contiguous CUDA tensor")
    return [records[k] for k in ("quant", "dequant", "pack4", "unpack4")]


def _record(name, line, ms, plain, b_ms, b_by):
    return {"name": name, "route": "cuda", "source": "src/repro_torch/csrc/qpack.cu",
            "replaces": f"src/repro/kernels/qpack/kernel.py:{line}",
            "max_abs_err": None, "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}


def check_adam_sync(torch, dev, flush):
    """Kernel 7, the fused Adam step with the uplink quantize, on the image
    experiment's ACGAN trees at full width (B = 5): the state after one
    round of training (moments and count of real steps) and one local
    step's gradients of G and D.  The main path is ``adam_sync_tree`` on
    each tree, one launch each, counted; then every output bit for bit
    against the plain version and against ``Adam.update`` followed by the
    qpack quantize of the bucketed new params, on the card.  Timed at the
    generator bucket beside the plain version and that composed form."""
    from torch.func import vmap
    from repro_torch.core.fedgan import _flat
    from repro_torch.kernels.qpack.kernel import quant_flat
    from repro_torch.kernels.qpack.ops import quantize_blocks
    from repro_torch.kernels.qsync import kernel as qk, ops as qops
    from repro_torch.kernels.qsync.ref import adam_sync_flat_ref
    from repro_torch.launch.train import experiment_spec
    from repro_torch.optim import Adam
    from repro_torch.tree import tree_leaves
    spec, _ = experiment_spec("image_acgan", steps=20, log_every=0, device=dev)
    result = spec.run_result()
    fed, state = result.fed, result.state
    batch = spec.build_data().sample_step(torch.Generator(device=dev).manual_seed(8))
    params = _flat(state["params"], B)
    gd, gg, _ = vmap(fed._agent_grads)(params, _flat(batch, B))
    lr, adam = 1e-3, Adam(b1=0.5, b2=0.999)

    def opt(key):   # one agent-stacked Adam state with the agents' shared count
        flat = _flat(state[key], B)
        return {"count": flat["count"][0], "mu": flat["mu"], "nu": flat["nu"]}

    trees = {"gen": (params["gen"], gg, opt("opt_g")), "disc": (params["disc"], gd, opt("opt_d"))}
    counters = launch_counters()
    _reset(counters)
    outs = {k: qops.adam_sync_tree(p, g, o, lr=lr) for k, (p, g, o) in trees.items()}
    torch.cuda.synchronize()
    counts = _read(counters)
    want = {n: 2 if n == "adam_sync" else 0 for n in counters}
    check(counts == want, f"adam_sync_tree on G and D: launches {counts}, expected {want}")
    bucket = lambda t: qops._bucket(tree_leaves(t), B, 128)[0]
    record, max_err = None, 0.0
    for k, (p, g, o) in trees.items():
        p2, o2, q, sc = outs[k]
        c = (o["count"] + 1).to(torch.float32)
        hyper = torch.stack([torch.tensor(lr, device=dev), 1.0 - 0.5 ** c,
                             1.0 - 0.999 ** c]).reshape(1, 3)
        args = (hyper, bucket(p), bucket(g), bucket(o["mu"]), bucket(o["nu"]))
        kw = dict(b1=0.5, b2=0.999, eps=1e-8, qmax=127, block=128)
        plain = adam_sync_flat_ref(*args, **kw)
        got = (bucket(p2), bucket(o2["mu"]), bucket(o2["nu"]), q, sc)
        for what, a, b in zip(("params", "mu", "nu", "codes", "scales"), got, plain):
            check(same_bits(torch, a, b), f"adam_sync {k}: {what} differs from the plain "
                                          f"version on {int((a != b).sum())} elements")
            max_err = max(max_err, (a.double() - b.double()).abs().max().item())
        ref_p, ref_o = adam.update(p, g, o, lr)
        rq, rs = quant_flat(bucket(ref_p), qmax=127)
        for what, a, b in (("params", p2, ref_p), ("mu", o2["mu"], ref_o["mu"]),
                           ("nu", o2["nu"], ref_o["nu"])):
            check(all(same_bits(torch, x, y) for x, y in zip(tree_leaves(a), tree_leaves(b))),
                  f"adam_sync {k}: {what} differs from Adam.update")
        check(same_bits(torch, q, rq) and same_bits(torch, sc, rs),
              f"adam_sync {k}: codes or scales differ from quantize of Adam.update's params")
        check(int(o2["count"]) == int(o["count"]) + 1, f"adam_sync {k}: count not stepped")
        R, N = args[1].shape
        log(f"adam_sync {k} bucket ({R}, {N}), count {int(o['count'])}: bit-identical to "
            f"its plain version and to Adam.update + quantize")
        if k == "gen":
            run = lambda: qk.adam_sync_flat(*args, **kw)
            ms = time_ms(torch, run, flush)
            plain_ms = time_ms(torch, lambda: adam_sync_flat_ref(*args, **kw), flush)
            # the composed form the kernel replaces, on this bucket, read
            # twice around Adam.update alone and a control on random tensors
            # of its shape (the same operations), each from a settled
            # allocator; the host's dispatch of the composed form is read
            # too, since the 2 ms spin hides only that much of it
            flat_state = {"count": o["count"], "mu": args[3], "nu": args[4]}
            composed = lambda st, p_, g_: quantize_blocks(adam.update(p_, g_, st, lr)[0], bits=8)
            rnd = [torch.randn(args[1].shape, device=dev) for _ in range(4)]
            rnd_state = {"count": o["count"], "mu": rnd[2], "nu": rnd[3].abs()}
            readings = {}
            for what, fn in (
                    ("composed", lambda: composed(flat_state, args[1], args[2])),
                    ("update", lambda: adam.update(args[1], args[2], flat_state, lr)),
                    ("control", lambda: composed(rnd_state, rnd[0], rnd[1])),
                    ("composed again", lambda: composed(flat_state, args[1], args[2]))):
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                readings[what] = time_ms(torch, fn, flush)
            dispatch = []
            for _ in range(REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                composed(flat_state, args[1], args[2])
                dispatch.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            del rnd, rnd_state
            # read p, g, mu, nu and the hyper row; write p', mu', nu', the codes, the scales
            nbytes = R * N * (16 + 13) + R * (N // 128) * 2 + 12
            b_ms, b_by = bound(nbytes, 15 * R * N)
            record = {"name": "adam_sync", "route": "cuda",
                      "source": "src/repro_torch/csrc/qsync.cu",
                      "replaces": "src/repro/kernels/qsync/kernel.py:124",
                      "launches": counts["adam_sync"], "max_abs_err": None, "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": None}
            log(f"adam_sync timing ({R}, {N}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"Adam.update + quantize_blocks {readings['composed']:.4f} ms, again "
                f"{readings['composed again']:.4f} ms (Adam.update alone "
                f"{readings['update']:.4f} ms; on random tensors of the shape "
                f"{readings['control']:.4f} ms; host dispatch of the composed form "
                f"{statistics.median(dispatch):.4f} ms), "
                f"bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB)")
    record["max_abs_err"] = max_err
    return record


def check_composed_vs_fused(torch, dev):
    """From the full-width state after one int8 round with error feedback,
    the coded sync of each subtree fused and composed, at 8 and 4 bits:
    every output bit-identical."""
    from repro_torch.comm import IntQuant
    from repro_torch.core import FedAvgSync
    from repro_torch.dist import collectives
    from repro_torch.launch.train import experiment_spec
    from repro_torch.tree import tree_leaves
    spec, _ = experiment_spec("image_acgan", steps=20, log_every=0, device=dev,
                              strategy=FedAvgSync(codec=IntQuant(8)))
    result = spec.run_result()
    state, w = result.state, result.fed._w(dev)
    for bits in (8, 4):
        for k in ("gen", "disc"):
            args = (state["params"][k], w, IntQuant(bits))
            kw = {"ef": state["ef"][k], "ef_down": state["ef_down"][k]}
            fused = collectives.coded_sync(*args, **kw, fused=True)
            composed = collectives.coded_sync(*args, **kw, fused=False)
            torch.cuda.synchronize()
            for what, f, c in zip(("synced", "new_ef", "new_ef_down"), fused, composed):
                for i, (a, b) in enumerate(zip(tree_leaves(f), tree_leaves(c))):
                    check(same_bits(torch, a, b),
                          f"composed vs fused int{bits} {k} leaf {i}: {what} differs "
                          f"on {int((a != b).sum())} elements")
        log(f"composed vs fused int{bits} + EF, full-width state after one round: "
            f"bit-identical")


def _small_round(torch, dev, codec, K):
    """One K-step round of the image experiment's nets at 8x8, SGD, from
    the same weights and batches on the card and on the CPU (the plain
    versions).  Returns the leaves over their limit, the largest ratio of
    a difference to its limit with its leaf, and (int8) the elements over
    the plain limit and the elements compared."""
    from repro_torch.core import FedAvgSync, FedGAN, FedGANConfig
    from repro_torch.launch.train import acgan_task
    from repro_torch.optim import SGD, constant, equal_timescale
    from repro_torch.tree import tree_map
    from torch_shared import named_leaves
    grid, b = (1, B), 8
    g = torch.Generator().manual_seed(3)
    batches = {"x": torch.rand((K,) + grid + (b, 8, 8, 3), generator=g) * 2 - 1,
               "y": torch.randint(0, 10, (K,) + grid + (b,), generator=g),
               "z": torch.randn((K,) + grid + (b, 62), generator=g)}
    task, _ = acgan_task(hw=8)
    fed = FedGAN(task, FedGANConfig(agent_grid=grid, sync_interval=K,
                                    strategy=FedAvgSync(codec=codec)),
                 opt_g=SGD(), opt_d=SGD(), scales=equal_timescale(constant(0.05)))
    out = {}
    for d in ("cpu", dev):
        state = fed.init_state(torch.Generator().manual_seed(4), device=d)
        out[str(d)], _ = fed.round(state, tree_map(lambda x: x.to(d), batches))
    bad, over, total, worst = [], 0, 0, (-1.0, None)
    for (path, c), (_, k) in zip(named_leaves(out["cpu"]["params"]),
                                 named_leaves(out[str(dev)]["params"])):
        diff = (c - k.cpu()).abs()
        tol = 1e-4 * max(1.0, float(c.abs().max()))
        lim = tol
        if codec is not None:
            # a downlink code flip moves one quantum; an uplink flip
            # adds w_b = 1/B of an agent's quantum on top
            lim = tol + 1.5 * float(c.abs().max()) / 127
            over += int((diff > tol).sum())
            total += diff.numel()
        if not bool((diff <= lim).all()):
            bad.append(f"{path} by {float(diff.max())} (limit {lim})")
        worst = max(worst, (float(diff.max()) / lim, path), key=lambda r: r[0])
    return bad, worst, over, total


def check_small_round(torch, dev):
    """One round (K = 1, ``torch_shared.CARD_K``) of the image experiment's
    nets at 8x8, SGD, from the same weights and batches on the card and on
    the CPU (the plain versions): plain sync within 1e-4 of each leaf's
    magnitude (float32 roundoff of cuDNN against the CPU library); int8
    sync additionally within 1.5 quanta of the leaf's coarsest block on at
    most 2% of the elements (values at a rounding tie may take the
    neighbouring code).  Prints the largest ratio of a difference to its
    limit, and its leaf, and that ratio at K = 2, not held: there the
    second step amplifies a rounding difference (``CARD_K``), and the CPU
    round alone moves by most of the plain limit with the host's kernel
    dispatch (ATen's scalar kernels against its vector ones, say), so the
    reference would depend on the machine."""
    from repro_torch.comm import IntQuant
    from torch_shared import CARD_K
    for codec in (None, IntQuant(8)):
        what = "int8" if codec else "plain"
        bad, worst, over, total = _small_round(torch, dev, codec, CARD_K)
        check(bad == [], f"small {what} round: card and CPU differ on {bad}")
        check(over <= 0.02 * max(total, 1), f"small int8 round: {over} codes moved")
        bad2, worst2, over2, _ = _small_round(torch, dev, codec, 2)
        log(f"small round card vs CPU ({what}): agree at K = {CARD_K}; largest "
            f"|card - CPU| / limit {worst[0]:.4g} at {worst[1]} (K = 2, not held: "
            f"{worst2[0]:.4g} at {worst2[1]}, {len(bad2)} leaves over"
            + (f", {over2} elements past the plain limit)" if codec else ")"))


def check_card_rounds(torch, dev):
    """One round (K = 1) of each paper experiment at test size (ACGAN nets
    at 8x8) on the card against the same round on the CPU port, from one
    start state and the same numpy batches, held to the bounds the CPU
    round is held to against the reference (``tests/torch_shared.py``).
    Prints each experiment's largest ratio of a difference to its limit,
    and, not held, the same at K = 2, where an activation input at rounding
    distance from its kink that changes sign moves an agent's second step
    (``torch_shared.CARD_K``)."""
    from torch_shared import CARD_K, ROUND_TASKS, port_round_mismatches
    for name in sorted(ROUND_TASKS):
        bad, (ratio, path) = port_round_mismatches(name, dev, K=CARD_K)
        check(bad == [], f"{name} round, card against CPU: {bad}")
        bad2, (ratio2, path2) = port_round_mismatches(name, dev, K=2)
        log(f"{name} round card vs CPU: agree at K = {CARD_K}; largest |card - CPU| / limit "
            f"{ratio:.4g} at {path} (K = 2, not held: {ratio2:.4g} at {path2}, "
            f"{len(bad2)} leaves over)")


def _kernel_close(torch, got, want, what):
    """float32: within 1e-5 of max |want|; bfloat16: that plus two bfloat16
    ulps (2^-6 of the larger magnitude) of the element.  Returns the
    largest error."""
    g, w = got.float(), want.float()
    bound_ = 1e-5 * float(w.abs().max()) + torch.zeros_like(w)
    if got.dtype == torch.bfloat16:
        bound_ = bound_ + 2.0 ** -6 * torch.maximum(g.abs(), w.abs())
    err = (g - w).abs()
    check(bool((err <= bound_).all()), f"{what}: kernel disagrees with plain "
                                       f"(max {float(err.max())})")
    return float(err.max())


def _flash_pairs(T, S, window):
    """(query, key) pairs per head that the causal mask, ``kpos < S`` and
    the window leave unmasked: the least work attention needs."""
    n = 0
    for q in range(T):
        lo = max(0, q - window + 1) if window > 0 else 0
        n += max(0, min(q, S - 1) - lo + 1)
    return n


def _sdpa_backend(torch, fn):
    """The name of the device kernel that takes most of ``fn``'s time, as
    the profiler sees it: a label for the log, not a check."""
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    except Exception as exc:  # the profiler is a label here; the timing stands
        return f"not measured ({type(exc).__name__})"
    if not events:
        return "not measured"
    top = max(events, key=lambda e: getattr(e, "device_time_total", 0))
    return top.key[:120]


def check_flash(torch, dev, flush):
    """The flash kernel against its plain version: gemma3-4b's shapes in
    bfloat16 (windows 1024 and 0), zamba2-7b's shared attention (head_dim
    112, causal) and whisper-medium's encoder (non-causal) in bfloat16,
    float32 without GQA, with GQA 4:1 and at head_dim 112.  Timing at
    gemma3-4b's local layers' window 1024 (29 of the 34 launches of a
    prefill; the kernels line's record) and global layers' 0, and at the
    two new shapes."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import (HEAD_DIMS, bf16_kernel_attrs,
                                                            flash_attention_bhsd)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    for hd in HEAD_DIMS:
        a = bf16_kernel_attrs(hd)
        log(f"flash_fwd_tc<{hd}>: {a['num_regs']} registers, {a['local_bytes']} local bytes "
            f"a thread, {a['smem_bytes']} shared bytes a block, {a['blocks_per_sm']} "
            f"blocks an SM")
        check(hd not in (112, 256) or a["local_bytes"] == 0,
              f"flash_fwd_tc<{hd}> spills: {a['local_bytes']} local bytes a thread")
    gen = torch.Generator(device=dev).manual_seed(6)
    # (B, nh, nkv, T, hd, window, causal, dtype, timed label or None)
    cases = [(2, 8, 4, 2000, 256, 1024, True, torch.bfloat16, "gemma3-4b local"),
             (2, 8, 4, 2000, 256, 0, True, torch.bfloat16, "gemma3-4b global"),
             (2, 32, 32, 2048, 112, 0, True, torch.bfloat16, "zamba2-7b shared attention"),
             (2, 16, 16, 1500, 64, 0, False, torch.bfloat16, "whisper-medium encoder"),
             (2, 4, 4, 333, 64, 0, True, torch.float32, None),
             (2, 8, 2, 333, 128, 100, True, torch.float32, None),
             (2, 4, 4, 333, 112, 0, False, torch.float32, None)]
    record, err_max = None, 0.0
    for (Bq, nh, nkv, T, hd, window, causal, dtype, label) in cases:
        q = torch.randn((Bq, nh, T, hd), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn((Bq, nkv, T, hd), generator=gen, device=dev).to(dtype)
                for _ in range(2))
        got = flash_attention_bhsd(q, k, v, causal=causal, window=window)
        want = attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        what = (f"flash q {tuple(q.shape)} kv {tuple(k.shape)} "
                f"{'causal' if causal else 'non-causal'} window {window} {dtype}")
        err = _kernel_close(torch, got, want, what)
        err_max = max(err_max, err) if dtype == torch.bfloat16 else err_max
        log(f"{what}: max_abs_err={err} (max |o| {float(want.float().abs().max())})")
        if label is None:
            continue
        mask = None
        if causal:
            pos = torch.arange(T, device=dev)
            mask = pos[:, None] >= pos[None, :]
            if window:
                mask &= pos[:, None] - pos[None, :] < window

        def lib():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)
        # the yardstick must compute the same function (it rounds p to
        # bfloat16 for p.v, so it is held loosely: 2^-5 of max |o|)
        check(float((lib().float() - want.float()).abs().max())
              <= 2.0 ** -5 * float(want.float().abs().max()),
              f"{what}: scaled_dot_product_attention disagrees with the plain version")
        ms = time_ms(torch, lambda: flash_attention_bhsd(q, k, v, causal=causal, window=window),
                     flush)
        plain = time_ms(torch, lambda: attention_ref(q, k, v, causal=causal, window=window),
                        flush)
        lib_ms = time_ms(torch, lib, flush)
        pairs = _flash_pairs(T, T, window) if causal else T * T
        ops = Bq * nh * pairs * 4 * hd                  # q.k and p.v of the unmasked pairs
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        b_ms, b_by = bound(nbytes, ops, BF16_OPS_PER_S)
        log(f"flash timing {label}, {what}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"scaled_dot_product_attention {lib_ms:.4f} ms "
            f"({_sdpa_backend(torch, lib)}), bound {b_ms:.4f} ms ({b_by}, {pairs} unmasked "
            f"pairs per head, {ops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
        log(f"flash {label}: the kernel is {max(ms, lib_ms) / min(ms, lib_ms):.2f}x "
            f"{'faster' if ms < lib_ms else 'slower'} than scaled_dot_product_attention "
            f"({ms:.4f} against {lib_ms:.4f} ms), {b_ms / ms:.1%} of its bound")
        if window:
            record = {"name": "flash_attention", "route": "cuda",
                      "source": "src/repro_torch/csrc/flash_attention.cu",
                      "replaces": "src/repro/kernels/flash_attention/kernel.py:29",
                      "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": lib_ms}
    record["max_abs_err"] = err_max
    return record


def check_ssd(torch, dev, flush):
    """The SSD kernel against its plain version at mamba2-2.7b's shapes;
    each phase timed alone."""
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_scan.kernel import (kernel_attrs, ssd_bthd, ssd_phase,
                                                     workspace)
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    gen = torch.Generator(device=dev).manual_seed(7)
    Bsz, T, nh, hd, ds, Q = 2, 2048, 80, 64, 128, 128
    x = (0.5 * torch.randn((Bsz, T, nh, hd), generator=gen, device=dev)).bfloat16()
    dt = F.softplus(torch.randn((Bsz, T, nh), generator=gen, device=dev))
    A = -torch.exp(torch.randn((nh,), generator=gen, device=dev))
    Bm, Cm = ((0.5 * torch.randn((Bsz, T, ds), generator=gen, device=dev)).bfloat16()
              for _ in range(2))
    got = ssd_bthd(x, dt, A, Bm, Cm, chunk=Q)
    want = ssd_ref(x, dt, A, Bm, Cm, chunk=Q)
    torch.cuda.synchronize()
    what = f"ssd x {tuple(x.shape)} state {ds} chunk {Q} bfloat16"
    err = _kernel_close(torch, got, want, what)
    log(f"{what}: max_abs_err={err} (max |y| {float(want.float().abs().max())})")
    for dtype in (torch.bfloat16, torch.float32):
        for phase in (1, 2, 3):
            a = kernel_attrs(phase, dtype)
            log(f"ssd phase {phase} ({dtype}): {a['num_regs']} registers, {a['local_bytes']} "
                f"local bytes a thread, {a['smem_bytes']} shared bytes a block, "
                f"{a['blocks_per_sm']} blocks an SM")
            check(a["local_bytes"] == 0,
                  f"ssd phase {phase} ({dtype}) spills: {a['local_bytes']} local bytes")
    ms = time_ms(torch, lambda: ssd_bthd(x, dt, A, Bm, Cm, chunk=Q), flush)
    plain = time_ms(torch, lambda: ssd_ref(x, dt, A, Bm, Cm, chunk=Q), flush)
    ws, y = workspace(x, Bm, chunk=Q), torch.empty_like(x)
    phase_ms = [time_ms(torch, lambda p=p: ssd_phase(p, x, dt, A, Bm, Cm, y, ws, chunk=Q),
                        flush) for p in (1, 2, 3)]
    for p in (1, 2, 3):      # in turn, once: the scan's output bit for bit
        ssd_phase(p, x, dt, A, Bm, Cm, y, ws, chunk=Q)
    torch.cuda.synchronize()
    check(torch.equal(y, got), "ssd: the three phases run alone differ from the scan")
    NC = T // Q
    # the chunked algorithm's products: C.B^T once per (batch, chunk); per
    # head the intra-chunk product, the inter-chunk product and the state
    ops = Bsz * NC * (2 * Q * Q * ds + nh * (2 * Q * Q * hd + 4 * Q * hd * ds))
    nbytes = 2 * x.numel() * 2 + dt.numel() * 4 + A.numel() * 4 + 2 * Bm.numel() * 2
    b_ms, b_by = bound(nbytes, ops, BF16_OPS_PER_S)
    log(f"ssd timing: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}, {ops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
    log(f"ssd phases alone: chunk states {phase_ms[0]:.4f} ms, state pass "
        f"{phase_ms[1]:.4f} ms, chunk outputs {phase_ms[2]:.4f} ms (sum "
        f"{sum(phase_ms):.4f}); workspace {ws.numel() * 4} bytes")
    err = max(err, check_ssd_final_state(torch, dev, flush))
    return {"name": "ssd_scan", "route": "cuda", "source": "src/repro_torch/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan/kernel.py:26", "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


def check_ssd_final_state(torch, dev, flush):
    """The SSD scan at zamba2-7b's shapes (x (2, 2048, 112, 64) bfloat16,
    state 64, chunk 128: the generic instantiation) with its final state,
    the decode cache of a prefill: the output and the (2, 112, 64, 64)
    float32 state against ``ssd_ref(return_final_state=True)`` with the
    tolerance above; timed with and without the state, with its bound.
    Returns the output's largest error."""
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_scan.kernel import ssd_bthd
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    gen = torch.Generator(device=dev).manual_seed(8)
    Bsz, T, nh, hd, ds, Q = 2, 2048, 112, 64, 64, 128
    x = (0.5 * torch.randn((Bsz, T, nh, hd), generator=gen, device=dev)).bfloat16()
    dt = F.softplus(torch.randn((Bsz, T, nh), generator=gen, device=dev))
    A = -torch.exp(torch.randn((nh,), generator=gen, device=dev))
    Bm, Cm = ((0.5 * torch.randn((Bsz, T, ds), generator=gen, device=dev)).bfloat16()
              for _ in range(2))
    got, state = ssd_bthd(x, dt, A, Bm, Cm, chunk=Q, return_final_state=True)
    want, want_state = ssd_ref(x, dt, A, Bm, Cm, chunk=Q, return_final_state=True)
    torch.cuda.synchronize()
    what = f"ssd x {tuple(x.shape)} state {ds} chunk {Q} bfloat16 with its final state"
    err = _kernel_close(torch, got, want, what)
    s_err = _kernel_close(torch, state, want_state, what + " (the state)")
    check(torch.equal(got, ssd_bthd(x, dt, A, Bm, Cm, chunk=Q)),
          f"{what}: the output differs from the scan's without the state")
    log(f"{what}: max_abs_err={err} (max |y| {float(want.float().abs().max())}); state "
        f"{tuple(state.shape)} max_abs_err={s_err} (max |state| "
        f"{float(want_state.abs().max())})")
    ms = time_ms(torch, lambda: ssd_bthd(x, dt, A, Bm, Cm, chunk=Q, return_final_state=True),
                 flush)
    ms_y = time_ms(torch, lambda: ssd_bthd(x, dt, A, Bm, Cm, chunk=Q), flush)
    plain = time_ms(torch, lambda: ssd_ref(x, dt, A, Bm, Cm, chunk=Q, return_final_state=True),
                    flush)
    NC = T // Q
    ops = Bsz * NC * (2 * Q * Q * ds + nh * (2 * Q * Q * hd + 4 * Q * hd * ds))
    nbytes = (2 * x.numel() * 2 + dt.numel() * 4 + A.numel() * 4 + 2 * Bm.numel() * 2
              + state.numel() * 4)
    b_ms, b_by = bound(nbytes, ops, BF16_OPS_PER_S)
    log(f"ssd timing at zamba2-7b's shapes: kernel with the final state {ms:.4f} ms "
        f"(without {ms_y:.4f} ms), plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
        f"{ops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB), {b_ms / ms:.2%} of the bound")
    return err


# What a checkout's own chip_smoke times, by --<what>-parent: {kernel: ms}.
AGAINST = {
    "ssd": "{'ssd': cs.check_ssd(torch, dev, flush)['ms']}",
    "qpack": "{r['name']: r['ms'] for r in cs.check_qpack(torch, dev, flush) "
             "if r['name'] in ('dequant', 'pack4', 'unpack4')}",
}


def kernels_against(other, what):
    """The ``what`` kernels (``AGAINST``) of the checkout ``other`` timed
    beside this one's, on this card, in turns (other, this, this, other):
    each run a process of its own through its checkout's own
    ``chip_smoke``."""
    other = os.path.abspath(other)
    check(os.path.isfile(os.path.join(other, "chip_smoke.py")),
          f"--{what}-parent {other}: no chip_smoke.py there")
    runs = {}
    for root in (other, ROOT, ROOT, other):
        code = (f"import json, sys, torch; sys.path[:0] = [{root!r}, "
                f"{os.path.join(root, 'src')!r}]; "
                "import chip_smoke as cs, repro_torch; dev = torch.device('cuda'); "
                "flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev); "
                f"print('KERNEL_MS', json.dumps({AGAINST[what]}))")
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             timeout=900, cwd=root)
        check(out.returncode == 0, f"{what} timing in {root} failed:\n{out.stdout}{out.stderr}")
        line = [ln for ln in out.stdout.splitlines() if ln.startswith("KERNEL_MS ")][-1]
        for name, ms in json.loads(line.split(" ", 1)[1]).items():
            runs.setdefault(name, []).append(("other" if root == other else "this", ms))
    for name, turns in runs.items():
        log(f"{name} kernel, this checkout against {other}: " +
            ", ".join(f"{who} {ms:.4f} ms" for who, ms in turns))


def _reset(counters):
    for c in counters.values():
        c.launches = 0


def _read(counters):
    return {name: c.launches for name, c in counters.items()}


def _logits_close(torch, got, want, rel, what):
    """|got - want| within ``rel`` of the largest |want|; both finite."""
    check(bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all()),
          f"{what}: non-finite logits")
    err, top = float((got - want).abs().max()), float(want.abs().max())
    check(err <= rel * top, f"{what}: logits differ by {err}, over {rel} x {top}")
    return err, top


def run_gemma(torch, dev):
    """gemma3-4b at full width: prefill through the flash kernel, greedy
    decode with a per-row index, the plain route's prefill beside it."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import Backbone
    from repro_torch.tree import tree_leaves
    cfg = get_config("gemma3-4b")
    B, T, steps = 2, 2048, 16
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.resolved_head_dim, cfg.d_ff, cfg.padded_vocab) ==
          (34, 2560, 8, 4, 256, 10240, 262_144), "gemma3-4b is not at full width")
    bb = Backbone(cfg, use_flash=True)
    t0 = time.perf_counter()
    params = bb.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(params))
    log(f"gemma3-4b: {n_params} parameters initialised on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    toks = torch.randint(0, cfg.vocab_size, (B, T),
                         generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    counters = launch_counters()
    bb.prefill(params, toks, max_seq=T + steps)     # warm-up: cuBLAS picks its kernels
    torch.cuda.synchronize()
    _reset(counters)
    t0 = time.perf_counter()
    pre = bb.prefill(params, toks, max_seq=T + steps)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_counts = _read(counters)
    want = {n: 34 if n == "flash_attention" else 0 for n in counters}
    check(prefill_counts == want, f"gemma3-4b prefill: launches {prefill_counts}, "
                                  f"expected {want}")
    logits = pre["logits"]
    check(tuple(logits.shape) == (B, 1, cfg.padded_vocab), "gemma3-4b prefill: logits shape")
    check(bool(torch.isfinite(logits).all()), "gemma3-4b prefill: non-finite logits")
    cache = pre["cache"]
    check(tuple(cache["local"]["k"].shape) == (5, 5, B, T + steps, 4, 256) and
          tuple(cache["tail"]["k"].shape) == (4, B, T + steps, 4, 256),
          "gemma3-4b prefill: cache shapes")
    _reset(counters)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    out = []
    t0 = time.perf_counter()
    for s in range(steps):
        index = torch.full((B,), T + s, device=dev)
        lg, cache = bb.decode(params, tok, cache, index)
        check(tuple(lg.shape) == (B, 1, cfg.padded_vocab), "gemma3-4b decode: logits shape")
        out.append(lg)
        tok = lg[:, -1].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / steps
    decode_counts = _read(counters)
    check(all(v == 0 for v in decode_counts.values()),
          f"gemma3-4b decode: launches {decode_counts}, expected none")
    check(all(bool(torch.isfinite(lg).all()) for lg in out), "gemma3-4b decode: non-finite")
    plain = Backbone(cfg, use_flash=False).prefill(params, toks, max_seq=T + steps)["logits"]
    torch.cuda.synchronize()
    err, top = _logits_close(torch, logits, plain, 2.0 ** -5,
                             "gemma3-4b prefill, flash vs plain route")
    same = float((logits[:, -1].argmax(-1) == plain[:, -1].argmax(-1)).float().mean())
    log(f"gemma3-4b: prefill {B} x {T} tokens {prefill_ms:.1f} ms, decode "
        f"{decode_ms:.2f} ms per step ({steps} greedy steps, per-row index), flash "
        f"launches {prefill_counts['flash_attention']} in the prefill and "
        f"{decode_counts['flash_attention']} in the decode; last-token logits vs "
        f"use_flash=False: max |diff| {err} of max |logit| {top}, same argmax on "
        f"{same:.2f} of rows; peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return prefill_counts["flash_attention"], params


def run_mamba(torch, dev):
    """mamba2-2.7b at full width: the bfloat16 forward through the SSD
    kernel (the main path), held to the plain chunked scan layer by layer
    and, in float32 compute on the same weights, at the logits.

    A random-init mamba2 at bfloat16 is chaotic: the kernel and the plain
    scan round y to bfloat16 at different elements (each within two ulps),
    and over 64 layers those differences grow to the size of the logits
    (measured 70% of max |logit|).  So the bf16 run is compared layer by
    layer, each mixer from the same normed input, and the whole model in
    float32."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import Backbone
    from repro_torch.models.layers import make_norm
    from repro_torch.models.transformer import _layer
    from repro_torch.tree import tree_leaves
    cfg = get_config("mamba2-2.7b")
    B, T = 2, 2048
    check((cfg.num_layers, cfg.d_model, cfg.d_inner, cfg.resolved_ssm_heads, cfg.ssm_state,
           cfg.ssm_chunk, cfg.padded_vocab) == (64, 2560, 5120, 80, 128, 128, 50_432),
          "mamba2-2.7b is not at full width")
    bb = Backbone(cfg, use_ssd_kernel=True)
    params = bb.init(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(x.numel() for x in tree_leaves(params))
    toks = torch.randint(0, cfg.vocab_size, (B, T),
                         generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    counters = launch_counters()
    bb.apply(params, toks)                           # warm-up
    torch.cuda.synchronize()
    _reset(counters)
    t0 = time.perf_counter()
    logits = bb.apply(params, toks)["logits"]
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    counts = _read(counters)
    want = {n: 64 if n == "ssd_scan" else 0 for n in counters}
    check(counts == want, f"mamba2-2.7b forward: launches {counts}, expected {want}")
    check(tuple(logits.shape) == (B, T, cfg.padded_vocab), "mamba2-2.7b: logits shape")
    check(bool(torch.isfinite(logits).all()), "mamba2-2.7b: non-finite logits")
    # the whole bf16 model against the plain scan, logged and not held: the
    # gap is the amplification described above
    plain16 = Backbone(cfg).apply(params, toks)["logits"]
    drift = float((logits - plain16).abs().max()) / float(plain16.abs().max())
    agree = float((logits.argmax(-1) == plain16.argmax(-1)).float().mean())
    del logits, plain16
    # bf16, layer by layer: each layer's mixer (Mamba2Block.apply, no
    # residual, which both routes would share exactly) through the kernel,
    # within 2^-5 of the largest |output| of the plain scan's mixer, from
    # the same normed input (the plain route's own hidden state)
    kern, plain = bb._mamba().inner, Backbone(cfg)._mamba().inner
    norm = make_norm(cfg, cfg.d_model)
    h, worst = bb._embed(params, toks), 0.0
    for i in range(cfg.num_layers):
        bp = _layer(params["blocks"], i)
        u = norm.apply(bp["ln"], h)
        got, want = kern.apply(bp["mixer"], u), plain.apply(bp["mixer"], u)
        err = float((got.float() - want.float()).abs().max()) / float(want.float().abs().max())
        check(bool(torch.isfinite(got).all()) and err <= 2.0 ** -5,
              f"mamba2-2.7b layer {i}: the kernel route's mixer differs by {err} of "
              f"its max |output|")
        worst = max(worst, err)
        h = h + want
    del got, want, u, h
    # float32 compute, the same weights: logits within 2^-6 of max |logit|
    cfg32 = cfg.scaled(dtype=torch.float32)
    got = Backbone(cfg32, use_ssd_kernel=True).apply(params, toks)["logits"]
    ref = Backbone(cfg32).apply(params, toks)["logits"]
    torch.cuda.synchronize()
    err, top = _logits_close(torch, got, ref, 2.0 ** -6,
                             "mamba2-2.7b float32 forward, kernel vs plain scan")
    log(f"mamba2-2.7b: {n_params} parameters; bf16 forward {B} x {T} tokens {fwd_ms:.1f} ms, "
        f"SSD launches {counts['ssd_scan']}; kernel vs plain scan: bf16 mixer by mixer "
        f"at most {worst:.3e} of its max |output|, float32 logits max |diff| {err} of "
        f"max |logit| {top}; (not held) bf16 logits max |diff| {drift:.3f} of max |logit|, argmax "
        f"agreeing on {agree:.3f} of positions; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return counts["ssd_scan"], params


# ---------------------------------------------------------------------------
# serving: the continuous-batching engine at full width
# ---------------------------------------------------------------------------

# (prompt length, new tokens): four slots, so two requests are admitted
# mid-stream; gemma3-4b's prompts hit five buckets and three overrun its
# 1,024 window; mamba2-2.7b's 77 is below one 128 chunk (a Tb = 0 prefill)
GEMMA_WORK = [(1500, 24), (300, 24), (2100, 24), (40, 24), (700, 24), (1100, 24)]
MAMBA_WORK = [(1000, 16), (77, 16), (300, 16), (640, 16), (129, 16)]


def _recording_engine(torch, cfg, params, dev, **kw):
    """A ServeEngine that keeps, per request, the logits row each generated
    token was sampled from (host numpy, as the engine fetched it)."""
    from repro_torch.serve import ServeEngine

    class Recording(ServeEngine):
        def _sample(self, row, req):
            self.rows.setdefault(req.rid, []).append(np.array(row[:self.cfg.vocab_size]))
            return super()._sample(row, req)

    eng = Recording(cfg, params=params, device=dev, **kw)
    eng.rows = {}
    return eng


def _serve_run(torch, cfg, params, dev, work, prompts, label, *, frames=None, late=(),
               **kw):
    """One engine over ``work``, every launch counter 0 just before and read
    just after (the serve path runs no kernel of the port).  ``frames``:
    each request's encoder frames (audio).  The requests indexed by
    ``late`` are submitted after the others' first four ticks (admitted
    mid-stream).  Returns (engine, {rid: request}, wall s, peak bytes)."""
    counters = launch_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = _recording_engine(torch, cfg, params, dev, **kw)
    frames = frames or [None] * len(work)

    def submit(i):
        return eng.submit(prompts[i], max_new_tokens=work[i][1], frames=frames[i])

    check(tuple(late) == tuple(range(len(work) - len(late), len(work))),
          f"{label}: the late requests must be the last ones")
    rids = [submit(i) for i in range(len(work)) if i not in late]
    _reset(counters)
    t0 = time.perf_counter()
    early = []
    if late:
        for _ in range(4):
            early += eng.tick()
        rids += [submit(i) for i in late]
    done = eng.run()
    done.update({r.rid: r for r in early})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read(counters)
    check(all(v == 0 for v in counts.values()), f"{label}: launches {counts}, expected none")
    check(sorted(done) == rids and all(len(done[r].generated) == g
                                       for r, (_, g) in zip(rids, work)),
          f"{label}: not every request finished with its tokens")
    check(all(np.isfinite(row).all() for rows in eng.rows.values() for row in rows),
          f"{label}: non-finite logits")
    return eng, done, wall, torch.cuda.max_memory_allocated()


def _same_run(torch, a, b, label):
    """Two engines' runs equal bit for bit: every sampled logits row, every
    token, the tick count and the final cache."""
    from repro_torch.tree import tree_leaves
    ea, da = a
    eb, db = b
    check(ea.stats.decode_ticks == eb.stats.decode_ticks, f"{label}: tick counts differ")
    check(all(da[r].generated == db[r].generated for r in da), f"{label}: tokens differ")
    check(all(len(ea.rows[r]) == len(eb.rows[r]) and
              all(np.array_equal(x.view(np.uint32), y.view(np.uint32))
                  for x, y in zip(ea.rows[r], eb.rows[r])) for r in ea.rows),
          f"{label}: logits differ")
    check(all(same_bits(torch, x, y) for x, y in zip(tree_leaves(ea.cache),
                                                    tree_leaves(eb.cache))),
          f"{label}: final caches differ")


def _teacher_rows(torch, bb, params, prompt, generated, dev, frames=None):
    """Batch-1 logits for each generated step, teacher-forced on the
    engine's own tokens: ``Backbone.prefill`` of the longest prefix the
    family prefills in one shot (the whole prompt for attention; with the
    request's encoder ``frames``, audio), then ``decode`` with a scalar
    index over the rest of the prompt and the generated tokens."""
    from repro_torch.serve.cache import prefill_prefix
    T, g = len(prompt), len(generated)
    seq = list(prompt) + list(generated[:-1])
    prefix = prefill_prefix(bb.cfg, T)
    rows = []
    if prefix:
        kw = {} if frames is None else {"encoder_frames": frames[None].to(dev)}
        pre = bb.prefill(params, torch.tensor([seq[:prefix]], device=dev), max_seq=T + g,
                         **kw)
        cache = pre["cache"]
        if prefix == T:
            rows.append(pre["logits"][0, 0])
    else:
        cache = bb.init_cache(1, T + g, device=dev)
    for i in range(prefix, T + g - 1):
        lg, cache = bb.decode(params, torch.tensor([[seq[i]]], device=dev), cache, i)
        if i >= T - 1:
            rows.append(lg[0, 0])
    V = bb.cfg.vocab_size
    return np.stack([r[:V].float().cpu().numpy() for r in rows])


def _hold(got, want, rel, what):
    """|got - want| within ``rel`` of the largest |want| (rows x vocab);
    returns (err, top, same-argmax share)."""
    err, top = float(np.abs(got - want).max()), float(np.abs(want).max())
    check(err <= rel * top, f"{what}: logits differ by {err}, over {rel} x {top}")
    return err, top, float((got.argmax(-1) == want.argmax(-1)).mean())


def _launches_per_tick(torch, eng):
    """Device kernels and device ms of one eager tick, of one replay of the
    captured tick (and the replay's four longest kernels), and of the
    alternative the engine does not take: the functional decode, its new
    cache copied into the static one (the profiler; the engine is drained,
    so its cache is garbage by now)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.tree import tree_leaves

    def functional():
        _, new = eng.bb.decode(eng.params, eng._tok, eng.cache, eng._idx)
        for dst, src in zip(tree_leaves(eng.cache), tree_leaves(new)):
            dst.copy_(src)

    out = []
    for fn in (eng._decode, eng._graph.replay, functional):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ks = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        top = sorted(ks, key=lambda e: -e.self_device_time_total)[:4]
        out.append((sum(e.count for e in ks), sum(e.self_device_time_total for e in ks) / 1e3,
                    "; ".join(f"{e.key[:60]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
                              for e in top)))
    return out


def _serve_report(torch, label, eng, eager, wall, peak, work, card):
    """The engine's printed lines: prefill ms per bucket, tick ms p50/p99
    eager and captured (and the captured run's first tick, which runs the
    tick eagerly and captures it), launches per tick, tokens/s, occupancy,
    peak memory, wall."""
    from repro_torch.serve.cache import prefill_bucket
    s, se = eng.stats, eager.stats
    buckets = [prefill_bucket(eng.cfg, T, eng.buckets) for T, _ in work]
    pre = ", ".join(f"{T}->{b} {ms * 1e3:.2f}" for (T, _), b, ms in
                    zip(work, buckets, s.prefill_seconds))
    later = sorted(list(s.tick_seconds)[1:])
    p99 = later[min(int(round(0.99 * (len(later) - 1))), len(later) - 1)] * 1e3
    (ne, me, _), (nc, mc, top), (nf, mf, _) = _launches_per_tick(torch, eng)
    log(f"{label}: prefill ms by prompt->bucket (captured run): {pre}; {card}")
    log(f"{label}: tick ms p50/p99 eager {se.tick_ms(50):.3f}/{se.tick_ms(99):.3f}, "
        f"captured {s.tick_ms(50):.3f}/{s.tick_ms(99):.3f} over {s.decode_ticks} ticks "
        f"(first tick, eager + capture, {s.tick_seconds[0] * 1e3:.3f}; p99 of the replays "
        f"{p99:.3f}); launches per tick eager {ne} kernels ({me:.3f} device ms), captured "
        f"one graph of {nc} kernels ({mc:.3f} device ms); {card}")
    log(f"{label}: captured tick's longest kernels: {top}; {card}")
    log(f"{label}: the tick undonated (functional decode, then its new cache copied into "
        f"the static one) {nf} kernels, {mf:.3f} device ms, against the donated tick's "
        f"{me:.3f}; {card}")
    log(f"{label}: decode tokens/s eager {se.tokens_per_sec():.1f}, captured "
        f"{s.tokens_per_sec():.1f}; mean occupancy {s.mean_occupancy(eng.max_batch):.3f}; "
        f"peak memory {peak / 2**30:.2f} GiB; captured run {wall:.2f} s wall; {card}")


def run_serve_gemma(torch, dev, params):
    """gemma3-4b (full width, run_gemma's params) served by ServeEngine,
    max_batch 4, max_seq 4096: the full and the ring layout, each eager and
    captured (bit-identical), each request's logits held teacher-forced to
    a batch-1 prefill + decode within 2^-5 of max |logit|, the ring
    engine's held to the full engine's on the steps whose tokens agree."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import Backbone
    t_phase = time.perf_counter()
    card = card_line()
    cfg = get_config("gemma3-4b")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, T).tolist() for T, _ in GEMMA_WORK]
    kw = dict(max_batch=4, max_seq=4096, min_bucket=16)
    runs = {}
    for ring in (False, True):
        label = f"gemma3-4b serve ({'ring' if ring else 'full'})"
        eager = _serve_run(torch, cfg, params, dev, GEMMA_WORK, prompts, label + " eager",
                           ring=ring, capture=False, **kw)
        capt = _serve_run(torch, cfg, params, dev, GEMMA_WORK, prompts, label + " captured",
                          ring=ring, capture=True, **kw)
        _same_run(torch, eager[:2], capt[:2], f"{label}: captured vs eager")
        _serve_report(torch, label, capt[0], eager[0], capt[2], capt[3], GEMMA_WORK, card)
        runs[ring] = capt[:2]
        del eager
    full, fdone = runs[False]
    ring, rdone = runs[True]
    bb = Backbone(cfg)
    errs, shares, tops, ring_steps = [], [], [], 0
    for rid, p in zip(sorted(fdone), prompts):
        want = _teacher_rows(torch, bb, params, p, fdone[rid].generated, dev)
        err, top, same = _hold(np.stack(full.rows[rid]), want, 2.0 ** -5,
                               f"gemma3-4b serve request {rid} vs teacher-forced")
        errs.append(err), tops.append(top), shares.append(same)
        # the ring engine on the steps whose earlier tokens agree with the full one's
        a, b = fdone[rid].generated, rdone[rid].generated
        n = next((j + 1 for j in range(len(a)) if a[j] != b[j]), len(a))
        _hold(np.stack(ring.rows[rid][:n]), np.stack(full.rows[rid][:n]), 2.0 ** -5,
              f"gemma3-4b serve request {rid}: ring vs full engine")
        ring_steps += n
    log(f"gemma3-4b serve: teacher-forced hold max |diff| {max(errs)} of max |logit| "
        f"{max(tops)} (2^-5 allowed), same argmax on {np.mean(shares):.3f} of steps; ring "
        f"engine held to the full engine on {ring_steps} of "
        f"{sum(g for _, g in GEMMA_WORK)} steps; phase {time.perf_counter() - t_phase:.1f} s "
        f"wall; {card}")


def run_serve_mamba(torch, dev, params):
    """mamba2-2.7b (full width, run_mamba's params) served by ServeEngine,
    max_batch 4, max_seq 1536: exact-prefix prefill (one prompt below a
    chunk, Tb = 0) and chunked prefill through the decode tick, eager and
    captured (bit-identical), each request held teacher-forced within 2^-5
    of max |logit|."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import Backbone
    t_phase = time.perf_counter()
    card = card_line()
    cfg = get_config("mamba2-2.7b")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, T).tolist() for T, _ in MAMBA_WORK]
    kw = dict(max_batch=4, max_seq=1536)
    label = "mamba2-2.7b serve"
    eager = _serve_run(torch, cfg, params, dev, MAMBA_WORK, prompts, label + " eager",
                       capture=False, **kw)
    capt = _serve_run(torch, cfg, params, dev, MAMBA_WORK, prompts, label + " captured",
                      capture=True, **kw)
    _same_run(torch, eager[:2], capt[:2], f"{label}: captured vs eager")
    _serve_report(torch, label, capt[0], eager[0], capt[2], capt[3], MAMBA_WORK, card)
    del eager
    eng, done = capt[:2]
    bb = Backbone(cfg)
    errs, shares, tops = [], [], []
    for rid, p in zip(sorted(done), prompts):
        want = _teacher_rows(torch, bb, params, p, done[rid].generated, dev)
        err, top, same = _hold(np.stack(eng.rows[rid]), want, 2.0 ** -5,
                               f"{label} request {rid} vs teacher-forced")
        errs.append(err), tops.append(top), shares.append(same)
    log(f"{label}: teacher-forced hold max |diff| {max(errs)} of max |logit| {max(tops)} "
        f"(2^-5 allowed), same argmax on {np.mean(shares):.3f} of steps; phase "
        f"{time.perf_counter() - t_phase:.1f} s wall; {card}")


def run_serve_reload(torch, dev):
    """Hot reload at gemma3-4b's .smoke() config on the card: a captured
    engine polling a checkpoint directory picks up a step written
    mid-stream by ``save_checkpoint`` between ticks, into the same param
    and cache tensors (no new allocation), and afterwards serves what a
    fresh eager engine on the new params serves."""
    import tempfile
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs.registry import get_config
    from repro_torch.models import Backbone
    from repro_torch.serve import ServeEngine
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_config("gemma3-4b").smoke()
    bb = Backbone(cfg)
    p0 = bb.init(torch.Generator(device=dev).manual_seed(10))
    p1 = bb.init(torch.Generator(device=dev).manual_seed(11))

    def state(p):
        return {"params": {"gen": tree_map(lambda x: x[None, None], p),
                           "disc": {"w": torch.zeros((1, 1, 3))}}}

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        save_checkpoint(d, state(p0), step=1)
        eng = ServeEngine(cfg, max_batch=2, max_seq=64, min_bucket=8, ckpt_dir=d, device=dev)
        check(eng.loaded_step == 1 and eng.captured, "reload: step 1 not loaded at start")
        ptrs = [x.data_ptr() for x in tree_leaves(eng.params) + tree_leaves(eng.cache)]
        rid = eng.submit(list(range(1, 9)), max_new_tokens=12)
        for _ in range(4):
            eng.tick()
        save_checkpoint(d, state(p1), step=2)
        done = eng.run()
        check(eng.loaded_step == 2 and eng.stats.reloads == 1 and
              len(done[rid].generated) == 12, "reload: step 2 not picked up mid-stream")
        check(ptrs == [x.data_ptr() for x in tree_leaves(eng.params) + tree_leaves(eng.cache)],
              "reload: the engine allocated new params or cache")
        check(all(same_bits(torch, a, b) for a, b in zip(tree_leaves(eng.params),
                                                         tree_leaves(p1))),
              "reload: served params are not step 2's")
        fresh = ServeEngine(cfg, max_batch=2, max_seq=64, min_bucket=8, params=p1,
                            device=dev, capture=False)
        got = []
        for e in (eng, fresh):
            r = e.submit(list(range(3, 14)), max_new_tokens=10)
            got.append(e.run()[r].generated)
        check(got[0] == got[1], f"reload: after the swap the captured engine serves "
                                f"{got[0]}, a fresh engine on step 2 {got[1]}")
    log(f"serve hot reload (gemma3-4b .smoke()): step 2 picked up after 4 ticks into the "
        f"same tensors, the captured tick then serves as a fresh engine on step 2 does")


LM_GAN_ARCH = "granite-moe-3b-a800m"
# the depth of each sync's rounds, of granite's 32 layers (PERF.md §4)
LM_GAN_LAYERS = {"plain": 2, "composed": 1, "fused": 1}
LM_GAN_SHAPE = dict(agents=4, batch=8, T=256, K=5, sequences=256)
GRANITE_WORK = [(400, 16), (40, 16), (150, 16), (250, 16)]


def _lm_gan_cfg(layers):
    """granite-moe-3b-a800m at full width (d_model 1,536, 24 query and 8
    KV heads of 64, 40 experts top-8 of d_ff 512, vocab 49,155 padded to
    49,408, groups of 1,024, capacity 1.25, bfloat16 compute on float32
    params; the discriminator at its config), ``layers`` of its 32."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(LM_GAN_ARCH)
    check((cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
           cfg.num_experts, cfg.experts_per_token, cfg.d_ff, cfg.padded_vocab,
           cfg.moe_group_size, cfg.capacity_factor, cfg.disc_layers, cfg.disc_d_model)
          == (1536, 24, 8, 64, 40, 8, 512, 49408, 1024, 1.25, 4, 512),
          f"{LM_GAN_ARCH} is not at its full width")
    return cfg.scaled(num_layers=layers)


def _lm_gan_spec(dev, cfg, strategy, rounds):
    """The LM GAN's RunSpec at ``cfg``: 4 agents on a (1, 4) grid, 256
    sequences of 256 tokens an agent from ``sample_agent_tokens``, batch
    8, K = 5, Adam at 1e-3 (the recipe of ``arch_smoke_spec`` at this
    width)."""
    from repro_torch import prng
    from repro_torch.data.synthetic import sample_agent_tokens
    from repro_torch.launch.steps import make_lm_gan_task
    from repro_torch.launch.train import RunSpec
    from repro_torch.optim import Adam, constant, equal_timescale
    sh = LM_GAN_SHAPE
    A = sh["agents"]
    data = [{"tokens": sample_agent_tokens(prng.key(0), sh["sequences"], sh["T"],
                                           cfg.vocab_size, agent=i, num_agents=A)}
            for i in range(A)]
    return RunSpec(task=make_lm_gan_task(cfg), agent_data=data, agent_grid=(1, A),
                   K=sh["K"], steps=rounds * sh["K"], batch_size=sh["batch"],
                   scales=equal_timescale(constant(1e-3)), opt_d=Adam(), opt_g=Adam(),
                   strategy=strategy, seed=0, log_every=0, device=str(dev))


def run_lm_gan_path(torch, dev, layers, strategy, per_round, label, rounds, card):
    """``rounds`` LM GAN rounds of granite-moe-3b-a800m at full width and
    ``layers`` deep under ``strategy``, through ``RunSpec.run_result``,
    with every sync kernel launch held in place against its plain version
    on the round's own leaves (``torch_shared.held_sync_kernels``).  Every
    launch counter is set to 0 just before the run and read just after;
    each must be ``rounds`` times ``per_round`` (kernels absent: 0).  After
    every round: every agent holds the synced params, every loss is
    finite, the peak memory of the round.  Returns (counts, held stats,
    the spec)."""
    from repro_torch.tree import tree_leaves
    from torch_shared import held_sync_kernels
    cfg = _lm_gan_cfg(layers)
    log(f"depth cut: {LM_GAN_ARCH} LM GAN under {label} runs {layers} of 32 layers at "
        f"full width (deeper rounds pass 72 GB of the card's 80), {rounds} rounds x "
        f"K={LM_GAN_SHAPE['K']}")
    spec = _lm_gan_spec(dev, cfg, strategy, rounds)
    unsynced, peaks = [], []

    def after(fed, state, r):
        unsynced.append(torch.stack([(x != x[:1, :1]).any()
                                     for x in tree_leaves(state["params"])]).any())
        peaks.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        return {}

    spec = dataclasses.replace(spec, eval_every=1, eval_hooks=(after,))
    counters = launch_counters()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset(counters)
    with held_sync_kernels() as held:
        result = spec.run_result()
        torch.cuda.synchronize()
    counts = _read(counters)
    want = {name: rounds * per_round.get(name, 0) for name in counters}
    check(counts == want, f"{label}: launches {counts} in {rounds} rounds, expected {want}")
    check({k: v["calls"] for k, v in held.items()} ==
          {k: v for k, v in counts.items() if v},
          f"{label}: held {held}, launched {counts}")
    check(len(unsynced) == rounds and not any(bool(u) for u in unsynced),
          f"{label}: agents do not hold identical params after a sync")
    check(all(math.isfinite(v) for m in result.history for v in m.values()),
          f"{label}: non-finite losses {result.history}")
    check(all(bool(torch.isfinite(x).all()) for x in tree_leaves(result.state)
              if x.is_floating_point()), f"{label}: non-finite state")
    t = result.timings
    log(f"LM GAN {label}: {layers} layers, grid (1, 4), batch 8 x T 256, K=5: "
        f"lm per round {[round(m['lm'], 4) for m in result.history]}, last losses "
        f"{ {k: round(v, 4) for k, v in result.history[-1].items()} }; with every sync "
        f"launch held in place {t['total_s'] / rounds * 1e3:.1f} ms/round, "
        f"{t['steps_per_s']:.3f} steps/s; peak GiB by round "
        f"{[round(p / 2 ** 30, 2) for p in peaks]}; launches {counts}; {card}")
    for name, h in sorted(held.items()):
        log(f"LM GAN {label}: {name} held to its plain version on {h['calls']} launches, "
            f"{h['elements']} elements, widest {h['widest']}, max_abs_err {h['max_abs_err']}")
    return counts, held, spec


def run_lm_gan(torch, dev):
    """Phase 11: the five new archs' smoke-width LM GAN rounds on the card
    against the CPU port; the LM GAN (FedGAN's Algorithm 1 on a backbone)
    at granite-moe-3b-a800m's full width through the sync kernels; and
    granite-moe-3b-a800m served at full size through the captured tick."""
    import gc
    from repro_torch.launch.train import run_arch_smoke
    from repro_torch.run.profile import profile_spec
    from torch_shared import lm_gan_round_mismatches, sync_cases
    t_phase = time.perf_counter()
    card = card_line()
    worst = []
    for arch in ("mixtral-8x22b", "qwen3-8b", "phi4-mini-3.8b", "glm4-9b", LM_GAN_ARCH,
                 "zamba2-7b", "whisper-medium", "chameleon-34b"):
        bad, (ratio, path) = lm_gan_round_mismatches(arch, dev)
        check(bad == [], f"{arch} .smoke() LM GAN round on the card departs from the CPU "
                         f"port: {bad[:5]}")
        worst.append((ratio, arch, path))
    ratio, arch, path = max(worst)
    log(f"LM GAN .smoke() rounds (K=1, SGD) of the eight archs of phases 11 and 12 on "
        f"the card held to the "
        f"CPU port within torch_shared's bounds; largest ratio of a difference to its "
        f"limit {ratio:.4f} ({arch}, {path}); {time.perf_counter() - t_phase:.1f} s wall")
    # per round: plain 2 fedavg (G and D bucketed), fused 2 qsync, composed
    # per float32 leaf (all of them) one fedavg and 2 of each qpack kernel
    cases = sync_cases(_lm_gan_leaf_count(torch))
    # A process's first local step leaves its input state in a garbage cycle
    # (torch's first-call set-up), a whole state at full width.  One
    # step of each sync at smoke width takes that step, then a collection.
    for strategy, _ in cases.values():
        run_arch_smoke(LM_GAN_ARCH, steps=1, K=1, seed=0, strategy=strategy, device=dev,
                       log_every=0)
    gc.collect()

    t0 = time.perf_counter()
    embed_n = 49408 * 1536
    _, held, spec = run_lm_gan_path(torch, dev, LM_GAN_LAYERS["plain"], *cases["plain"],
                                    "FedAvgSync()", 2, card)
    check(held["fedavg"]["widest"][1] > 2 * embed_n,
          "FedAvgSync(): the bucketed launch does not hold embed and lm_head")
    gc.collect()
    torch.cuda.empty_cache()
    prof = profile_spec(dataclasses.replace(spec, eval_every=0, eval_hooks=()), rounds=1)
    log(f"LM GAN FedAvgSync() profiled (run.profile.profile_spec, 1 warm-up round, 1 timed, "
        f"1 profiled): {prof['ms_per_round']:.1f} ms/round, "
        f"{1e3 * LM_GAN_SHAPE['K'] / prof['ms_per_round']:.3f} steps/s, device busy share "
        f"{prof['device_busy_share']:.4f}, device ms/round {prof['device_ms_per_round']}, "
        f"sync kernels {prof['sync_kernels']}; top kernels {prof['top_kernels'][:6]}; {card}")
    del spec, prof
    gc.collect()
    torch.cuda.empty_cache()
    _, held, _ = run_lm_gan_path(
        torch, dev, LM_GAN_LAYERS["composed"], *cases["composed"],
        "FedAvgSync(codec=TopK(0.25)+IntQuant(4), error_feedback=True)", 1, card)
    check(embed_n in held["fedavg"]["widths"],
          "composed: no fedavg launch held at embed's (4, 75,890,688)")
    gc.collect()
    torch.cuda.empty_cache()
    _, held, _ = run_lm_gan_path(
        torch, dev, LM_GAN_LAYERS["fused"], *cases["fused"],
        "FedAvgSync(codec=IntQuant(8), error_feedback=True)", 2, card)
    check(held["qsync"]["widest"][1] > 2 * embed_n,
          "fused int8: the bucketed launch does not hold embed and lm_head")
    del held
    gc.collect()
    torch.cuda.empty_cache()
    log(f"LM GAN at full width: {time.perf_counter() - t0:.1f} s wall; {card}")
    run_serve_granite(torch, dev, card)


def _lm_gan_leaf_count(torch):
    """The number of leaves of the LM GAN's (G, D) pair in granite's
    family, all float32: the composed sync takes them one by one.  Counted
    on a narrow copy of the config (the leaves do not depend on widths or
    depth: layers are stacked)."""
    from repro_torch.launch.steps import make_lm_gan_task
    from repro_torch.tree import tree_leaves
    small = _lm_gan_cfg(2).scaled(d_model=16, num_heads=2, num_kv_heads=2, head_dim=8,
                                  d_ff=8, vocab_size=16, num_experts=4, experts_per_token=2,
                                  disc_d_model=16, disc_heads=2)
    leaves = tree_leaves(make_lm_gan_task(small).init(torch.Generator().manual_seed(0)))
    check(all(x.dtype == torch.float32 for x in leaves), "a non-float32 LM GAN leaf")
    return len(leaves)


def run_serve_granite(torch, dev, card):
    """granite-moe-3b-a800m at full size (32 layers) served by ServeEngine,
    max_batch 4, max_seq 1,024: four requests of 400, 40, 150 and 250
    prompt tokens, 16 new each.  An MoE prompt prefills exactly in whole
    groups of 1,024 (the reference's rule), so these prompts go through the
    shared decode tick; eager and captured bit-identical, no kernel of the
    port launched."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import Backbone
    from repro_torch.tree import tree_leaves
    t_phase = time.perf_counter()
    cfg = get_config(LM_GAN_ARCH)
    params = Backbone(cfg).init(torch.Generator(device=dev).manual_seed(0))
    n = sum(x.numel() for x in tree_leaves(params))
    log(f"{LM_GAN_ARCH} serve: full size, {cfg.num_layers} layers, {n} params "
        f"({n * 4 / 2 ** 30:.2f} GiB float32)")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, T).tolist() for T, _ in GRANITE_WORK]
    kw = dict(max_batch=4, max_seq=1024)
    label = f"{LM_GAN_ARCH} serve"
    eager = _serve_run(torch, cfg, params, dev, GRANITE_WORK, prompts, label + " eager",
                       capture=False, **kw)
    capt = _serve_run(torch, cfg, params, dev, GRANITE_WORK, prompts, label + " captured",
                      capture=True, **kw)
    _same_run(torch, eager[:2], capt[:2], f"{label}: captured vs eager")
    _serve_report(torch, label, capt[0], eager[0], capt[2], capt[3], GRANITE_WORK, card)
    log(f"{label}: captured tick bit-identical to the eager tick; phase "
        f"{time.perf_counter() - t_phase:.1f} s wall; {card}")


# ---------------------------------------------------------------------------
# phase 12: the hybrid, audio and vlm families at full width
# ---------------------------------------------------------------------------

# zamba2-7b's requests are mamba2-2.7b's (phase 10); whisper-medium's four,
# the last two submitted after four ticks (admitted mid-stream)
ZAMBA_WORK = MAMBA_WORK
WHISPER_WORK = [(5, 16), (60, 16), (200, 16), (400, 16)]
WHISPER_LATE = (2, 3)
CARD_BUDGET = 72 * 2 ** 30     # of the card's 80 GiB, what a full-width phase may hold


def _counted(torch, counters, fn):
    """``fn()`` with every launch counter set to 0 just before and read just
    after; returns (result, counts)."""
    torch.cuda.synchronize()
    _reset(counters)
    out = fn()
    torch.cuda.synchronize()
    return out, _read(counters)


def _greedy(torch, bb, params, pre, T, steps, dev, tokens=None):
    """``steps`` decode steps from a prefill's cache with a per-row index:
    greedy on the route's own logits, or teacher-forced on ``tokens``
    (steps, B, 1).  Returns (the tokens fed, the logits of each step)."""
    cache, lg = pre["cache"], pre["logits"]
    fed, out = [], []
    for s in range(steps):
        tok = lg[:, -1].argmax(-1, keepdim=True) if tokens is None else tokens[s]
        index = torch.full((tok.shape[0],), T + s, device=dev)
        lg, cache = bb.decode(params, tok, cache, index)
        fed.append(tok)
        out.append(lg)
    return torch.stack(fed), torch.stack(out)


def _hold_prefill_decode(torch, kern, plain, params, toks, steps, dev, label, kw=None):
    """``prefill`` of ``toks`` (max_seq T + steps) through ``kern``, then
    ``steps`` greedy decode steps with a per-row index; the same prefill
    through ``plain`` and its decode teacher-forced on the kernel route's
    tokens: every logit finite, the prefill's and every step's within 2^-5
    of the largest |logit| of the plain route.  The decode continues from
    each route's own cache (the SSD kernel's final states, the flash
    route's k and v).  Returns (max err, max |logit|, the share of
    positions whose argmax agrees)."""
    kw = kw or {}
    T = toks.shape[1]
    pk = kern.prefill(params, toks, max_seq=T + steps, **kw)
    fed, lk = _greedy(torch, kern, params, pk, T, steps, dev)
    first_k = pk["logits"]
    del pk
    pp = plain.prefill(params, toks, max_seq=T + steps, **kw)
    _, lp = _greedy(torch, plain, params, pp, T, steps, dev, tokens=fed)
    first_p = pp["logits"]
    del pp
    e0, t0 = _logits_close(torch, first_k, first_p, 2.0 ** -5, f"{label}: prefill logits")
    e1, t1 = _logits_close(torch, lk, lp, 2.0 ** -5, f"{label}: decode logits")
    V = kern.cfg.vocab_size
    same = float((torch.cat([first_k, lk.flatten(0, 1)])[..., :V].argmax(-1) ==
                  torch.cat([first_p, lp.flatten(0, 1)])[..., :V].argmax(-1)).float().mean())
    return max(e0, e1), max(t0, t1), same


def run_zamba(torch, dev):
    """zamba2-7b at full size (81 blocks: 13 groups of the one shared
    decoder block and 5 Mamba2 layers, then 3 Mamba2; d_model 3,584, 32
    heads of 112, 112 SSD heads of 64, state 64): ``apply`` on 2 x 2,048
    tokens through flash and the SSD scan (13 and 68 launches), held to the
    flag-free model block by block in bfloat16 (each shared-attention
    application and each mixer from the same normed input, within 2^-5 of
    its largest |output|) and at the logits in float32 compute (2^-6);
    ``prefill`` with max_seq 2,064 through both kernels (68 scans each
    returning its final state), 16 greedy decode steps; the prefill and
    decode held to the flag-free route's within 2^-5 of the largest |logit|
    in float32 compute (logged, not held, in bfloat16: the random-init
    model amplifies last-bit differences over 81 layers, as phase 9
    shows)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import Backbone
    from repro_torch.models.layers import make_norm
    from repro_torch.models.transformer import _layer
    from repro_torch.tree import tree_leaves
    t_phase = time.perf_counter()
    cfg = get_config("zamba2-7b")
    B, T, steps = 2, 2048, 16
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
           cfg.d_ff, cfg.padded_vocab, cfg.d_inner, cfg.resolved_ssm_heads, cfg.ssm_state,
           cfg.ssm_chunk, cfg.hybrid_period) ==
          (81, 3584, 32, 32, 112, 14336, 32000, 7168, 112, 64, 128, 6),
          "zamba2-7b is not at full size")
    flags = dict(use_flash=True, use_ssd_kernel=True)
    bb, plain = Backbone(cfg, **flags), Backbone(cfg)
    check((bb.n_groups, bb.n_tail) == (13, 3), "zamba2-7b: not 13 groups and a tail of 3")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = bb.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(params))
    log(f"zamba2-7b: {n_params} parameters ({n_params * 4 / 2 ** 30:.2f} GiB float32) "
        f"initialised on the card in {time.perf_counter() - t0:.1f} s")
    toks = torch.randint(0, cfg.vocab_size, (B, T),
                         generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    counters = launch_counters()
    want_counts = {n: {"flash_attention": 13, "ssd_scan": 68}.get(n, 0) for n in counters}
    bb.apply(params, toks)                           # warm-up
    t0 = time.perf_counter()
    logits, counts = _counted(torch, counters, lambda: bb.apply(params, toks)["logits"])
    fwd_ms = (time.perf_counter() - t0) * 1e3
    check(counts == want_counts, f"zamba2-7b apply: launches {counts}, expected {want_counts}")
    check(tuple(logits.shape) == (B, T, cfg.padded_vocab), "zamba2-7b: logits shape")
    check(bool(torch.isfinite(logits).all()), "zamba2-7b: non-finite logits")
    plain16 = plain.apply(params, toks)["logits"]
    drift = float((logits - plain16).abs().max()) / float(plain16.abs().max())
    agree = float((logits.argmax(-1) == plain16.argmax(-1)).float().mean())
    del logits, plain16
    # bf16, block by block, each from the plain route's own hidden state
    norm = make_norm(cfg, cfg.d_model)
    ak, ap = bb._block().attn, plain._block().attn
    mk, mp = bb._mamba().inner, plain._mamba().inner
    block = plain._block()
    shared = params["shared_attn"]
    h, worst = plain._embed(params, toks), {"attention": 0.0, "mixer": 0.0}

    def held(kind, got, want, where):
        err = float((got.float() - want.float()).abs().max()) / float(want.float().abs().max())
        check(bool(torch.isfinite(got).all()) and err <= 2.0 ** -5,
              f"zamba2-7b {where}: the kernel route's {kind} differs by {err} of its max "
              f"|output|")
        worst[kind] = max(worst[kind], err)

    def mixer(bp, h, where):
        u = norm.apply(bp["ln"], h)
        want = mp.apply(bp["mixer"], u)
        held("mixer", mk.apply(bp["mixer"], u), want, where)
        return h + want

    for g in range(bb.n_groups):
        x = norm.apply(shared["ln1"], h)
        held("attention", ak.apply(shared["attn"], x), ap.apply(shared["attn"], x),
             f"group {g} shared attention")
        h, _ = block.apply(shared, h)
        for r in range(cfg.hybrid_period - 1):
            h = mixer(_layer(params["mamba"], g, r), h, f"group {g} mixer {r}")
    for t in range(bb.n_tail):
        h = mixer(_layer(params["mamba_tail"], t), h, f"tail mixer {t}")
    del h, x
    # float32 compute, the same weights: logits within 2^-6 of max |logit|
    cfg32 = cfg.scaled(dtype=torch.float32)
    k32, p32 = Backbone(cfg32, **flags), Backbone(cfg32)
    got, c32 = _counted(torch, counters, lambda: k32.apply(params, toks)["logits"])
    check(c32 == want_counts, f"zamba2-7b float32 apply: launches {c32}")
    err32, top32 = _logits_close(torch, got, p32.apply(params, toks)["logits"], 2.0 ** -6,
                                 "zamba2-7b float32 forward, kernels vs plain route")
    del got
    # the prefill through both kernels (each scan returning its final state)
    pre, counts = _counted(torch, counters, lambda: bb.prefill(params, toks, max_seq=T + steps))
    check(counts == want_counts, f"zamba2-7b prefill: launches {counts}, expected {want_counts}")
    cache = pre["cache"]
    check(tuple(cache["attn"]["k"].shape) == (13, B, T + steps, 32, 112) and
          tuple(cache["mamba"]["ssm"].shape) == (13, 5, B, 112, 64, 64) and
          tuple(cache["tail"]["ssm"].shape) == (3, B, 112, 64, 64),
          "zamba2-7b prefill: cache shapes")
    (fed, lk), counts = _counted(torch, counters,
                                 lambda: _greedy(torch, bb, params, pre, T, steps, dev))
    check(all(v == 0 for v in counts.values()), f"zamba2-7b decode: launches {counts}")
    check(bool(torch.isfinite(lk).all()), "zamba2-7b decode: non-finite logits")
    pp = plain.prefill(params, toks, max_seq=T + steps)
    _, lp = _greedy(torch, plain, params, pp, T, steps, dev, tokens=fed)
    d16 = float((torch.cat([pre["logits"], lk.flatten(0, 1)]) -
                 torch.cat([pp["logits"], lp.flatten(0, 1)])).abs().max()) / \
        float(lp.abs().max())
    del pre, pp, cache, lk, lp
    err, top, same = _hold_prefill_decode(torch, k32, p32, params, toks, steps, dev,
                                          "zamba2-7b float32 prefill + decode")
    log(f"zamba2-7b: bf16 apply {B} x {T} tokens {fwd_ms:.1f} ms, launches "
        f"{want_counts['flash_attention']} flash and {want_counts['ssd_scan']} SSD (the apply "
        f"and the prefill each); kernel routes vs plain: bf16 block by block at most "
        f"{worst['attention']:.3e} (shared attention) and {worst['mixer']:.3e} (mixers) of "
        f"max |output|; float32 logits max |diff| {err32} of max |logit| {top32} (2^-6 "
        f"allowed); float32 prefill + {steps} decode steps max |diff| {err} of max |logit| "
        f"{top} (2^-5 allowed), same argmax on {same:.3f}; (not held) bf16 logits "
        f"{drift:.3f} of max |logit| (argmax agreeing on {agree:.3f}), bf16 prefill + "
        f"decode {d16:.3f}; peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.1f} "
        f"GiB; phase "
        f"{time.perf_counter() - t_phase:.1f} s wall")
    return params


def run_serve_zamba(torch, dev, params):
    """zamba2-7b (full size, run_zamba's params) served by ServeEngine,
    max_batch 4, max_seq 1,536, five requests of 1,000, 77, 300, 640 and
    129 prompt tokens, 16 new each: exact-prefix prefill (whole chunks of
    128; 77 is under one, a fresh slot) with the rest of the prompt
    through the decode tick; the shared block's k/v and the Mamba2 states
    in one cache; eager and captured bit-identical, no kernel launched.
    Each request is held teacher-forced within 2^-5 of max |logit| in
    float32 compute (a captured float32 engine on the same params): in
    bfloat16 the random-init model amplifies the last-bit differences of
    a batch-4 tick against a batch-1 decode over 81 layers and a hundred
    recurrent steps (request 0 departed by 0.365 of max |logit| 2.22 on the
    card, as the kernel and plain routes depart by 0.86 in run_zamba)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import Backbone
    t_phase = time.perf_counter()
    card = card_line()
    cfg = get_config("zamba2-7b")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, T).tolist() for T, _ in ZAMBA_WORK]
    kw = dict(max_batch=4, max_seq=1536)
    label = "zamba2-7b serve"
    eager = _serve_run(torch, cfg, params, dev, ZAMBA_WORK, prompts, label + " eager",
                       capture=False, **kw)
    capt = _serve_run(torch, cfg, params, dev, ZAMBA_WORK, prompts, label + " captured",
                      capture=True, **kw)
    _same_run(torch, eager[:2], capt[:2], f"{label}: captured vs eager")
    _serve_report(torch, label, capt[0], eager[0], capt[2], capt[3], ZAMBA_WORK, card)
    del eager, capt
    cfg32 = cfg.scaled(dtype=torch.float32)
    eng, done = _serve_run(torch, cfg32, params, dev, ZAMBA_WORK, prompts,
                           label + " float32 captured", capture=True, **kw)[:2]
    bb = Backbone(cfg32)
    errs, shares, tops = [], [], []
    for rid, p in zip(sorted(done), prompts):
        want = _teacher_rows(torch, bb, params, p, done[rid].generated, dev)
        err, top, same = _hold(np.stack(eng.rows[rid]), want, 2.0 ** -5,
                               f"{label} float32 request {rid} vs teacher-forced")
        errs.append(err), tops.append(top), shares.append(same)
    log(f"{label}: captured tick bit-identical to the eager tick; float32 engine "
        f"teacher-forced hold max |diff| {max(errs)} of max |logit| {max(tops)} (2^-5 "
        f"allowed), same argmax on {np.mean(shares):.3f} of steps; float32 captured tick p50 "
        f"{eng.stats.tick_ms(50):.3f} ms; phase {time.perf_counter() - t_phase:.1f} s wall; "
        f"{card}")


def run_whisper(torch, dev):
    """whisper-medium at full size (24 encoder and 24 decoder layers,
    d_model 1,024, 16 heads of 64, LayerNorm, vocab 51,865): ``encode`` of
    seeded frames (2, 1,500, 1,024) through flash (24 non-causal
    launches); ``prefill`` of 2 x 448 tokens with those frames (48: the
    encoder's 24 again and the decoder's 24 causal); ``build_cross_cache``
    equal to the prefill's cross caches; 16 greedy decode steps on it; the
    prefill and decode held to ``use_flash=False`` within 2^-5 of the
    largest |logit| in bfloat16."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import Backbone
    from repro_torch.tree import tree_leaves
    t_phase = time.perf_counter()
    cfg = get_config("whisper-medium")
    B, T, steps = 2, 448, 16
    check((cfg.num_layers, cfg.encoder_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size, cfg.encoder_seq, cfg.norm) ==
          (24, 24, 1024, 16, 16, 64, 4096, 51865, 1500, "layernorm"),
          "whisper-medium is not at full size")
    bb, plain = Backbone(cfg, use_flash=True), Backbone(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = bb.init(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(x.numel() for x in tree_leaves(params))
    gen = torch.Generator(device=dev).manual_seed(1)
    frames = 0.1 * torch.randn((B, cfg.encoder_seq, cfg.d_model), generator=gen, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (B, T), generator=gen, device=dev)
    counters = launch_counters()
    flash_only = lambda n: {k: (n if k == "flash_attention" else 0) for k in counters}  # noqa
    bb.prefill(params, toks, encoder_frames=frames)          # warm-up
    t0 = time.perf_counter()
    memory, counts = _counted(torch, counters, lambda: bb.encode(params, frames))
    enc_ms = (time.perf_counter() - t0) * 1e3
    check(counts == flash_only(24), f"whisper-medium encode: launches {counts}")
    check(tuple(memory.shape) == (B, 1500, 1024) and bool(torch.isfinite(memory).all()),
          "whisper-medium encode: memory shape or non-finite")
    t0 = time.perf_counter()
    pre, counts = _counted(torch, counters, lambda: bb.prefill(
        params, toks, encoder_frames=frames, max_seq=T + steps))
    pre_ms = (time.perf_counter() - t0) * 1e3
    check(counts == flash_only(48), f"whisper-medium prefill: launches {counts}, expected 24 "
                                    f"non-causal (encoder) + 24 causal (decoder)")
    check(torch.equal(pre["memory"], memory), "whisper-medium: the prefill's memory differs "
                                              "from encode's")
    cross = bb.build_cross_cache(params, memory)
    check(tuple(cross["k"].shape) == (24, B, 1500, 16, 64) and
          all(torch.equal(a, b) for a, b in zip(tree_leaves(cross),
                                                tree_leaves(pre["cache"]["cross"]))),
          "whisper-medium: build_cross_cache differs from the prefill's cross caches")
    pre["cache"]["cross"] = cross
    (fed, lk), counts = _counted(torch, counters,
                                 lambda: _greedy(torch, bb, params, pre, T, steps, dev))
    check(all(v == 0 for v in counts.values()), f"whisper-medium decode: launches {counts}")
    check(bool(torch.isfinite(lk).all()), "whisper-medium decode: non-finite logits")
    del pre, lk, cross
    err, top, same = _hold_prefill_decode(torch, bb, plain, params, toks, steps, dev,
                                          "whisper-medium", {"encoder_frames": frames})
    log(f"whisper-medium: {n_params} parameters; encode (2, 1500) frames {enc_ms:.1f} ms "
        f"(24 non-causal flash launches), prefill 2 x {T} tokens with the frames {pre_ms:.1f} "
        f"ms (48 flash launches: 24 non-causal, 24 causal), {steps} decode steps on "
        f"build_cross_cache's caches (none); flash vs plain route, prefill + decode: max "
        f"|diff| {err} of max |logit| {top} (2^-5 allowed), same argmax on {same:.3f}; peak "
        f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB; phase "
        f"{time.perf_counter() - t_phase:.1f} s wall")
    return params


def run_serve_whisper(torch, dev, params):
    """whisper-medium (full size, run_whisper's params) served by
    ServeEngine, max_batch 4, max_seq 448: four requests of 5, 60, 200 and
    400 prompt tokens, each with its own (1,500, 1,024) frames, 16 new
    each, the last two submitted after four ticks; the captured tick reads
    the cross caches at fixed addresses.  Eager and captured bit-identical,
    each request held teacher-forced (its frames, a batch-1 prefill, then
    decode) within 2^-5 of max |logit|, no kernel launched."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import Backbone
    t_phase = time.perf_counter()
    card = card_line()
    cfg = get_config("whisper-medium")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, T).tolist() for T, _ in WHISPER_WORK]
    gen = torch.Generator().manual_seed(7)
    frames = [0.1 * torch.randn((cfg.encoder_seq, cfg.d_model), generator=gen)
              for _ in WHISPER_WORK]
    kw = dict(max_batch=4, max_seq=448, frames=frames, late=WHISPER_LATE)
    label = "whisper-medium serve"
    eager = _serve_run(torch, cfg, params, dev, WHISPER_WORK, prompts, label + " eager",
                       capture=False, **kw)
    capt = _serve_run(torch, cfg, params, dev, WHISPER_WORK, prompts, label + " captured",
                      capture=True, **kw)
    _same_run(torch, eager[:2], capt[:2], f"{label}: captured vs eager")
    _serve_report(torch, label, capt[0], eager[0], capt[2], capt[3], WHISPER_WORK, card)
    del eager
    eng, done = capt[:2]
    bb = Backbone(cfg)
    errs, shares, tops = [], [], []
    for rid, p, f in zip(sorted(done), prompts, frames):
        want = _teacher_rows(torch, bb, params, p, done[rid].generated, dev, frames=f)
        err, top, same = _hold(np.stack(eng.rows[rid]), want, 2.0 ** -5,
                               f"{label} request {rid} vs teacher-forced")
        errs.append(err), tops.append(top), shares.append(same)
    log(f"{label}: two requests admitted mid-stream; captured tick bit-identical to the "
        f"eager tick; teacher-forced hold max |diff| {max(errs)} of max |logit| {max(tops)} "
        f"(2^-5 allowed), same argmax on {np.mean(shares):.3f} of steps; phase "
        f"{time.perf_counter() - t_phase:.1f} s wall; {card}")


def chameleon_depth(cfg):
    """The deepest cut of chameleon-34b's 48 layers whose float32 params
    and a 12e9-byte reserve for the prefill's activations, the plain
    route's score tensor and one layer's bfloat16 casts stay under
    CARD_BUDGET (72 GiB)."""
    d, nh, nkv, hd, ff = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                          cfg.resolved_head_dim, cfg.d_ff)
    layer = 4 * (2 * d * nh * hd + 2 * d * nkv * hd + 3 * d * ff + 2 * d + 2 * hd)
    fixed = 4 * (2 * cfg.padded_vocab * d + d)
    return int((CARD_BUDGET - fixed - 12e9) // layer), layer, fixed


def run_chameleon(torch, dev):
    """chameleon-34b at full width (d_model 8,192, 64 query and 8 KV heads
    of 128 with qk-norm, d_ff 22,016, vocab 65,536), cut in depth only to
    ``chameleon_depth`` layers: ``prefill`` of 2 x 2,048 tokens through
    flash (one launch a layer), 16 greedy decode steps, held to the plain
    route within 2^-5 of the largest |logit| in bfloat16; the peak memory
    under CARD_BUDGET."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import Backbone
    from repro_torch.tree import tree_leaves
    t_phase = time.perf_counter()
    full = get_config("chameleon-34b")
    check((full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
           full.resolved_head_dim, full.d_ff, full.padded_vocab, full.qk_norm) ==
          (48, 8192, 64, 8, 128, 22016, 65536, True), "chameleon-34b is not at full width")
    L, layer, fixed = chameleon_depth(full)
    log(f"depth cut: chameleon-34b runs {L} of its 48 layers at full width (a layer "
        f"{layer / 2 ** 30:.2f} GiB of float32 params, embed and head {fixed / 2 ** 30:.2f} "
        f"GiB; all 48 {(fixed + 48 * layer) / 2 ** 30:.1f} GiB, over the card's 80; the cut "
        f"keeps the peak under {CARD_BUDGET / 2 ** 30:.0f} GiB)")
    cfg = full.scaled(num_layers=L)
    B, T, steps = 2, 2048, 16
    bb, plain = Backbone(cfg, use_flash=True), Backbone(cfg)
    gc_collect(torch)
    torch.cuda.reset_peak_memory_stats()
    params = bb.init(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(x.numel() for x in tree_leaves(params))
    toks = torch.randint(0, cfg.vocab_size, (B, T),
                         generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    counters = launch_counters()
    t0 = time.perf_counter()
    pre, counts = _counted(torch, counters,
                           lambda: bb.prefill(params, toks, max_seq=T + steps))
    pre_ms = (time.perf_counter() - t0) * 1e3
    want = {k: (L if k == "flash_attention" else 0) for k in counters}
    check(counts == want, f"chameleon-34b prefill: launches {counts}, expected {want}")
    check(bool(torch.isfinite(pre["logits"]).all()), "chameleon-34b prefill: non-finite")
    t0 = time.perf_counter()
    (fed, lk), counts = _counted(torch, counters,
                                 lambda: _greedy(torch, bb, params, pre, T, steps, dev))
    dec_ms = (time.perf_counter() - t0) * 1e3 / steps
    check(all(v == 0 for v in counts.values()), f"chameleon-34b decode: launches {counts}")
    del pre, lk
    err, top, same = _hold_prefill_decode(torch, bb, plain, params, toks, steps, dev,
                                          "chameleon-34b")
    peak = torch.cuda.max_memory_allocated()
    check(peak <= CARD_BUDGET, f"chameleon-34b: peak memory {peak / 2 ** 30:.1f} GiB over "
                               f"{CARD_BUDGET / 2 ** 30:.0f}")
    log(f"chameleon-34b: {L} layers, {n_params} parameters; prefill {B} x {T} tokens "
        f"{pre_ms:.1f} ms ({L} flash launches), decode {dec_ms:.1f} ms a step (none); flash "
        f"vs plain route, prefill + {steps} decode steps: max |diff| {err} of max |logit| "
        f"{top} (2^-5 allowed), same argmax on {same:.3f}; peak memory "
        f"{peak / 2 ** 30:.1f} GiB; "
        f"phase {time.perf_counter() - t_phase:.1f} s wall")


def gc_collect(torch):
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def run_families(torch, dev):
    """Phase 12: zamba2-7b, whisper-medium and chameleon-34b on the card,
    each freed before the next."""
    params = run_zamba(torch, dev)
    run_serve_zamba(torch, dev, params)
    del params
    gc_collect(torch)
    params = run_whisper(torch, dev)
    run_serve_whisper(torch, dev, params)
    del params
    gc_collect(torch)
    run_chameleon(torch, dev)
    gc_collect(torch)


def run_main_path(torch, dev, strategy, label, per_round):
    """Three full-width rounds of ``image_acgan`` under ``strategy``, every
    launch counter set to 0 just before and read just after.
    ``per_round`` is the launches per round of each kernel the path runs;
    every other kernel must launch no time."""
    from repro_torch.launch.train import experiment_spec
    from repro_torch.tree import tree_leaves
    rounds, K = 3, 20
    # warm-up round: cuDNN's first calls pick algorithms; not counted
    experiment_spec("image_acgan", steps=K, strategy=strategy, log_every=0,
                    device=dev)[0].run_result()
    spec, _ = experiment_spec("image_acgan", steps=rounds * K, strategy=strategy,
                              log_every=1, device=dev)
    check((spec.K, spec.batch_size, spec.agent_grid) == (K, 64, (1, B)),
          "image_acgan is not at the experiment's width")
    log(f"depth cut: image_acgan under {label} runs {rounds} rounds x K={K} = "
        f"{rounds * K} local steps of the paper's 30000")
    mismatched = []

    def synced(fed, state, r):
        # stays on the device; read once after the run
        mismatched.append(torch.stack([(x != x[:1, :1]).any()
                                       for x in tree_leaves(state["params"])]).any())
        return {}

    spec = dataclasses.replace(spec, eval_every=1, eval_hooks=(synced,))
    counters = launch_counters()
    _reset(counters)
    result = spec.run_result()
    torch.cuda.synchronize()
    counts = _read(counters)
    check(len(mismatched) == rounds and not any(bool(m) for m in mismatched),
          f"{label}: agents do not hold identical params after a sync")
    check(all(torch.isfinite(torch.tensor(list(m.values()))).all()
              for m in result.history), f"{label}: non-finite losses")
    check(all(bool(torch.isfinite(x).all()) for x in tree_leaves(result.state)
              if x.is_floating_point()), f"{label}: non-finite state")
    want = {name: rounds * per_round.get(name, 0) for name in counters}
    check(counts == want, f"{label}: launches {counts} in {rounds} rounds, "
                          f"expected {want}")
    t = result.timings
    log(f"main path {label}: {rounds} rounds x K={K}, B={B}, batch 64: "
        f"{t['steps_per_s']:.3f} steps/s, {t['total_s'] / rounds * 1e3:.1f} ms/round, "
        f"round gap {t['round_gap_s'] * 1e3:.2f} ms, launches {counts}, "
        f"last losses {result.history[-1]}")
    return counts, t


def _agents_equal(torch, state, key="params"):
    """(B, B) bool on the device: whether agents i and j hold the same
    ``state[key]`` bit for bit."""
    from repro_torch.tree import tree_leaves
    flat = [x.reshape(x.shape[0] * x.shape[1], -1) for x in tree_leaves(state[key])]
    n = flat[0].shape[0]
    return torch.stack([torch.stack([torch.stack([(x[i] == x[j]).all() for x in flat]).all()
                                     for j in range(n)]) for i in range(n)])


def run_strategy_path(torch, dev, strategy, label, want_total, *, agents=None, grid=None,
                      after_round=None, rounds=3):
    """``rounds`` full-width rounds of ``image_acgan`` under ``strategy``
    (on ``grid``, with ``agents`` of the experiment's data, when given),
    after one uncounted warm-up round, every launch counter set to 0 just
    before and read just after: the counts must equal ``want_total``
    (kernels absent from it: 0).  ``after_round(r, eq)`` checks the (B, B)
    agent-equality matrix after round r.  Returns the counts."""
    from repro_torch.launch.train import experiment_spec
    from repro_torch.tree import tree_leaves
    K = 20
    spec, _ = experiment_spec("image_acgan", steps=K, strategy=strategy, log_every=0,
                              device=dev, agents=agents)
    if grid is not None:
        spec = dataclasses.replace(spec, agent_grid=grid)
    dataclasses.replace(spec, steps=K).run_result()   # warm-up: cuDNN picks algorithms
    log(f"depth cut: image_acgan under {label} runs {rounds} rounds x K={K} = "
        f"{rounds * K} local steps of the paper's 30000")
    eqs = []
    spec = dataclasses.replace(
        spec, steps=rounds * K, log_every=1, eval_every=1,
        eval_hooks=(lambda fed, state, r: eqs.append(_agents_equal(torch, state)) or {},))
    counters = launch_counters()
    _reset(counters)
    result = spec.run_result()
    torch.cuda.synchronize()
    counts = _read(counters)
    want = {name: want_total.get(name, 0) for name in counters}
    check(counts == want, f"{label}: launches {counts} in {rounds} rounds, expected {want}")
    check(all(math.isfinite(v) for m in result.history for v in m.values()),
          f"{label}: non-finite losses")
    check(all(bool(torch.isfinite(x).all()) for x in tree_leaves(result.state)
              if x.is_floating_point()), f"{label}: non-finite state")
    for r, eq in enumerate(eqs):
        after_round(r, eq.cpu())
    t = result.timings
    log(f"path {label}: {rounds} rounds x K={K}, grid {spec.agent_grid}, batch "
        f"{spec.batch_size}: {t['total_s'] / rounds * 1e3:.1f} ms/round, launches {counts}")
    return counts


def run_strategy_paths(torch, dev):
    """The sync schedules beyond the plain average, each through
    ``run_strategy_path`` with its launches and its agents' agreement
    checked.  Returns the wire and pod routes' launches."""
    from repro_torch.core import (AdaptiveK, FedAvgSync, FedGANConfig, Hierarchical,
                                  ParticipationSchedule, PerStepGradAvg, SubsampledFedAvg)
    from repro_torch.tree import tree_leaves
    bf16, K, rounds = torch.bfloat16, 20, 3

    def all_synced(label):
        def after(r, eq):
            check(bool(eq.all()), f"{label}: agents differ after round {r}")
        return after

    run_strategy_path(torch, dev, PerStepGradAvg(), "PerStepGradAvg()",
                      {"fedavg": 2 * K * rounds}, after_round=all_synced("PerStepGradAvg"))
    wire = run_strategy_path(torch, dev, PerStepGradAvg(sync_dtype=bf16),
                             "PerStepGradAvg(sync_dtype=bfloat16)",
                             {"fedavg_wire": 2 * K * rounds},
                             after_round=all_synced("PerStepGradAvg(bf16)"))["fedavg_wire"]
    run_strategy_path(torch, dev, FedAvgSync(sync_dtype=bf16), "FedAvgSync(sync_dtype=bfloat16)",
                      {"fedavg_wire": 2 * rounds}, after_round=all_synced("FedAvgSync(bf16)"))

    pods = []

    @dataclasses.dataclass(frozen=True)
    class PodChecked(Hierarchical):
        """Hierarchical that records, after each segment sync, whether
        every pod's agents agree."""

        def segment_sync(self, fed, state):
            out = super().segment_sync(fed, state)
            pods.append(torch.stack([(x == x[:, :1]).all()
                                     for x in tree_leaves(out["params"])]).all())
            return out

    pod = run_strategy_path(torch, dev, PodChecked(intra_interval=5),
                            "Hierarchical(intra_interval=5) on (2, 4)",
                            {"fedavg_pod": (K // 5) * rounds, "fedavg": 2 * rounds},
                            agents=8, grid=(2, 4), after_round=all_synced("Hierarchical"))
    check(len(pods) == (K // 5) * (rounds + 1) and all(bool(p) for p in pods),
          "Hierarchical: a pod's agents differ after a segment sync")

    sub = SubsampledFedAvg(fraction=0.6)
    m = sub.num_participants(FedGANConfig(agent_grid=(1, B)))

    def cohort_only(r, eq):
        cohort = set(ParticipationSchedule(0).cohort(r, B, m).tolist())
        for i in range(B):
            for j in range(B):
                if i != j:
                    want = i in cohort and j in cohort
                    check(bool(eq[i, j]) == want,
                          f"SubsampledFedAvg round {r}: agents {i}, {j} equal={bool(eq[i, j])}, "
                          f"cohort {sorted(cohort)}")
    run_strategy_path(torch, dev, sub, "SubsampledFedAvg(fraction=0.6)",
                      {"fedavg": 2 * rounds}, after_round=cohort_only)

    adaptive = AdaptiveK(warmup_rounds=1, sync_every=2)

    def adaptive_after(r, eq):
        check(bool(eq.all()) == adaptive.syncs_at(r),
              f"AdaptiveK round {r}: agents synced={bool(eq.all())}")
    run_strategy_path(torch, dev, adaptive, "AdaptiveK(warmup_rounds=1, sync_every=2)",
                      {"fedavg": 2 * sum(adaptive.syncs_at(r) for r in range(rounds))},
                      after_round=adaptive_after)
    return wire, pod["fedavg_pod"]


def run_checkpoint(torch, dev):
    """image_acgan at full width for 4 rounds, checkpointed every 2
    (``RoundDriver(ckpt_dir=, ckpt_every=2)``): LATEST restores to the
    final state bit for bit on the card, and a run resumed from the first
    checkpoint runs on to step 80 with finite values."""
    import tempfile
    from repro_torch.checkpoint import list_checkpoints, restore_checkpoint
    from repro_torch.launch.train import experiment_spec
    from repro_torch.run import RoundDriver
    from repro_torch.tree import tree_leaves
    K, rounds = 20, 4
    spec, _ = experiment_spec("image_acgan", steps=rounds * K, log_every=0, device=dev)
    fed, data = spec.build(), spec.build_data()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        t0 = time.perf_counter()
        result = RoundDriver(fed, data, rounds, log_every=0, ckpt_dir=d, ckpt_every=2,
                             verbose=False).run(1)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        check(list_checkpoints(d) == [2 * K, 4 * K], f"checkpoints {list_checkpoints(d)}")
        last, manifest = restore_checkpoint(d, device=dev)
        check(manifest["metadata"] == {"round": 3, "K": K}, f"metadata {manifest['metadata']}")
        for a, b in zip(tree_leaves(last), tree_leaves(result.state)):
            check(a.device == b.device and same_bits(torch, a, b.contiguous()),
                  "checkpoint: LATEST does not restore the final state bit for bit")
        first, _ = restore_checkpoint(d, step=2 * K, device=dev)
        resumed = RoundDriver(fed, data, 2, log_every=0, verbose=False).run(1, state=first)
        torch.cuda.synchronize()
        check(int(resumed.state["step"]) == 4 * K, "resumed run did not reach step 80")
        check(all(bool(torch.isfinite(x).all()) for x in tree_leaves(resumed.state)
                  if x.is_floating_point()), "resumed run: non-finite state")
        nbytes = sum(os.path.getsize(os.path.join(d, "step_00000080", f))
                     for f in os.listdir(os.path.join(d, "step_00000080")))
    log(f"checkpoint: 4 rounds with 2 saves {run_s:.2f} s, LATEST bit-identical on the card, "
        f"resumed from step {2 * K} to {4 * K}; {nbytes / 2**20:.1f} MiB a checkpoint")


def run_federated_images(torch, dev):
    """``python -m repro_torch.federated_images`` at a short depth (K = 20,
    40 steps: 2 FedGAN rounds, 40 distributed steps): finite scores, the
    checkpoint restored bit for bit with its score within 1e-6, and fedavg
    launched 2 a round, 2 a distributed step and one a parameter leaf for
    each of the three evals' ``averaged_params``."""
    from repro_torch import federated_images
    from repro_torch.launch.train import acgan_task
    from repro_torch.tree import tree_leaves
    K, steps = 20, 40
    L = len(tree_leaves(acgan_task(hw=16)[0].init(torch.Generator().manual_seed(0))))
    log(f"depth cut: federated_images runs {steps} steps of its default 400")
    counters = launch_counters()
    _reset(counters)
    out = federated_images.run(K=K, steps=steps, device=dev, verbose=False)
    torch.cuda.synchronize()
    counts = _read(counters)
    want = {n: 0 for n in counters}
    want["fedavg"] = 2 * (steps // K) + 2 * steps + 3 * L
    check(counts == want, f"federated_images: launches {counts}, expected {want}")
    # the state must come back bit for bit; its score within the
    # reference's 1e-6 (cuDNN's transposed convolution, a backward-data
    # algorithm, may sum in another order from one call to the next)
    check(out["restored_equal"] and abs(out["fd_restored"] - out["fd"]) < 1e-6,
          f"federated_images: the checkpoint did not restore ({out})")
    check(math.isfinite(out["fd"]) and math.isfinite(out["fd_distributed"]),
          f"federated_images: non-finite FD ({out})")
    log(f"federated_images: FD FedGAN {out['fd']:.4f}, distributed {out['fd_distributed']:.4f}, "
        f"restored {out['fd_restored']:.4f}; launches {counts}")


def run_quickstart(torch, dev):
    """``python -m repro_torch.quickstart`` at its own defaults (B = 5,
    K = 20, 3,000 SGD steps): it must end within 0.1 of (1, 0); the fedavg
    kernel launches one per subtree per round (the gen and disc subtrees of
    the 2D system hold one leaf each), plus one per leaf for each of the
    ten points of the printed trajectory (``averaged_params``)."""
    from repro_torch import quickstart
    counters = launch_counters()
    _reset(counters)
    out = quickstart.run(device=dev)
    torch.cuda.synchronize()
    counts = _read(counters)
    rounds, points = out["rounds"], len(out["trajectory"])
    want = {n: 2 * rounds + 2 * points if n == "fedavg" else 0 for n in counters}
    check(counts == want, f"quickstart: launches {counts}, expected {want}")
    check(quickstart.converged(out), f"quickstart: ended at ({out['theta']}, {out['psi']}), "
                                     f"not within 0.1 of (1, 0)")
    t = out["timings"]
    log(f"quickstart: (theta, psi) = ({out['theta']:+.4f}, {out['psi']:+.4f}) after "
        f"{rounds} rounds x K=20, {t['steps_per_s']:.1f} steps/s, "
        f"{t['total_s'] / rounds * 1e3:.2f} ms/round, launches {counts}")
    return counts["fedavg"]


PAPER_ROUNDS = {"mixed_gaussian": 4, "swiss_roll": 4, "celeba_acgan": 2, "timeseries_cgan": 3}


def run_paper(torch, dev, name, rounds):
    """One of the paper's experiments through ``experiment_spec`` at its
    full width (the paper's nets, agents, batch and K) for ``rounds``
    rounds after one warm-up round, with the suite's eval after the last:
    finite losses and FD, every agent holding the synced parameters after
    every round, fedavg launched one per subtree per round plus one per
    parameter leaf for the eval's ``averaged_params``."""
    from repro_torch.configs.paper_gans import ALL_EXPERIMENTS
    from repro_torch.launch.train import experiment_spec
    from repro_torch.run.evals import eval_hook
    from repro_torch.tree import tree_leaves
    spec, suite = experiment_spec(name, log_every=0, device=dev)
    K, exp = spec.K, ALL_EXPERIMENTS[name]
    log(f"depth cut: {name} runs {rounds} rounds x K={K} = {rounds * K} local steps of the "
        f"paper's {exp.iterations}")
    dataclasses.replace(spec, steps=K).run_result()   # warm-up: cuDNN picks algorithms
    mismatched, eval_s = [], []
    score = eval_hook(suite, seed=0)

    def hook(fed, state, r):
        mismatched.append(torch.stack([(x != x[:1, :1]).any()
                                       for x in tree_leaves(state["params"])]).any())
        if r < rounds - 1:
            return {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = score(fed, state, r)
        eval_s.append(time.perf_counter() - t0)
        return out

    spec = dataclasses.replace(spec, steps=rounds * K, eval_every=1, eval_hooks=(hook,))
    counters = launch_counters()
    _reset(counters)
    result = spec.run_result()
    torch.cuda.synchronize()
    counts = _read(counters)
    n_leaves = len(tree_leaves(result.state["params"]))
    want = {n: 2 * rounds + n_leaves if n == "fedavg" else 0 for n in counters}
    check(counts == want, f"{name}: launches {counts}, expected {want}")
    check(len(mismatched) == rounds and not any(bool(m) for m in mismatched),
          f"{name}: agents do not hold identical params after a sync")
    check(all(math.isfinite(v) for m in result.history for v in m.values()),
          f"{name}: non-finite losses")
    scores = result.evals[-1]
    check(math.isfinite(scores["fd"]), f"{name}: FD is not finite ({scores})")
    if name == "mixed_gaussian":
        check("modes_covered" in scores and "high_quality_frac" in scores,
              f"{name}: mode_stats did not run")
    ms = (result.timings["total_s"] - eval_s[0]) / rounds * 1e3
    log(f"paper {name}: B={spec.agent_grid[1]}, K={K}, batch {spec.batch_size}: "
        f"{ms:.1f} ms/round ({rounds * K / (ms * rounds / 1e3):.1f} steps/s), eval "
        f"{eval_s[0] * 1e3:.0f} ms: {json.dumps({k: v for k, v in scores.items()})}; "
        f"launches {counts}")
    return counts["fedavg"]


def run_ksweep(torch, dev):
    """``run_sweep("toy_2d", Ks=(5, 20, 50), codec_names=("none", "int8"))``
    at a reduced depth, at the sweep's default of 8 rounds a captured
    chunk: the summary table, ms per round per cell, and the sync kernels'
    launches exactly: per round one fedavg (none) or one qsync (int8) per
    subtree, plus one fedavg per leaf for each cell's final eval."""
    import tempfile
    from repro_torch.run.experiments import run_sweep, summary_table
    Ks, steps = (5, 20, 50), 1000
    log(f"depth cut: toy_2d K-sweep runs {steps} local steps per cell of the paper's 4000")
    counters = launch_counters()
    _reset(counters)
    with tempfile.TemporaryDirectory() as out_dir:
        cells = run_sweep("toy_2d", Ks, codec_names=("none", "int8"), steps=steps,
                          out_dir=out_dir, device=dev, verbose=False)
        rows = sum(1 for _ in open(os.path.join(out_dir, "sweep_toy_2d.jsonl")))
    torch.cuda.synchronize()
    counts = _read(counters)
    rounds = sum(steps // K for K in Ks)
    want = {n: 0 for n in counters}
    want["qsync"] = 2 * rounds
    want["fedavg"] = 2 * rounds + 2 * len(cells)
    check(counts == want, f"K-sweep: launches {counts}, expected {want}")
    check(rows == 2 * rounds + len(cells), f"K-sweep: {rows} JSONL rows")
    for c in cells:
        check(math.isfinite(c.final["fd"]), f"K-sweep {c.label} K={c.K}: FD not finite")
        check(c.timings["captured"], f"K-sweep {c.label} K={c.K}: not captured")
        log(f"K-sweep {c.label} K={c.K}: {c.timings['total_s'] / (steps // c.K) * 1e3:.2f} "
            f"ms/round, {c.timings['steps_per_s']:.1f} steps/s, final {c.final}, "
            f"{c.bytes_per_round} B/round")
    by = {(c.K, c.codec): c for c in cells}
    check(all(by[K, "int8"].bytes_per_round < by[K, "none"].bytes_per_round for K in Ks),
          "K-sweep: int8 does not bill fewer bytes than float32")
    log("K-sweep summary:\n" + summary_table(cells))
    log(f"K-sweep launches {counts}")
    return counts["qsync"]


def _states_same(torch, a, b):
    """Two states (trees of tensors) equal in every byte, leaf by leaf."""
    from repro_torch.tree import tree_flatten
    la, da = tree_flatten(a)
    lb, db = tree_flatten(b)
    return da == db and all(same_bits(torch, x, y) for x, y in zip(la, lb))


def _counted_run(torch, spec, label, want_per_round, rounds):
    """``spec.run_result()`` with every launch counter set to 0 just
    before and read just after; the counts must be ``rounds`` times
    ``want_per_round`` (other kernels: 0).  Returns the result."""
    counters = launch_counters()
    _reset(counters)
    result = spec.run_result()
    torch.cuda.synchronize()
    counts = _read(counters)
    want = {n: rounds * want_per_round.get(n, 0) for n in counters}
    check(counts == want, f"{label}: launches {counts} in {rounds} rounds, expected {want}")
    return result


def _finite_run(torch, result, label):
    from repro_torch.tree import tree_leaves
    check(all(math.isfinite(v) for m in result.history for v in m.values()),
          f"{label}: non-finite losses")
    check(all(bool(torch.isfinite(x).all()) for x in tree_leaves(result.state)
              if x.is_floating_point()), f"{label}: non-finite state")


def run_stream(torch, dev):
    """Phase A, the host-streaming pipeline.  ``image_acgan`` at full width
    (B = 5, K = 20, batch 64), 3 rounds with ``data_mode="stream"`` beside
    3 on the device path, under ``FedAvgSync()`` and fused int8 + EF:
    launches exact and equal to the device path's, finite histories, ms a
    round, steps/s and round gap for both.  Every uploaded round tensor
    bit-identical to the blocking ``FederatedRounds.round_batches`` at
    prefetch 1, 2 and 4; ``mixed_gaussian`` streamed at prefetch 2
    bit-identical to the blocking loop over the same rounds."""
    from repro_torch import prng
    from repro_torch.comm import IntQuant
    from repro_torch.core import FedAvgSync
    from repro_torch.data import stream_key_schedule
    from repro_torch.launch.train import experiment_spec
    from repro_torch.run.graph import metric_row
    from repro_torch.tree import tree_leaves, tree_map
    rounds, K = 3, 20
    log(f"depth cut: the stream phase runs image_acgan {rounds} rounds x K={K} a run of "
        "the paper's 30000 steps")
    for label, strategy, per_round in (
            ("FedAvgSync()", None, {"fedavg": 2}),
            ("FedAvgSync(codec=IntQuant(8))", FedAvgSync(codec=IntQuant(bits=8),
                                                         error_feedback=True), {"qsync": 2})):
        line = []
        for mode in ("device", "stream"):
            spec, _ = experiment_spec("image_acgan", steps=K, strategy=strategy, log_every=0,
                                      device=dev, data_mode=mode)
            spec.run_result()                      # warm-up: cuDNN picks algorithms
            spec = dataclasses.replace(spec, steps=rounds * K)
            result = _counted_run(torch, spec, f"{mode} {label}", per_round, rounds)
            _finite_run(torch, result, f"{mode} {label}")
            check(result.timings["data_kind"] == mode, f"{mode}: ran {result.timings}")
            t = result.timings
            line.append(f"{mode} {t['total_s'] / rounds * 1e3:.1f} ms/round, "
                        f"{t['steps_per_s']:.2f} steps/s, round gap "
                        f"{t['round_gap_s'] * 1e3:.3f} ms")
        log(f"stream phase image_acgan {label}: " + "; ".join(line))

    spec, _ = experiment_spec("image_acgan", steps=rounds * K, log_every=0, device=dev,
                              data_mode="stream")
    data = spec.build_data()
    key = prng.key(spec.seed + 1)
    want = [data.rounds.round_batches(rb) for rb in stream_key_schedule(key, 4)]
    for prefetch in (1, 2, 4):
        got = list(dataclasses.replace(data, prefetch=prefetch).iter_rounds(key, 4))
        torch.cuda.synchronize()
        check(len(got) == 4, f"stream prefetch {prefetch}: {len(got)} rounds")
        for r, ((gb, gs), (wb, ws)) in enumerate(zip(got, want)):
            check(all(x.device.type == "cuda" for x in tree_leaves(gb) + [gs]),
                  f"stream prefetch {prefetch}: round {r} not on the card")
            check(sorted(gb) == sorted(wb) and all(
                same_bits(torch, gb[k].cpu(), wb[k]) for k in wb) and same_bits(
                    torch, gs.cpu(), ws),
                f"stream prefetch {prefetch}: round {r} differs from the blocking assembler")
    log("stream phase: uploads at prefetch 1, 2, 4 bit-identical to the blocking "
        "assembler (4 rounds of image_acgan, x, y, z and seeds)")

    mg, _ = experiment_spec("mixed_gaussian", steps=4 * 5, log_every=0, device=dev,
                            data_mode="stream")
    fed, data = mg.build(), mg.build_data()
    init = fed.init_state(torch.Generator().manual_seed(mg.seed), device=dev)
    from repro_torch.run import RoundDriver
    streamed = RoundDriver(fed, data, mg.n_rounds, log_every=0, verbose=False).run(
        mg.seed + 1, state=tree_map(torch.clone, init))
    state, rows = init, []
    for rb in stream_key_schedule(prng.key(mg.seed + 1), mg.n_rounds):
        batches, _ = data.rounds.round_batches(rb)
        state, m = fed.round(state, tree_map(lambda x: x.to(dev), batches))
        rows.append(metric_row(m, sorted(m)).tolist())
    check(_states_same(torch, streamed.state, state)
          and [list(h.values()) for h in streamed.history] == rows,
          "stream phase: mixed_gaussian streamed at prefetch 2 differs from the blocking loop")
    log(f"stream phase: mixed_gaussian {mg.n_rounds} rounds streamed at prefetch 2 "
        "bit-identical to the blocking loop")


def _profile_line(name, **kw):
    from repro_torch.run.profile import profile_rounds
    out = profile_rounds(name, rounds=3, **kw)
    return (f"{out['ms_per_round']:.2f} ms/round, busy {out['device_busy_share']:.1%} "
            f"({sum(out['device_ms_per_round'].values()):.2f} kernel ms a round on "
            f"{out['device_streams']} streams)")


def run_captured(torch, dev):
    """Phase B, rounds in chunks through the captured CUDA graph.
    ``toy_2d``, ``mixed_gaussian`` and ``swiss_roll`` (12 rounds at K = 5)
    at ``rounds_per_chunk`` 1, 4 and 12: histories and states
    bit-identical, launches exact.  ``image_acgan`` at full width: 3
    rounds captured against 3 eager under ``FedAvgSync()`` and fused int8 +
    EF, with ``cudnn.deterministic`` set for both runs (cuDNN's weight
    gradient is not deterministic otherwise) and restored: states and
    histories bit-identical, launches exact.  ``AdaptiveK`` and
    ``SubsampledFedAvg`` at ``rounds_per_chunk=4`` run and report
    ``captured: False``.  ms a round and the profiler's busy share of each
    path."""
    from repro_torch.comm import IntQuant
    from repro_torch.core import AdaptiveK, FedAvgSync, SubsampledFedAvg
    from repro_torch.launch.train import experiment_spec
    for name in ("toy_2d", "mixed_gaussian", "swiss_roll"):
        spec, _ = experiment_spec(name, K=5, steps=60, log_every=0, device=dev)
        spec.run_result()                         # warm-up: libraries, algorithms
        runs, line = {}, []
        for c in (1, 4, 12):
            res = _counted_run(torch, dataclasses.replace(spec, rounds_per_chunk=c),
                               f"{name} rounds_per_chunk={c}", {"fedavg": 2}, 12)
            check(res.timings["captured"] == (c > 1), f"{name} c={c}: {res.timings}")
            runs[c] = res
            line.append(f"c={c} {res.timings['total_s'] / 12 * 1e3:.2f} ms/round")
        for c in (4, 12):
            check(runs[c].history == runs[1].history
                  and _states_same(torch, runs[c].state, runs[1].state),
                  f"{name}: rounds_per_chunk={c} differs from 1")
        log(f"captured phase {name}, 12 rounds x K=5, bit-identical at c = 1, 4, 12: "
            + ", ".join(line))

    # the other sync schedules and wires captured: a per-round host copy
    # or read in any of them fails the capture
    from repro_torch.comm import get_codec
    from repro_torch.core import Hierarchical, PartialSharing, PerStepGradAvg
    schedules = (
        ("PerStepGradAvg()", PerStepGradAvg(), {}),
        ("PartialSharing()", PartialSharing(), {}),
        ("FedAvgSync(sync_dtype=bfloat16)", FedAvgSync(sync_dtype=torch.bfloat16), {}),
        ("FedAvgSync(codec=TopK(0.25)+IntQuant(4))",
         FedAvgSync(codec=get_codec("topk+int4", fraction=0.25)), {}),
        ("FedAvgSync(codec=IntQuant(8), fused_sync=False)",
         FedAvgSync(codec=IntQuant(bits=8), fused_sync=False), {}),
        ("Hierarchical(intra_interval=5) on (2, 4)", Hierarchical(intra_interval=5),
         {"agents": 8}))
    for label, strategy, kw in schedules:
        spec, _ = experiment_spec("mixed_gaussian", K=10, steps=80, strategy=strategy,
                                  log_every=0, device=dev, **kw)
        if "agents" in kw:
            spec = dataclasses.replace(spec, agent_grid=(2, 4))
        counters = launch_counters()
        runs = {}
        for c in (1, 8):
            _reset(counters)
            runs[c] = dataclasses.replace(spec, rounds_per_chunk=c).run_result()
            torch.cuda.synchronize()
            runs[c].timings["launches"] = _read(counters)
        check(runs[8].timings["captured"] and runs[8].history == runs[1].history
              and _states_same(torch, runs[8].state, runs[1].state),
              f"captured mixed_gaussian under {label} differs from the eager rounds")
        check(runs[8].timings["launches"] == runs[1].timings["launches"]
              and any(runs[1].timings["launches"].values()),
              f"{label}: captured launches {runs[8].timings['launches']}, eager "
              f"{runs[1].timings['launches']}")
        log(f"captured phase mixed_gaussian K=10 under {label}: 8 rounds bit-identical "
            f"to eager, launches {runs[8].timings['launches']}; eager "
            f"{runs[1].timings['total_s'] / 8 * 1e3:.2f}, captured "
            f"{runs[8].timings['total_s'] / 8 * 1e3:.2f} ms/round")

    K, rounds = 20, 3
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for label, strategy, per_round in (
                ("FedAvgSync()", None, {"fedavg": 2}),
                ("FedAvgSync(codec=IntQuant(8))", FedAvgSync(codec=IntQuant(bits=8),
                                                             error_feedback=True),
                 {"qsync": 2})):
            spec, _ = experiment_spec("image_acgan", steps=rounds * K, strategy=strategy,
                                      log_every=0, device=dev)
            dataclasses.replace(spec, steps=K).run_result()   # warm-up
            eager = _counted_run(torch, spec, f"eager image_acgan {label}", per_round, rounds)
            capt = _counted_run(torch, dataclasses.replace(spec, rounds_per_chunk=rounds),
                                f"captured image_acgan {label}", per_round, rounds)
            _finite_run(torch, capt, f"captured image_acgan {label}")
            check(capt.timings["captured"] and not eager.timings["captured"],
                  f"image_acgan {label}: captured flags {capt.timings}, {eager.timings}")
            check(capt.history == eager.history and _states_same(torch, capt.state, eager.state),
                  f"image_acgan {label}: the captured rounds differ from the eager ones")
            log(f"captured phase image_acgan {label}, {rounds} rounds x K={K}, "
                f"cudnn.deterministic: bit-identical; eager "
                f"{eager.timings['total_s'] / rounds * 1e3:.1f} ms/round, captured "
                f"{capt.timings['total_s'] / rounds * 1e3:.1f} ms/round")
    finally:
        torch.backends.cudnn.deterministic = old

    for strategy in (AdaptiveK(warmup_rounds=1, sync_every=2), SubsampledFedAvg(fraction=0.6)):
        spec, _ = experiment_spec("toy_2d", K=5, steps=40, strategy=strategy, log_every=0,
                                  device=dev, rounds_per_chunk=4)
        res = spec.run_result()
        _finite_run(torch, res, strategy.name)
        check(res.timings["captured"] is False and len(res.history) == 8,
              f"{strategy.name} at rounds_per_chunk=4: {res.timings}")
        log(f"captured phase {strategy.name} at rounds_per_chunk=4: eager rounds, "
            f"captured false, {res.timings['total_s'] / 8 * 1e3:.2f} ms/round")

    for name in ("toy_2d", "mixed_gaussian"):
        log(f"profile {name} K=5: eager " + _profile_line(name, K=5, device=dev)
            + "; captured " + _profile_line(name, K=5, device=dev, captured=True))
    log("profile image_acgan: eager " + _profile_line("image_acgan", device=dev)
        + "; captured " + _profile_line("image_acgan", device=dev, captured=True))


# ---------------------------------------------------------------------------
# phase 13: privacy and robustness at image_acgan's full width
# ---------------------------------------------------------------------------

DP_CLIP = 1.0


def _enveloped(torch, cls, f, record, **kw):
    """``cls(**kw)``, a robust strategy whose reduce also appends, per
    leaf, the count of aggregate coordinates that are not finite or lie
    outside the per-coordinate envelope of the honest agents' values
    (agents f.. of the flattened grid: the decoded wire images on the
    composed path), a device count read after the round."""

    @dataclasses.dataclass(frozen=True)
    class Enveloped(cls):
        def sync_reduce(self):
            inner = cls.sync_reduce(self)

            def reduce(x, w):
                m = inner(x, w)
                honest = x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))[f:]
                record.append(((m < honest.amin(0)) | (m > honest.amax(0))
                               | ~torch.isfinite(m)).sum())
                return m
            return reduce

    return Enveloped(**kw)


def _wire_check(torch, fed, local, dev):
    """The secure sum's uplink at full width: the generator's wire images
    under the round's key, masks drawn on the card, differ from the
    plaintext payload bits (all but a 2^-32 chance per element) and still
    add up, over the agents and mod 2^32, to the payloads' sum.  Returns
    the share of wire words equal to their payload and the element
    count."""
    from repro_torch import prng
    from repro_torch.dist import collectives
    from repro_torch.privacy import SecureAgg
    from repro_torch.tree import tree_leaves
    key = prng.fold_in_t(SecureAgg(0).round_key(local["step"]), 0)
    w = fed._w(dev)
    params = local["params"]["gen"]
    same, total = 0, 0
    for x, wire in zip(tree_leaves(params), tree_leaves(collectives.masked_wire(params, w, key))):
        check(wire.is_cuda, "secure sum: the wire image is not on the card")
        payload = collectives._to_bits(x * w.reshape(w.shape + (1,) * (x.dim() - 2)))
        B_ = x.shape[0] * x.shape[1]
        check(torch.equal(wire.reshape(B_, -1).sum(0) & 0xFFFFFFFF,
                          payload.reshape(B_, -1).sum(0) & 0xFFFFFFFF),
              "secure sum: the masks do not cancel over the agents")
        same += int((wire == payload).sum())
        total += wire.numel()
    check(same <= 1e-4 * total, f"secure sum: {same} of {total} wire words are the plaintext")
    return same, total


def _joint_norms(torch, fed, state, data, dev):
    """Each (agent, example)'s clipped joint (G, D) gradient norm and
    pre-clip joint norm at full width, from one step's minibatch: the
    per-example vmap nested in the agent vmap, as the DP-SGD step runs
    it.  Returns (largest clipped norm, share of examples clipped, peak
    bytes)."""
    from torch.func import vmap
    from repro_torch.core.fedgan import _flat
    from repro_torch.privacy import per_example_grads
    from repro_torch.tree import tree_leaves
    torch.cuda.reset_peak_memory_stats()
    batch = data.sample_step(torch.Generator(device=dev).manual_seed(11))
    gd, gg, nd, ng, _ = vmap(lambda p, b: per_example_grads(fed._agent_grads, p, b, DP_CLIP))(
        _flat(state["params"], B), _flat(batch, B))
    sq = sum(torch.sum(torch.square(g).reshape(g.shape[0], g.shape[1], -1), dim=2)
             for g in tree_leaves(gd) + tree_leaves(gg))
    joint, pre = torch.sqrt(sq), torch.hypot(nd, ng)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    top = float(joint.max())
    check(top <= DP_CLIP * (1 + 1e-6), f"DP-SGD: a per-example joint norm {top} exceeds {DP_CLIP}")
    clipped = pre > DP_CLIP
    check(bool((torch.abs(joint[clipped] - DP_CLIP) <= 1e-5 * DP_CLIP).all()),
          "DP-SGD: a clipped example's joint norm is not C")
    return top, float(clipped.float().mean()), peak


def _privacy_rounds(torch, dev, base, data, state):
    """Phase 13's full-width rounds (see ``run_privacy``), one per path
    from ``state`` with the same round generator.  Returns the local-only
    round's state, the plain round's peak bytes and each path's ms."""
    from repro_torch.comm import IntQuant, get_codec
    from repro_torch.core import (CoordinateMedianSync, FedAvgSync, LocalOnly,
                                  TrimmedMeanSync)
    from repro_torch.privacy import DPSGD, SecureAgg, WithByzantine
    from repro_torch.tree import tree_leaves
    K = base.cfg.sync_interval
    L = len(tree_leaves(state["params"]))
    counters = launch_counters()

    def path(strategy=None, dp=None):
        return dataclasses.replace(base, cfg=dataclasses.replace(base.cfg, strategy=strategy,
                                                                 dp=dp))

    def run(fed, label, want):
        gen = torch.Generator(device=dev).manual_seed(7)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset(counters)
        t = time.perf_counter()
        out, m = fed.round_from_data(state, data, gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        counts = _read(counters)
        want = {n: want.get(n, 0) for n in counters}
        check(counts == want, f"{label}: launches {counts} in one round, expected {want}")
        check(all(bool(torch.isfinite(v).all()) for v in m.values()), f"{label}: non-finite losses")
        check(all(bool(torch.isfinite(x).all()) for x in tree_leaves(out["params"])),
              f"{label}: non-finite params")
        return out, m, ms, torch.cuda.max_memory_allocated()

    ms = {}
    path().round_from_data(state, data, torch.Generator(device=dev).manual_seed(7))  # warm-up
    plain, _, ms["plain"], plain_peak = run(path(), "plain", {"fedavg": 2})
    secure, _, ms["secure"], _ = run(path(FedAvgSync(secure_agg=SecureAgg(0))), "secure",
                                     {"fedavg": 2})
    check(_states_same(torch, plain["params"], secure["params"]),
          "secure sum: the round's params differ from the plain round's")
    del plain, secure
    local, _, ms["local only"], _ = run(path(LocalOnly()), "local only", {})
    same, total = _wire_check(torch, base, local, dev)
    log(f"privacy secure sum: params bit-identical to FedAvgSync(); generator wire image "
        f"{same} of {total} words equal to the plaintext, masks drawn on the card and "
        f"cancelling mod 2^32")

    outside = []
    tm = WithByzantine(_enveloped(torch, TrimmedMeanSync, 1, outside, trim=1,
                                  codec=IntQuant(bits=8), fused_sync=False), "sign_flip", 1)
    out, _, ms["trimmed mean (int8 composed)"], _ = run(
        path(tm), "trimmed mean under sign_flip x1", {"quant": 2 * L, "dequant": 2 * L})
    check(len(outside) == L and sum(int(o) for o in outside) == 0,
          f"trimmed mean: {[int(o) for o in outside]} coordinates outside the honest envelope")
    check(bool(_agents_equal(torch, out).all()), "trimmed mean: agents differ after the sync")
    outside = []
    med = WithByzantine(_enveloped(torch, CoordinateMedianSync, 2, outside,
                                   codec=get_codec("topk+int4", fraction=0.25)), "nan", 2)
    out, _, ms["median (top-k + int4)"], _ = run(
        path(med), "median under nan x2",
        {"quant": 2 * L, "pack4": 2 * L, "unpack4": 2 * L, "dequant": 2 * L})
    check(len(outside) == L and sum(int(o) for o in outside) == 0,
          f"median: {[int(o) for o in outside]} coordinates outside the honest envelope")
    check(bool(_agents_equal(torch, out).all()), "median: agents differ after the sync")
    del out
    log("privacy robust reduces under attack: trimmed mean (trim 1, int8 composed, sign_flip "
        "x1) and median (top-k 0.25 + int4, nan x2) inside the honest envelope on every "
        f"coordinate of all {L} leaves, finite; no fedavg launched")

    dp = DPSGD(clip=DP_CLIP, noise_multiplier=1.0)
    _, _, ms["int8 fused"], _ = run(path(FedAvgSync(codec=IntQuant(bits=8))), "int8 fused",
                                    {"qsync": 2})
    _, m_dp, ms["DP-SGD + int8 fused"], dp_peak = run(
        path(FedAvgSync(codec=IntQuant(bits=8)), dp), "DP-SGD, int8 fused", {"qsync": 2})
    top, share, pe_peak = _joint_norms(torch, path(None, dp), state, data, dev)
    log(f"privacy DP-SGD (clip {DP_CLIP}, sigma 1.0, fused int8): round finite, "
        f"dp_grad_norm_d {float(m_dp['dp_grad_norm_d'].mean()):.4g}, dp_grad_norm_g "
        f"{float(m_dp['dp_grad_norm_g'].mean()):.4g}, epsilon after one round "
        f"{dp.epsilon(K)!r} (delta {dp.delta}); largest per-example joint norm {top!r} "
        f"(<= C), {share:.3f} of examples clipped; peak {dp_peak / 2 ** 30:.2f} GiB in the "
        f"round, {pe_peak / 2 ** 30:.2f} GiB holding one step's per-example gradients "
        f"(plain round {plain_peak / 2 ** 30:.2f} GiB)")
    return local, ms


def run_privacy(torch, dev):
    """Phase 13: ``experiment_spec("image_acgan")`` at full width (B = 5,
    K = 20, batch 64, Adam), one round of each privacy path from one state
    and the same batches (the same round generator), after an uncounted
    warm-up round, every launch counter set to 0 just before and read just
    after each round:
    * ``FedAvgSync()`` (2 fedavg) and ``FedAvgSync(secure_agg=SecureAgg(0))``
      (2 fedavg, the reduce of the unmasked products): params bit-identical;
      the generator's wire image (masks drawn on the card) is not the
      plaintext and sums to it over the agents;
    * ``WithByzantine(TrimmedMeanSync(trim=1, codec=IntQuant(8),
      fused_sync=False), "sign_flip", 1)``: 2L quant and 2L dequant (L
      float32 leaves), no fedavg; every leaf's aggregate inside the honest
      agents' envelope of decoded values;
    * ``WithByzantine(CoordinateMedianSync(codec=TopK(0.25) +
      IntQuant(4)), "nan", 2)``: 2L each of quant, pack4, unpack4 and
      dequant, no fedavg; the aggregate finite and inside the envelope;
    * ``FedAvgSync(codec=IntQuant(8))`` with ``dp=DPSGD(clip=1,
      noise_multiplier=1)``: 2 qsync; finite; its accountant epsilon; every
      per-example joint norm of one step at full width at most C.
    These rounds run with ``cudnn.deterministic`` set (restored after):
    cuDNN's weight gradient is not deterministic otherwise, and the secure
    round is held to the plain one bit for bit.  Then one K = 1 round of
    the 8x8 ACGAN nets on the card against the CPU port for the secure,
    trimmed-mean, median and clip-only DP paths, within
    ``tests/torch_shared.py``'s bounds; the robust reduces' time against
    fedavg's on the local round's params, and each sync's ``round_sync``
    alone on that state (CUDA events).  Prints each path's ms a round
    beside the plain round's, peaks and the card."""
    from repro_torch.comm import IntQuant
    from repro_torch.core import CoordinateMedianSync, FedAvgSync, TrimmedMeanSync
    from repro_torch.dist import collectives
    from repro_torch.launch.train import experiment_spec
    from repro_torch.privacy import DPSGD, SecureAgg
    from repro_torch.tree import tree_leaves
    from torch_shared import CARD_K, port_round_mismatches
    t_phase = time.perf_counter()
    card = card_line()
    K = 20
    spec, _ = experiment_spec("image_acgan", steps=K, log_every=0, device=dev)
    check((spec.K, spec.batch_size, spec.agent_grid) == (K, 64, (1, B)),
          "image_acgan is not at the experiment's width")
    base, data = spec.build(), spec.build_data()
    state = base.init_state(torch.Generator().manual_seed(spec.seed), device=dev)
    log("depth cut: phase 13 runs image_acgan one round x K=20 a path of the paper's 30000 "
        "steps")
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        local, ms = _privacy_rounds(torch, dev, base, data, state)
    finally:
        torch.backends.cudnn.deterministic = old

    w = base._w(dev)
    leaves = [x.contiguous() for x in tree_leaves(local["params"])]
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    reduces = {kind: collectives.make_robust_reduce(kind) for kind in ("trimmed_mean", "median")}
    red_ms = {kind: time_ms(torch, lambda r=r: [r(x, w) for x in leaves], flush)
              for kind, r in reduces.items()}
    avg_ms = time_ms(torch, lambda: collectives.average_agents(local["params"], w), flush)
    log(f"privacy reduce of the local round's params ({sum(x.numel() for x in leaves)} "
        f"values in {len(leaves)} leaves): trimmed mean {red_ms['trimmed_mean']:.3f} ms, "
        f"median {red_ms['median']:.3f} ms, fedavg (2 bucketed launches) {avg_ms:.3f} ms; "
        f"{card}")
    syncs = {"FedAvgSync()": FedAvgSync(),
             "FedAvgSync(secure_agg=SecureAgg(0))": FedAvgSync(secure_agg=SecureAgg(0)),
             "TrimmedMeanSync()": TrimmedMeanSync(),
             "CoordinateMedianSync()": CoordinateMedianSync(),
             "FedAvgSync(codec=IntQuant(8), fused_sync=False)":
                 FedAvgSync(codec=IntQuant(bits=8), fused_sync=False),
             "TrimmedMeanSync(codec=IntQuant(8), fused_sync=False)":
                 TrimmedMeanSync(codec=IntQuant(bits=8), fused_sync=False)}
    sync_ms = {label: time_ms(torch, lambda st=st: st.round_sync(base, local), flush)
               for label, st in syncs.items()}
    del flush
    log("privacy round_sync of the local round's state alone (CUDA events, median of "
        f"{REPS}, L2 flushed): " + ", ".join(f"{k} {v:.3f} ms" for k, v in sync_ms.items())
        + f"; {card}")

    for label, kw in (("secure", {"strategy": FedAvgSync(secure_agg=SecureAgg(0))}),
                      ("trimmed_mean", {"strategy": TrimmedMeanSync()}),
                      ("median", {"strategy": CoordinateMedianSync()}),
                      ("dp clip-only", {"dp": DPSGD(clip=DP_CLIP)})):
        bad, (ratio, where) = port_round_mismatches("image_acgan", dev, K=CARD_K, **kw)
        check(bad == [], f"image_acgan {label} round, card against CPU: {bad}")
        log(f"privacy {label} round card vs CPU (8x8 nets, K = {CARD_K}): agree; largest "
            f"|card - CPU| / limit {ratio:.4g} at {where}")
    log(f"privacy ms a round (image_acgan, B={B}, K={K}, batch 64, cudnn.deterministic): "
        + ", ".join(f"{k} {v:.1f}" for k, v in ms.items())
        + f"; phase {time.perf_counter() - t_phase:.1f} s wall; {card}")


# ---------------------------------------------------------------------------
# phase 14: the virtual-client fleet and the async buffered aggregation
# ---------------------------------------------------------------------------

# image_acgan's width (B = 5 slots, K = 20, batch 64, Adam); the fleet sizes
# and rounds of each part.  A rehearsal on the CPU shrinks them.
FLEET_K, FLEET_BATCH = 20, 64
FLEET_TOTAL, FLEET_ROUNDS = 1024, 6
FLEET_ASYNC_CLIENTS, FLEET_FLUSHES = 64, 6
# the demo's latency model (repro_torch.run.simclock.demo_driver)
FLEET_ASYNC = dict(buffer_goal=2, timeout=6.0, max_retries=2, backoff=2.0)
FLEET_LATENCY = dict(base=1.0, jitter=0.5, straggler_frac=0.25, straggler_factor=8.0)


def _fleet_spec(dev, **kw):
    from repro_torch.launch.train import experiment_spec
    spec, _ = experiment_spec("image_acgan", K=FLEET_K, log_every=0, device=dev,
                              batch_size=FLEET_BATCH, **kw)
    check((spec.K, spec.batch_size, spec.agent_grid) == (FLEET_K, FLEET_BATCH, (1, B)),
          "image_acgan is not at the experiment's width")
    return spec


def _host_and_card_peaks(torch):
    """(the process's peak resident host memory, the card's peak
    allocation since the last reset), GiB."""
    import resource
    return (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20,
            torch.cuda.max_memory_allocated() / 2 ** 30)


def _held_calls(held, counts, names):
    """Every launch of ``names`` was held in place to its plain version."""
    for n in names:
        calls = held.get(n, {}).get("calls", 0)
        check(calls == counts[n], f"{n}: {calls} calls held, {counts[n]} launches")
    return {n: held[n]["max_abs_err"] for n in names if n in held}


def _fleet_identity(torch, dev, counters, card):
    """(a) ``a_total = a_active = 5``: the fleet against the dense stream
    ``RoundDriver`` on the card, from the fleet's init and round keys, bit
    for bit (``cudnn.deterministic`` set)."""
    from repro_torch.data import FederatedRounds, StreamingFederatedData
    from repro_torch.run import RoundDriver
    from repro_torch.run.virtual import init_generators
    rounds = 3
    spec = _fleet_spec(dev, steps=rounds * FLEET_K, a_total=B, a_active=B)
    fed = spec.build()
    data = StreamingFederatedData(FederatedRounds(spec.agent_data, (1, B), FLEET_BATCH,
                                                  FLEET_K, sample_extra=spec.sample_extra),
                                  device=dev)
    data_rng, init_gen = init_generators(spec.seed + 1)
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # warm-up round: cuDNN's first calls pick algorithms; not counted
        RoundDriver(fed, data, 1, log_every=0, verbose=False).run(
            data_rng, state=fed.init_state(init_gen(), device=dev))
        _reset(counters)
        virt = spec.run_result()
        torch.cuda.synchronize()
        counts = _read(counters)
        dense = RoundDriver(fed, data, rounds, log_every=0, verbose=False).run(
            data_rng, state=fed.init_state(init_gen(), device=dev))
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = old
    want = {n: rounds * 2 if n == "fedavg" else 0 for n in counters}
    check(counts == want, f"fleet identity: launches {counts}, expected {want}")
    check(virt.timings["swapped_rows"] == 0, "fleet identity: the identity schedule swapped")
    check(virt.history == dense.history and _states_same(torch, virt.state, dense.state),
          "fleet identity: the fleet differs from the dense stream run")
    log(f"fleet (a) identity a_total = a_active = {B}, {rounds} rounds x K={FLEET_K}: params, "
        f"Adam state and metrics bit-identical to the dense stream RoundDriver; fleet "
        f"{virt.timings['rounds_per_s']:.3f} rounds/s (gap {virt.timings['round_gap_s'] * 1e3:.2f}"
        f" ms), dense {rounds / dense.timings['total_s']:.3f} rounds/s (gap "
        f"{dense.timings['round_gap_s'] * 1e3:.2f} ms); launches {counts}; {card}")


def _fleet_sampled(torch, dev, counters, card):
    """(b) ``a_total = FLEET_TOTAL``, 5 slots, ``participation_seed = 0``:
    FLEET_ROUNDS rounds under the plain and the fused int8 + EF sync, every
    sync launch held in place.  Returns the spec."""
    from repro_torch.comm import IntQuant
    from repro_torch.core import FedAvgSync
    from repro_torch.tree import tree_leaves
    from torch_shared import held_sync_kernels
    t = time.perf_counter()
    spec = _fleet_spec(dev, steps=FLEET_ROUNDS * FLEET_K, a_total=FLEET_TOTAL, a_active=B,
                       participation_seed=0)
    n_samples = spec.agent_data[0]["x"].shape[0]
    log(f"fleet (b) data: {FLEET_TOTAL} clients x {n_samples} images on the host, made in "
        f"{time.perf_counter() - t:.1f} s; depth cut: {FLEET_ROUNDS} rounds x K={FLEET_K} of "
        "the paper's 30000 steps")
    for label, strategy, per_round in (
            ("FedAvgSync()", None, {"fedavg": 2}),
            ("FedAvgSync(codec=IntQuant(8), error_feedback=True)",
             FedAvgSync(codec=IntQuant(bits=8), error_feedback=True), {"qsync": 2})):
        run = dataclasses.replace(spec, strategy=strategy)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset(counters)
        with held_sync_kernels() as held:
            res = run.run_result()
            torch.cuda.synchronize()
        counts = _read(counters)
        want = {n: FLEET_ROUNDS * per_round.get(n, 0) for n in counters}
        check(counts == want, f"fleet {label}: launches {counts}, expected {want}")
        errs = _held_calls(held, counts, ("fedavg", "qsync", "adam_sync"))
        t_ = res.timings
        check(t_["swapped_rows"] > 0 and B <= t_["store_rows"] <= FLEET_ROUNDS * B,
              f"fleet {label}: store_rows {t_['store_rows']}, swapped {t_['swapped_rows']}")
        check(all(math.isfinite(v) for m in res.history for v in m.values()),
              f"fleet {label}: non-finite losses")
        check(all(bool(torch.isfinite(x).all()) for x in tree_leaves(res.state)
                  if x.is_floating_point()), f"fleet {label}: non-finite state")
        rss, peak = _host_and_card_peaks(torch)
        log(f"fleet (b) {label}, a_total {FLEET_TOTAL}, a_active {B}: {FLEET_ROUNDS} rounds, "
            f"{t_['rounds_per_s']:.3f} rounds/s, round gap {t_['round_gap_s'] * 1e3:.2f} ms "
            f"(paging {t_['paging_s'] * 1e3:.2f} ms of it), store_rows {t_['store_rows']}, swapped_rows {t_['swapped_rows']}, launches "
            f"{ {n: c for n, c in counts.items() if c} } (adam_sync {counts['adam_sync']}: the "
            f"round takes Adam.update, then the sync), each held in place (max |kernel - "
            f"plain| {errs}); host peak RSS {rss:.2f} GiB, card peak {peak:.2f} GiB; {card}")
    return spec


def _fleet_deferred(torch, dev, spec, counters, card):
    """(c) ``straggler_policy="defer"`` on (b)'s fleet, a planted
    ``late:1`` and a ``drop`` in round 1: every round takes the split path,
    whose merge launches fedavg once per leaf, held in place; then one such
    round at K = 1 on the 8x8 nets against the CPU port."""
    from repro_torch.core import ParticipationSchedule
    from repro_torch.tree import tree_leaves
    from repro_torch.run.virtual import StragglerPolicy, VirtualClientDriver
    from torch_shared import CARD_K, held_sync_kernels, port_fleet_round_mismatches
    rounds = 3
    fed, fleet = spec.build_fleet()
    L = len(tree_leaves(fed.init_state(torch.Generator().manual_seed(0),
                                       device="cpu")["params"]))
    faults = lambda r, slots: {slots[0]: "late:1", slots[2]: "drop"} if r == 1 else {}  # noqa: E731
    drv = VirtualClientDriver(fed, fleet, rounds, schedule=ParticipationSchedule(seed=0),
                              straggler=StragglerPolicy(mode="defer"), faults=faults,
                              log_every=0, device=dev)
    _reset(counters)
    with held_sync_kernels() as held:
        res = drv.run(spec.seed + 1)
        torch.cuda.synchronize()
    counts = _read(counters)
    want = {n: rounds * L if n == "fedavg" else 0 for n in counters}
    check(counts == want, f"fleet deferred: launches {counts}, expected {want}")
    errs = _held_calls(held, counts, ("fedavg",))
    t_ = res.timings
    check((t_["late"], t_["dropped"], t_["merged_deltas"]) == (1, 1, 1),
          f"fleet deferred: late {t_['late']}, dropped {t_['dropped']}, merged "
          f"{t_['merged_deltas']}")
    (bad, (ratio, where)), dropped = port_fleet_round_mismatches(dev)
    check(bad == [] and dropped, f"fleet deferred round, card against CPU: {bad}, "
                                 f"dropped slot reverted: {dropped}")
    log(f"fleet (c) defer, late:1 and drop in round 1 of {rounds}: the merges launched fedavg "
        f"{counts['fedavg']} times ({L} leaves a round), each held in place (max |kernel - "
        f"plain| {errs['fedavg']!r}); {t_['rounds_per_s']:.3f} rounds/s; one such round "
        f"(8x8 nets, K = {CARD_K}) card vs CPU: agree, largest |card - CPU| / limit "
        f"{ratio:.4g} at {where}; {card}")


def _fleet_async(torch, dev, counters, card):
    """(d) ``AsyncAggDriver`` buffered over FLEET_ASYNC_CLIENTS clients,
    cohort 5, goal 2, the demo's latency model, FLEET_FLUSHES flushes: each
    flush's fedavg launches held in place; its journal equals the CPU
    port's run of the same fleet (at K = 1: the journal is the schedule's
    and the latency model's alone) apart from the params digests; then
    ``demo_driver`` twice on the card, byte-identical."""
    from repro_torch.core import ParticipationSchedule
    from repro_torch.run.async_agg import AsyncAggDriver
    from repro_torch.run.simclock import LatencyModel, demo_driver
    from repro_torch.run.virtual import StragglerPolicy
    from repro_torch.tree import tree_leaves
    from torch_shared import CARD_K, held_sync_kernels
    spec = _fleet_spec(dev, steps=FLEET_K, a_total=FLEET_ASYNC_CLIENTS, a_active=B)

    def driver(run_spec, device):
        fed, fleet = run_spec.build_fleet()
        return AsyncAggDriver(fed, fleet, FLEET_FLUSHES, schedule=ParticipationSchedule(seed=0),
                              straggler=StragglerPolicy(mode="defer", decay=0.5, max_staleness=2),
                              latency=LatencyModel(**FLEET_LATENCY), device=device,
                              log_every=0, **FLEET_ASYNC)

    drv = driver(spec, dev)
    L = len(tree_leaves(drv.fed.init_state(torch.Generator().manual_seed(0),
                                           device="cpu")["params"]))
    _reset(counters)
    t = time.perf_counter()
    with held_sync_kernels() as held:
        res = drv.run(spec.seed + 1)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = _read(counters)
    want = {n: FLEET_FLUSHES * L if n == "fedavg" else 0 for n in counters}
    check(counts == want, f"fleet async: launches {counts}, expected {want}")
    errs = _held_calls(held, counts, ("fedavg",))
    check(all(bool(torch.isfinite(torch.from_numpy(x)).all())
              for x in tree_leaves(res.state["params"])), "fleet async: non-finite params")
    t = time.perf_counter()
    cpu = driver(dataclasses.replace(spec, K=CARD_K, steps=CARD_K), "cpu")
    cpu.run(spec.seed + 1)
    cpu_wall = time.perf_counter() - t
    strip = lambda j: [{k: v for k, v in r.items() if k != "params_digest"}  # noqa: E731
                       for r in j.records]
    check(strip(drv.journal) == strip(cpu.journal),
          "fleet async: the card's journal differs from the CPU port's")
    t_ = res.timings
    log(f"fleet (d) async buffered, {FLEET_ASYNC_CLIENTS} clients, cohort {B}, goal "
        f"{FLEET_ASYNC['buffer_goal']}: {t_['flushes']} flushes, {t_['dispatches']} dispatches, "
        f"{t_['timeouts']} timeouts, {t_['retries']} retries, {t_['gave_up']} gave up, "
        f"{t_['expired_deltas']} expired, makespan {t_['makespan']!r} (virtual), {wall:.1f} s "
        f"wall; flush fedavg launches {counts['fedavg']} ({L} leaves a flush), each held in "
        f"place (max |kernel - plain| {errs['fedavg']!r}); journal of {len(drv.journal)} "
        f"events equal to the CPU port's (K = {CARD_K}, {cpu_wall:.1f} s) apart from the "
        f"params digests; {card}")
    runs = []
    for _ in range(2):
        d = demo_driver(device=dev)
        d.run(7)
        runs.append(d)
    check(runs[0].journal.canonical_bytes() == runs[1].journal.canonical_bytes(),
          "fleet async: two demo runs on the card give different journals")
    c = runs[0].journal.counts()
    log(f"fleet (d) demo_driver twice on the card: journals of {len(runs[0].journal)} events "
        f"byte-identical, digests included ({c.get('flush', 0)} flushes, "
        f"{c.get('timeout', 0)} timeouts, end digest "
        f"{runs[0].journal.select('end')[-1]['params_digest']})")


def run_fleet(torch, dev):
    """Phase 14: the virtual-client fleet at image_acgan's full width (5
    slots, K = 20, batch 64, Adam, 4.56 M params an agent), through the
    sync kernels: (a) the identity fleet against the dense stream run, bit
    for bit; (b) a sampled 1,024-client fleet under the plain and the fused
    int8 + EF syncs, every sync launch held in place, its paging counts,
    rounds/s, round gap and peaks; (c) deferred stragglers, the merges'
    fedavg launches held in place, one such round at K = 1 against the
    CPU port; (d) the async buffered server over 64 clients, its flushes'
    fedavg launches held in place, its journal against the CPU port's and
    the demo's determinism on the card.  Each launch counter is set to 0
    just before each run and read just after."""
    t_phase = time.perf_counter()
    card = card_line()
    counters = launch_counters()
    _fleet_identity(torch, dev, counters, card)
    spec = _fleet_sampled(torch, dev, counters, card)
    _fleet_deferred(torch, dev, spec, counters, card)
    del spec
    gc_collect(torch)
    _fleet_async(torch, dev, counters, card)
    log(f"fleet phase 14: {time.perf_counter() - t_phase:.1f} s wall; {card}")


# ---------------------------------------------------------------------------
# phase 15: the mesh on one card
# ---------------------------------------------------------------------------


def _mesh_part(torch, label, t0, card):
    torch.cuda.synchronize()
    log(f"mesh {label}: {time.perf_counter() - t0:.1f} s wall, peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; {card}")
    torch.cuda.reset_peak_memory_stats()


def _tree_same_bits(torch, a, b):
    from repro_torch.dist.sharding import full_tree
    from repro_torch.tree import tree_leaves
    la, lb = tree_leaves(full_tree(a)), tree_leaves(full_tree(b))
    return len(la) == len(lb) and all(same_bits(torch, x, y) for x, y in zip(la, lb))


def _mesh_gemma(torch, dev, params, mesh, card):
    """(a): gemma3-4b's prefill and the serving builders on the mesh."""
    from repro_torch.configs.registry import get_config
    from repro_torch.dist.sharding import (is_sharded, named_shardings, param_specs, place,
                                           use_mesh)
    from repro_torch.launch.steps import build_decode, build_prefill
    from repro_torch.models import Backbone
    from repro_torch.models.config import ShapeConfig
    from repro_torch.tree import tree_leaves
    t0 = time.perf_counter()
    cfg = get_config("gemma3-4b")
    B, T = 2, 2048
    toks = torch.randint(0, cfg.vocab_size, (B, T),
                         generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    counters = launch_counters()
    flash = Backbone(cfg, use_flash=True)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    want, plain_ms = timed(lambda: flash.prefill(params, toks)["logits"])
    placed = place(params, named_shardings(mesh, param_specs(params, mesh)))
    check(all(is_sharded(x) for x in tree_leaves(placed)), "mesh: params are not DTensors")
    mesh_ms = []
    for _ in range(2):   # the first call fills DTensor's sharding caches
        _reset(counters)
        with use_mesh(mesh):
            got, ms = timed(lambda: flash.prefill(placed, toks)["logits"])
        mesh_ms.append(ms)
    counts = _read(counters)
    expect = {n: 34 if n == "flash_attention" else 0 for n in counters}
    check(counts == expect, f"mesh gemma3-4b prefill: launches {counts}, expected {expect}")
    check(is_sharded(got) and _tree_same_bits(torch, got, want),
          "mesh gemma3-4b prefill: logits differ from the unsharded prefill")
    del got, want
    plain = Backbone(cfg)
    bp = build_prefill(cfg, ShapeConfig("prefill_card", T, B, "prefill"), mesh)
    _reset(counters)
    # the builders' param specs are param_specs' on the same mesh: the
    # placed params serve all three
    out = bp.fn(placed, place(toks, bp.in_shardings[1]))
    torch.cuda.synchronize()
    check(all(v == 0 for v in _read(counters).values()), "mesh build_prefill launched a kernel")
    ref = plain.prefill(params, toks, logits_mode="last")
    check(_tree_same_bits(torch, out["logits"], ref["logits"]),
          "mesh build_prefill: logits differ from the unsharded backbone's")
    del out, ref
    steps = 4
    bd = build_decode(cfg, ShapeConfig("decode_card", T + steps, B, "decode"), mesh)
    pre = plain.prefill(params, toks, max_seq=T + steps)
    tok = pre["logits"][:, -1].argmax(-1, keepdim=True)
    cache = place(pre["cache"], bd.in_shardings[2])
    ref_cache = pre["cache"]
    for s in range(steps):
        lg, cache = bd.fn(placed, place(tok, bd.in_shardings[1]), cache,
                          torch.tensor(T + s, device=dev))
        rl, ref_cache = plain.decode(params, tok, ref_cache, T + s)
        check(_tree_same_bits(torch, lg, rl), f"mesh build_decode step {s}: logits differ")
        tok = rl[:, -1].argmax(-1, keepdim=True)
    check(_tree_same_bits(torch, cache, ref_cache), "mesh build_decode: caches differ")
    log(f"mesh (a) gemma3-4b (34 layers, d_model 2560, bf16 compute) on {mesh}: prefill "
        f"2 x {T} under use_mesh with {counts['flash_attention']} flash launches, logits "
        f"bit-identical to the unsharded prefill, {mesh_ms[0]:.1f} ms on the first call and "
        f"{mesh_ms[1]:.1f} on the second against {plain_ms:.1f} unsharded (wall); "
        f"build_prefill and {steps} build_decode steps bit-identical to the unsharded "
        f"backbone")
    _mesh_part(torch, "(a) gemma3-4b prefill and builders", t0, card)


def _mesh_serve(torch, dev, params, mesh, card):
    """(b): ServeEngine(mesh=) against the unsharded engine."""
    from repro_torch.configs.registry import get_config
    from repro_torch.dist.sharding import is_sharded
    from repro_torch.tree import tree_leaves
    t0 = time.perf_counter()
    cfg = get_config("gemma3-4b")
    work = GEMMA_WORK[:2]
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, T).tolist() for T, _ in GEMMA_WORK][:2]
    kw = dict(max_batch=4, max_seq=4096, min_bucket=16)
    plain = _serve_run(torch, cfg, params, dev, work, prompts, "mesh (b) unsharded engine",
                       capture=True, **kw)
    plain_eager = _serve_run(torch, cfg, params, dev, work, prompts,
                             "mesh (b) unsharded engine eager", capture=False, **kw)
    eager = _serve_run(torch, cfg, params, dev, work, prompts, "mesh (b) engine eager",
                       capture=False, mesh=mesh, **kw)
    capt = _serve_run(torch, cfg, params, dev, work, prompts, "mesh (b) engine captured",
                      capture=True, mesh=mesh, **kw)
    eng = capt[0]
    check(eng.captured and all(is_sharded(x) for x in tree_leaves(eng.cache)),
          "mesh (b): the engine's tick is not captured on DTensors")
    for a, b, label in ((capt, eager, "captured vs eager"), (capt, plain, "vs unsharded")):
        check(a[0].stats.decode_ticks == b[0].stats.decode_ticks, f"mesh (b) {label}: ticks")
        check(all(a[1][r].generated == b[1][r].generated for r in a[1]),
              f"mesh (b) {label}: tokens differ")
    same_rows = all(np.array_equal(x.view(np.uint32), y.view(np.uint32))
                    for r in capt[0].rows for x, y in zip(capt[0].rows[r], eager[0].rows[r]))
    check(same_rows and _tree_same_bits(torch, capt[0].cache, eager[0].cache),
          "mesh (b): the captured tick is not the eager tick bit for bit")
    vs_plain = all(np.array_equal(x.view(np.uint32), y.view(np.uint32))
                   for r in capt[0].rows for x, y in zip(capt[0].rows[r], plain[0].rows[r]))
    s = eng.stats
    log(f"mesh (b) ServeEngine(gemma3-4b, mesh=make_serving_mesh()): {len(work)} requests "
        f"({[T for T, _ in work]} prompt tokens, {work[0][1]} new each), tokens equal to the "
        f"unsharded engine's, captured tick bit-identical to the eager one, logits rows "
        f"bit-identical to the unsharded engine's: {vs_plain}; tick p50 captured "
        f"{s.tick_ms(50):.2f} ms (unsharded {plain[0].stats.tick_ms(50):.2f} ms), eager "
        f"{eager[0].stats.tick_ms(50):.2f} ms (unsharded "
        f"{plain_eager[0].stats.tick_ms(50):.2f} ms), {s.tokens_per_sec():.1f} tokens/s")
    _mesh_part(torch, "(b) sharded engine", t0, card)


def _mesh_lm_gan(torch, dev, mesh, card):
    """(c): the built LM GAN round against FedGAN.round without a mesh."""
    from repro_torch.dist.sharding import full_tree, is_sharded, place
    from repro_torch.launch.steps import AGENTS_DATA, build_step
    from repro_torch.models.config import ShapeConfig
    from repro_torch.tree import tree_leaves
    t0 = time.perf_counter()
    cfg = _lm_gan_cfg(2)
    built = build_step(cfg, ShapeConfig("train_card", 256, 8, "train"), mesh, K=5,
                       plan=AGENTS_DATA)
    fed = built.fed
    check(fed.cfg.agent_grid == (1, 1), f"mesh (c): agent grid {fed.cfg.agent_grid}")
    state = fed.init_state(torch.Generator(device=dev).manual_seed(0), device=dev)
    shape = tuple(built.input_sds[1]["tokens"].shape)
    batches = {"tokens": torch.randint(0, cfg.vocab_size, shape, device=dev,
                                       generator=torch.Generator(device=dev).manual_seed(1))}
    counters = launch_counters()
    expect = {n: 2 if n == "fedavg" else 0 for n in counters}   # one per subtree
    _reset(counters)
    t1 = time.perf_counter()
    want, wm = fed.round(state, batches)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t1
    plain_counts = _read(counters)
    check(plain_counts == expect, f"mesh (c) unsharded round: launches {plain_counts}")
    placed = place(state, built.in_shardings[0])
    pb = place(batches, built.in_shardings[1])
    check(all(is_sharded(x) for x in tree_leaves(placed)), "mesh (c): state not DTensors")
    _reset(counters)
    t1 = time.perf_counter()
    got, gm = built.fn(placed, pb)
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t1
    counts = _read(counters)
    check(counts == expect, f"mesh (c) built round: launches {counts}, expected {expect}")
    check(_tree_same_bits(torch, got, want), "mesh (c): the built round's state differs "
                                             "from FedGAN.round's")
    check(_tree_same_bits(torch, gm, wm), "mesh (c): the built round's metrics differ")
    log(f"mesh (c) build_step({LM_GAN_ARCH} 2 of 32 layers at full width, train_card 256 x "
        f"8, K=5, {AGENTS_DATA.name}): new state bit-identical to FedGAN.round without a "
        f"mesh ({len(tree_leaves(got))} leaves), fedavg launches {counts['fedavg']} a round "
        f"and no other kernel; the built round {mesh_s:.2f} s against {plain_s:.2f} s "
        f"unsharded (wall; the unsharded round runs first), lm "
        f"{[round(float(x), 4) for x in full_tree(gm)['lm']]}")
    _mesh_part(torch, "(c) LM GAN round", t0, card)


def _mesh_experiment(torch, dev, card):
    """(d): run_experiment against experiment_spec(...).run()."""
    from repro_torch.launch.train import experiment_spec, run_experiment
    t0 = time.perf_counter()
    kw = dict(K=5, steps=20, seed=0, log_every=0, device=str(dev))
    _, _, hist = run_experiment("toy_2d", **kw)
    spec, _ = experiment_spec("toy_2d", **kw)
    want = spec.run()[2]
    check(len(hist) == 4 and hist == want, f"mesh (d): run_experiment history {hist} "
                                           f"is not experiment_spec's {want}")
    check(all(math.isfinite(v) for m in hist for v in m.values()), "mesh (d): non-finite")
    log(f"mesh (d) run_experiment('toy_2d', K=5, steps=20): {len(hist)} rounds, history "
        f"equal to experiment_spec(...).run()'s; last {hist[-1]}")
    _mesh_part(torch, "(d) run_experiment", t0, card)


def run_mesh(torch, dev, params):
    """Phase 15: the mesh on one card (module docstring)."""
    from repro_torch.launch.mesh import make_serving_mesh
    t_phase = time.perf_counter()
    card = card_line()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_serving_mesh()
    check(tuple(mesh.shape) == (1, 1) and mesh.device_type == "cuda",
          f"mesh: {mesh} is not the one-card serving mesh")
    _mesh_gemma(torch, dev, params, mesh, card)
    _mesh_serve(torch, dev, params, mesh, card)
    _mesh_lm_gan(torch, dev, mesh, card)
    _mesh_experiment(torch, dev, card)
    log(f"phase 15 (the mesh on one card): {time.perf_counter() - t_phase:.1f} s wall; {card}")


def launch_counters():
    """Every kernel wrapper of the port, by kernel name."""
    from repro_torch.kernels import launch_counters as counters
    return counters()


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ssd-parent", metavar="DIR",
                    help="also time the SSD kernel of the checkout DIR beside this one's")
    ap.add_argument("--qpack-parent", metavar="DIR", action="append", default=[],
                    help="also time the dequant, pack4 and unpack4 kernels of the "
                         "checkout DIR beside this one's (may be given more than once)")
    args = ap.parse_args()
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "needs one CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a checkout",
              file=sys.stderr)
        return 1
    sys.path[:0] = [SRC, os.path.join(ROOT, "tests")]
    import repro_torch  # noqa: F401  (turns TF32 off)
    from repro_torch.comm import IntQuant, get_codec
    from repro_torch.core import FedAvgSync
    from repro_torch.kernels import _build
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    per_source = _build.build(["fedavg", "qsync", "qpack", "flash_attention", "ssd_scan"])
    log(f"nvcc build: {time.perf_counter() - t0:.1f} s wall "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in per_source.items()) or 'cached'})")

    shapes = stream_shapes()
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    records = {r["name"]: r for r in (check_fedavg(torch, shapes, dev, flush),
                                      *check_fedavg_routes(torch, shapes, dev, flush),
                                      check_qsync(torch, shapes, dev, flush),
                                      *check_qpack(torch, dev, flush),
                                      check_adam_sync(torch, dev, flush),
                                      check_flash(torch, dev, flush),
                                      check_ssd(torch, dev, flush))}
    del flush
    if args.ssd_parent:
        kernels_against(args.ssd_parent, "ssd")
    for other in args.qpack_parent:
        kernels_against(other, "qpack")
    check_composed_vs_fused(torch, dev)
    check_small_round(torch, dev)
    check_card_rounds(torch, dev)

    L = sum(len(v) for v in shapes.values())   # float32 leaves of gen + disc
    plain_counts, _ = run_main_path(torch, dev, None, "FedAvgSync()", {"fedavg": 2})
    int8_counts, _ = run_main_path(
        torch, dev, FedAvgSync(codec=IntQuant(bits=8), error_feedback=True),
        "FedAvgSync(codec=IntQuant(8), error_feedback=True)", {"qsync": 2})
    chain_counts, _ = run_main_path(
        torch, dev, FedAvgSync(codec=get_codec("topk+int4", fraction=0.25),
                               error_feedback=True),
        "FedAvgSync(codec=TopK(0.25)+IntQuant(4), error_feedback=True)",
        {"fedavg": L, "quant": 2 * L, "pack4": 2 * L, "unpack4": 2 * L,
         "dequant": 2 * L})
    run_main_path(
        torch, dev, FedAvgSync(codec=IntQuant(bits=8), fused_sync=False),
        "FedAvgSync(codec=IntQuant(8), fused_sync=False)",
        {"fedavg": L, "quant": 2 * L, "dequant": 2 * L})
    records["fedavg"]["launches"] = plain_counts["fedavg"]
    records["qsync"]["launches"] = int8_counts["qsync"]
    for name in ("quant", "dequant", "pack4", "unpack4"):
        records[name]["launches"] = chain_counts[name]
    records["fedavg_wire"]["launches"], records["fedavg_pod"]["launches"] = \
        run_strategy_paths(torch, dev)
    run_stream(torch, dev)
    run_captured(torch, dev)
    run_checkpoint(torch, dev)
    run_federated_images(torch, dev)
    run_quickstart(torch, dev)
    for name, rounds in PAPER_ROUNDS.items():
        run_paper(torch, dev, name, rounds)
    run_ksweep(torch, dev)
    records["flash_attention"]["launches"], params = run_gemma(torch, dev)
    run_serve_gemma(torch, dev, params)
    gc_collect(torch)
    run_mesh(torch, dev, params)
    del params
    torch.cuda.empty_cache()
    records["ssd_scan"]["launches"], params = run_mamba(torch, dev)
    run_serve_mamba(torch, dev, params)
    del params
    torch.cuda.empty_cache()
    run_serve_reload(torch, dev)
    run_lm_gan(torch, dev)
    gc_collect(torch)
    run_families(torch, dev)
    gc_collect(torch)
    run_privacy(torch, dev)
    gc_collect(torch)
    run_fleet(torch, dev)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    check("jax" not in sys.modules, "the port or this script imported jax")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s wall in all")
    print(card_line(), flush=True)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records.values()]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
