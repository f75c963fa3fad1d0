"""Serve a generator with continuous batching — a thin CLI over
``repro_torch.serve``, the port's twin of the reference's
``examples/serve_generator.py``.

Submits ``--requests`` generation requests of staggered prompt lengths to
a :class:`repro_torch.serve.ServeEngine` (any of the ten archs of the
port's registry, at its reduced ``.smoke()`` size; an audio arch's
requests carry seeded encoder frames) and drains them: requests are admitted
into free batch slots as earlier ones finish, every slot decodes at its
own position, and sliding-window archs can serve with O(window) ring
caches (``--ring``).  On the card the decode tick is one captured CUDA
graph (``--eager`` runs it op by op).

Run:  PYTHONPATH=src python -m repro_torch.serve_generator --arch gemma3-4b \\
          --requests 6 --batch 4 --prompt-len 32 --gen 16 --ring [--device cpu]

Hot-reload a training run live: point ``--ckpt-dir`` at the directory a
trainer writes with ``--ckpt-dir``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs.registry import get_config
from repro_torch.serve import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=4, help="engine batch slots")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=0,
                    help="decode-cache capacity (default prompt+gen)")
    ap.add_argument("--ring", action="store_true",
                    help="O(window) ring caches on sliding-window layers")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--ckpt-dir", default="",
                    help="hot-reload generator params from this train run")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--eager", action="store_true",
                    help="run the decode tick op by op instead of replaying its graph")
    args = ap.parse_args(argv)

    try:
        cfg = get_config(args.arch).smoke()
    except KeyError as e:
        ap.error(e.args[0])
    max_seq = args.max_seq or args.prompt_len + args.gen
    eng = ServeEngine(cfg, max_batch=args.batch, max_seq=max_seq, ring=args.ring,
                      ckpt_dir=args.ckpt_dir, device=args.device,
                      capture=not args.eager)

    rng = np.random.default_rng(1)
    rids = []
    for i in range(args.requests):
        # staggered lengths exercise bucketing + mid-stream admission
        T = max(4, args.prompt_len - 3 * (i % args.batch))
        prompt = rng.integers(0, cfg.vocab_size, (T,))
        frames = None
        if cfg.family == "audio":
            frames = (0.1 * rng.standard_normal((cfg.encoder_seq, cfg.d_model))
                      ).astype(np.float32)
        rids.append(eng.submit(prompt, max_new_tokens=args.gen,
                               temperature=args.temperature, frames=frames))

    t0 = time.perf_counter()
    done = eng.run()
    wall = time.perf_counter() - t0

    s = eng.stats
    for rid in rids:
        req = done[rid]
        assert len(req.generated) == args.gen
        assert max(req.generated) < cfg.vocab_size
        print(f"req {rid}: prompt {req.prompt_len:3d} -> {req.generated[:8]}"
              f"{' ...' if args.gen > 8 else ''}")
    print(f"arch={cfg.name} (smoke) ring={args.ring} slots={args.batch} "
          f"device={eng.device} captured={eng.captured} "
          f"buckets={sorted(s.prefill_buckets)}")
    print(f"{s.ticks} ticks, {s.decode_tokens} decode tokens in {wall:.1f}s "
          f"wall ({s.tokens_per_sec():.0f} tok/s decode, "
          f"occupancy {s.mean_occupancy(args.batch):.0%})")
    print(f"tick latency p50={s.tick_ms(50):.1f}ms p99={s.tick_ms(99):.1f}ms; "
          f"reloads={s.reloads}"
          + (f" (step {eng.loaded_step})" if eng.loaded_step is not None else ""))
    print("serve OK ✓")


if __name__ == "__main__":
    main()
