"""End-to-end federated adversarial training of an assigned backbone, the
port's twin of the reference's ``examples/federated_backbone.py``.

Four agents with non-iid token streams train (G = the reduced assigned
arch, D = the feature discriminator) under FedGAN; the script reports the
§3.2 communication accounting, per-round losses and whether the agents are
synced after the final round.  The token streams and each round's
minibatches are the reference's bit for bit (``sample_agent_tokens`` and
``FederatedRounds`` over the numpy Threefry); the initial weights, and an
audio arch's encoder frames (``sample_audio_frames``), are the port's own
draws.

Run:  PYTHONPATH=src python -m repro_torch.federated_backbone \\
          --arch mamba2-2.7b --steps 60 --K 5 [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import prng, resolve_device
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.core import FedGAN, FedGANConfig, get_strategy, strategies
from repro_torch.data import FederatedRounds, synthetic
from repro_torch.launch.steps import make_lm_gan_task
from repro_torch.optim import Adam, constant, equal_timescale
from repro_torch.tree import tree_leaves, tree_map


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.federated_backbone")
    ap.add_argument("--arch", default="mamba2-2.7b", choices=list_archs())
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--K", type=int, default=5)
    ap.add_argument("--agents", type=int, default=4)
    ap.add_argument("--strategy", default="fedgan", choices=sorted(strategies.STRATEGIES))
    ap.add_argument("--intra-interval", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda (the default) needs a GPU")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch).smoke()
    B, K, T = args.agents, args.K, 32
    strat_kw = ({"intra_interval": args.intra_interval}
                if args.strategy == "hierarchical" else {})
    strategy = get_strategy(args.strategy, **strat_kw)
    fed = FedGAN(make_lm_gan_task(cfg),
                 FedGANConfig(agent_grid=(1, B), sync_interval=K, strategy=strategy),
                 opt_g=Adam(), opt_d=Adam(), scales=equal_timescale(constant(1e-3)))
    state = fed.init_state(torch.Generator().manual_seed(0), device=dev)

    rng = prng.key(1)
    agent_data = []
    for i in range(B):
        d = {"tokens": synthetic.sample_agent_tokens(
            rng, 512, T, cfg.vocab_size, agent=i, num_agents=B)}
        if cfg.family == "audio":
            d["frames"] = synthetic.sample_audio_frames(1, 512, cfg.encoder_seq, cfg.d_model,
                                                        agent=i)
        agent_data.append(d)
    rounds = FederatedRounds(agent_data, (1, B), batch_size=8, sync_interval=K)

    acct = fed.comm_bytes_per_round(state)
    print(f"arch={cfg.name} (smoke) B={B} K={K} strategy={strategy.name} device={dev}")
    print(f"§3.2 accounting: M={acct['param_bytes_M']/1e6:.1f}MB/agent, "
          f"fedgan {acct['per_agent_per_round']['fedgan']/1e6:.1f}MB/round vs "
          f"distributed {acct['per_agent_per_round']['distributed']/1e6:.1f}MB/round "
          f"(x{acct['ratio']} saving); this strategy moves "
          f"{acct['strategy_bytes_per_round']/1e6:.1f}MB/round")

    for r in range(args.steps // K):
        rng, rb = prng.split(rng)
        batches, _seeds = rounds.round_batches(rb)
        state, m = fed.round(state, tree_map(lambda x: x.to(dev), batches))
        print(f"  round {r:3d} step {(r + 1) * K:4d}: "
              f"d_loss={float(torch.mean(m['d_loss'])):.4f} "
              f"g_loss={float(torch.mean(m['g_loss'])):.4f} "
              f"lm={float(torch.mean(m['lm'])):.4f}")

    leaf = tree_leaves(state["params"]["gen"])[0]
    synced = bool(torch.allclose(leaf[0, 0], leaf[0, -1], atol=1e-5))
    # subsampled/adaptive_k legitimately leave agents apart after a round
    # (non-participants keep local state; skip rounds don't sync at all)
    always_syncs = args.strategy not in ("local_only", "subsampled", "adaptive_k")
    print(f"agents synced after final round: {synced} (expected {always_syncs})")
    return state, synced


if __name__ == "__main__":
    main()
