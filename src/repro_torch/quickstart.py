"""Quickstart: FedGAN on the paper's 2D system (Appendix C, Fig 5), the
port's twin of the reference's ``examples/quickstart.py``.

Five agents each see one slice of U[-1,1]; the local D(x) = psi x^2 and
G(z) = theta z train for K steps between parameter syncs.  The run prints
the intermediary's (theta, psi) trajectory converging to the paper's fixed
point (1, 0), robust to the sync interval K, and fails unless it ends
within 0.1 of it.  Every agent's shard lives on the device and the K
minibatches are drawn there (``DeviceFederatedData``); each round's sync
is one fedavg kernel launch per subtree on the card.

Run:  PYTHONPATH=src python -m repro_torch.quickstart [--K 20] [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core import FedAvgSync, FedGAN, FedGANConfig, make_gan_task
from repro_torch.data import DeviceFederatedData, synthetic
from repro_torch.models.gan_nets import Toy2DDiscriminator, Toy2DGenerator
from repro_torch.optim import SGD, equal_timescale, power_decay
from repro_torch.run import RoundDriver


def run(*, K: int = 20, steps: int = 3000, agents: int = 5, seed: int = 0,
        device="cuda", verbose: bool = True) -> dict:
    """Train the 2D system for ``steps`` local steps (``steps // K``
    rounds).  Returns the final ``theta`` and ``psi`` of the intermediary,
    the ``trajectory`` of (step, theta, psi) it printed (ten points, each
    one ``averaged_params``, the last at the end), the number of rounds and
    the driver's ``timings``."""
    dev = resolve_device(device)
    B = agents
    G, D = Toy2DGenerator(theta0=0.5), Toy2DDiscriminator(psi0=0.5)
    # FedAvgSync() is the paper's intermediary; the SGD rates decay as
    # a(n) = 0.1 / (1 + n/200)^0.6, which meets (A2)
    fed = FedGAN(make_gan_task(G, D),
                 FedGANConfig(agent_grid=(1, B), sync_interval=K, strategy=FedAvgSync()),
                 opt_g=SGD(), opt_d=SGD(),
                 scales=equal_timescale(power_decay(0.1, tau=200, p=0.6)))
    gen = torch.Generator(device=dev).manual_seed(seed)
    data = DeviceFederatedData.from_agent_data(
        [{"x": synthetic.sample_2d_segment(gen, 4096, i, B)} for i in range(B)],
        (1, B), batch_size=64, device=dev,
        sample_extra=lambda g, s: {"z": 2 * torch.rand(s, generator=g, device=g.device) - 1})
    n_rounds = max(steps // K, 1)
    trajectory = []

    def record(fed, state, r):
        avg = fed.averaged_params(state)
        theta, psi = float(avg["gen"]["theta"]), float(avg["disc"]["psi"])
        trajectory.append(((r + 1) * K, theta, psi))
        if verbose:
            print(f"  step {(r + 1) * K:5d}: theta={theta:+.4f} psi={psi:+.4f}", flush=True)
        return {"theta": theta, "psi": psi}

    if verbose:
        print(f"FedGAN 2D system on {dev}: B={B} agents, K={K} ({n_rounds} rounds)")
    result = RoundDriver(fed, data, n_rounds, log_every=0,
                         eval_every=max(n_rounds // 10, 1), eval_hooks=(record,),
                         verbose=False).run(seed + 1)
    _, theta, psi = trajectory[-1]
    return {"theta": theta, "psi": psi, "trajectory": trajectory,
            "rounds": n_rounds, "timings": result.timings}


def converged(out: dict) -> bool:
    """Within 0.1 of the paper's fixed point (theta, psi) = (1, 0)."""
    return abs(out["theta"] - 1.0) < 0.1 and abs(out["psi"]) < 0.1


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.quickstart")
    ap.add_argument("--K", type=int, default=20)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--agents", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda (the default) needs a GPU")
    args = ap.parse_args(argv)
    out = run(K=args.K, steps=args.steps, agents=args.agents, seed=args.seed,
              device=args.device)
    print(f"final: (theta, psi) = ({out['theta']:+.4f}, {out['psi']:+.4f})  "
          f"[paper fixed point: (1, 0)]; {out['timings']['steps_per_s']:.1f} steps/s")
    if not converged(out):
        raise SystemExit("did not converge to (1, 0)")
    print("converged")
    return out


if __name__ == "__main__":
    main()
