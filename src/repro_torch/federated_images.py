"""End-to-end federated image GAN (the paper's §4.2 shape on synthetic
data), the port's twin of the reference's ``examples/federated_images.py``.

B = 5 agents each hold two of ten image classes (the paper's MNIST/CIFAR
split); an ACGAN pair at 16x16 trains with K = 20 local steps per sync
(``FedAvgSync``).  The run scores the intermediary's generator with the
Fréchet-distance stand-in, trains the distributed-GAN baseline
(``PerStepGradAvg``: gradients averaged every step, K = 1) on the same
data for the same number of steps, and saves and restores a checkpoint,
whose restored state must score the same.

Run:  PYTHONPATH=src python -m repro_torch.federated_images [--steps 400] [--device cpu]
"""
from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.core import FedAvgSync, FedGAN, FedGANConfig, PerStepGradAvg
from repro_torch.data import DeviceFederatedData, synthetic
from repro_torch.evals import fd_score
from repro_torch.launch.train import acgan_task
from repro_torch.optim import Adam, constant, equal_timescale
from repro_torch.run import RoundDriver
from repro_torch.tree import tree_leaves

HW, NCLS, B = 16, 10, 5


def agent_data(dev, seed=0, n=512):
    """Agent i holds classes 2i and 2i + 1, ``n`` images each agent."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for i in range(B):
        lab = torch.randint(2 * i, 2 * i + 2, (n,), generator=gen, device=dev)
        out.append({"x": synthetic.sample_class_images(gen, n, lab, hw=HW, num_classes=NCLS),
                    "y": lab})
    return out


def train(K, steps, strategy, dev, seed=0, batch=32):
    """``steps // K`` rounds of the ACGAN pair under ``strategy``."""
    task, (G, _) = acgan_task(hw=HW, num_classes=NCLS)
    fed = FedGAN(task, FedGANConfig(agent_grid=(1, B), sync_interval=K, strategy=strategy),
                 opt_g=Adam(b1=0.5), opt_d=Adam(b1=0.5),
                 scales=equal_timescale(constant(1e-3)))
    data = DeviceFederatedData.from_agent_data(
        agent_data(dev, seed), (1, B), batch, device=dev,
        sample_extra=lambda g, s: {"z": torch.randn(s + (62,), generator=g, device=g.device)})
    result = RoundDriver(fed, data, max(steps // K, 1), log_every=0, verbose=False).run(seed)
    return fed, result.state, G


def evaluate(fed, state, G, n_eval=512):
    """FD of the intermediary's generator against fresh real images of the
    same labels, from fixed seeds."""
    dev = state["step"].device
    gp = fed.averaged_params(state)["gen"]
    gen = torch.Generator(device=dev).manual_seed(99)
    lab = torch.randint(0, NCLS, (n_eval,), generator=gen, device=dev)
    fake = G.apply(gp, torch.randn((n_eval, 62), generator=gen, device=dev), lab)
    real = synthetic.sample_class_images(gen, n_eval, lab, hw=HW, num_classes=NCLS)
    return fd_score(torch.Generator(device=dev).manual_seed(7), real, fake)


def run(*, K=20, steps=400, device="cuda", verbose=True) -> dict:
    """FedGAN at ``K`` against the distributed baseline, then a checkpoint
    round trip.  Returns both FDs, the restored FD and whether the
    restored state equals the saved one bit for bit."""
    dev = resolve_device(device)
    say = print if verbose else (lambda *a, **k: None)
    say(f"FedGAN ACGAN on {dev}, B={B} agents x 2 classes, K={K}")
    fed, state, G = train(K, steps, FedAvgSync(), dev)
    fd = evaluate(fed, state, G)
    say(f"  FedGAN      (K={K}): FD = {fd:.2f}")
    fed_b, state_b, G_b = train(1, steps, PerStepGradAvg(), dev)
    fd_b = evaluate(fed_b, state_b, G_b)
    say(f"  distributed (K=1):  FD = {fd_b:.2f}  "
        f"(paper claim: FedGAN stays close at 1/{K} the communication)")
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, state, step=steps, metadata={"K": K, "fd": fd})
        restored, _ = restore_checkpoint(d, device=dev)
    same = all(torch.equal(a, b) and a.dtype == b.dtype
               for a, b in zip(tree_leaves(state), tree_leaves(restored)))
    fd_r = evaluate(fed, restored, G)
    say(f"  checkpoint roundtrip: FD = {fd_r:.2f} (must match)")
    return {"fd": fd, "fd_distributed": fd_b, "fd_restored": fd_r, "restored_equal": same}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.federated_images")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--K", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda (the default) needs a GPU")
    args = ap.parse_args(argv)
    out = run(K=args.K, steps=args.steps, device=args.device)
    if not (out["restored_equal"] and abs(out["fd_restored"] - out["fd"]) < 1e-6):
        raise SystemExit("the restored checkpoint does not reproduce the saved state")
    return out


if __name__ == "__main__":
    main()
