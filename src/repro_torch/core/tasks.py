"""Declarative GANTask builder: (G, D, LossSpec) -> GANTask.

A port of ``repro.core.tasks``.  Batch protocol: ``x`` real data, ``z``
latent noise, ``y`` labels (conditional specs only).  Each loss detaches the
other player (simultaneous updates, eq. (1)).  The losses take no random
state: the noise arrives in the batch.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import losses
from repro_torch.core.fedgan import GANTask


@dataclasses.dataclass(frozen=True)
class LossSpec:
    kind: str = "ns"         # "ns" (non-saturating GAN) | "acgan"
    cond_gen: bool = False   # G.apply(params, z, y) instead of (params, z)
    cond_disc: bool = False  # D.apply(params, x, y) instead of (params, x)


NS = LossSpec()
CONDITIONAL = LossSpec(cond_gen=True, cond_disc=True)
ACGAN = LossSpec(kind="acgan", cond_gen=True)


def make_gan_task(G, D, spec: LossSpec = NS) -> GANTask:
    """Build the GANTask for a (G, D) pair under ``spec``."""
    if spec.kind not in ("ns", "acgan"):
        raise ValueError(f"unknown loss kind {spec.kind!r}")

    def init(gen: torch.Generator):
        return {"gen": G.init(gen), "disc": D.init(gen)}

    def fake_of(params, batch):
        args = (batch["z"], batch["y"]) if spec.cond_gen else (batch["z"],)
        return G.apply(params["gen"], *args)

    def d_of(params, x, batch):
        args = (x, batch["y"]) if spec.cond_disc else (x,)
        return D.apply(params["disc"], *args)

    if spec.kind == "ns":
        def disc_loss(params, batch):
            fake = fake_of(params, batch).detach()
            return losses.ns_d_loss(d_of(params, batch["x"], batch),
                                    d_of(params, fake, batch))

        def gen_loss(params, batch):
            return losses.ns_g_loss(d_of(params, fake_of(params, batch), batch))
    else:  # acgan: D returns (real/fake logit, class logits)
        def disc_loss(params, batch):
            fake = fake_of(params, batch).detach()
            rb, rc = D.apply(params["disc"], batch["x"])
            fb, fc = D.apply(params["disc"], fake)
            return losses.acgan_d_loss(rb, fb, rc, fc, batch["y"])

        def gen_loss(params, batch):
            fb, fc = D.apply(params["disc"], fake_of(params, batch))
            return losses.acgan_g_loss(fb, fc, batch["y"])

    return GANTask(init=init, disc_loss=disc_loss, gen_loss=gen_loss)
