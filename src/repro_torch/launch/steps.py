"""The LM adversarial task (a port of ``make_lm_gan_task`` in
``repro.launch.steps``): FedGAN's Algorithm 1 with an assigned backbone as
the generator and ``FeatureDiscriminator`` as the discriminator.

Its fused gradients run the generator forward once, through
``torch.func.vjp``: the discriminator's gradients come from the detached
real and fake features, then the generator's objective is differentiated
in the forward's outputs (hidden states and logits) and pulled back
through the forward, with the cotangent ``router_aux_weight`` on the MoE
router's aux loss (a float32 0 in the other families, which still takes
its cotangent).  An audio-family batch carries the encoder's ``frames``
beside its ``tokens``.  The reference's mesh plans and sharded round builders are
ROADMAP queue 1, slice 8.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.func import grad_and_value, vjp

from repro_torch.core.fedgan import GANTask
from repro_torch.models.adversarial import AdversarialLM
from repro_torch.models.config import ArchConfig


def make_lm_gan_task(cfg: ArchConfig, *, adv_weight: float = 0.1) -> GANTask:
    model = AdversarialLM(cfg, adv_weight=adv_weight)
    disc_model = model.discriminator

    def fused(params, batch):
        tokens, frames = batch["tokens"], batch.get("frames")
        gen, disc = params["gen"], params["disc"]

        def gfwd(gp):
            out = model.generator.apply(gp, tokens, encoder_frames=frames)
            return out["hidden"], out["logits"], out["aux"]

        (h, logits, aux), g_vjp = vjp(gfwd, gen)
        real = model.real_features(gen, tokens).detach()
        h_sg = h.detach()

        def dloss(dp):
            lr_ = disc_model.apply(dp, real)
            lf_ = disc_model.apply(dp, h_sg)
            return torch.mean(F.softplus(-lr_)) + torch.mean(F.softplus(lf_))

        gd, ld = grad_and_value(dloss)(disc)

        def gobj(h_, logits_):
            adv = torch.mean(F.softplus(-disc_model.apply(disc, h_)))
            lm = model.lm_loss(logits_, tokens)
            return lm + model.adv_weight * adv, (lm, adv)

        (dh, dlogits), (lg, (lm, adv)) = grad_and_value(
            gobj, argnums=(0, 1), has_aux=True)(h, logits)
        aux_weight = torch.full_like(aux, cfg.router_aux_weight)
        # one pull-back: the forward's saved tensors are freed as it goes
        (gg,) = g_vjp((dh, dlogits, aux_weight), retain_graph=False)
        return gd, gg, {"d_loss": ld, "g_loss": lg, "lm": lm, "adv": adv, "aux": aux}

    def disc_loss(params, batch):
        fake, _, _ = model.fake_features(params["gen"], batch["tokens"], batch.get("frames"))
        real = model.real_features(params["gen"], batch["tokens"])
        return model.disc_loss(params["disc"], real, fake)

    def gen_loss(params, batch):
        total, _ = model.gen_loss(params["gen"], params["disc"], batch["tokens"],
                                  batch.get("frames"))
        return total

    return GANTask(init=model.init, disc_loss=disc_loss, gen_loss=gen_loss,
                   fused_grads=fused)
