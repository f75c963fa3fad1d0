"""GAN losses (the subset of ``repro.core.losses`` the ported tasks use).

    d_loss(d_logits_real, d_logits_fake) -> scalar   (minimised by D)
    g_loss(d_logits_fake) -> scalar                  (minimised by G)

plus the ACGAN auxiliary terms.  All reductions are float32 means.
"""
from __future__ import annotations

import torch


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0); F.softplus switches to x above 20
    return torch.logaddexp(x.float(), torch.zeros_like(x, dtype=torch.float32))


def ns_d_loss(real_logits, fake_logits):
    return (torch.mean(_softplus(-real_logits))
            + torch.mean(_softplus(fake_logits)))


def ns_g_loss(fake_logits):
    return torch.mean(_softplus(-fake_logits))


def aux_class_loss(cls_logits, labels):
    lp = torch.log_softmax(cls_logits.float(), dim=-1)
    return -torch.mean(torch.gather(lp, -1, labels[:, None].long()))


def acgan_d_loss(real_bin, fake_bin, real_cls, fake_cls, labels):
    """D maximises binary discrimination + classifies BOTH real and fake."""
    return (ns_d_loss(real_bin, fake_bin)
            + aux_class_loss(real_cls, labels)
            + aux_class_loss(fake_cls, labels))


def acgan_g_loss(fake_bin, fake_cls, labels):
    return ns_g_loss(fake_bin) + aux_class_loss(fake_cls, labels)
