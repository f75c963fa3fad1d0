"""GAN loss zoo (a port of ``repro.core.losses``).

    d_loss(d_logits_real, d_logits_fake) -> scalar   (minimised by D)
    g_loss(d_logits_fake) -> scalar                  (minimised by G)

for the non-saturating, least-squares, hinge and Wasserstein objectives,
the WGAN-GP ``gradient_penalty``, the raw zero-sum ``minimax_value`` and
the ACGAN auxiliary terms.  All reductions are float32 means.
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


# -- minimax (the 2D toy analysis uses the raw zero-sum form) ----------------


def minimax_value(real_scores, fake_scores):
    """V(D, G) with a sigmoid-free D (the paper's 2D system uses f(x) =
    D(x) directly); D ascends V, G descends it."""
    return torch.mean(real_scores.float()) - torch.mean(fake_scores.float())


# -- least squares GAN -------------------------------------------------------


def ls_d_loss(real_logits, fake_logits):
    return 0.5 * (torch.mean((real_logits.float() - 1.0) ** 2)
                  + torch.mean(fake_logits.float() ** 2))


def ls_g_loss(fake_logits):
    return 0.5 * torch.mean((fake_logits.float() - 1.0) ** 2)


# -- hinge --------------------------------------------------------------------


def hinge_d_loss(real_logits, fake_logits):
    return (torch.mean(torch.relu(1.0 - real_logits.float()))
            + torch.mean(torch.relu(1.0 + fake_logits.float())))


def hinge_g_loss(fake_logits):
    return -torch.mean(fake_logits.float())


# -- WGAN (+ gradient penalty helper) ----------------------------------------


def w_d_loss(real_logits, fake_logits):
    return torch.mean(fake_logits.float()) - torch.mean(real_logits.float())


def w_g_loss(fake_logits):
    return -torch.mean(fake_logits.float())


def gradient_penalty(d_apply, d_params, real, fake, eps, weight=10.0):
    """WGAN-GP penalty on interpolates (Gulrajani et al.): the mean of
    (|grad_x D(x)| - 1)^2 over x = eps real + (1 - eps) fake, times
    ``weight``.  ``eps`` is the interpolation noise, uniform in [0, 1)
    with shape (n, 1, ..., 1); the reference draws it from its key, the
    port takes it from the caller."""
    inter = eps * real + (1.0 - eps) * fake
    grads = torch.func.grad(lambda x: torch.sum(d_apply(d_params, x)))(inter).float()
    gn = torch.sqrt(torch.sum(grads * grads, dim=tuple(range(1, grads.ndim))) + 1e-12)
    return weight * torch.mean((gn - 1.0) ** 2)


# -- ACGAN auxiliary classification -------------------------------------------


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
