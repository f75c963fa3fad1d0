"""Adversarial pair for backbone LMs (a port of
``repro.models.adversarial``): the operand of FedGAN's local step when the
generator is an assigned backbone.

Each agent holds (G = the backbone, D = a compact bidirectional
transformer encoder).  The discriminator scores *feature sequences* in the
generator's embedding space (real: the embedding of the real tokens; fake:
G's final hidden states), which keeps the (B, T, vocab) softmax out of the
feature path.  G's loss is the LM cross-entropy (the auxiliary task) plus
the non-saturating adversarial term plus the MoE router's aux loss.

This module defines the models and losses; the federated schedule lives in
``repro_torch.core.fedgan`` and the fused gradients in
``repro_torch.launch.steps``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import nn
from repro_torch.dist.sharding import batch_spec, shard
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import make_norm
from repro_torch.models.transformer import Backbone, DecoderBlock, _layers, stack_init


@dataclasses.dataclass(frozen=True)
class FeatureDiscriminator(nn.Module):
    """Bidirectional transformer encoder over (B, T, d_model) features ->
    a per-sequence real/fake logit."""

    cfg: ArchConfig

    def _dcfg(self) -> ArchConfig:
        c = self.cfg
        return c.scaled(
            d_model=c.disc_d_model, num_heads=c.disc_heads,
            num_kv_heads=c.disc_heads, head_dim=c.disc_d_model // c.disc_heads,
            d_ff=4 * c.disc_d_model, num_experts=0, sliding_window=0,
            local_global_ratio=0, qk_norm=False)

    def _block(self):
        return DecoderBlock(self._dcfg(), causal=False)

    def init(self, gen):
        c, dc = self.cfg, self._dcfg()
        return {
            "proj_in": nn.Dense(c.d_model, dc.d_model, use_bias=False,
                                dtype=c.param_dtype).init(gen),
            "blocks": stack_init(self._block(), gen, c.disc_layers),
            "norm": make_norm(dc, dc.d_model).init(gen),
            "head": nn.Dense(dc.d_model, 1, dtype=c.param_dtype).init(gen),
        }

    def apply(self, params, feats):
        """feats: (B, T, d_model) -> (B,) real/fake logits."""
        c, dc = self.cfg, self._dcfg()
        h = feats.to(c.dtype) @ params["proj_in"]["w"].to(c.dtype)
        h = shard(h, *batch_spec(None, None))
        block = self._block()
        for bp in _layers(params["blocks"], c.disc_layers):
            h, _ = block.apply(bp, h, window=None)
        h = make_norm(dc, dc.d_model).apply(params["norm"], h)
        pooled = torch.mean(h.float(), dim=1)
        logit = pooled @ params["head"]["w"].float() + params["head"]["b"].float()
        return logit[..., 0]


@dataclasses.dataclass(frozen=True)
class AdversarialLM(nn.Module):
    """The (G, D) pair.  params = {"gen": ..., "disc": ...}.  The
    reference's ``use_flash`` (off by default, and its flash kernel has no
    backward) is not carried over: the generator trains on the plain
    attention, as the reference's LM GAN does."""

    cfg: ArchConfig
    adv_weight: float = 0.1

    @property
    def generator(self) -> Backbone:
        return Backbone(self.cfg)

    @property
    def discriminator(self) -> FeatureDiscriminator:
        return FeatureDiscriminator(self.cfg)

    def init(self, gen):
        return {"gen": self.generator.init(gen), "disc": self.discriminator.init(gen)}

    # ---- feature extraction ----
    def real_features(self, gen_params, tokens):
        emb = nn.Embedding(self.cfg.padded_vocab, self.cfg.d_model).apply(
            gen_params["embed"], tokens)
        return emb.to(self.cfg.dtype)

    def fake_features(self, gen_params, tokens, encoder_frames=None):
        out = self.generator.apply(gen_params, tokens, encoder_frames=encoder_frames)
        return out["hidden"], out["logits"], out["aux"]

    # ---- losses ----
    def lm_loss(self, logits, tokens):
        """Next-token cross entropy (teacher forcing), float32 log-softmax
        over the padded vocab as the reference takes it."""
        tgt = tokens[:, 1:].long()
        lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        return torch.mean(-torch.gather(lp, -1, tgt[..., None])[..., 0])

    def disc_loss(self, disc_params, real_feats, fake_feats):
        """Non-saturating GAN loss for D (the features are detached)."""
        d = self.discriminator
        lr_ = d.apply(disc_params, real_feats.detach())
        lf_ = d.apply(disc_params, fake_feats.detach())
        return torch.mean(F.softplus(-lr_)) + torch.mean(F.softplus(lf_))

    def gen_loss(self, gen_params, disc_params, tokens, encoder_frames=None):
        """LM cross-entropy + adversarial (fool D) + MoE router aux."""
        fake, logits, aux = self.fake_features(gen_params, tokens, encoder_frames)
        lm = self.lm_loss(logits, tokens)
        adv = torch.mean(F.softplus(-self.discriminator.apply(disc_params, fake)))
        total = lm + self.adv_weight * adv + self.cfg.router_aux_weight * aux
        return total, {"lm": lm, "adv": adv, "aux": aux, "fake_feats": fake}
