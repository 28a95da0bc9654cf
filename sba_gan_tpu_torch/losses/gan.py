"""Adversarial and KL losses (the JAX package's ``losses/gan.py`` and the D
and G terms of its ``train/gan.py`` step).

* :func:`bce_logits`: mean BCE of logits against a constant target, in the
  softplus form softplus(l) - t l, float32;
* :func:`kl_loss`: KL of the CA posterior against N(0, I);
* :func:`discriminator_loss`: one scale's D loss, with its passes in the
  JAX step's order (so the BatchNorm running statistics move in the same
  order): backbone on the reals, on the fakes, the conditional head on
  reals, fakes and the wrong pairs (real features ``[:B-1]`` against
  ``sent[1:]``), then the unconditional head on reals and fakes;
* :func:`generator_adv_loss`: one scale's adversarial G term.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bce_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """mean(softplus(l) - target * l) in float32."""
    logits = logits.float()
    return (F.softplus(logits) - target * logits).mean()


def kl_loss(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """-0.5 * mean(1 + logvar - mu^2 - exp(logvar)) in float32."""
    mu, logvar = mu.float(), logvar.float()
    return -0.5 * torch.mean(1.0 + logvar - mu * mu - torch.exp(logvar))


def discriminator_loss(dnet, real: torch.Tensor, fake: torch.Tensor,
                       sent_emb: torch.Tensor) -> torch.Tensor:
    """(real + cond_real) / 2 + (fake + cond_fake + wrong) / 3, or without an
    unconditional head cond_real + (cond_fake + wrong) / 2.  ``fake`` must
    already be detached."""
    b = real.shape[0]
    real_f = dnet(real)
    fake_f = dnet(fake)
    cond_real = bce_logits(dnet.cond_logits(real_f, sent_emb), 1.0)
    cond_fake = bce_logits(dnet.cond_logits(fake_f, sent_emb), 0.0)
    cond_wrong = bce_logits(dnet.cond_logits(real_f[: b - 1], sent_emb[1:]), 0.0)
    if dnet.UNCOND_DNET is None:
        return cond_real + (cond_fake + cond_wrong) / 2.0
    real_u = bce_logits(dnet.uncond_logits(real_f), 1.0)
    fake_u = bce_logits(dnet.uncond_logits(fake_f), 0.0)
    return (real_u + cond_real) / 2.0 + (fake_u + cond_fake + cond_wrong) / 3.0


def generator_adv_loss(dnet, fake: torch.Tensor, sent_emb: torch.Tensor) -> torch.Tensor:
    """bce(cond(D(fake)), 1) + bce(uncond(D(fake)), 1)."""
    features = dnet(fake)
    loss = bce_logits(dnet.cond_logits(features, sent_emb), 1.0)
    if dnet.UNCOND_DNET is not None:
        loss = loss + bce_logits(dnet.uncond_logits(features), 1.0)
    return loss
