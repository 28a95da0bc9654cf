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
* :func:`generator_adv_loss`: one scale's adversarial G term;
* the gen-1 progressive StyleGAN's critic losses: :func:`wgan_d_loss`
  (drift 0.001), :func:`wgan_gradient_penalty` (the norm sqrt(sum g^2 +
  1e-12) of D's input gradient at the epsilon-mix of real and fake, weight
  10), :func:`r1_d_loss` (softplus terms and gamma / 2 mean sum g^2 of D's
  input gradient at the reals, gamma 10) and :func:`wgan_g_loss`.  Both
  penalties compute in at least float32 and take the input gradient with
  ``create_graph=True``, so D's parameters take the gradient through it (a
  double backward through the blur, the pools, the minibatch statistic and
  the fade).

Across ranks (:mod:`parallel.dist`) each mean is over the global batch: the
D and G terms divide by B, the wrong pairs by B - 1, and the wrong pairs
follow the global pairing (each rank's last real image with the next
rank's first sentence; the global last image has none).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from sba_gan_tpu_torch.models.norms import promote
from sba_gan_tpu_torch.parallel import dist


def bce_logits(logits: torch.Tensor, target: float, total: Optional[int] = None
               ) -> torch.Tensor:
    """mean(softplus(l) - target * l) in float32, over every rank's logits
    (``total`` of them, by default as many on each rank)."""
    logits = logits.float()
    return dist.batch_mean(F.softplus(logits) - target * logits, total)


def kl_loss(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """-0.5 * mean(1 + logvar - mu^2 - exp(logvar)) in float32."""
    mu, logvar = mu.float(), logvar.float()
    return -0.5 * dist.batch_mean(1.0 + logvar - mu * mu - torch.exp(logvar))


def discriminator_loss(dnet, real: torch.Tensor, fake: torch.Tensor,
                       sent_emb: torch.Tensor) -> torch.Tensor:
    """(real + cond_real) / 2 + (fake + cond_fake + wrong) / 3, or without an
    unconditional head cond_real + (cond_fake + wrong) / 2.  ``fake`` must
    already be detached."""
    real_f = dnet(real)
    fake_f = dnet(fake)
    cond_real = bce_logits(dnet.cond_logits(real_f, sent_emb), 1.0)
    cond_fake = bce_logits(dnet.cond_logits(fake_f, sent_emb), 0.0)
    wrong_sent = dist.next_rows(sent_emb)  # sentence g + 1 for image g
    cond_wrong = bce_logits(dnet.cond_logits(real_f[: wrong_sent.shape[0]], wrong_sent), 0.0,
                            real.shape[0] * dist.world_size() - 1)
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


def wgan_d_loss(real_scores: torch.Tensor, fake_scores: torch.Tensor,
                drift: float = 0.001) -> torch.Tensor:
    """mean(fake) - mean(real) + drift mean(real^2)."""
    real_scores, fake_scores = promote(real_scores), promote(fake_scores)
    return fake_scores.mean() - real_scores.mean() + drift * (real_scores ** 2).mean()


def wgan_gradient_penalty(d_fn: Callable, real: torch.Tensor, fake: torch.Tensor,
                          eps: torch.Tensor, weight: float = 10.0) -> torch.Tensor:
    """``eps`` (B, 1, 1, 1) uniform in [0, 1): weight mean((|grad D(x)| - 1)^2)
    at x = eps real + (1 - eps) fake, D run once on the whole batch."""
    real, fake = promote(real), promote(fake)
    eps = eps.to(real.dtype)
    x_hat = (eps * real + (1 - eps) * fake).requires_grad_(True)
    (grads,) = torch.autograd.grad(d_fn(x_hat).sum(), x_hat, create_graph=True)
    norms = torch.sqrt((grads * grads).sum(dim=(1, 2, 3)) + 1e-12)
    return weight * ((norms - 1.0) ** 2).mean()


def r1_d_loss(d_fn: Callable, real: torch.Tensor, fake_scores: torch.Tensor,
              gamma: float = 10.0) -> torch.Tensor:
    """mean softplus(-D(real)) + mean softplus(fake) + gamma / 2 mean sum
    grad D(real)^2, D run on the reals inside (one pass gives the scores and
    the input gradient)."""
    x = promote(real)
    if not x.requires_grad:
        x = x.detach().requires_grad_(True)
    real_scores = d_fn(x)
    (grads,) = torch.autograd.grad(real_scores.sum(), x, create_graph=True)
    penalty = 0.5 * gamma * (grads * grads).sum(dim=(1, 2, 3)).mean()
    return (F.softplus(-promote(real_scores)).mean() + F.softplus(promote(fake_scores)).mean()
            + penalty)


def wgan_g_loss(fake_scores: torch.Tensor) -> torch.Tensor:
    return -promote(fake_scores).mean()
