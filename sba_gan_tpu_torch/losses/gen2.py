"""Gen-2 losses (the JAX package's ``losses/gen2.py``).

* :func:`gen2_sent_loss`: the symmetric cross-entropy over the (B, B)
  cosine-similarity matrix of image codes and sentences, times GAMMA3 (the
  JAX package's reading of the reference, whose norms-product scores are
  constant);
* the BCE D and G losses on logits (:func:`losses.gan.bce_logits`), with
  the wrong pairs and the (real + cond) / 2 + (fake + cond + wrong) / 3
  weighting; the G loss adds LAMBDA times the sentence loss;
* the WGAN critic loss (fake + cond + wrong) / 3 - (real + cond) / 2 + GP,
  and the G loss -(uncond + cond) / 2;
* :func:`gen2_feature_gradient_penalty`: the penalty on the gradient of the
  *sum of D's feature map* at the epsilon-mix of real and fake images,
  taken with ``create_graph=True`` so that the critic's gradient goes
  through it (a double backward); norms sqrt(sum g^2 + 1e-12) over
  (C, H, W).

Every loss computes in at least float32.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from sba_gan_tpu_torch.losses.gan import bce_logits
from sba_gan_tpu_torch.models.norms import promote


def gen2_sent_loss(sent_emb: torch.Tensor, img_code: torch.Tensor, gamma3: float = 10.0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    s, v = promote(sent_emb), promote(img_code)
    s = s / s.norm(dim=-1, keepdim=True).clamp_min(1e-8)
    v = v / v.norm(dim=-1, keepdim=True).clamp_min(1e-8)
    scores0 = gamma3 * (v @ s.T)  # rows: images, columns: sentences
    loss0 = -F.log_softmax(scores0, dim=-1).diagonal().mean()
    loss1 = -F.log_softmax(scores0.T, dim=-1).diagonal().mean()
    return loss0, loss1


def gen2_d_loss_bce(real_uncond, fake_uncond, cond_real, cond_fake, cond_wrong):
    return ((bce_logits(real_uncond, 1.0) + bce_logits(cond_real, 1.0)) / 2.0
            + (bce_logits(fake_uncond, 0.0) + bce_logits(cond_fake, 0.0)
               + bce_logits(cond_wrong, 0.0)) / 3.0)


def gen2_g_loss_bce(fake_uncond, cond_fake, sent_emb, img_code, lam: float,
                    gamma3: float = 10.0) -> torch.Tensor:
    err = bce_logits(fake_uncond, 1.0) + bce_logits(cond_fake, 1.0)
    s0, s1 = gen2_sent_loss(sent_emb, img_code, gamma3)
    return err + lam * (s0 + s1)


def gen2_feature_gradient_penalty(feat_fn: Callable, real: torch.Tensor, fake: torch.Tensor,
                                  eps: torch.Tensor, weight: float = 10.0) -> torch.Tensor:
    """``eps`` (B, 1, 1, 1) uniform in [0, 1): x = eps real + (1 - eps) fake."""
    real, fake = promote(real), promote(fake)
    x_hat = (eps.to(real.dtype) * real + (1 - eps.to(real.dtype)) * fake).requires_grad_(True)
    (grads,) = torch.autograd.grad(promote(feat_fn(x_hat)).sum(), x_hat, create_graph=True)
    norms = torch.sqrt((grads * grads).sum(dim=(1, 2, 3)) + 1e-12)
    return weight * ((norms - 1.0) ** 2).mean()


def gen2_d_loss_wgan(real_uncond, fake_uncond, cond_real, cond_fake, cond_wrong,
                     penalty) -> torch.Tensor:
    fake_term = (promote(fake_uncond).mean() + promote(cond_fake).mean()
                 + promote(cond_wrong).mean()) / 3.0
    real_term = (promote(real_uncond).mean() + promote(cond_real).mean()) / 2.0
    return fake_term - real_term + penalty


def gen2_g_loss_wgan(fake_uncond, cond_fake) -> torch.Tensor:
    return -(promote(fake_uncond).mean() + promote(cond_fake).mean()) / 2.0
