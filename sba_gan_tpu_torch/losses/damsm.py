"""DAMSM text-image matching losses (the JAX package's ``losses/damsm.py``).

* :func:`sent_loss`: cosine scores of the global image codes against the
  sentence codes, times gamma3, same-class pairs off the diagonal masked
  out, cross-entropy in both directions.
* :func:`words_loss`: the word-region similarity sim (B, B) of every (text,
  image) pair through :func:`ops.damsm_sim.damsm_sim` (kernels K1-K3 on the
  card, their plain versions on the CPU), then the same masking and the two
  cross-entropies.  The kernels take any batch size.  Words and regions are
  cast to float32 first, as the JAX package casts them; ``mm_dtype``
  (``JAX.LOSS_DTYPE``) is the dtype the kernels round the operands of their
  products to.
* :func:`damsm_losses`: both losses of this rank's rows over the global
  batch (:mod:`parallel.dist`): every rank gathers every text's words,
  lengths, class ids and sentence codes and every image's code; K1 runs
  on all texts against this rank's images, giving the (B, B/N) columns of
  sim, which are gathered into the global matrix; its gradient gives K2
  this rank's columns (the gradient of this rank's images) and K3 every
  text's words against this rank's images, summed over ranks.  Labels
  and the class mask are the global ones.  One process: the plain losses.
* :func:`own_image_attention`: the Eq. 8-9 attention of each text over its
  own image, (B, T, R), for the attention dump of the pretrain CLI; the
  losses never use it.

Under ``LOSS_DTYPE: bfloat16`` the port follows the JAX package's kernel
formulation (``DAMSM_SIM_IMPL: pallas``, the setting of its accelerator
preset): only the operands of the similarity's matrix products are rounded
to bfloat16, and the cosine's numerator, the norms and every softmax read
float32 values.  The JAX package's dense XLA formulation
(``DAMSM_SIM_IMPL: xla``) rounds elsewhere as well: it takes the numerator
from bfloat16 words and context.  The port has no such path; which
implementation runs is the tensors' device, not a key.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from sba_gan_tpu_torch.ops.damsm_sim import damsm_sim
from sba_gan_tpu_torch.parallel import dist

NEG_INF = -1e9
EPS = 1e-8


def class_mask(class_ids: torch.Tensor) -> torch.Tensor:
    """(B, B) bool: True where two different samples share a class."""
    same = class_ids[:, None] == class_ids[None, :]
    eye = torch.eye(class_ids.shape[0], dtype=torch.bool, device=class_ids.device)
    return same & ~eye


def masked_cross_entropy(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over rows; masked entries already hold NEG_INF."""
    logz = torch.logsumexp(scores, dim=1)
    picked = scores.gather(1, labels[:, None])[:, 0]
    return (logz - picked).mean()


def _mask_classes(scores, class_ids):
    if class_ids is None:
        return scores
    return scores.masked_fill(class_mask(class_ids), NEG_INF)


def sent_loss(cnn_code: torch.Tensor, rnn_code: torch.Tensor, labels: torch.Tensor,
              class_ids: Optional[torch.Tensor], gamma3: float = 10.0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cnn_code, rnn_code (B, D); labels (B,).  Returns (image->text,
    text->image) cross-entropies."""
    cnn_code = cnn_code.float()
    rnn_code = rnn_code.float()
    scores = cnn_code @ rnn_code.T
    cnn_norm = torch.linalg.vector_norm(cnn_code, dim=1, keepdim=True)
    rnn_norm = torch.linalg.vector_norm(rnn_code, dim=1, keepdim=True)
    norms = torch.clamp(cnn_norm @ rnn_norm.T, min=EPS)
    scores = _mask_classes(scores / norms * gamma3, class_ids)
    return masked_cross_entropy(scores, labels), masked_cross_entropy(scores.T, labels)


def words_loss(img_features: torch.Tensor, words_emb: torch.Tensor,
               labels: torch.Tensor, cap_lens: torch.Tensor,
               class_ids: Optional[torch.Tensor], gamma1: float = 4.0,
               gamma2: float = 5.0, gamma3: float = 10.0,
               mm_dtype: torch.dtype = torch.float32
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """img_features (Bj, R, D) regions, words_emb (B, T, D), cap_lens (B,)
    real word counts in [1, T] (any device), labels (B,).  Returns
    (image->text, text->image) cross-entropies.  One process: Bj = B.
    Across ranks: every text's words and this rank's images, whose columns
    of sim are gathered over ranks."""
    sim = dist.gather(damsm_sim(words_emb.float(), img_features.float(), cap_lens,
                                gamma1, gamma2, mm_dtype), dim=1)
    similarities = _mask_classes(sim.T * gamma3, class_ids)  # [image, text]
    return (masked_cross_entropy(similarities, labels),
            masked_cross_entropy(similarities.T, labels))


def damsm_losses(region: torch.Tensor, code: torch.Tensor, words_emb: torch.Tensor,
                 sent_emb: torch.Tensor, cap_lens: torch.Tensor,
                 class_ids: Optional[torch.Tensor], gamma1: float, gamma2: float,
                 gamma3: float, mm_dtype: torch.dtype = torch.float32
                 ) -> Tuple[torch.Tensor, ...]:
    """(w0, w1, s0, s1) over the global batch from this rank's rows: the
    image encoder's region (b, R, D) and code (b, D), the text encoder's
    words_emb (b, T, D) and sent_emb (b, D), cap_lens (b,) and class_ids
    (b,) or None."""
    words = dist.share(dist.gather(words_emb.float()))
    lens = dist.gather(cap_lens)
    ids = None if class_ids is None else dist.gather(class_ids)
    labels = torch.arange(words.shape[0], device=region.device)
    w0, w1 = words_loss(region, words, labels, lens, ids, gamma1, gamma2, gamma3, mm_dtype)
    s0, s1 = sent_loss(dist.gather(code.float()), dist.gather(sent_emb.float()), labels,
                       ids, gamma3)
    return w0, w1, s0, s1


def own_image_attention(img_features: torch.Tensor, words_emb: torch.Tensor,
                        cap_lens: torch.Tensor, gamma1: float = 4.0) -> torch.Tensor:
    """(B, T, R): softmax over regions of gamma1 times the softmax over real
    words of the scores of text i against its own image i (rows of padding
    words come out uniform, as in the JAX package's dense grid)."""
    words = words_emb.float()
    scores = torch.einsum("itd,ird->itr", words, img_features.float())
    t = words.shape[1]
    lens = cap_lens.to(device=words.device, dtype=torch.long)
    valid = torch.arange(t, device=words.device)[None, :] < lens[:, None]
    scores = scores.masked_fill(~valid[:, :, None], NEG_INF)
    return torch.softmax(gamma1 * torch.softmax(scores, dim=1), dim=2)
