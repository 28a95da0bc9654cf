"""DAMSM pretraining: the text encoder and the image projections trained
jointly on the words and sentence losses (the JAX package's
``train/damsm.py``).

* total = w_loss0 + w_loss1 + s_loss0 + s_loss1 (both directions of both
  losses), log keys ``w_loss0 w_loss1 s_loss0 s_loss1 total``;
* the Inception trunk is frozen (``requires_grad=False``) but runs in train
  mode, so its BatchNorm running statistics still move; only
  ``emb_features`` and ``emb_cnn_code`` train on the image side
  (Mixed_7a/b/c too under ``MODEL.TEXT_ENCODER: bert``);
* Adam with betas (0.5, 0.999) and eps 1e-8 on both sides; the text side's
  gradients are clipped to global norm 0.25 first, with optax's formula
  (``g * 0.25 / norm`` when ``norm >= 0.25``).  Every text parameter
  trains, BERT's too, as in the JAX trainer (the reference freezes BERT's
  embeddings and encoder layers: ``models.text_bert.bert_trainable_mask``,
  which neither trainer applies);
* the RNN encoder's embedding dropout draws its mask from the trainer's
  generator; BERT has no dropout and gets neither;
* each epoch re-creates both optimizers (moments reset) with the learning
  rate of :func:`epoch_lr` (x0.98 per epoch while above a tenth of the
  base), as the reference does;
* ``JAX.DAMSM_CHUNKS`` above 1 (the JAX trainer's sequential sub-batches
  of the train-mode Inception) raises: not ported.

The similarity of the words loss goes through kernels K1-K3 on the card,
with ``JAX.LOSS_DTYPE`` as their ``mm_dtype``; the encoders compute in
``JAX.DTYPE`` with float32 parameters.

Across ranks (:mod:`parallel.dist`) each rank takes its rows of the global
batch; the losses are the global batch's (:func:`losses.damsm.damsm_losses`:
K1, K2 and K3 on this rank's images), the Inception's train-mode
BatchNorms take the global statistics, the dropout mask is drawn for the
global batch and sliced, and both sides' gradients are summed over ranks
before the clip, which so sees the global gradient, as optax's does.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from sba_gan_tpu_torch.config import compute_dtype, loss_dtype
from sba_gan_tpu_torch.losses.damsm import damsm_losses
from sba_gan_tpu_torch.models.inception import CNNEncoder, HEADS
from sba_gan_tpu_torch.models.inception import init_weights as init_image_weights
from sba_gan_tpu_torch.models.text_rnn import RNNEncoder
from sba_gan_tpu_torch.parallel import dist
from sba_gan_tpu_torch.train.sample import build_text_encoder, init_text_weights
from sba_gan_tpu_torch.utils.platform import resolve_device

LOG_KEYS = ("w_loss0", "w_loss1", "s_loss0", "s_loss1", "total")
MIXED7 = ("Mixed_7a", "Mixed_7b", "Mixed_7c")


class DAMSMModels(NamedTuple):
    text_encoder: nn.Module
    image_encoder: CNNEncoder


def build_damsm_models(cfg, n_words: int, seed: Optional[int] = None) -> DAMSMModels:
    """The text encoder and the Inception CNNEncoder of ``cfg``, on the CPU,
    computing in ``JAX.DTYPE``; with ``seed``, random weights drawn from it."""
    models = DAMSMModels(
        text_encoder=build_text_encoder(cfg, n_words),
        image_encoder=CNNEncoder(nef=cfg.TEXT.EMBEDDING_DIM,
                                 input_size=cfg.MODEL.INCEPTION_INPUT,
                                 dtype=compute_dtype(cfg)))
    if seed is not None:
        gen = torch.Generator().manual_seed(seed)
        init_text_weights(models.text_encoder, gen)
        init_image_weights(models.image_encoder, gen)
    return models


def image_trainable_mask(image_encoder: nn.Module,
                         unfreeze_mixed7: bool = False) -> Dict[str, bool]:
    """{parameter name: trains}.  The projection heads only; Mixed_7a/b/c as
    well in the BERT variant."""
    trainable = HEADS + (MIXED7 if unfreeze_mixed7 else ())
    return {name: name.split(".")[0] in trainable
            for name, _ in image_encoder.named_parameters()}


def epoch_lr(base_lr: float, epoch: int, decay: float = 0.98) -> float:
    """x ``decay`` per epoch while above base_lr / 10."""
    lr = base_lr
    for _ in range(epoch):
        if lr > base_lr / 10.0:
            lr *= decay
    return lr


def clip_by_global_norm_(grads, max_norm: float) -> None:
    """optax's ``clip_by_global_norm`` in place: every gradient times
    ``max_norm / norm`` when the global norm reaches ``max_norm`` (no host
    sync)."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)


class DAMSMTrainer:
    """Owns the models (on ``device``), the optimizers and the dropout
    generator; host code drives the epochs."""

    def __init__(self, cfg, models: DAMSMModels, device="cuda"):
        if cfg.JAX.DAMSM_CHUNKS > 1:
            raise NotImplementedError(
                f"JAX.DAMSM_CHUNKS={cfg.JAX.DAMSM_CHUNKS}: pretraining over sequential "
                "sub-batches of the train-mode Inception (their own BatchNorm statistics) "
                "is not ported (ROADMAP.md, queue 1, item 4); use 1")
        self.mm_dtype = loss_dtype(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.text_encoder = models.text_encoder.to(self.device)
        self.image_encoder = models.image_encoder.to(self.device)
        self.grad_clip = cfg.TRAIN.RNN_GRAD_CLIP
        self.base_lr = cfg.TRAIN.ENCODER_LR
        self.gammas = (cfg.TRAIN.SMOOTH.GAMMA1, cfg.TRAIN.SMOOTH.GAMMA2,
                       cfg.TRAIN.SMOOTH.GAMMA3)
        self.unfreeze_mixed7 = cfg.MODEL.TEXT_ENCODER == "bert"
        mask = image_trainable_mask(self.image_encoder, self.unfreeze_mixed7)
        for name, p in self.image_encoder.named_parameters():
            p.requires_grad_(mask[name])
        self.text_params = list(self.text_encoder.parameters())
        self.image_params = [p for p in self.image_encoder.parameters()
                             if p.requires_grad]
        self.dropout_gen = torch.Generator().manual_seed(cfg.JAX.SEED + 7)
        self.step = 0
        self.reset_optimizer(0)

    def reset_optimizer(self, epoch: int) -> float:
        """New Adam moments on both sides, at the learning rate of ``epoch``."""
        lr = epoch_lr(self.base_lr, epoch)
        adam = dict(lr=lr, betas=(0.5, 0.999), eps=1e-8)
        self.text_opt = torch.optim.Adam(self.text_params, **adam)
        self.image_opt = torch.optim.Adam(self.image_params, **adam)
        return lr

    def _losses(self, img, captions, cap_lens, class_ids, keep_mask=None):
        g1, g2, g3 = self.gammas
        region, code = self.image_encoder(img)
        if isinstance(self.text_encoder, RNNEncoder):
            words_emb, sent_emb = self.text_encoder(
                captions, cap_lens, keep_mask=keep_mask, generator=self.dropout_gen)
        else:
            words_emb, sent_emb = self.text_encoder(captions, cap_lens)
        w0, w1, s0, s1 = damsm_losses(region, code, words_emb, sent_emb, cap_lens,
                                      class_ids, g1, g2, g3, self.mm_dtype)
        total = w0 + w1 + s0 + s1
        return total, dict(zip(LOG_KEYS, (w0, w1, s0, s1, total)))

    def train_step(self, img, captions, cap_lens, class_ids,
                   keep_mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One update on a batch (this rank's rows of it): img (b, S, S, 3),
        captions (b, T), cap_lens (b,) (any device), class_ids (b,) or None.
        ``keep_mask`` (b, T, 300) fixes the RNN encoder's embedding dropout;
        by default it comes from the trainer's generator.  Returns the log values as 0-d tensors on
        the device."""
        self.text_encoder.train()
        self.image_encoder.train()
        self.text_opt.zero_grad(set_to_none=True)
        self.image_opt.zero_grad(set_to_none=True)
        total, logs = self._losses(img, captions, cap_lens, class_ids, keep_mask)
        total.backward()
        dist.all_reduce_grads_([p.grad for p in self.text_params + self.image_params])
        clip_by_global_norm_([p.grad for p in self.text_params], self.grad_clip)
        self.text_opt.step()
        self.image_opt.step()
        self.step += 1
        return {k: v.detach() for k, v in logs.items()}

    @torch.no_grad()
    def eval_step(self, img, captions, cap_lens, class_ids) -> Dict[str, torch.Tensor]:
        """The losses in eval mode (running BatchNorm statistics, no dropout)."""
        self.text_encoder.eval()
        self.image_encoder.eval()
        return self._losses(img, captions, cap_lens, class_ids)[1]

    def state_dict(self) -> Dict:
        return {"step": self.step,
                "text_encoder": self.text_encoder.state_dict(),
                "image_encoder": self.image_encoder.state_dict(),
                "text_opt": self.text_opt.state_dict(),
                "image_opt": self.image_opt.state_dict(),
                "dropout_gen": self.dropout_gen.get_state()}

    def load_state_dict(self, state: Dict) -> None:
        self.step = int(state["step"])
        self.text_encoder.load_state_dict(state["text_encoder"])
        self.image_encoder.load_state_dict(state["image_encoder"])
        self.text_opt.load_state_dict(state["text_opt"])
        self.image_opt.load_state_dict(state["image_opt"])
        self.dropout_gen.set_state(state["dropout_gen"])
