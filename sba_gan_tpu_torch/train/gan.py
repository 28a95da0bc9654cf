"""GAN training: the models, the train state and the train step (the JAX
package's ``train/gan.py``).

One step, in the JAX step's order:

1. the frozen text encoder (eval mode, no gradient) encodes the captions;
   ``pad_mask = captions == 0``;
2. G runs forward once, in train mode (its BatchNorm running statistics
   move), with noise ``z`` (B, Z) or (2, B, Z) under ``TRAIN.MIXING`` and
   the CA noise ``eps`` (B, CONDITION_DIM);
3. each D is updated on the detached fakes by its own Adam step;
4. the G loss is taken against the *updated* Ds, in train mode but with
   their running statistics frozen (the JAX step drops those updates);
   D parameters get no gradient;
5. the frozen Inception encoder (eval mode) encodes the final-scale fakes;
   the DAMSM words and sentence losses, times ``TRAIN.SMOOTH.LAMBDA``, are
   added (with lambda 0 they leave the graph); then KL;
6. G takes its Adam step, then the EMA ``avg = 0.999 avg + 0.001 p`` over
   G's parameters (not its BatchNorm statistics).

Adam is torch's with betas (0.5, 0.999) and eps 1e-8, one per network.  The
logs (``errD*``, ``g_loss*``, ``w_loss``, ``s_loss``, ``kl_loss``,
``errG``) come back as 0-d tensors on the device: the step reads nothing
back to the host.  On the card the step launches K4 twice (both refinement
stages, forward; its gradient is ``bmm`` code), K1 once (``sim`` of the
words loss) and K2 once (``d_img`` in the G backward); K3 never, because
the words are detached.

``JAX.DTYPE`` is the models' compute dtype (:mod:`models.layers`): the
parameters, their gradients, Adam's moments and the EMA stay float32.
``JAX.LOSS_DTYPE`` is the ``mm_dtype`` of K1 and K2.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from sba_gan_tpu_torch.config import compute_dtype, loss_dtype
from sba_gan_tpu_torch.losses.damsm import sent_loss, words_loss
from sba_gan_tpu_torch.losses.gan import discriminator_loss, generator_adv_loss, kl_loss
from sba_gan_tpu_torch.models.blocks import init_weights
from sba_gan_tpu_torch.models.discriminator import build_discriminators
from sba_gan_tpu_torch.models.generator import GNet, build_generator
from sba_gan_tpu_torch.models.inception import CNNEncoder
from sba_gan_tpu_torch.models.inception import init_weights as init_image_weights
from sba_gan_tpu_torch.models.norms import frozen_running_stats
from sba_gan_tpu_torch.models.text_rnn import init_weights as init_text_weights
from sba_gan_tpu_torch.train.sample import build_text_encoder, noise_shape
from sba_gan_tpu_torch.utils.platform import resolve_device

EMA_DECAY = 0.999
ADAM = dict(betas=(0.5, 0.999), eps=1e-8)


def log_keys(n_ds: int) -> Tuple[str, ...]:
    return (tuple(f"errD{i}" for i in range(n_ds)) + tuple(f"g_loss{i}" for i in range(n_ds))
            + ("w_loss", "s_loss", "kl_loss", "errG"))


class GANModels(NamedTuple):
    text_encoder: nn.Module
    image_encoder: CNNEncoder
    generator: GNet
    discriminators: Tuple[nn.Module, ...]


def build_models(cfg, n_words: int, seed: Optional[int] = None) -> GANModels:
    """The four networks of ``cfg`` on the CPU, computing in ``JAX.DTYPE``;
    with ``seed``, random weights drawn from it."""
    models = GANModels(
        text_encoder=build_text_encoder(cfg, n_words),
        image_encoder=CNNEncoder(nef=cfg.TEXT.EMBEDDING_DIM,
                                 input_size=cfg.MODEL.INCEPTION_INPUT,
                                 dtype=compute_dtype(cfg)),
        generator=build_generator(cfg),
        discriminators=tuple(build_discriminators(cfg)),
    )
    if seed is not None:
        gen = torch.Generator().manual_seed(seed)
        init_text_weights(models.text_encoder, gen)
        init_image_weights(models.image_encoder, gen)
        init_weights(models.generator, gen)
        for d in models.discriminators:
            init_weights(d, gen)
    return models


class GANTrainState:
    """The networks on ``device``, the EMA of G's parameters, one Adam per
    network and the step count.  The encoders are frozen (eval mode, no
    gradient)."""

    def __init__(self, cfg, models: GANModels, device="cuda"):
        if cfg.TRAIN.GRAD_ACCUM > 1:
            raise NotImplementedError(
                f"TRAIN.GRAD_ACCUM={cfg.TRAIN.GRAD_ACCUM}: gradient accumulation "
                "(GRAD_ACCUM_MODE 'window' / 'dfresh') is still to port "
                "(ROADMAP.md, queue 1, item 1)")
        self.device = resolve_device(device)
        dev = self.device
        self.text_encoder = models.text_encoder.to(dev).eval().requires_grad_(False)
        self.image_encoder = models.image_encoder.to(dev).eval().requires_grad_(False)
        self.generator = models.generator.to(dev).train()
        self.discriminators = nn.ModuleList(models.discriminators).to(dev).train()
        self.g_ema = {n: p.detach().clone() for n, p in self.generator.named_parameters()}
        self.g_opt = torch.optim.Adam(self.generator.parameters(),
                                      lr=cfg.TRAIN.GENERATOR_LR, **ADAM)
        self.d_opts = [torch.optim.Adam(d.parameters(), lr=cfg.TRAIN.DISCRIMINATOR_LR, **ADAM)
                       for d in self.discriminators]
        self.step = 0

    def ema_generator(self) -> GNet:
        """A copy of G holding the EMA parameters and G's BatchNorm
        statistics, in eval mode (what sampling runs)."""
        g = copy.deepcopy(self.generator).eval()
        with torch.no_grad():
            for n, p in g.named_parameters():
                p.copy_(self.g_ema[n])
        return g

    def state_dict(self) -> Dict:
        return {"step": self.step,
                "generator": self.generator.state_dict(),
                "g_ema": dict(self.g_ema),
                "discriminators": [d.state_dict() for d in self.discriminators],
                "g_opt": self.g_opt.state_dict(),
                "d_opts": [o.state_dict() for o in self.d_opts],
                "text_encoder": self.text_encoder.state_dict(),
                "image_encoder": self.image_encoder.state_dict()}

    def load_state_dict(self, state: Dict) -> None:
        """A :meth:`state_dict`, or the networks alone (no ``step``, no
        optimizers), as :func:`utils.weights.gan_state_from_jax` gives them."""
        self.generator.load_state_dict(state["generator"])
        with torch.no_grad():
            for n, v in state["g_ema"].items():
                self.g_ema[n].copy_(v)
        for d, sd in zip(self.discriminators, state["discriminators"], strict=True):
            d.load_state_dict(sd)
        self.text_encoder.load_state_dict(state["text_encoder"])
        self.image_encoder.load_state_dict(state["image_encoder"])
        if "step" in state:
            self.step = int(state["step"])
            self.g_opt.load_state_dict(state["g_opt"])
            for o, sd in zip(self.d_opts, state["d_opts"], strict=True):
                o.load_state_dict(sd)


def init_gan_state(cfg, models: GANModels, device="cuda",
                   text_state: Optional[Dict] = None,
                   image_state: Optional[Dict] = None) -> GANTrainState:
    """The train state of ``models`` on ``device``; ``text_state`` /
    ``image_state`` are pretrained encoder state dicts (a DAMSM checkpoint's
    ``text_encoder`` / ``image_encoder``), else the encoders keep their
    weights."""
    if text_state is not None:
        models.text_encoder.load_state_dict(text_state)
    if image_state is not None:
        models.image_encoder.load_state_dict(image_state)
    return GANTrainState(cfg, models, device)


class GANStep:
    """``step(imgs, captions, cap_lens, class_ids, z=None, eps=None)`` updates
    ``state`` and returns the logs.

    imgs: per branch (B, S, S, 3) in [-1, 1]; captions (B, T) and class_ids
    (B,) on the state's device; cap_lens (B,) on the CPU.  ``z`` / ``eps``
    default to draws from the step's ``torch.Generator`` on the device.
    ``mark(name)``, if given, is called at the end of each phase (for
    timing: ``text``, ``g_forward``, ``d0``..., ``g_adv``, ``damsm``,
    ``g_backward``, ``g_adam``, ``ema``)."""

    def __init__(self, cfg, state: GANTrainState, seed: Optional[int] = None):
        self.cfg = cfg
        self.state = state
        self.gammas = (cfg.TRAIN.SMOOTH.GAMMA1, cfg.TRAIN.SMOOTH.GAMMA2,
                       cfg.TRAIN.SMOOTH.GAMMA3)
        self.smooth_lambda = cfg.TRAIN.SMOOTH.LAMBDA
        self.mm_dtype = loss_dtype(cfg)
        self.noise = torch.Generator(device=state.device)
        self.noise.manual_seed(cfg.JAX.SEED + 1 if seed is None else seed)

    def draw_noise(self, batch: int) -> Tuple[torch.Tensor, torch.Tensor]:
        dev = self.state.device
        z = torch.randn(noise_shape(self.cfg, batch), generator=self.noise, device=dev)
        eps = torch.randn((batch, self.cfg.GAN.CONDITION_DIM), generator=self.noise,
                          device=dev)
        return z, eps

    def damsm_loss(self, img: torch.Tensor, words: torch.Tensor, sent: torch.Tensor,
                   cap_lens: torch.Tensor, class_ids: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The G loss's DAMSM terms, (words, sentence) times lambda, of the
        final-scale images ``img`` (B, S, S, 3) through the frozen Inception
        encoder: K1 in the words loss, K2 in its gradient to ``img``."""
        g1, g2, g3 = self.gammas
        labels = torch.arange(img.shape[0], device=img.device)
        region, code = self.state.image_encoder(img)
        w0, w1 = words_loss(region, words, labels, cap_lens, class_ids, g1, g2, g3,
                            self.mm_dtype)
        s0, s1 = sent_loss(code, sent, labels, class_ids, g3)
        return (w0 + w1) * self.smooth_lambda, (s0 + s1) * self.smooth_lambda

    def __call__(self, imgs: Sequence[torch.Tensor], captions: torch.Tensor,
                 cap_lens: torch.Tensor, class_ids: Optional[torch.Tensor],
                 z: Optional[torch.Tensor] = None, eps: Optional[torch.Tensor] = None,
                 mark: Optional[Callable[[str], None]] = None) -> Dict[str, torch.Tensor]:
        s = self.state
        mark = mark or (lambda name: None)
        b = captions.shape[0]
        if z is None or eps is None:
            z_draw, eps_draw = self.draw_noise(b)
            z = z_draw if z is None else z
            eps = eps_draw if eps is None else eps

        with torch.no_grad():
            words, sent = s.text_encoder(captions, cap_lens)
        pad_mask = captions == 0
        mark("text")

        fakes, _, mu, logvar = s.generator.forward_nchw(z, sent, words, pad_mask, eps)
        reals = [img.permute(0, 3, 1, 2).contiguous() for img in imgs]
        mark("g_forward")

        logs: Dict[str, torch.Tensor] = {}
        for i, (d, opt) in enumerate(zip(s.discriminators, s.d_opts)):
            opt.zero_grad(set_to_none=True)
            err = discriminator_loss(d, reals[i], fakes[i].detach(), sent)
            err.backward()
            opt.step()
            logs[f"errD{i}"] = err.detach()
            mark(f"d{i}")

        total = torch.zeros((), device=s.device)
        with frozen_running_stats(*s.discriminators):
            for i, d in enumerate(s.discriminators):
                g_loss = generator_adv_loss(d, fakes[i], sent)
                logs[f"g_loss{i}"] = g_loss.detach()
                total = total + g_loss
        mark("g_adv")

        if self.smooth_lambda == 0.0:
            w_loss = s_loss = torch.zeros((), device=s.device)
        else:
            w_loss, s_loss = self.damsm_loss(fakes[-1].permute(0, 2, 3, 1), words, sent,
                                             cap_lens, class_ids)
            total = total + w_loss + s_loss
        kl = kl_loss(mu, logvar)
        total = total + kl
        mark("damsm")

        params = list(s.generator.parameters())
        for p, g in zip(params, torch.autograd.grad(total, params)):
            p.grad = g
        mark("g_backward")
        s.g_opt.step()
        mark("g_adam")
        with torch.no_grad():
            ema = list(s.g_ema.values())
            torch._foreach_mul_(ema, EMA_DECAY)
            torch._foreach_add_(ema, [p.detach() for p in params], alpha=1.0 - EMA_DECAY)
        mark("ema")
        s.step += 1
        logs.update(w_loss=w_loss.detach(), s_loss=s_loss.detach(), kl_loss=kl.detach(),
                    errG=total.detach())
        return logs

