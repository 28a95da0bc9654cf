"""GAN training: the models, the train state and the train step (the JAX
package's ``train/gan.py``).

One step, in the JAX step's order:

1. the frozen text encoder (eval mode, no gradient; the bi-LSTM, or
   bert-base under ``MODEL.TEXT_ENCODER: bert``) encodes the captions;
   ``pad_mask = captions == 0``;
2. G runs forward once, in train mode (its BatchNorm running statistics
   move), with noise ``z`` (B, Z) or (2, B, Z) under ``TRAIN.MIXING`` and
   the CA noise ``eps`` (B, CONDITION_DIM);
3. each D is updated on the detached fakes by its own Adam step (under
   ``GAN.B_DCGAN`` G makes one image and there is one D, at the final
   scale, which takes the last of the reals, as the JAX step pairs them);
4. the G loss is taken against the *updated* Ds, in train mode but with
   their running statistics frozen (the JAX step drops those updates);
   D parameters get no gradient;
5. the frozen Inception encoder (eval mode) encodes the final-scale fakes;
   the DAMSM words and sentence losses, times ``TRAIN.SMOOTH.LAMBDA``, are
   added (with lambda 0 they leave the graph); then KL;
6. G takes its Adam step, then the EMA ``avg = 0.999 avg + 0.001 p`` over
   G's parameters (not its BatchNorm statistics), each average paired with
   its parameter by name.

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

Across ranks (:mod:`parallel.dist`, one process per GPU under ``torchrun``)
each rank takes its rows of the global batch; the noise is drawn for the
global batch from the step's generator, seeded alike on every rank, and
each rank takes its rows, so N ranks see one process's noise.  Every batch
reduction is global (the BatchNorm statistics, the GAN losses' means, the
wrong pairs, the DAMSM matrices), and each network's gradient is summed
over ranks before its optimizer step: G's, and each D's in its own update.
The logs are the global batch's, the same on every rank.

``TRAIN.GRAD_ACCUM`` = k > 1 accumulates as the JAX package's optax
``MultiSteps`` (``train/state.py``): each call is a micro-step, the
accumulator takes the mean ``acc + (g - acc) / (n + 1)`` of the reduced
gradients, and Adam steps once a window, on that mean, its state still
between.  ``GRAD_ACCUM_MODE`` 'window': G and every D accumulate;
'dfresh': every D steps on every micro-batch, G accumulates.  The EMA folds
only when ``(step + 1) % k == 0``.  The accumulators and the micro-step
count are in the state dict, so a resume mid-window finishes the window.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from sba_gan_tpu_torch.config import compute_dtype, loss_dtype
from sba_gan_tpu_torch.losses.damsm import damsm_losses
from sba_gan_tpu_torch.losses.gan import discriminator_loss, generator_adv_loss, kl_loss
from sba_gan_tpu_torch.models.blocks import init_weights
from sba_gan_tpu_torch.models.discriminator import build_discriminators
from sba_gan_tpu_torch.models.generator import build_generator
from sba_gan_tpu_torch.models.inception import CNNEncoder
from sba_gan_tpu_torch.models.inception import init_weights as init_image_weights
from sba_gan_tpu_torch.models.norms import frozen_running_stats
from sba_gan_tpu_torch.parallel import dist
from sba_gan_tpu_torch.train.sample import build_text_encoder, init_text_weights, noise_shape
from sba_gan_tpu_torch.utils.platform import resolve_device

EMA_DECAY = 0.999
ADAM = dict(betas=(0.5, 0.999), eps=1e-8)


def log_keys(n_ds: int) -> Tuple[str, ...]:
    return (tuple(f"errD{i}" for i in range(n_ds)) + tuple(f"g_loss{i}" for i in range(n_ds))
            + ("w_loss", "s_loss", "kl_loss", "errG"))


class GANModels(NamedTuple):
    text_encoder: nn.Module
    image_encoder: CNNEncoder
    generator: nn.Module  # GNet, or GDCGAN under GAN.B_DCGAN
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
        init_models(models, seed)
    return models


def init_models(models: GANModels, seed: int) -> None:
    """Random weights drawn from ``seed`` into ``models``, in place: the
    weights :func:`build_models` gives with that seed."""
    gen = torch.Generator().manual_seed(seed)
    init_text_weights(models.text_encoder, gen)
    init_image_weights(models.image_encoder, gen)
    init_weights(models.generator, gen)
    for d in models.discriminators:
        init_weights(d, gen)


class GANTrainState:
    """The networks on ``device``, the EMA of G's parameters, one Adam per
    network, the step count, and under ``TRAIN.GRAD_ACCUM`` > 1 the
    gradient accumulators and the micro-step count.  The encoders are
    frozen (eval mode, no gradient)."""

    def __init__(self, cfg, models: GANModels, device="cuda"):
        self.accum_k = cfg.TRAIN.GRAD_ACCUM
        mode = cfg.TRAIN.GRAD_ACCUM_MODE
        if self.accum_k < 1 or mode not in ("window", "dfresh"):
            raise ValueError(f"TRAIN.GRAD_ACCUM must be >= 1 and GRAD_ACCUM_MODE 'window' "
                             f"or 'dfresh'; got {self.accum_k}, {mode!r}")
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
        accum = self.accum_k > 1
        self.micro = 0  # micro-steps into the window
        self.g_accum = _zeros(self.generator) if accum else None
        self.d_accums = [_zeros(d) if accum and mode == "window" else None
                         for d in self.discriminators]

    def ema_generator(self) -> nn.Module:
        """A copy of G holding the EMA parameters and G's BatchNorm
        statistics, in eval mode (what sampling runs)."""
        g = copy.deepcopy(self.generator).eval()
        with torch.no_grad():
            for n, p in g.named_parameters():
                p.copy_(self.g_ema[n])
        return g

    def state_dict(self) -> Dict:
        state = {"step": self.step,
                 "generator": self.generator.state_dict(),
                 "g_ema": dict(self.g_ema),
                 "discriminators": [d.state_dict() for d in self.discriminators],
                 "g_opt": self.g_opt.state_dict(),
                 "d_opts": [o.state_dict() for o in self.d_opts],
                 "text_encoder": self.text_encoder.state_dict(),
                 "image_encoder": self.image_encoder.state_dict()}
        if self.g_accum is not None:
            state["accum"] = {"micro": self.micro, "generator": dict(self.g_accum),
                              "discriminators": [None if a is None else dict(a)
                                                 for a in self.d_accums]}
        return state

    def load_state_dict(self, state: Dict) -> None:
        """A :meth:`state_dict`, or the networks alone (no ``step``, no
        optimizers), as :func:`utils.weights.gan_state_from_jax` gives them.
        Accumulators are read where both sides have them; else a window
        starts afresh."""
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
        saved = state.get("accum")
        if saved is not None and self.g_accum is not None:
            self.micro = int(saved["micro"])
            pairs = [(self.g_accum, saved["generator"])] + list(
                zip(self.d_accums, saved["discriminators"], strict=True))
            with torch.no_grad():
                for mine, theirs in pairs:
                    if mine is not None and theirs is not None:
                        for n, v in mine.items():
                            v.copy_(theirs[n])


def _zeros(module: nn.Module) -> Dict[str, torch.Tensor]:
    return {n: torch.zeros_like(p) for n, p in module.named_parameters()}


def _grads(loss: torch.Tensor, params) -> list:
    """d loss / d params, zero for a parameter the loss does not use (G's
    mapping net at ``TREE.BRANCH_NUM`` 1), as JAX's gradient is."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


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

    imgs: per branch (b, S, S, 3) in [-1, 1]; captions (b, T) and class_ids
    (b,) on the state's device; cap_lens (b,) on the CPU: this rank's rows
    of the global batch (b = B in one process).  ``z`` / ``eps`` are the
    global batch's noise, of which the step takes this rank's rows; they
    default to draws from the step's ``torch.Generator`` on the device.
    After a call each parameter's ``grad`` holds its network's gradient of
    the micro-batch, summed over ranks, or at the end of an accumulation
    window the window's mean, which Adam applied.
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
        final-scale images ``img`` (b, S, S, 3) through the frozen Inception
        encoder, over the global batch: K1 in the words loss, K2 in its
        gradient to ``img``."""
        g1, g2, g3 = self.gammas
        region, code = self.state.image_encoder(img)
        w0, w1, s0, s1 = damsm_losses(region, code, words, sent, cap_lens, class_ids,
                                      g1, g2, g3, self.mm_dtype)
        return (w0 + w1) * self.smooth_lambda, (s0 + s1) * self.smooth_lambda

    def _update(self, opt, params, grads, accum: Optional[Dict[str, torch.Tensor]]) -> None:
        """Sums ``grads`` over ranks; steps ``opt`` on them, or with an
        accumulator folds them into the window's mean and steps on that at
        the window's end (optax ``MultiSteps``)."""
        dist.all_reduce_grads_(grads)
        if accum is not None:
            acc = list(accum.values())
            n = self.state.micro
            torch._foreach_add_(acc, torch._foreach_div(torch._foreach_sub(grads, acc),
                                                        n + 1))
            if n + 1 < self.state.accum_k:
                for p, g in zip(params, grads):
                    p.grad = g
                return
            grads = [a.clone() for a in acc]
            torch._foreach_zero_(acc)
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()

    def __call__(self, imgs: Sequence[torch.Tensor], captions: torch.Tensor,
                 cap_lens: torch.Tensor, class_ids: Optional[torch.Tensor],
                 z: Optional[torch.Tensor] = None, eps: Optional[torch.Tensor] = None,
                 mark: Optional[Callable[[str], None]] = None) -> Dict[str, torch.Tensor]:
        s = self.state
        mark = mark or (lambda name: None)
        b = captions.shape[0]
        if z is None or eps is None:
            z_draw, eps_draw = self.draw_noise(b * dist.world_size())
            z = z_draw if z is None else z
            eps = eps_draw if eps is None else eps
        mine = dist.rows(b)
        z, eps = z[..., mine, :], eps[mine]

        with torch.no_grad():
            words, sent = s.text_encoder(captions, cap_lens)
        pad_mask = captions == 0
        mark("text")

        fakes, _, mu, logvar = s.generator.forward_nchw(z, sent, words, pad_mask, eps)
        if len(fakes) != len(imgs):  # GDCGAN: its one image meets the final-scale reals
            imgs = imgs[-1:]
        reals = [img.permute(0, 3, 1, 2).contiguous() for img in imgs]
        mark("g_forward")

        logs: Dict[str, torch.Tensor] = {}
        for i, (d, opt) in enumerate(zip(s.discriminators, s.d_opts)):
            err = discriminator_loss(d, reals[i], fakes[i].detach(), sent)
            params = list(d.parameters())
            self._update(opt, params, _grads(err, params), s.d_accums[i])
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

        names, params = zip(*s.generator.named_parameters())
        params = list(params)
        grads = _grads(total, params)
        mark("g_backward")
        self._update(s.g_opt, params, grads, s.g_accum)
        mark("g_adam")
        if (s.step + 1) % s.accum_k == 0:  # the EMA folds once a window
            with torch.no_grad():
                ema = [s.g_ema[n] for n in names]
                torch._foreach_mul_(ema, EMA_DECAY)
                torch._foreach_add_(ema, [p.detach() for p in params],
                                    alpha=1.0 - EMA_DECAY)
        mark("ema")
        s.step += 1
        s.micro = (s.micro + 1) % s.accum_k
        logs.update(w_loss=w_loss.detach(), s_loss=s_loss.detach(), kl_loss=kl.detach(),
                    errG=total.detach())
        return logs
