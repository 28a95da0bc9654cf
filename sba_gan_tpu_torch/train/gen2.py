"""Gen-2 trainer (the JAX package's ``train/gen2.py``): RMSprop, a D update
every batch and a G update after every ``TRAIN.CRITIC_ITER``-th, WGAN-GP or
BCE losses, sentence-conditioned D heads, a 0.999 EMA of G.

As in the JAX package:

* the D step draws fakes without a graph and detaches the sentence; its
  WGAN loss carries the feature gradient penalty, a double backward
  through D (:func:`losses.gen2.gen2_feature_gradient_penalty`); the wrong
  pairs are the real features ``[:B-1]`` against ``sent[1:]``;
* the G step makes fresh fakes inside its loss, the sentence detached;
  D's parameters take no gradient there; in BCE mode the image encoder's
  ``fc`` trains beside G (``TRAIN.ENCODER_LR``) and its Inception trunk
  stays frozen;
* the BERT tower takes no update (``requires_grad`` false; JAX zeroes its
  gradient, which gives a zero RMSprop update); ``bert_embedding.fc``
  trains, through the CA net;
* the EMA e = 0.999 e + 0.001 p runs over every G parameter after each G
  update.

:class:`RMSprop` is ``optax.rmsprop(lr)`` (decay 0.9, eps 1e-8 *inside*
the square root, moments starting at 0); ``torch.optim.RMSprop`` differs
(alpha 0.99, eps outside the root).

deviation (BCE mode): the JAX trainer keeps only the image encoder's
``params`` and applies it without ``batch_stats`` in its G step, which
raises (ROADMAP.md, section 3); the port applies the Inception trunk on
the running statistics it holds (mean 0 and variance 1 at init, or carried
weights'), which is what the JAX step evidently means.

Random draws: the JAX steps fold ``2 step`` (D) and ``2 step + 1`` (G,
after the D step raised ``step``) into one key.  The port seeds a CPU
``torch.Generator`` from (seed, that number) for each step and draws, in
order, z, the CA's epsilon, the epilogues' noise maps (with
``USE_NOISE``) and, in the D step, the penalty's epsilon; drawn on the CPU
and copied, so a run on the card sees the CPU's values.  Every step also
takes injected draws (``draws=``), which the tests take from JAX.

Entry points run on the card unless ``device='cpu'`` asks for the CPU.
"""

from __future__ import annotations

import copy
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from sba_gan_tpu_torch.losses.gen2 import (
    gen2_d_loss_bce,
    gen2_d_loss_wgan,
    gen2_feature_gradient_penalty,
    gen2_g_loss_bce,
    gen2_g_loss_wgan,
)
from sba_gan_tpu_torch.models.gen2 import (
    Gen2Discriminator,
    Gen2DOutput,
    Gen2Generator,
    Gen2ImageEncoder,
    gen2_image_encoder_trainable,
    gen2_trainable,
)
from sba_gan_tpu_torch.models.norms import BatchNorm
from sba_gan_tpu_torch.utils.platform import resolve_device

EMA_DECAY = 0.999
# flax's lecun_normal: a normal truncated at 2 standard units, whose
# standard deviation this factor corrects to 1 / sqrt(fan_in)
_TRUNC_STD = 0.87962566103423978


class Gen2DNet(nn.Module):
    """The feature backbone and the unconditional and conditional heads."""

    def __init__(self, resolution: int = 128, resolution_init: int = 4, e_dim: int = 128,
                 fmap_base: int = 4096, fmap_max: int = 256):
        super().__init__()
        self.backbone = Gen2Discriminator(resolution, resolution_init, fmap_base, fmap_max)
        c = self.backbone.channels
        self.uncond = Gen2DOutput(c, e_dim, condition=False)
        self.cond = Gen2DOutput(c, e_dim, condition=True)

    def forward(self, img: torch.Tensor, sent: torch.Tensor):
        return self.scores(self.features(img), sent)

    def features(self, img: torch.Tensor) -> torch.Tensor:
        return self.backbone(img)

    def scores(self, feats: torch.Tensor, sent: torch.Tensor):
        return self.uncond(feats), self.cond(feats, sent)


class RMSprop:
    """``optax.rmsprop(lr)``: nu = 0.9 nu + 0.1 g^2, p -= lr g / sqrt(nu +
    1e-8), nu from 0, over ``params`` (a list)."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float, decay: float = 0.9,
                 eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.decay, self.eps = lr, decay, eps
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        grads = list(grads)
        torch._foreach_mul_(self.nu, self.decay)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.decay)
        scale = torch._foreach_add(self.nu, self.eps)
        torch._foreach_rsqrt_(scale)
        torch._foreach_mul_(scale, grads)
        torch._foreach_add_(self.params, scale, alpha=-self.lr)

    def state_dict(self) -> List[torch.Tensor]:
        return self.nu

    def load_state_dict(self, nu: Sequence[torch.Tensor]) -> None:
        for mine, saved in zip(self.nu, nu, strict=True):
            mine.copy_(saved)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights drawn as flax's default initializers draw them: every
    linear, convolution and transposed convolution lecun-normal (a normal
    of std 1 / sqrt(fan_in) truncated at two of its standard units), biases
    0; BERT's embedding tables normal with std 1 / sqrt(width), LayerNorm
    1 and 0; BatchNorm scale 1, bias 0, running mean 0, variance 1.  The
    generator's constant and its bias stay 1, the noise gains 0."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            if isinstance(m, nn.ConvTranspose2d):  # (in, out, kh, kw)
                fan_in = w.shape[0] * w.shape[2] * w.shape[3]
            else:
                fan_in = w[0].numel()
            std = fan_in ** -0.5 / _TRUNC_STD
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, m.embedding_dim ** -0.5, generator=generator)
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.reset_parameters()


def bert_cfg_of(cfg) -> Dict:
    """The BERT tower of ``GEN2``'s keys."""
    g2 = cfg.GEN2
    return dict(vocab_size=g2.BERT_VOCAB, hidden_size=g2.BERT_HIDDEN,
                num_layers=g2.BERT_LAYERS, num_heads=g2.BERT_HEADS,
                intermediate_size=g2.BERT_INTERMEDIATE,
                max_position=max(512, g2.MAX_LENGTH), type_vocab_size=2,
                layer_norm_eps=1e-12)


def build_gen2_models(cfg) -> Tuple[Gen2Generator, Gen2DNet, Optional[Gen2ImageEncoder]]:
    """G, D and (BCE mode) the image encoder of ``cfg.GEN2``, on the CPU."""
    g2 = cfg.GEN2
    common = dict(fmap_base=g2.FMAP_BASE, fmap_max=g2.FMAP_MAX)
    generator = Gen2Generator(
        resolution=g2.RESOLUTION, resolution_init=g2.RESOLUTION_INIT, e_dim=g2.E_DIM,
        c_dim=g2.C_DIM, z_dim=g2.Z_DIM, w_dim=g2.W_DIM, a_dim=g2.A_DIM,
        m_layers=g2.M_LAYERS, m_use_norm=g2.M_USE_NORM, use_attn=g2.USE_ATTENTION,
        use_noise=g2.USE_NOISE, use_pixel_norm=g2.USE_PIXEL_NORM,
        use_instance_norm=g2.USE_INSTANCE_NORM, use_truncation=g2.USE_TRUNCATION,
        bert_cfg=bert_cfg_of(cfg), **common)
    dnet = Gen2DNet(g2.RESOLUTION, g2.RESOLUTION_INIT, g2.E_DIM, **common)
    encoder = None if g2.WGAN else Gen2ImageEncoder(g2.E_DIM, cfg.MODEL.INCEPTION_INPUT)
    return generator, dnet, encoder


def step_seed(seed: int, n: int) -> int:
    """The seed of the draws of step number ``n`` (2 step for D, 2 step + 1
    for G) under the run's ``seed``."""
    return int(np.random.SeedSequence([seed, n]).generate_state(1)[0])


class Gen2Trainer:
    """Trains the gen-2 conditional StyleGAN on one device: the
    weights drawn from ``seed`` (with ``init``; else torch's defaults, for a
    caller that loads a state next), G, D and the image encoder in
    ``dtype`` (float32, or float64 for a reference run on the CPU)."""

    def __init__(self, cfg, device="cuda", seed: int = 100,
                 dtype: torch.dtype = torch.float32, init: bool = True):
        self.device = resolve_device(device)
        self.dtype = dtype
        g2 = cfg.GEN2
        self.cfg = cfg
        self.seed = seed
        self.wgan = g2.WGAN
        self.critic_iter = cfg.TRAIN.CRITIC_ITER
        self.gp_lambda = float(g2.WGAN_LAMBDA)
        self.gamma3 = float(cfg.TRAIN.SMOOTH.GAMMA3)
        self.lam = float(cfg.TRAIN.SMOOTH.LAMBDA)
        generator, dnet, encoder = build_gen2_models(cfg)
        gen = torch.Generator().manual_seed(seed)
        for m in (generator, dnet, encoder):
            if m is not None and init:
                init_weights(m, gen)
        self.generator = generator.to(self.device, dtype)
        self.dnet = dnet.to(self.device, dtype)
        self.image_encoder = None if encoder is None else encoder.to(self.device, dtype)
        self.g_ema = copy.deepcopy(self.generator).requires_grad_(False)

        self.g_names = [n for n, _ in self.generator.named_parameters() if gen2_trainable(n)]
        for n, p in self.generator.named_parameters():
            p.requires_grad_(gen2_trainable(n))
        self.g_params = [p for p in self.generator.parameters() if p.requires_grad]
        self.d_names = [n for n, _ in self.dnet.named_parameters()]
        self.d_params = list(self.dnet.parameters())
        self.g_opt = RMSprop(self.g_params, cfg.TRAIN.GENERATOR_LR)
        self.d_opt = RMSprop(self.d_params, cfg.TRAIN.DISCRIMINATOR_LR)
        self.e_names, self.e_params, self.e_opt = [], [], None
        if self.image_encoder is not None:
            for n, p in self.image_encoder.named_parameters():
                p.requires_grad_(gen2_image_encoder_trainable(n))
            self.e_names = [n for n, p in self.image_encoder.named_parameters()
                            if p.requires_grad]
            self.e_params = [p for p in self.image_encoder.parameters() if p.requires_grad]
            self.e_opt = RMSprop(self.e_params, cfg.TRAIN.ENCODER_LR)
        self.step = 0

    # ------------------------------------------------------------------
    def _images(self, real) -> torch.Tensor:
        """NHWC images (numpy or tensor) -> NCHW on the device, in ``dtype``."""
        real = torch.as_tensor(real)
        return real.to(self.device, self.dtype, non_blocking=True).permute(0, 3, 1, 2)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens).to(self.device, torch.long, non_blocking=True)

    def _on_device(self, draws: Dict) -> Dict:
        """The draws on the device, copied from pinned memory without waiting
        for the card's queue."""
        cuda = self.device.type == "cuda"

        def move(v):
            if v is None:
                return None
            if isinstance(v, (list, tuple)):
                return [move(x) for x in v]
            v = torch.as_tensor(v).to(dtype=self.dtype)
            if cuda and v.device.type == "cpu":
                v = v.pin_memory()
            return v.to(self.device, non_blocking=True)
        return {k: move(v) for k, v in draws.items()}

    def draw(self, n: int, batch: int, penalty: bool) -> Dict:
        """Step number ``n``'s draws: z, eps, noise, and with ``penalty``
        the penalty's epsilon (B, 1, 1, 1) in [0, 1)."""
        gen = torch.Generator().manual_seed(step_seed(self.seed, n))
        draws = self.generator.draw(batch, gen)
        if penalty:
            draws["gp_eps"] = torch.rand((batch, 1, 1, 1), generator=gen)
        return draws

    def _generate(self, net, tokens, draws):
        return net(tokens, draws["z"], draws["eps"], draws["noise"])

    # ------------------------------------------------------------------
    def d_loss(self, real: torch.Tensor, tokens: torch.Tensor, draws: Dict) -> torch.Tensor:
        """The D step's loss (``real`` NCHW on the device), its graph to D's
        parameters only."""
        with torch.no_grad():
            fake, _, sent, _, _ = self._generate(self.generator, tokens, draws)
        dnet = self.dnet
        real_f, fake_f = dnet.features(real), dnet.features(fake)
        ru, rc = dnet.scores(real_f, sent)
        fu, fc = dnet.scores(fake_f, sent)
        _, wc = dnet.scores(real_f[:-1], sent[1:])
        if self.wgan:
            gp = gen2_feature_gradient_penalty(dnet.features, real, fake, draws["gp_eps"],
                                               self.gp_lambda)
            return gen2_d_loss_wgan(ru, fu, rc, fc, wc, gp)
        return gen2_d_loss_bce(ru, fu, rc, fc, wc)

    def g_loss(self, tokens: torch.Tensor, draws: Dict) -> torch.Tensor:
        fake, _, sent, _, _ = self._generate(self.generator, tokens, draws)
        sent = sent.detach()
        fu, fc = self.dnet(fake, sent)
        if self.wgan:
            return gen2_g_loss_wgan(fu, fc)
        img_code = self.image_encoder(fake)
        return gen2_g_loss_bce(fu, fc, sent, img_code, self.lam, self.gamma3)

    def d_grads(self, real, tokens, draws: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(loss, D's gradients in ``d_names`` order) of the next D step."""
        real = self._images(real)
        draws = self._on_device(draws or self.draw(2 * self.step, real.shape[0],
                                                   self.wgan))
        loss = self.d_loss(real, self._tokens(tokens), draws)
        return loss.detach(), list(torch.autograd.grad(loss, self.d_params))

    def g_grads(self, tokens, draws: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
        """(loss, G's gradients in ``g_names`` order, the image encoder's in
        ``e_names`` order) of the next G step."""
        tokens = self._tokens(tokens)
        draws = self._on_device(draws or self.draw(2 * self.step + 1, tokens.shape[0],
                                                   False))
        loss = self.g_loss(tokens, draws)
        grads = torch.autograd.grad(loss, self.g_params + self.e_params)
        n = len(self.g_params)
        return loss.detach(), list(grads[:n]), list(grads[n:])

    def apply_d(self, grads: Sequence[torch.Tensor]) -> None:
        """D's RMSprop update from ``grads``; the step count goes up."""
        self.d_opt.step(grads)
        self.step += 1

    def apply_g(self, g_grads: Sequence[torch.Tensor], e_grads: Sequence[torch.Tensor]
                ) -> None:
        """G's (and the image encoder's) RMSprop update, then the EMA."""
        if self.e_opt is not None:
            self.e_opt.step(e_grads)
        self.g_opt.step(g_grads)
        with torch.no_grad():
            ema, now = list(self.g_ema.parameters()), list(self.generator.parameters())
            torch._foreach_mul_(ema, EMA_DECAY)
            torch._foreach_add_(ema, now, alpha=1.0 - EMA_DECAY)

    def d_step(self, real, tokens, draws: Optional[Dict] = None) -> torch.Tensor:
        loss, grads = self.d_grads(real, tokens, draws)
        self.apply_d(grads)
        return loss

    def g_step(self, tokens, draws: Optional[Dict] = None) -> torch.Tensor:
        loss, g_grads, e_grads = self.g_grads(tokens, draws)
        self.apply_g(g_grads, e_grads)
        return loss

    def train_epoch(self, batches: Iterable) -> Tuple[float, float]:
        """One pass over ``batches`` of (images NHWC in [-1, 1], tokens): D
        every batch, G after every ``critic_iter``-th; the last D and G
        losses (G's 0.0 if it took no step)."""
        d_loss = g_loss = None
        for i, (real, tokens) in enumerate(batches):
            d_loss = self.d_step(real, tokens)
            if (i + 1) % self.critic_iter == 0:
                g_loss = self.g_step(tokens)
        return (0.0 if d_loss is None else float(d_loss),
                0.0 if g_loss is None else float(g_loss))

    @torch.no_grad()
    def sample(self, tokens, seed: int, use_ema: bool = True,
               draws: Optional[Dict] = None) -> torch.Tensor:
        """Images (B, R, R, 3) float32 on the CPU of the EMA (or the live)
        generator, its draws from ``seed``."""
        tokens = self._tokens(tokens)
        if draws is None:
            draws = self.generator.draw(tokens.shape[0], torch.Generator().manual_seed(seed))
        net = self.g_ema if use_ema else self.generator
        img = self._generate(net, tokens, self._on_device(draws))[0]
        return img.permute(0, 2, 3, 1).float().cpu()

    # ------------------------------------------------------------------
    def state_dict(self) -> Dict:
        """Everything a resumed run needs: the step, G, its EMA, D, the image
        encoder and the RMSprop moments."""
        return {"step": self.step, "generator": self.generator.state_dict(),
                "g_ema": self.g_ema.state_dict(), "dnet": self.dnet.state_dict(),
                "image_encoder": (None if self.image_encoder is None
                                  else self.image_encoder.state_dict()),
                "g_opt": self.g_opt.state_dict(), "d_opt": self.d_opt.state_dict(),
                "e_opt": None if self.e_opt is None else self.e_opt.state_dict()}

    def load_state_dict(self, state: Dict) -> None:
        self.step = int(state["step"])
        self.generator.load_state_dict(state["generator"])
        self.g_ema.load_state_dict(state["g_ema"])
        self.dnet.load_state_dict(state["dnet"])
        if self.image_encoder is not None:
            self.image_encoder.load_state_dict(state["image_encoder"])
            self.e_opt.load_state_dict(state["e_opt"])
        self.g_opt.load_state_dict(state["g_opt"])
        self.d_opt.load_state_dict(state["d_opt"])
