"""The gen-1 progressive trainer (the JAX package's ``train/progressive.py``):
per-rung D and G steps, WGAN-GP or R1 critic losses, style mixing with
probability 0.9, Adam with beta (0.0, 0.99) and eps 1e-8 where D's learning
rate is ``d_lr_mult`` (4) times G's and the style MLP's updates are scaled
by 0.01, and a 0.99 EMA of G.

As in the JAX package:

* a D step draws fakes without a graph; WGAN-GP: mean(fake) - mean(real) +
  0.001 mean(real^2) + the gradient penalty at the epsilon-mix, a double
  backward through D; R1: the softplus terms and the penalty at the reals
  (:mod:`losses.gan`); the step count goes up;
* a G step makes fresh fakes inside its loss, -mean D(fake); D's parameters
  take no gradient there; then the EMA e = 0.99 e + 0.01 p over every G
  parameter;
* blocks from ``crossover = max(1, n_blocks // 2)`` on take the second
  style, n_blocks = rung + 1.

The optimizers are ``torch.optim.Adam`` at beta (0.0, 0.99) and eps 1e-8,
G's in two groups, the ``mlp_*`` parameters at 0.01 times the rate (the
text projection keeps 1).  optax's ``adam`` keeps one count for all
parameters, PyTorch's a count per parameter that a parameter without a
gradient does not advance; so every parameter takes a gradient at every
step, zeros for the parts the rung does not run (with beta1 0 they do not
move, and their second moments decay), and the counts stay optax's.  With
beta1 0 PyTorch's update, lr m / (sqrt(v) / sqrt(1 - b2^t) + eps), is
optax's up to rounding.

Random draws: the JAX steps fold ``2 step`` (D) and ``2 step + 1`` (G, after
the D step raised ``step``) into one key.  The port seeds a CPU
``torch.Generator`` from (seed, that number) for each step and draws, in
order, z (2, B, Z), the batch's mixing decision (uniform < the mixing
probability, else z[1] = z[0]), each block's two noise maps and, in a
WGAN-GP D step, the penalty's epsilon (B, 1, 1, 1); drawn on the CPU and
copied, so a run on the card sees the CPU's values.  Every step also takes
injected draws (``draws=``), which the tests take from JAX.

Entry points run on the card unless ``device='cpu'`` asks for the CPU.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from sba_gan_tpu_torch.losses.gan import (
    r1_d_loss,
    wgan_d_loss,
    wgan_g_loss,
    wgan_gradient_penalty,
)
from sba_gan_tpu_torch.models.progressive import (
    ProgressiveDiscriminator,
    StyledGenerator,
    init_weights,
)
from sba_gan_tpu_torch.train.gen2 import step_seed
from sba_gan_tpu_torch.utils.platform import resolve_device

EMA_DECAY = 0.99
MLP_LR_SCALE = 0.01


def make_adam(groups: Sequence[Tuple[Sequence[torch.Tensor], float]],
              lr: float) -> torch.optim.Adam:
    """``torch.optim.Adam`` over (parameters, rate scale) groups, the first
    of scale 1; each group keeps its ``lr_scale`` for :func:`set_lr`."""
    return torch.optim.Adam([{"params": list(ps), "lr": lr * s, "lr_scale": s}
                             for ps, s in groups if ps],
                            lr=lr, betas=(0.0, 0.99), eps=1e-8, foreach=True)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr * group["lr_scale"]


def base_lr(opt: torch.optim.Optimizer) -> float:
    """The rate of the optimizer's scale-1 group."""
    return opt.param_groups[0]["lr"]


class ProgressiveTrainer:
    """Trains the gen-1 progressive StyleGAN on one device: the weights drawn
    from ``seed`` (with ``init``; else left for a caller that loads a state
    next), G, its EMA and D in ``dtype`` (float32, or float64 for a reference
    run on the CPU).  ``embed_dim`` conditions G on a sentence embedding."""

    def __init__(self, z_dim: int = 128, w_dim: int = 512, max_resolution: int = 256,
                 fmap_max: int = 512, loss_mode: str = "wgan-gp", lr: float = 1e-3,
                 d_lr_mult: float = 4.0, mixing_prob: float = 0.9,
                 embed_dim: Optional[int] = None, n_mlp: int = 8, device="cuda",
                 seed: int = 0, dtype: torch.dtype = torch.float32, init: bool = True):
        if loss_mode not in ("wgan-gp", "r1"):
            raise ValueError(f"loss_mode must be 'wgan-gp' or 'r1', got {loss_mode!r}")
        self.device = resolve_device(device)
        self.dtype = dtype
        self.z_dim = z_dim
        self.loss_mode = loss_mode
        self.mixing_prob = mixing_prob
        self.seed = seed
        generator = StyledGenerator(z_dim=z_dim, w_dim=w_dim, n_mlp=n_mlp,
                                    max_resolution=max_resolution, fmap_max=fmap_max,
                                    embed_dim=embed_dim)
        discriminator = ProgressiveDiscriminator(max_resolution=max_resolution,
                                                 fmap_max=fmap_max)
        if init:
            gen = torch.Generator().manual_seed(seed)
            init_weights(generator, gen)
            init_weights(discriminator, gen)
        self.generator = generator.to(self.device, dtype)
        self.discriminator = discriminator.to(self.device, dtype)
        self.g_ema = copy.deepcopy(self.generator).requires_grad_(False)
        self.g_names = [n for n, _ in self.generator.named_parameters()]
        self.g_params = list(self.generator.parameters())
        self.d_names = [n for n, _ in self.discriminator.named_parameters()]
        self.d_params = list(self.discriminator.parameters())
        mlp = [n.startswith("mlp_") for n in self.g_names]
        self.g_opt = make_adam(
            [([p for p, m in zip(self.g_params, mlp) if not m], 1.0),
             ([p for p, m in zip(self.g_params, mlp) if m], MLP_LR_SCALE)], lr)
        self.d_opt = make_adam([(self.d_params, 1.0)], lr * d_lr_mult)
        self.step = 0

    def n_blocks(self) -> int:
        return self.generator.n_blocks()

    @staticmethod
    def crossover(res_step: int) -> int:
        return max(1, (res_step + 1) // 2)

    def with_lr(self, g_lr: float, d_lr: float) -> None:
        """Retune both learning rates (the reference's adjust_lr at a phase
        switch).  The CLI's ``--sched`` passes the same ``SCHED_LR`` value for
        both, so D then trains at G's rate, not 4x it: that is what the JAX
        CLI does (its ``progressive_main.py:239-240``), and the port follows
        it."""
        set_lr(self.g_opt, g_lr)
        set_lr(self.d_opt, d_lr)

    # ------------------------------------------------------------------
    def draw(self, n: int, batch: int, res_step: int, penalty: bool) -> Dict:
        """Step number ``n``'s draws: z (2, B, Z) with the mixing decision
        applied, the noise maps of rung ``res_step`` and, with ``penalty``,
        the penalty's epsilon."""
        gen = torch.Generator().manual_seed(step_seed(self.seed, n))
        z = torch.randn((2, batch, self.z_dim), generator=gen)
        if not bool(torch.rand((), generator=gen) < self.mixing_prob):
            z[1] = z[0]
        draws = {"z": z, "noise": self.generator.draw_noise(batch, res_step, gen)}
        if penalty:
            draws["gp_eps"] = torch.rand((batch, 1, 1, 1), generator=gen)
        return draws

    def _on_device(self, draws: Dict) -> Dict:
        """The draws on the device in ``dtype``, copied from pinned memory
        without waiting for the card's queue."""
        cuda = self.device.type == "cuda"

        def move(v):
            if isinstance(v, (list, tuple)):
                return [move(x) for x in v]
            v = torch.as_tensor(v).to(dtype=self.dtype)
            if cuda and v.device.type == "cpu":
                v = v.pin_memory()
            return v.to(self.device, non_blocking=True)
        return {k: move(v) for k, v in draws.items()}

    def _images(self, real) -> torch.Tensor:
        """NHWC images (numpy or tensor) -> NCHW on the device, in ``dtype``."""
        real = torch.as_tensor(real)
        return real.to(self.device, self.dtype, non_blocking=True).permute(0, 3, 1, 2)

    def _sent(self, sent) -> Optional[torch.Tensor]:
        return None if sent is None else torch.as_tensor(sent).to(self.device, self.dtype)

    def _fake(self, net, sent, alpha, res_step, draws) -> torch.Tensor:
        return net(draws["z"], sent, res_step, alpha, draws["noise"],
                   crossover=self.crossover(res_step))

    # ------------------------------------------------------------------
    def d_loss(self, real: torch.Tensor, sent: Optional[torch.Tensor], alpha: float,
               res_step: int, draws: Dict) -> torch.Tensor:
        """The D step's loss (``real`` NCHW on the device), its graph to D's
        parameters only."""
        with torch.no_grad():
            fake = self._fake(self.generator, sent, alpha, res_step, draws)

        def d_fn(x):
            return self.discriminator(x, res_step, alpha)
        if self.loss_mode == "r1":
            return r1_d_loss(d_fn, real, d_fn(fake))
        return (wgan_d_loss(d_fn(real), d_fn(fake))
                + wgan_gradient_penalty(d_fn, real, fake, draws["gp_eps"]))

    def g_loss(self, sent: Optional[torch.Tensor], alpha: float, res_step: int,
               draws: Dict) -> torch.Tensor:
        fake = self._fake(self.generator, sent, alpha, res_step, draws)
        return wgan_g_loss(self.discriminator(fake, res_step, alpha))

    def d_grads(self, real, sent, alpha: float, res_step: int,
                draws: Optional[Dict] = None) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(loss, D's gradients in ``d_names`` order, zeros for the parts the
        rung does not run) of the next D step; ``real`` NHWC."""
        real = self._images(real)
        draws = self._on_device(draws or self.draw(
            2 * self.step, real.shape[0], res_step, self.loss_mode == "wgan-gp"))
        loss = self.d_loss(real, self._sent(sent), alpha, res_step, draws)
        grads = torch.autograd.grad(loss, self.d_params, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(self.d_params, grads)]

    def g_grads(self, batch: int, sent, alpha: float, res_step: int,
                draws: Optional[Dict] = None) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(loss, G's gradients in ``g_names`` order) of the next G step."""
        draws = self._on_device(draws or self.draw(2 * self.step + 1, batch, res_step, False))
        loss = self.g_loss(self._sent(sent), alpha, res_step, draws)
        grads = torch.autograd.grad(loss, self.g_params, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(self.g_params, grads)]

    @staticmethod
    def _update(opt: torch.optim.Optimizer, params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor]) -> None:
        for p, g in zip(params, grads, strict=True):
            p.grad = g
        opt.step()
        opt.zero_grad(set_to_none=True)

    def apply_d(self, grads: Sequence[torch.Tensor]) -> None:
        """D's Adam update from ``grads`` (one for every parameter); the
        step count goes up."""
        self._update(self.d_opt, self.d_params, grads)
        self.step += 1

    def apply_g(self, grads: Sequence[torch.Tensor]) -> None:
        """G's Adam update from ``grads`` (one for every parameter), then the
        EMA."""
        self._update(self.g_opt, self.g_params, grads)
        with torch.no_grad():
            ema, now = list(self.g_ema.parameters()), list(self.generator.parameters())
            torch._foreach_mul_(ema, EMA_DECAY)
            torch._foreach_add_(ema, now, alpha=1.0 - EMA_DECAY)

    def d_step(self, real, sent, alpha: float, res_step: int,
               draws: Optional[Dict] = None) -> torch.Tensor:
        loss, grads = self.d_grads(real, sent, alpha, res_step, draws)
        self.apply_d(grads)
        return loss

    def g_step(self, batch: int, sent, alpha: float, res_step: int,
               draws: Optional[Dict] = None) -> torch.Tensor:
        loss, grads = self.g_grads(batch, sent, alpha, res_step, draws)
        self.apply_g(grads)
        return loss

    @torch.no_grad()
    def sample(self, batch: int, res_step: int, sent_emb=None, alpha: float = 1.0,
               use_ema: bool = True, seed: int = 0, draws: Optional[Dict] = None
               ) -> torch.Tensor:
        """Images (B, R, R, 3) float32 on the CPU of the EMA (or the live)
        generator, one style a row: z (B, Z) then the noise maps drawn from
        ``seed``, or ``draws``."""
        if draws is None:
            gen = torch.Generator().manual_seed(seed)
            draws = {"z": torch.randn((batch, self.z_dim), generator=gen)}
            draws["noise"] = self.generator.draw_noise(batch, res_step, gen)
        draws = self._on_device(draws)
        net = self.g_ema if use_ema else self.generator
        img = net(draws["z"], self._sent(sent_emb), res_step, alpha, draws["noise"])
        return img.permute(0, 2, 3, 1).float().cpu()

    # ------------------------------------------------------------------
    def state_dict(self) -> Dict:
        """Everything a resumed run needs: the step, G, its EMA, D and both
        optimizers' counts, learning rates and moments."""
        return {"step": self.step, "generator": self.generator.state_dict(),
                "g_ema": self.g_ema.state_dict(),
                "discriminator": self.discriminator.state_dict(),
                "g_opt": self.g_opt.state_dict(), "d_opt": self.d_opt.state_dict()}

    def load_state_dict(self, state: Dict) -> None:
        self.step = int(state["step"])
        self.generator.load_state_dict(state["generator"])
        self.g_ema.load_state_dict(state["g_ema"])
        self.discriminator.load_state_dict(state["discriminator"])
        self.g_opt.load_state_dict(state["g_opt"])
        self.d_opt.load_state_dict(state["d_opt"])
