"""The gen-1 progressive text-conditioned StyleGAN (the JAX package's
``models/progressive.py``), NCHW.

* :class:`StyleAdaIN`: (gamma + 1) instance_norm(h) + beta, eps 1e-5, with
  (gamma, beta) an equalized dense of w;
* :class:`StyledConvBlock`: the learned 4 x 4 constant (block 0), or a
  nearest 2x upsampling, the 4-tap blur and a 3 x 3 conv; then noise, leaky
  ReLU 0.2 and AdaIN, a second 3 x 3 conv, noise, leaky ReLU and AdaIN;
* :func:`_channels`: 512 channels to 32 x 32, then 256, 128, 64 ...;
* :class:`StyledGenerator`: the style MLP of PixelNorm(z) (concatenated with
  PixelNorm(text_proj(sentence)) when conditioned), ``n_mlp`` equalized
  dense layers with leaky ReLUs; blocks 0..step; the image of to_rgb_step
  faded by alpha against the nearest-upsampled to_rgb_{step-1}.  z of shape
  (2, B, Z) mixes two styles: blocks from ``crossover`` on take the second.
  ``w_mean`` and ``style_weight`` truncate w toward the mean style;
  ``return_w`` stops after the style MLP;
* :class:`ProgressiveDiscriminator`: from_rgb_step (and at a fade,
  from_rgb_{step-1} of the 2 x 2 average pool of the image), blocks of conv
  3 x 3, leaky, blur, conv 3 x 3 to the lower rung's channels, leaky, 2 x 2
  average pool, down to 4 x 4, the fade at the top rung, the minibatch
  statistic, a 3 x 3 conv, a dense of the (H, W, C)-ordered flattening and
  the score head: scores (B,) in at least float32.

Every block and head up to ``max_resolution`` is built at construction; a
call at rung ``step`` runs blocks 0..step and only the heads it blends
(the JAX modules apply every head and discard the rest, which gives the
same values and, to the unused heads, zero gradients).

Parameters carry the JAX package's names (``mlp_0``, ``text_proj``,
``block_0.const.input``, ``block_1.conv1.weight``, ``block_1.noise1.weight``,
``block_1.adain1.style.weight``, ``to_rgb_1``; ``from_rgb_1``, ``conv_1``,
``down_1``, ``final_conv``, ``final_dense``, ``head``), so
:func:`utils.weights.progressive_state_dict` maps the Flax trees by path.

The noise maps are arguments: a list of 2 (step + 1) maps (B, 1, H, W),
two a block, or a ``torch.Generator`` to draw them from
(:meth:`StyledGenerator.draw_noise`); the tests inject the JAX package's.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sba_gan_tpu_torch.models.blocks import instance_norm_2d
from sba_gan_tpu_torch.models.legacy_style import (
    Blur4Tap,
    ConstantInput,
    EqualizedConv,
    EqualizedDense,
    NoiseInjection,
    PixelNorm,
    minibatch_stddev,
    noise_sizes,
    truncate_w,
)
from sba_gan_tpu_torch.models.norms import promote


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def _up2(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsampling (the JAX ``repeat`` on both axes)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def _channels(block_idx: int, fmap_base: int = 512, fmap_max: int = 512) -> int:
    """512, 512, 512, 512, 256, 128, 64, 32, 16 for 4 x 4 .. 1024 x 1024."""
    return min(fmap_max, int(fmap_base / (2 ** max(0, block_idx - 3))))


def n_blocks_of(max_resolution: int) -> int:
    return int(math.log2(max_resolution // 4)) + 1


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX initializers: equalized weights and the constant N(0, 1),
    biases and noise gains 0, drawn in module order from ``generator``."""
    for m in module.modules():
        if isinstance(m, (EqualizedDense, EqualizedConv, NoiseInjection, ConstantInput)):
            m.reset_parameters(generator)


class StyleAdaIN(nn.Module):
    def __init__(self, features: int, w_dim: int):
        super().__init__()
        self.features = features
        self.style = EqualizedDense(w_dim, features * 2)

    def forward(self, h: torch.Tensor, w_code: torch.Tensor) -> torch.Tensor:
        style = self.style(w_code)
        gamma = style[:, :self.features, None, None]
        beta = style[:, self.features:, None, None]
        return (gamma + 1.0) * instance_norm_2d(h) + beta


class StyledConvBlock(nn.Module):
    def __init__(self, in_channels: int, features: int, w_dim: int, initial: bool = False):
        super().__init__()
        self.initial = initial
        if initial:
            self.const = ConstantInput(features)
        else:
            self.blur = Blur4Tap()
            self.conv1 = EqualizedConv(in_channels, features)
        self.noise1 = NoiseInjection(features)
        self.adain1 = StyleAdaIN(features, w_dim)
        self.conv2 = EqualizedConv(features, features)
        self.noise2 = NoiseInjection(features)
        self.adain2 = StyleAdaIN(features, w_dim)

    def forward(self, h: Optional[torch.Tensor], w_code: torch.Tensor,
                noise: Sequence[torch.Tensor]) -> torch.Tensor:
        if self.initial:
            h = self.const(w_code.shape[0])
        else:
            h = self.conv1(self.blur(_up2(h)))
        h = self.adain1(_leaky(self.noise1(h, noise[0])), w_code)
        h = self.conv2(h)
        return self.adain2(_leaky(self.noise2(h, noise[1])), w_code)


class StyledGenerator(nn.Module):
    """forward(z, sent_emb, step, alpha, noise, crossover=None, w_mean=None,
    style_weight=0.7, return_w=False) -> images (B, 3, R, R), R = 4 * 2^step.

    z (B, Z), or (2, B, Z) with ``crossover``; ``sent_emb`` (B, E) or None
    (unconditional; a conditioned G takes ``embed_dim``); ``noise`` the
    2 (step + 1) maps, or a ``torch.Generator`` to draw them from."""

    def __init__(self, z_dim: int = 128, w_dim: int = 512, n_mlp: int = 8,
                 max_resolution: int = 256, fmap_max: int = 512,
                 embed_dim: Optional[int] = None):
        super().__init__()
        self.z_dim, self.w_dim = z_dim, w_dim
        self.max_resolution = max_resolution
        self.pixel_norm = PixelNorm()
        self.text_proj = EqualizedDense(embed_dim, z_dim) if embed_dim else None
        style_in = 2 * z_dim if embed_dim else z_dim
        for i in range(n_mlp):
            self.add_module(f"mlp_{i}", EqualizedDense(style_in if i == 0 else w_dim, w_dim))
        self.n_mlp = n_mlp
        prev = None
        for i in range(self.n_blocks()):
            c = _channels(i, fmap_max=fmap_max)
            self.add_module(f"block_{i}", StyledConvBlock(prev, c, w_dim, initial=(i == 0)))
            self.add_module(f"to_rgb_{i}", EqualizedConv(c, 3, kernel=1))
            prev = c

    def n_blocks(self) -> int:
        return n_blocks_of(self.max_resolution)

    def style(self, z: torch.Tensor, sent_emb: Optional[torch.Tensor]) -> torch.Tensor:
        h = self.pixel_norm(z)
        if self.text_proj is not None and sent_emb is not None:
            h = torch.cat([h, self.pixel_norm(self.text_proj(sent_emb.to(h.dtype)))], dim=-1)
        for i in range(self.n_mlp):
            h = _leaky(getattr(self, f"mlp_{i}")(h))
        return h

    def draw_noise(self, batch: int, step: int, generator: torch.Generator
                   ) -> List[torch.Tensor]:
        """The 2 (step + 1) noise maps (B, 1, S, S) of a run at rung ``step``,
        drawn in order on the CPU from ``generator``."""
        return [torch.randn((batch, 1, s, s), generator=generator) for s in noise_sizes(step)]

    def forward(self, z: torch.Tensor, sent_emb: Optional[torch.Tensor], step: int,
                alpha: float, noise, crossover: Optional[int] = None,
                w_mean: Optional[torch.Tensor] = None, style_weight: float = 0.7,
                return_w: bool = False) -> torch.Tensor:
        if not 0 <= step < self.n_blocks():
            raise ValueError(f"step {step} outside 0..{self.n_blocks() - 1}")
        if z.dim() == 3:  # (2, B, Z): two styles
            w0, w1 = self.style(z[0], sent_emb), self.style(z[1], sent_emb)
        else:
            w0 = w1 = self.style(z, sent_emb)
        if return_w:
            return w0
        if w_mean is not None:
            w0, w1 = truncate_w(w0, w_mean, style_weight), truncate_w(w1, w_mean, style_weight)
        cross = crossover if crossover is not None else self.n_blocks()
        batch = w0.shape[0]
        if isinstance(noise, torch.Generator):
            noise = self.draw_noise(batch, step, noise)
        noise = [n.to(w0.device, w0.dtype) for n in noise]
        h = None
        for i in range(step + 1):
            h = getattr(self, f"block_{i}")(h, w0 if i < cross else w1, noise[2 * i:2 * i + 2])
            if i == step - 1:
                skip = getattr(self, f"to_rgb_{i}")(h)
        out = getattr(self, f"to_rgb_{step}")(h)
        if step > 0:
            out = (1.0 - alpha) * _up2(skip) + alpha * out
        return out


class ProgressiveDiscriminator(nn.Module):
    """forward(img (B, 3, R, R), step, alpha) -> scores (B,), in at least
    float32."""

    def __init__(self, max_resolution: int = 256, fmap_max: int = 512):
        super().__init__()
        self.max_resolution = max_resolution
        ch = [_channels(i, fmap_max=fmap_max) for i in range(self.n_blocks())]
        for i, c in enumerate(ch):
            self.add_module(f"from_rgb_{i}", EqualizedConv(3, c, kernel=1))
            if i > 0:
                self.add_module(f"conv_{i}", EqualizedConv(c, c))
                self.add_module(f"blur_{i}", Blur4Tap())
                self.add_module(f"down_{i}", EqualizedConv(c, ch[i - 1]))
        self.final_conv = EqualizedConv(ch[0] + 1, ch[0])
        self.final_dense = EqualizedDense(16 * ch[0], fmap_max)
        self.head = EqualizedDense(fmap_max, 1)

    def n_blocks(self) -> int:
        return n_blocks_of(self.max_resolution)

    def forward(self, img: torch.Tensor, step: int, alpha: float) -> torch.Tensor:
        if not 0 <= step < self.n_blocks():
            raise ValueError(f"step {step} outside 0..{self.n_blocks() - 1}")
        h = _leaky(getattr(self, f"from_rgb_{step}")(img))
        for i in range(step, 0, -1):
            h = _leaky(getattr(self, f"conv_{i}")(h))
            h = getattr(self, f"blur_{i}")(h)
            h = F.avg_pool2d(_leaky(getattr(self, f"down_{i}")(h)), 2)
            if i == step:
                skip = _leaky(getattr(self, f"from_rgb_{step - 1}")(F.avg_pool2d(img, 2)))
                h = (1.0 - alpha) * skip + alpha * h
        h = _leaky(self.final_conv(minibatch_stddev(h)))
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # (H, W, C) order, as JAX's NHWC
        h = _leaky(self.final_dense(h))
        return promote(self.head(h)[:, 0])
