"""Pieces of the JAX package's legacy StyleGAN stacks (its
``models/legacy_style.py``), NCHW, for the gen-2 generator and the gen-1
progressive StyleGAN (:mod:`models.progressive`).

* :class:`PixelNorm`: x * rsqrt(mean(x^2) + eps) over one dimension, its
  arithmetic in at least float32 and the result in the input's dtype (the
  JAX module's axis -1 is the channel axis of its NHWC maps; in the port's
  NCHW maps that is ``dim=1``).
* :func:`equalized_lr_scale`, :class:`EqualizedDense`,
  :class:`EqualizedConv`: the He constant sqrt(2) / sqrt(fan_in) multiplies
  the stored weight at every call (so the stored weight's gradient is
  JAX's), weights drawn N(0, 1), biases 0.  The weight layouts are torch's:
  (out, in) and OIHW where Flax keeps (in, out) and HWIO; 'SAME' is padding
  1 for 3 x 3 and 0 for 1 x 1.
* :class:`NoiseInjection`: x + gain[c] * noise, one (B, 1, H, W) map for all
  channels, the gain starting at 0; the noise injected, or drawn from an
  explicit ``torch.Generator`` (on the CPU, then copied to ``x``'s device).
* :class:`ConstantInput`: a learned (1, C, size, size) map, broadcast to the
  batch.
* :func:`blur_4tap` / :class:`Blur4Tap`: the depthwise [1,2,1]^T [1,2,1] / 16
  blur with zero padding, differentiated as its own adjoint at every order
  (as the reference's hand-written ``BlurFunction``): PyTorch's double
  backward of the grouped convolution would take a launch per channel.
* :func:`minibatch_stddev`: the variance over the batch (ddof 0) in at least
  float32, sqrt(var + eps) averaged over C, H and W, appended as one more
  channel.
* :func:`mean_style`, :func:`truncate_w`; :func:`progressive_schedule` and
  :func:`progressive_schedule_samples`, the gen-1 resolution and fade-in
  schedule (host-side integers, copies of the JAX functions).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sba_gan_tpu_torch.models.norms import promote


class PixelNorm(nn.Module):
    def __init__(self, dim: int = -1, eps: float = 1e-8):
        super().__init__()
        self.dim = dim
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = promote(x)
        scale = torch.rsqrt((x32 * x32).mean(dim=self.dim, keepdim=True) + self.eps)
        return (x32 * scale).to(x.dtype)


def equalized_lr_scale(fan_in: int, gain: float = math.sqrt(2.0)) -> float:
    """He constant applied at run time (the reference's EqualLR)."""
    return gain / math.sqrt(fan_in)


class EqualizedDense(nn.Module):
    """x @ (w * scale)^T + b, w (out, in) drawn N(0, 1) (the JAX layer at its
    ``lr_mul`` 1, the only one its models use)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.scale = equalized_lr_scale(in_features)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.weight.normal_(0.0, 1.0, generator=generator)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight * self.scale, self.bias)


class EqualizedConv(nn.Module):
    """conv(x, w * scale) + b, stride 1, 'SAME' padding; w (out, in, k, k)
    drawn N(0, 1)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.scale = equalized_lr_scale(in_channels * kernel * kernel)
        self.padding = kernel // 2

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.weight.normal_(0.0, 1.0, generator=generator)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight * self.scale, self.bias, padding=self.padding)


class NoiseInjection(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(channels))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.weight.zero_()

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if noise is None:
            if generator is None:
                raise ValueError("NoiseInjection needs a noise map or a torch.Generator")
            b, _, h, w = x.shape
            noise = torch.randn((b, 1, h, w), generator=generator).to(x.device)
        return x + self.weight.to(x.dtype)[None, :, None, None] * noise.to(x.dtype)


class ConstantInput(nn.Module):
    def __init__(self, channels: int, size: int = 4):
        super().__init__()
        self.input = nn.Parameter(torch.empty(1, channels, size, size))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.input.normal_(0.0, 1.0, generator=generator)

    def forward(self, batch: int) -> torch.Tensor:
        return self.input.expand(batch, -1, -1, -1)


_BLUR_KERNELS = {}  # (dtype, device) -> the 3 x 3 kernel, made once


def _blur_conv(x: torch.Tensor) -> torch.Tensor:
    key = (x.dtype, x.device)
    if key not in _BLUR_KERNELS:
        k1 = torch.tensor([1.0, 2.0, 1.0], dtype=x.dtype)
        _BLUR_KERNELS[key] = ((k1[:, None] * k1[None, :]) / 16.0).to(x.device)
    c = x.shape[1]
    return F.conv2d(x, _BLUR_KERNELS[key].expand(c, 1, 3, 3), padding=1, groups=c)


class _Blur(torch.autograd.Function):
    """The blur is its own adjoint (a symmetric kernel, zero padding, stride
    1), so its gradient is the blur of the gradient, at every order.
    Autograd's double backward of a grouped convolution computes the
    kernel's gradient one group at a time, a launch per channel, whether or
    not the kernel takes a gradient; this keeps the penalties' second
    derivative to one depthwise convolution a blur."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return _blur_conv(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        return _Blur.apply(grad)


def blur_4tap(x: torch.Tensor) -> torch.Tensor:
    """Depthwise [1,2,1]^T [1,2,1] / 16 blur of (B, C, H, W), zero padding."""
    return _Blur.apply(x)


class Blur4Tap(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return blur_4tap(x)


def minibatch_stddev(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(B, C, H, W) -> (B, C + 1, H, W): the batch statistic as the last
    channel."""
    x32 = promote(x)
    std = torch.sqrt(x32.var(dim=0, unbiased=False) + eps).mean()
    b, _, h, w = x.shape
    return torch.cat([x, std.to(x.dtype).expand(b, 1, h, w)], dim=1)


def mean_style(w: torch.Tensor) -> torch.Tensor:
    """The mean style vector over a sample of w codes, (1, W)."""
    return w.mean(dim=0, keepdim=True)


def truncate_w(w: torch.Tensor, w_mean: torch.Tensor, psi: float = 0.7) -> torch.Tensor:
    """The truncation trick: w_mean + psi (w - w_mean)."""
    return w_mean + psi * (w - w_mean)


def progressive_schedule(step: int, phase_samples: int, batch_size: int,
                         init_size: int = 8, max_size: int = 64) -> Tuple[int, float]:
    """Resolution and alpha at ``step`` for a fixed batch size."""
    return progressive_schedule_samples(step * batch_size, phase_samples, init_size,
                                        max_size)


def progressive_schedule_samples(used: int, phase_samples: int, init_size: int = 8,
                                 max_size: int = 64) -> Tuple[int, float]:
    """Resolution and alpha from the number of samples consumed: a phase of
    ``phase_samples`` per resolution from ``init_size`` to ``max_size``, alpha
    rising from 0 to 1 over each phase but the first (1 there)."""
    n_phases = int(math.log2(max_size / init_size)) + 1
    phase = min(used // phase_samples, n_phases - 1)
    resolution = init_size * (2 ** phase)
    if phase == 0:
        alpha = 1.0
    else:
        alpha = min(1.0, (used - phase * phase_samples) / phase_samples)
    return resolution, alpha


def noise_sizes(step: int) -> List[int]:
    """The sides of the 2 (step + 1) noise maps of a generator run at rung
    ``step``: two a block, 4, 4, 8, 8, ..."""
    return [4 * 2 ** i for i in range(step + 1) for _ in range(2)]
