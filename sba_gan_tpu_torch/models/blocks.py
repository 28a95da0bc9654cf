"""Generator building blocks, NCHW.

The port's counterparts of the JAX package's generator-side blocks
(``sba_gan_tpu/models/blocks.py``).  Submodule names and ``nn.Sequential``
indices follow the reference G_NET state-dict keys (``upsample.1`` conv,
``upsample.2`` BN, ``block.{0,1,3,4}``), so :mod:`utils.weights` can map
every Flax path to one key.

The JAX package's ``UPBLOCK_FUSED``, ``BN_COMPACT``, ``RGB_HEAD_PAD`` and
``CONV_WGRAD_DOT`` levers are XLA lowerings of the same values; the port
computes the plain math and needs none of them.  BatchNorm is torch's, used
in eval mode on the running statistics; train mode (with flax's biased
running-variance update) comes with the training slice.
"""

from __future__ import annotations

import torch
from torch import nn

BN_EPS = 1e-5


def glu(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Gated linear unit: split ``dim`` in half, a * sigmoid(b)."""
    if x.shape[dim] % 2:
        raise ValueError("glu needs an even number of channels")
    a, b = x.chunk(2, dim=dim)
    return a * torch.sigmoid(b)


class GLU(nn.Module):
    def forward(self, x):
        return glu(x, 1)


def conv3x3(cin: int, cout: int) -> nn.Conv2d:
    """3x3 stride-1 conv, padding 1, no bias."""
    return nn.Conv2d(cin, cout, 3, padding=1, bias=False)


def batch_norm(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=BN_EPS)


def up_block(cin: int, cout: int) -> nn.Sequential:
    """nearest-up x2 -> conv3x3(2*cout) -> BN -> GLU."""
    return nn.Sequential(
        nn.Upsample(scale_factor=2, mode="nearest"),
        conv3x3(cin, cout * 2),
        batch_norm(cout * 2),
        GLU(),
    )


class ResBlock(nn.Module):
    """x + BN(conv3x3(GLU(BN(conv3x3(x)))))."""

    def __init__(self, c: int):
        super().__init__()
        self.block = nn.Sequential(
            conv3x3(c, c * 2),
            batch_norm(c * 2),
            GLU(),
            conv3x3(c, c),
            batch_norm(c),
        )

    def forward(self, x):
        return x + self.block(x)


class CANet(nn.Module):
    """Conditioning augmentation: linear -> GLU -> (mu, logvar) ->
    c = mu + eps * exp(logvar / 2).  ``eps`` (B, c_dim) is passed in."""

    def __init__(self, t_dim: int, c_dim: int):
        super().__init__()
        self.c_dim = c_dim
        self.fc = nn.Linear(t_dim, c_dim * 4)

    def forward(self, sent_emb, eps):
        x = glu(self.fc(sent_emb), 1)
        mu, logvar = x[:, : self.c_dim], x[:, self.c_dim:]
        return mu + eps * torch.exp(0.5 * logvar), mu, logvar


class MappingNet(nn.Module):
    """z -> w: ``num_layers`` bias-free linears with no activation between."""

    def __init__(self, z_dim: int, w_dim: int, num_layers: int = 6):
        super().__init__()
        dims = [z_dim] + [w_dim] * num_layers
        self.fc = nn.Sequential(*[
            nn.Linear(dims[i], dims[i + 1], bias=False) for i in range(num_layers)
        ])

    def forward(self, z):
        return self.fc(z)


def instance_norm_2d(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-sample, per-channel normalization over H, W (biased variance)."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)


class AdaINNorm(nn.Module):
    """out = (gamma + 1) * IN(h) + beta, (gamma, beta) = linear(w)."""

    def __init__(self, w_dim: int, features: int):
        super().__init__()
        self.style = nn.Linear(w_dim, features * 2)

    def forward(self, h, w_code):
        gamma, beta = self.style(w_code)[:, :, None, None].chunk(2, dim=1)
        return (gamma + 1.0) * instance_norm_2d(h) + beta


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights in the reference scheme: orthogonal conv and linear
    weights, zero biases, BN scale N(1, 0.02).  Running statistics stay at
    mean 0, var 1.  ``generator`` is a CPU generator: initialise on the
    CPU, then move the module."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            nn.init.orthogonal_(m.weight, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.weight.copy_(1.0 + 0.02 * torch.randn(m.weight.shape, generator=generator))
            m.bias.zero_()
