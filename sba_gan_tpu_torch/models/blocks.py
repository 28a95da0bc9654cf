"""Generator and discriminator building blocks, NCHW.

The port's counterparts of the JAX package's blocks
(``sba_gan_tpu/models/blocks.py``).  Submodule names and ``nn.Sequential``
indices follow the reference G_NET and D_NET state-dict keys (``upsample.1``
conv, ``upsample.2`` BN, ``block.{0,1,3,4}``; a down block's ``0`` conv and
``1`` BN), so :mod:`utils.weights` can map every Flax path to one key.

The JAX package's ``UPBLOCK_FUSED``, ``BN_COMPACT``, ``RGB_HEAD_PAD`` and
``CONV_WGRAD_DOT`` levers are XLA lowerings of the same values; the port
computes the plain math and needs none of them.  BatchNorm is
:class:`models.norms.BatchNorm` (flax's train-mode statistics, eps 1e-5).
"""

from __future__ import annotations

import torch
from torch import nn

from sba_gan_tpu_torch.models.norms import BatchNorm

BN_EPS = 1e-5
LEAK = 0.2


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


def batch_norm(c: int) -> BatchNorm:
    return BatchNorm(c, eps=BN_EPS)


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


# --------------------------- discriminator blocks --------------------------


def block3x3_leak_relu(cin: int, cout: int) -> nn.Sequential:
    """conv3x3 -> BN -> LeakyReLU(0.2), same spatial size."""
    return nn.Sequential(conv3x3(cin, cout), batch_norm(cout), nn.LeakyReLU(LEAK))


def down_block(cin: int, cout: int) -> nn.Sequential:
    """4x4 stride-2 conv (padding 1, no bias) -> BN -> LeakyReLU(0.2): H/2."""
    return nn.Sequential(nn.Conv2d(cin, cout, 4, stride=2, padding=1, bias=False),
                         batch_norm(cout), nn.LeakyReLU(LEAK))


def encode_by_16(ndf: int) -> nn.Sequential:
    """3 -> ndf -> 2ndf -> 4ndf -> 8ndf by four stride-2 4x4 convs, H/16; the
    first conv has no BN.  Flat, as the reference's
    ``encode_image_by_16times`` (convs at 0, 2, 5, 8; BNs at 3, 6, 9)."""
    layers = [nn.Conv2d(3, ndf, 4, stride=2, padding=1, bias=False), nn.LeakyReLU(LEAK)]
    for mult in (1, 2, 4):
        layers.extend(down_block(ndf * mult, ndf * mult * 2))
    return nn.Sequential(*layers)


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
