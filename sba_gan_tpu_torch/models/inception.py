"""Inception-v3 image encoder of DAMSM (the JAX package's ``CNNEncoder``).

Images in [-1, 1], (B, S, S, 3) as the JAX package takes them, are resized
to ``input_size`` with an align-corners bilinear map when S differs, run
through the Inception-v3 trunk (NCHW inside), and tapped twice: the 17 x 17
x 768 map after Mixed_6e goes through ``emb_features`` (1 x 1 conv, no bias)
to the region features (B, 289, nef), in row-major 17 x 17 order as the JAX
package's NHWC reshape gives them; the 2048-d average after Mixed_7c goes
through ``emb_cnn_code`` (linear) to the global code (B, nef).

Module names are torchvision's (``Conv2d_1a_3x3.conv.weight``,
``Mixed_5b.branch1x1.bn.running_mean``, ...), so a state dict has the keys
that the JAX package's ``port_cnn_encoder`` reads.  BatchNorm is flax's
(:class:`models.norms.BatchNorm`) with eps 1e-3: in train mode the running
statistics move as ``new = 0.9 old + 0.1 batch`` with the *biased* batch
variance, not torch's unbiased one.

``CNNEncoder(dtype=...)`` is the JAX package's ``CNNEncoder(dtype=...)``:
the parameters stay float32, the resize runs in float32, the convolutions
and the code's linear compute in ``dtype`` (float32 or bfloat16), the
3 x 3 average pools sum in float32, and the regions and the code come out
in at least float32.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sba_gan_tpu_torch.models.layers import Conv2d, Linear, set_compute_dtype
from sba_gan_tpu_torch.models.norms import BatchNorm, promote


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of a 1-D bilinear resize with align_corners
    (scale (n_in - 1) / (n_out - 1))."""
    w = np.zeros((n_out, n_in), np.float32)
    if n_out == 1 or n_in == 1:
        w[:, 0] = 1.0
        return w
    pos = np.arange(n_out, dtype=np.float64) * ((n_in - 1) / (n_out - 1))
    lo = np.clip(np.floor(pos).astype(np.int64), 0, n_in - 2)
    frac = (pos - lo).astype(np.float32)
    rows = np.arange(n_out)
    w[rows, lo] = 1.0 - frac
    w[rows, lo + 1] += frac
    return w


def resize_bilinear_align_corners(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) -> (B, oh, ow, C): bilinear, corners aligned, as two
    products with the separable weight matrices."""
    _, h, w, _ = x.shape
    wy = torch.from_numpy(resize_matrix(h, size[0])).to(x.device)
    wx = torch.from_numpy(resize_matrix(w, size[1])).to(x.device)
    out = torch.einsum("bhwc,ph->bpwc", x.float(), wy)
    out = torch.einsum("bhwc,qw->bhqc", out, wx)
    return out.to(x.dtype)


class BasicConv2d(nn.Module):
    """conv (no bias) + BatchNorm (eps 1e-3) + relu."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1, padding=0):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, stride=stride, padding=padding,
                           bias=False)
        self.bn = BatchNorm(cout, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def avg_pool_3x3(x):
    """3 x 3, stride 1, pad 1, padding counted (divisor 9); in at least
    float32, returned in ``x``'s dtype."""
    return F.avg_pool2d(promote(x), 3, stride=1, padding=1,
                        count_include_pad=True).to(x.dtype)


def max_pool_3x3_s2(x):
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(avg_pool_3x3(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, max_pool_3x3_s2(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3,
                      self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = layer(bd)
        bp = self.branch_pool(avg_pool_3x3(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for layer in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = layer(b7)
        return torch.cat([b3, b7, max_pool_3x3_s2(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        bp = self.branch_pool(avg_pool_3x3(x))
        return torch.cat([b1, b3, bd, bp], dim=1)


TRUNK = ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3", "Conv2d_3b_1x1",
         "Conv2d_4a_3x3", "Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
         "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b",
         "Mixed_7c")
HEADS = ("emb_features", "emb_cnn_code")


class CNNEncoder(nn.Module):
    """forward(images (B, S, S, 3)) -> (regions (B, R, nef), code (B, nef)),
    R = 289 at input 299."""

    def __init__(self, nef: int = 256, input_size: int = 299,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.input_size = input_size
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.emb_features = Conv2d(768, nef, 1, bias=False)
        self.emb_cnn_code = Linear(2048, nef)
        set_compute_dtype(self, dtype)

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        size = self.input_size
        if images.shape[1] != size or images.shape[2] != size:
            images = resize_bilinear_align_corners(images, (size, size))
        x = images.permute(0, 3, 1, 2).contiguous()
        for name in TRUNK[:5]:
            x = getattr(self, name)(x)
            if name in ("Conv2d_2b_3x3", "Conv2d_4a_3x3"):
                x = max_pool_3x3_s2(x)
        for name in TRUNK[5:13]:
            x = getattr(self, name)(x)
        features = x  # 17 x 17 x 768 region tap
        for name in TRUNK[13:]:
            x = getattr(self, name)(x)
        pooled = x.mean(dim=(2, 3))
        region = self.emb_features(features)  # (B, nef, 17, 17)
        region = region.permute(0, 2, 3, 1).reshape(region.shape[0], -1, region.shape[1])
        return promote(region), promote(self.emb_cnn_code(pooled))


@torch.no_grad()
def init_weights(encoder: CNNEncoder, generator: torch.Generator) -> None:
    """Random weights from ``generator``: trunk convs normal with std
    1/sqrt(fan_in) (lecun scale, as flax's default), BatchNorm scale 1,
    bias 0, running mean 0, var 1; both heads U(-0.1, 0.1) as the JAX
    package draws them, and the code's bias 0."""
    for m in encoder.modules():
        if isinstance(m, nn.Conv2d) and m is not encoder.emb_features:
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
        elif isinstance(m, BatchNorm):
            m.reset_parameters()
    encoder.emb_features.weight.uniform_(-0.1, 0.1, generator=generator)
    encoder.emb_cnn_code.weight.uniform_(-0.1, 0.1, generator=generator)
    encoder.emb_cnn_code.bias.zero_()
