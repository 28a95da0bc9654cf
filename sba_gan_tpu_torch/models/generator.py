"""Multi-stage attentional generator with AdaIN style injection, NCHW inside.

* :class:`InitStageG` — FC + BN + GLU -> (ngf, 4, 4) -> four up-blocks -> 64x64.
* :class:`NextStageG` — word attention on the pre-AdaIN features, AdaIN,
  ``[h_styled, ctx]`` -> ResBlocks -> up-block.
* :class:`GetImageG` — conv3x3 -> tanh.
* :class:`GNet` — CA net + mapping net + up to three branches; with
  ``style_mixing`` z is (2, B, Z) and the two w codes feed stage 2 and
  stage 3.
* :class:`GDCGAN` — ``GAN.B_DCGAN``: the same trunk (one w code styles
  every refinement stage through its AdaIN) and one image, at the last
  stage.

Submodule names follow the reference G_NET / G_DCGAN state-dict keys
(``ca_net``, ``mapping_net.fc.N``, ``h_net1.fc``, ``h_net1.upsampleK``,
``img_netI.img`` or G_DCGAN's one ``img_net.img``,
``h_netJ.{att, adain, residual, upsample}``).  ``forward`` takes and
returns the JAX package's layouts: images (B, S, S, 3), maps (B, H, W, T).

``GNet(dtype=...)`` / ``GDCGAN(dtype=...)`` are the JAX package's
``dtype=``: the parameters stay float32, the convolutions and linears
compute in ``dtype`` (float32 or bfloat16), and the images come out float32
(each head's tanh runs on its conv's output cast to float32); the maps and
``mu``/``logvar`` come out in ``dtype``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from sba_gan_tpu_torch.config import compute_dtype
from sba_gan_tpu_torch.models.attention import WordAttention
from sba_gan_tpu_torch.models.blocks import (
    AdaINNorm,
    CANet,
    GLU,
    MappingNet,
    ResBlock,
    batch_norm,
    conv3x3,
    up_block,
)
from sba_gan_tpu_torch.models.layers import Linear, set_compute_dtype
from sba_gan_tpu_torch.models.norms import promote


class InitStageG(nn.Module):
    """Stage 0: (z, c) -> (B, ngf/16, 64, 64)."""

    def __init__(self, ngf: int, in_dim: int):
        super().__init__()
        self.ngf = ngf
        self.fc = nn.Sequential(
            Linear(in_dim, ngf * 4 * 4 * 2, bias=False),
            batch_norm(ngf * 4 * 4 * 2),
            GLU(),
        )
        self.upsample1 = up_block(ngf, ngf // 2)
        self.upsample2 = up_block(ngf // 2, ngf // 4)
        self.upsample3 = up_block(ngf // 4, ngf // 8)
        self.upsample4 = up_block(ngf // 8, ngf // 16)

    def forward(self, x):
        x = self.fc(x).view(-1, self.ngf, 4, 4)
        x = self.upsample1(x)
        x = self.upsample2(x)
        x = self.upsample3(x)
        return self.upsample4(x)


class NextStageG(nn.Module):
    """Refinement stage: (B, ngf, H, W) -> (B, ngf, 2H, 2W) and the
    attention maps (B, H, W, T)."""

    def __init__(self, ngf: int, nef: int, w_dim: int, num_residual: int = 2):
        super().__init__()
        self.att = WordAttention(ngf, nef)
        self.adain = AdaINNorm(w_dim, ngf)
        self.residual = nn.Sequential(
            *[ResBlock(ngf * 2) for _ in range(num_residual)])
        self.upsample = up_block(ngf * 2, ngf)

    def forward(self, h_code, w_code, word_embs, pad_mask):
        # attention queries the features before AdaIN
        ctx, att = self.att(h_code, word_embs, pad_mask)
        h = torch.cat([self.adain(h_code, w_code), ctx], dim=1)
        return self.upsample(self.residual(h)), att


class GetImageG(nn.Module):
    """conv3x3 -> tanh, the tanh in at least float32."""

    def __init__(self, ngf: int):
        super().__init__()
        self.img = nn.Sequential(conv3x3(ngf, 3), nn.Tanh())

    def forward(self, h):
        conv, tanh = self.img
        return tanh(promote(conv(h)))


class _Generator(nn.Module):
    """:meth:`forward` in the JAX package's layouts around a subclass's
    :meth:`forward_nchw`."""

    def forward(self, z, sent_emb, word_embs, pad_mask: Optional[torch.Tensor],
                eps) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                              torch.Tensor, torch.Tensor]:
        fakes, atts, mu, logvar = self.forward_nchw(z, sent_emb, word_embs, pad_mask, eps)
        fakes = [f.permute(0, 2, 3, 1).contiguous() for f in fakes]
        return fakes, atts, mu, logvar


class GNet(_Generator):
    """Tree generator (G_NET / G_NET_MIX).  In train mode its BatchNorms
    normalize by batch statistics and move their running statistics as flax
    does; in eval mode they use the running statistics.

    forward(z, sent_emb, word_embs, pad_mask, eps):
      z:         (B, Z) noise, or (2, B, Z) with ``style_mixing``.
      sent_emb:  (B, nef); word_embs (B, T, nef); pad_mask (B, T) bool.
      eps:       (B, condition_dim) CA-net noise.
    Returns (images [(B, S, S, 3)], maps [(B, H, W, T)], mu, logvar).
    ``dtype`` is the compute dtype (see the module's docstring).
    :meth:`forward_nchw` returns the images as (B, 3, S, S), as the
    discriminators take them.
    """

    def __init__(self, gf_dim: int, nef: int, z_dim: int, condition_dim: int,
                 w_dim: int, branch_num: int = 3, num_residual: int = 2,
                 mapping_layers: int = 6, z_concat: bool = True,
                 style_mixing: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        if not 1 <= branch_num <= 3:
            raise ValueError(f"branch_num must be 1..3, got {branch_num}")
        ngf = gf_dim
        self.branch_num = branch_num
        self.style_mixing = style_mixing
        self.z_concat = z_concat
        self.ca_net = CANet(nef, condition_dim)
        self.mapping_net = MappingNet(z_dim, w_dim, mapping_layers)
        in_dim = condition_dim + z_dim if z_concat else condition_dim
        self.h_net1 = InitStageG(ngf * 16, in_dim)
        self.img_net1 = GetImageG(ngf)
        if branch_num > 1:
            self.h_net2 = NextStageG(ngf, nef, w_dim, num_residual)
            self.img_net2 = GetImageG(ngf)
        if branch_num > 2:
            self.h_net3 = NextStageG(ngf, nef, w_dim, num_residual)
            self.img_net3 = GetImageG(ngf)
        set_compute_dtype(self, dtype)

    def forward_nchw(self, z, sent_emb, word_embs, pad_mask: Optional[torch.Tensor],
                     eps) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                                   torch.Tensor, torch.Tensor]:
        c_code, mu, logvar = self.ca_net(sent_emb, eps)
        if self.style_mixing:
            w_code2, w_code3 = self.mapping_net(z[0]), self.mapping_net(z[1])
            z0 = z[0]
        else:
            w_code2 = w_code3 = self.mapping_net(z)
            z0 = z
        x = torch.cat([c_code, z0], dim=1) if self.z_concat else c_code
        h = self.h_net1(x)
        fakes = [self.img_net1(h)]
        atts = []
        for j, w_code in ((2, w_code2), (3, w_code3))[: self.branch_num - 1]:
            h, att = getattr(self, f"h_net{j}")(h, w_code, word_embs, pad_mask)
            fakes.append(getattr(self, f"img_net{j}")(h))
            atts.append(att)
        return fakes, atts, mu, logvar


class GDCGAN(_Generator):
    """Single-image generator (G_DCGAN, ``GAN.B_DCGAN``): CA net, mapping
    net, :class:`InitStageG`, up to two :class:`NextStageG` and one
    :class:`GetImageG` on the last stage's features.  Every refinement stage
    takes the same w code, which its AdaIN applies before the residual
    blocks, so the mapping net shapes the image (and takes a gradient) at
    any ``num_residual``, 0 included.  (The JAX package's comment at
    ``sba_gan_tpu/models/generator.py:249-252`` says w is unused at R_NUM 0;
    its code, which this follows, applies it.)

    forward(z, sent_emb, word_embs, pad_mask, eps) as :class:`GNet`'s with
    z (B, Z); returns ([image (B, S, S, 3)], maps [(B, H, W, T)], mu,
    logvar), S = 64 * 2 ** (branch_num - 1).
    """

    def __init__(self, gf_dim: int, nef: int, z_dim: int, condition_dim: int,
                 w_dim: int, branch_num: int = 3, num_residual: int = 2,
                 mapping_layers: int = 6, z_concat: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if not 1 <= branch_num <= 3:
            raise ValueError(f"branch_num must be 1..3, got {branch_num}")
        ngf = gf_dim
        self.branch_num = branch_num
        self.z_concat = z_concat
        self.ca_net = CANet(nef, condition_dim)
        self.mapping_net = MappingNet(z_dim, w_dim, mapping_layers)
        in_dim = condition_dim + z_dim if z_concat else condition_dim
        self.h_net1 = InitStageG(ngf * 16, in_dim)
        for j in range(2, branch_num + 1):
            setattr(self, f"h_net{j}", NextStageG(ngf, nef, w_dim, num_residual))
        self.img_net = GetImageG(ngf)
        set_compute_dtype(self, dtype)

    def forward_nchw(self, z, sent_emb, word_embs, pad_mask: Optional[torch.Tensor],
                     eps) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                                   torch.Tensor, torch.Tensor]:
        c_code, mu, logvar = self.ca_net(sent_emb, eps)
        w_code = self.mapping_net(z)
        h = self.h_net1(torch.cat([c_code, z], dim=1) if self.z_concat else c_code)
        atts = []
        for j in range(2, self.branch_num + 1):
            h, att = getattr(self, f"h_net{j}")(h, w_code, word_embs, pad_mask)
            atts.append(att)
        return [self.img_net(h)], atts, mu, logvar


def build_generator(cfg) -> nn.Module:
    """The generator ``cfg`` describes, computing in ``JAX.DTYPE``:
    :class:`GDCGAN` under ``GAN.B_DCGAN``, else :class:`GNet`."""
    common = dict(
        gf_dim=cfg.GAN.GF_DIM,
        nef=cfg.TEXT.EMBEDDING_DIM,
        z_dim=cfg.GAN.Z_DIM,
        condition_dim=cfg.GAN.CONDITION_DIM,
        w_dim=cfg.GAN.W_DIM,
        branch_num=cfg.TREE.BRANCH_NUM,
        num_residual=cfg.GAN.R_NUM,
        mapping_layers=cfg.GAN.M_NUM,
        z_concat=cfg.GAN.INIT_Z_CONCAT,
        dtype=compute_dtype(cfg),
    )
    if cfg.GAN.B_DCGAN:
        return GDCGAN(**common)
    return GNet(style_mixing=cfg.TRAIN.MIXING, **common)
