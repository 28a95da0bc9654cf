"""Per-scale discriminators, NCHW (the JAX package's ``models/discriminator.py``).

``DNet64/128/256`` encode an image (B, 3, S, S) to a (B, 8 ndf, 4, 4) code;
two logit heads (:class:`DGetLogits`) score it, conditioned on the sentence
(``cond_logits``) or not (``uncond_logits``).  Heads return raw logits,
(B,) float32; the losses take BCE from logits.

Submodule names are the reference D_NET state-dict keys (``img_code_s16``,
``img_code_s32``, ``img_code_s32_1``, ``img_code_s64``, ``img_code_s64_1``,
``img_code_s64_2``, ``COND_DNET.jointConv``, ``COND_DNET.outlogits``,
``UNCOND_DNET.outlogits``), so :func:`utils.weights.d_net_state_dict` maps
every Flax path to one key.

Each takes ``dtype``, the compute dtype of its convolutions (float32 or
bfloat16, the JAX package's ``dtype=``; the parameters stay float32); the
logits come out float32 either way.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from sba_gan_tpu_torch.config import compute_dtype
from sba_gan_tpu_torch.models.blocks import block3x3_leak_relu, down_block, encode_by_16
from sba_gan_tpu_torch.models.layers import Conv2d, set_compute_dtype


class DGetLogits(nn.Module):
    """Logit head.  Conditioned, the sentence (B, nef) is tiled over the
    4 x 4 code, concatenated after its channels and mixed by a 3 x 3 block;
    then a 4 x 4 stride-4 conv with bias gives one logit per image."""

    def __init__(self, ndf: int, nef: int, bcondition: bool = False):
        super().__init__()
        self.bcondition = bcondition
        if bcondition:
            self.jointConv = block3x3_leak_relu(ndf * 8 + nef, ndf * 8)
        self.outlogits = nn.Sequential(Conv2d(ndf * 8, 1, 4, stride=4))

    def forward(self, h_code: torch.Tensor, c_code: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        if self.bcondition:
            b, _, sh, sw = h_code.shape
            c = c_code.to(h_code.dtype)[:, :, None, None].expand(b, c_code.shape[1], sh, sw)
            h_code = self.jointConv(torch.cat([h_code, c], dim=1))
        return self.outlogits(h_code).reshape(-1).float()


class _DNet(nn.Module):
    """Backbone ``img_code_s16`` plus the blocks a subclass adds, and the
    two heads (no ``UNCOND_DNET`` without ``b_jcu``)."""

    stages: List[str] = []

    def __init__(self, ndf: int, nef: int, b_jcu: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.img_code_s16 = encode_by_16(ndf)
        self.COND_DNET = DGetLogits(ndf, nef, bcondition=True)
        self.UNCOND_DNET = DGetLogits(ndf, nef, bcondition=False) if b_jcu else None
        for name, (cin, cout, block) in self._blocks(ndf).items():
            setattr(self, name, block(cin, cout))
        set_compute_dtype(self, dtype)

    @staticmethod
    def _blocks(ndf: int) -> dict:
        """{name: (cin, cout, block)} of the blocks past the backbone."""
        return {}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.img_code_s16(x)
        for name in self.stages:
            h = getattr(self, name)(h)
        return h

    def cond_logits(self, h: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        return self.COND_DNET(h, c)

    def uncond_logits(self, h: torch.Tensor) -> torch.Tensor:
        if self.UNCOND_DNET is None:
            raise ValueError("this discriminator has no unconditional head")
        return self.UNCOND_DNET(h)


class DNet64(_DNet):
    """64 x 64: encode / 16."""


class DNet128(_DNet):
    """128 x 128: encode / 16, a down block, a 3 x 3 block back to 8 ndf."""

    stages = ["img_code_s32", "img_code_s32_1"]

    @staticmethod
    def _blocks(ndf: int) -> dict:
        return {"img_code_s32": (ndf * 8, ndf * 16, down_block),
                "img_code_s32_1": (ndf * 16, ndf * 8, block3x3_leak_relu)}


class DNet256(_DNet):
    """256 x 256: encode / 16, two down blocks, two 3 x 3 blocks back to 8 ndf."""

    stages = ["img_code_s32", "img_code_s64", "img_code_s64_1", "img_code_s64_2"]

    @staticmethod
    def _blocks(ndf: int) -> dict:
        return {"img_code_s32": (ndf * 8, ndf * 16, down_block),
                "img_code_s64": (ndf * 16, ndf * 32, down_block),
                "img_code_s64_1": (ndf * 32, ndf * 16, block3x3_leak_relu),
                "img_code_s64_2": (ndf * 16, ndf * 8, block3x3_leak_relu)}


def build_discriminators(cfg) -> List[_DNet]:
    """One discriminator per branch, computing in ``JAX.DTYPE`` (GDCGAN's
    single one is not ported yet)."""
    if cfg.GAN.B_DCGAN:
        raise NotImplementedError(
            "GAN.B_DCGAN (G_DCGAN and its one discriminator) is not ported yet "
            "(ROADMAP.md, queue 1, item 1)")
    ndf, nef = cfg.GAN.DF_DIM, cfg.TEXT.EMBEDDING_DIM
    klass = (DNet64, DNet128, DNet256)
    return [klass[i](ndf, nef, dtype=compute_dtype(cfg)) for i in range(cfg.TREE.BRANCH_NUM)]
