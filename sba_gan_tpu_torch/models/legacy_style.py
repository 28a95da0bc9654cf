"""Pieces of the JAX package's legacy StyleGAN stacks (its
``models/legacy_style.py``) that the port's gen-2 generator uses.

* :class:`PixelNorm`: x * rsqrt(mean(x^2) + eps) over one dimension, its
  arithmetic in at least float32 and the result in the input's dtype (the
  JAX module's axis -1 is the channel axis of its NHWC maps; in the port's
  NCHW maps that is ``dim=1``).
"""

from __future__ import annotations

import torch
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
