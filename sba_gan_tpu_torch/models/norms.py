"""BatchNorm with flax's train-mode statistics, for G, D and Inception.

The JAX package's ``BatchNorm`` (``models/blocks.py``) is flax's
``nn.BatchNorm`` with momentum 0.9: in train mode it normalizes by the
batch mean and the *biased* fast variance E[x^2] - E[x]^2 (clipped at 0),
and moves the running statistics as ``new = 0.9 old + 0.1 batch`` with that
same biased variance.  Torch's ``BatchNorm2d`` would move ``running_var``
with the unbiased estimate instead.  :class:`BatchNorm` is a ``_BatchNorm``
subclass, so its state-dict keys (``weight``, ``bias``, ``running_mean``,
``running_var``, ``num_batches_tracked``) and every ``isinstance`` check on
``_BatchNorm`` stay as they were.  It takes ``(B, F)`` and ``(B, C, H, W)``
and reduces over every dim but 1.

:func:`frozen_running_stats` normalizes by batch statistics without moving
the running buffers, for the passes of the G loss through the
discriminators, whose running-statistic updates the JAX step drops.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """Flax-statistics BatchNorm over dim 1 of a 2-D or 4-D input."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__(num_features, eps=eps)
        self.flax_momentum = momentum
        self.update_stats = True

    def _check_input_dim(self, x: torch.Tensor) -> None:
        if x.dim() not in (2, 4):
            raise ValueError(f"BatchNorm takes (B, F) or (B, C, H, W), got {tuple(x.shape)}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(x)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        dims = [0] + list(range(2, x.dim()))
        mean = x.mean(dim=dims)
        var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
        if self.update_stats:
            with torch.no_grad():
                m = self.flax_momentum
                self.running_mean.mul_(m).add_((1.0 - m) * mean)
                self.running_var.mul_(m).add_((1.0 - m) * var)
                self.num_batches_tracked.add_(1)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        scale = torch.rsqrt(var + self.eps) * self.weight
        return torch.addcmul(self.bias.view(shape), x - mean.view(shape),
                             scale.view(shape))


@contextlib.contextmanager
def frozen_running_stats(*modules: nn.Module) -> Iterator[None]:
    """Within the block, every :class:`BatchNorm` under ``modules`` still
    normalizes by batch statistics in train mode but leaves its running
    buffers as they are."""
    norms = [m for module in modules for m in module.modules()
             if isinstance(m, BatchNorm)]
    before = [m.update_stats for m in norms]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m, flag in zip(norms, before):
            m.update_stats = flag
