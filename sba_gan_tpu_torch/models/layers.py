"""Convolutions and linears that compute in a given dtype, as flax's
``nn.Conv(dtype=...)`` and ``nn.Dense(dtype=...)`` do.

The parameters stay float32 (and the state dicts with them): under a
compute dtype of bfloat16 each call casts its input, its weight and its
bias to bfloat16 and returns bfloat16, and autograd casts the gradients
back to float32.  With no compute dtype set (the default, and what
float32 sets) the layer is ``nn.Conv2d`` / ``nn.Linear`` as it is, so
float32 and float64 modules compute exactly as before.

The model builders set the dtype on every such layer under a model with
:func:`set_compute_dtype`; the elementwise code between the layers runs in
whatever dtype its input has, and casts to float32 where the JAX package
does (BatchNorm's and the instance norm's statistics, the CA sample, the
image heads' tanh, the logits, the losses).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class Linear(nn.Linear):
    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Every :class:`Conv2d` and :class:`Linear` under ``module`` computes in
    ``dtype`` (float32 or bfloat16; float32 leaves them as they are).
    Returns ``module``."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype must be float32 or bfloat16, got {dtype}")
    for m in module.modules():
        if isinstance(m, (Conv2d, Linear)):
            m.compute_dtype = None if dtype == torch.float32 else dtype
    return module
