"""Device selection for the port's entry points.

Every entry point takes ``device=``, defaulting to ``"cuda"``.  Asking for
CUDA on a machine without it raises; only an explicit ``device="cpu"``
runs on the CPU.  There is no silent fallback.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} was asked for but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
