"""sba_gan_tpu_torch — the PyTorch/CUDA port of sba_gan_tpu for one NVIDIA H100.

It mirrors the JAX package's module paths and keeps its public layouts
(word embeddings (B, T, D), images (B, S, S, 3), attention maps
(B, H, W, T)); inside, tensors are NCHW.  The port imports nothing of JAX
or of the JAX package.  Its entry points run on CUDA unless the caller
passes ``device="cpu"``; each TPU kernel on the ported path is a CUDA
kernel written by hand (``ops/csrc``), with a plain PyTorch version that
serves CPU tensors.
"""

__version__ = "0.1.0"

from sba_gan_tpu_torch.config import (
    ConfigDict,
    cfg_from_dict,
    cfg_from_file,
    default_config,
    preset,
)

__all__ = ["ConfigDict", "cfg_from_dict", "cfg_from_file", "default_config",
           "preset"]
