"""Text -> image inference: captions -> three images and two attention maps.

The port's counterpart of the JAX package's ``make_sample_fn`` and its
``with_noise`` variant.  The generator holds the EMA weights (a JAX train
state carries them as ``g_ema``), runs in eval mode under
``torch.inference_mode()``, and ``pad_mask = captions == 0``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from sba_gan_tpu_torch.config import compute_dtype
from sba_gan_tpu_torch.models.blocks import init_weights
from sba_gan_tpu_torch.models.generator import GNet, build_generator
from sba_gan_tpu_torch.models.text_rnn import RNNEncoder
from sba_gan_tpu_torch.models.text_rnn import init_weights as init_text_weights
from sba_gan_tpu_torch.utils import weights as W
from sba_gan_tpu_torch.utils.platform import resolve_device


def noise_shape(cfg, batch: int) -> Tuple[int, ...]:
    if cfg.TRAIN.MIXING:
        return (2, batch, cfg.GAN.Z_DIM)
    return (batch, cfg.GAN.Z_DIM)


def build_text_encoder(cfg, n_words: int) -> RNNEncoder:
    if cfg.MODEL.TEXT_ENCODER != "rnn":
        raise NotImplementedError(
            f"MODEL.TEXT_ENCODER={cfg.MODEL.TEXT_ENCODER!r} is not ported yet")
    return RNNEncoder(ntoken=n_words, nhidden=cfg.TEXT.EMBEDDING_DIM,
                      rnn_type=cfg.RNN_TYPE, dtype=compute_dtype(cfg))


class Sampler:
    """``sampler(captions, cap_lens, seed)`` or
    ``sampler.with_noise(captions, cap_lens, z, eps)`` -> (fakes, atts) as
    CPU numpy arrays: fakes[i] (B, S_i, S_i, 3) in [-1, 1], atts[j]
    (B, H_j, W_j, T).  ``launch`` returns the same as tensors on the device,
    without waiting for them."""

    def __init__(self, cfg, generator: GNet, text_encoder: RNNEncoder,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.generator = generator.to(self.device).eval()
        self.text_encoder = text_encoder.to(self.device).eval()

    @classmethod
    def from_config(cls, cfg, n_words: int, seed: int = 0,
                    weights: Optional[str] = None, device="cuda") -> "Sampler":
        """Models of ``cfg``: random weights made from ``seed``, or the
        weights of an ``.npz`` file (see :mod:`utils.weights`), computing in
        ``JAX.DTYPE``."""
        dev = resolve_device(device)
        generator = build_generator(cfg)
        text_encoder = build_text_encoder(cfg, n_words)
        if weights is None:
            gen = torch.Generator().manual_seed(seed)
            init_weights(generator, gen)
            init_text_weights(text_encoder, gen)
        else:
            g_params, g_stats, text_params = W.read_npz(weights)
            generator.load_state_dict(W.g_net_state_dict(g_params, g_stats))
            text_encoder.load_state_dict(W.rnn_encoder_state_dict(text_params))
        return cls(cfg, generator, text_encoder, device=dev)

    def draw_noise(self, batch: int, seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(z, eps) from a CPU generator seeded with ``seed`` (the same
        numbers whatever the device)."""
        gen = torch.Generator().manual_seed(int(seed))
        z = torch.randn(noise_shape(self.cfg, batch), generator=gen)
        eps = torch.randn((batch, self.cfg.GAN.CONDITION_DIM), generator=gen)
        return z, eps

    def _tensor(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(self.device)

    def launch_with_noise(self, captions, cap_lens, z, eps
                          ) -> Tuple[Sequence[torch.Tensor], Sequence[torch.Tensor]]:
        captions = self._tensor(captions, torch.long)
        cap_lens = torch.as_tensor(np.asarray(cap_lens), dtype=torch.long)
        z = self._tensor(z, torch.float32)
        eps = self._tensor(eps, torch.float32)
        with torch.inference_mode():
            words_embs, sent_emb = self.text_encoder(captions, cap_lens)
            pad_mask = captions == 0
            fakes, atts, _, _ = self.generator(z, sent_emb, words_embs,
                                               pad_mask, eps)
        return tuple(fakes), tuple(atts)

    def launch(self, captions, cap_lens, seed: int):
        z, eps = self.draw_noise(len(captions), seed)
        return self.launch_with_noise(captions, cap_lens, z, eps)

    def with_noise(self, captions, cap_lens, z, eps):
        return fetch(self.launch_with_noise(captions, cap_lens, z, eps))

    def __call__(self, captions, cap_lens, seed: int):
        return fetch(self.launch(captions, cap_lens, seed))


def fetch(outputs) -> Tuple[list, list]:
    """(fakes, atts) tensors -> CPU numpy arrays, bfloat16 maps as float32;
    the copy waits for the device."""
    fakes, atts = outputs
    return ([f.cpu().numpy() for f in fakes],
            [(a.float() if a.dtype == torch.bfloat16 else a).cpu().numpy() for a in atts])
