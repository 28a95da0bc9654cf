"""Gen-2 conditional StyleGAN (the JAX package's ``models/gen2.py``), NCHW.

A fixed ladder of StyleGAN blocks from a learned 4 x 4 constant up to
``resolution``, conditioned on a frozen BERT tower: the pooled text code
goes through a conditioning-augmentation net and, with z, through a
mapping net to one w code, broadcast (and optionally truncated) to every
layer's epilogue; a resolution-mirrored discriminator whose feature map
feeds an unconditional and a sentence-conditioned head; an Inception-v3
image encoder for the BCE mode's sentence loss.

Modules and parameters carry the JAX package's names (``bert_embedding``,
``ca_net.fc``, ``mapping.fc_0`` ... ``const``, ``bias``, ``adaIN1``,
``conv``, ``adaIN2``, ``block_0`` ... ``torgb``; ``backbone.fromrgb``,
``backbone.block_0.down_conv``, ``uncond.fc``, ``cond.intermediate``), so
:func:`utils.weights.gen2_state_from_jax` maps the Flax trees by path.
The arithmetic is the JAX package's:

* leaky ReLU 0.2 everywhere; the epilogue is noise -> leaky -> [pixel
  norm over channels] -> [instance norm, eps 1e-8] -> style modulation
  x (s0 + 1) + s1, the style a Linear of w (and of the attention code)
  through a leaky ReLU;
* the attention style: a bias-free projection of the 768-wide BERT words
  to C, softmax over the words per pixel (float32), the context map, a
  bias-free 1 x 1 to one channel, flattened in (h, w) row order into a
  Linear of H W -> A (no pad mask, as the reference);
* a block doubles its size by the align-corners bilinear resize where the
  channel count stays, else by a 4 x 4 / 2 transposed convolution with
  padding 1 (the Flax 'SAME' transposed convolution with its kernel
  flipped in space: the weight map flips it);
* the mapping net is ``M_LAYERS`` linears with biases and no nonlinearity
  between them; the to-RGB 1 x 1 has no tanh;
* a D block is conv 3 x 3 + leaky, then a 2 x 2 average pool where the
  channel count stays, else a 2 x 2 / 2 convolution, + leaky; the
  conditional head concatenates [h, sentence] on channels before its
  bias-free 1 x 1 and leaky, both heads average over H, W and end in a
  Linear to one logit.

The random draws (z, the CA's epsilon, the noise maps of the epilogues)
are arguments: :meth:`Gen2Generator.draw` makes them from a
``torch.Generator``, and the tests inject the JAX package's.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sba_gan_tpu_torch.models.blocks import instance_norm_2d
from sba_gan_tpu_torch.models.inception import InceptionV3, resize_bilinear_align_corners
from sba_gan_tpu_torch.models.legacy_style import PixelNorm
from sba_gan_tpu_torch.models.norms import promote
from sba_gan_tpu_torch.models.text_bert import BERT_BASE, BertModel


def nf(res_log2: int, fmap_base: int = 4096, fmap_decay: float = 1.0,
       fmap_max: int = 256) -> int:
    """Feature maps at a resolution rung."""
    return min(int(fmap_base / (2.0 ** (res_log2 * fmap_decay))), fmap_max)


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, 2H, 2W), bilinear with corners aligned (the
    Inception resize, through NHWC)."""
    _, _, h, w = x.shape
    y = resize_bilinear_align_corners(x.permute(0, 2, 3, 1), (h * 2, w * 2))
    return y.permute(0, 3, 1, 2)


class Gen2ApplyNoise(nn.Module):
    """x + weight[c] * noise, one (B, 1, H, W) map for all channels."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        return x + self.weight.to(x.dtype)[None, :, None, None] * noise.to(x.dtype)


class Gen2AttentionStyle(nn.Module):
    """h (B, C, H, W) attends over the words (B, T, word_dim) -> (B, A)."""

    def __init__(self, channels: int, resolution: int, word_dim: int, a_dim: int):
        super().__init__()
        self.conv_context = nn.Linear(word_dim, channels, bias=False)
        self.conv = nn.Linear(channels, 1, bias=False)
        self.att_fc = nn.Linear(resolution * resolution, a_dim)

    def forward(self, h: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
        b, c, ih, iw = h.shape
        source = self.conv_context(words.to(h.dtype))  # (B, T, C)
        target = h.reshape(b, c, ih * iw).transpose(1, 2)  # (B, HW, C), row order
        attn = torch.bmm(target, source.transpose(1, 2))
        attn = torch.softmax(promote(attn), dim=-1).to(h.dtype)
        ctx = self.conv(torch.bmm(attn, source))  # (B, HW, 1)
        return self.att_fc(ctx.reshape(b, ih * iw))


class Gen2ApplyStyle(nn.Module):
    """x (s0 + 1) + s1 with (s0, s1) = leaky(fc(w)), or of [attention, w]."""

    def __init__(self, channels: int, resolution: int, w_dim: int, a_dim: int,
                 word_dim: int, use_attn: bool):
        super().__init__()
        self.attn = (Gen2AttentionStyle(channels, resolution, word_dim, a_dim)
                     if use_attn else None)
        self.fc = nn.Linear(w_dim + (a_dim if use_attn else 0), channels * 2)

    def forward(self, x: torch.Tensor, w_code: torch.Tensor, words: torch.Tensor
                ) -> torch.Tensor:
        c = x.shape[1]
        style_in = w_code
        if self.attn is not None:
            code = self.attn(x, words)
            style_in = torch.cat([code, w_code.to(code.dtype)], dim=-1)
        style = _leaky(self.fc(style_in))
        scale, shift = style[:, :c, None, None], style[:, c:, None, None]
        return x * (scale + 1.0) + shift


class LayerEpilogue(nn.Module):
    """noise -> leaky -> [pixel norm] -> [instance norm, eps 1e-8] -> style."""

    def __init__(self, channels: int, resolution: int, w_dim: int, a_dim: int,
                 word_dim: int, use_attn: bool = True, use_noise: bool = True,
                 use_pixel_norm: bool = False, use_instance_norm: bool = True):
        super().__init__()
        self.apply_noise = Gen2ApplyNoise(channels) if use_noise else None
        self.pixel_norm = PixelNorm(dim=1) if use_pixel_norm else None
        self.use_instance_norm = use_instance_norm
        self.apply_style = Gen2ApplyStyle(channels, resolution, w_dim, a_dim, word_dim,
                                          use_attn)

    def forward(self, x, w_code, words, noise: Optional[torch.Tensor]) -> torch.Tensor:
        if self.apply_noise is not None:
            x = self.apply_noise(x, noise)
        x = _leaky(x)
        if self.pixel_norm is not None:
            x = self.pixel_norm(x)
        if self.use_instance_norm:
            x = instance_norm_2d(x, eps=1e-8)
        return self.apply_style(x, w_code, words)


class Gen2GBlock(nn.Module):
    """Double the size, then two (epilogue, conv) pairs at ``resolution``."""

    def __init__(self, resolution: int, w_dim: int, a_dim: int, word_dim: int,
                 fmap_base: int = 4096, fmap_max: int = 256, **toggles):
        super().__init__()
        log2 = int(math.log2(resolution))
        channels = nf(log2, fmap_base, fmap_max=fmap_max)
        cin = nf(log2 - 1, fmap_base, fmap_max=fmap_max)
        self.up_conv = (None if cin == channels else
                        nn.ConvTranspose2d(cin, channels, 4, stride=2, padding=1))
        kw = dict(channels=channels, resolution=resolution, w_dim=w_dim, a_dim=a_dim,
                  word_dim=word_dim, **toggles)
        self.adaIN1 = LayerEpilogue(**kw)
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.adaIN2 = LayerEpilogue(**kw)

    def forward(self, x, w_pair, words, noise: Sequence[Optional[torch.Tensor]]):
        x = upsample2x(x) if self.up_conv is None else self.up_conv(x)
        x = self.adaIN1(x, w_pair[:, 0], words, noise[0])
        x = self.conv(x)
        return self.adaIN2(x, w_pair[:, 1], words, noise[1])


class Gen2TextEncoder(nn.Module):
    """BERT (frozen by the trainer) and ``fc``: pooled -> e_dim.  Returns
    (words (B, T, hidden), sentence (B, e_dim)), in at least float32; the
    words are not zeroed at padding (as the JAX module)."""

    def __init__(self, e_dim: int = 128, bert_cfg: Optional[Dict] = None):
        super().__init__()
        self.cfg = dict(bert_cfg or BERT_BASE)
        self.bert = BertModel(self.cfg)
        self.fc = nn.Linear(self.cfg["hidden_size"], e_dim)

    def forward(self, tokens: torch.Tensor):
        mask = (tokens != 0).to(torch.int32)
        hidden, pooled = self.bert(tokens, mask, self.fc.weight.dtype)
        return hidden, self.fc(pooled)


class Gen2CANet(nn.Module):
    """fc(e -> 4c), GLU, (mu, logvar), c = mu + eps exp(logvar / 2)."""

    def __init__(self, e_dim: int = 128, c_dim: int = 128):
        super().__init__()
        self.c_dim = c_dim
        self.fc = nn.Linear(e_dim, c_dim * 4)

    def forward(self, sent: torch.Tensor, eps: torch.Tensor):
        a, b = self.fc(sent).chunk(2, dim=-1)
        x = a * torch.sigmoid(b)
        mu, logvar = x[:, :self.c_dim], x[:, self.c_dim:]
        std = torch.exp(0.5 * logvar)
        return mu + eps.to(mu.dtype) * std, mu, logvar


class Gen2Mapping(nn.Module):
    """[pixel norm of z], concat(c, z), ``num_layers`` linears in a row."""

    def __init__(self, in_dim: int, w_dim: int = 256, num_layers: int = 8,
                 use_norm: bool = True):
        super().__init__()
        self.pixel_norm = PixelNorm() if use_norm else None
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"fc_{i}", nn.Linear(in_dim if i == 0 else w_dim, w_dim))

    def forward(self, c_code: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        if self.pixel_norm is not None:
            z = self.pixel_norm(z)
        w = torch.cat([c_code, z.to(c_code.dtype)], dim=-1)
        for i in range(self.num_layers):
            w = getattr(self, f"fc_{i}")(w)
        return w


class Gen2Generator(nn.Module):
    """forward(tokens (B, T), z (B, Z), eps (B, C), noise) -> (image (B, 3,
    R, R), words, sentence, mu, logvar); ``noise`` lists one (B, 1, H, W)
    map per epilogue (top two first, then two a block), or is None when the
    epilogues take none."""

    def __init__(self, resolution: int = 128, resolution_init: int = 4, e_dim: int = 128,
                 c_dim: int = 128, z_dim: int = 128, w_dim: int = 256, a_dim: int = 256,
                 m_layers: int = 8, m_use_norm: bool = True, use_attn: bool = False,
                 use_noise: bool = False, use_pixel_norm: bool = False,
                 use_instance_norm: bool = True, use_truncation: bool = False,
                 truncation_psi: float = 0.7, truncation_cutoff: int = 8,
                 fmap_base: int = 4096, fmap_max: int = 256,
                 bert_cfg: Optional[Dict] = None):
        super().__init__()
        log2, log2_init = int(math.log2(resolution)), int(math.log2(resolution_init))
        self.num_layers = (log2 - log2_init + 1) * 2
        self.resolution_init = resolution_init
        self.z_dim, self.c_dim = z_dim, c_dim
        self.use_noise = use_noise
        self.use_truncation = use_truncation
        self.truncation_psi, self.truncation_cutoff = truncation_psi, truncation_cutoff
        c_init = nf(log2_init, fmap_base, fmap_max=fmap_max)

        self.bert_embedding = Gen2TextEncoder(e_dim, bert_cfg)
        word_dim = self.bert_embedding.cfg["hidden_size"]
        self.ca_net = Gen2CANet(e_dim, c_dim)
        self.mapping = Gen2Mapping(c_dim + z_dim, w_dim, m_layers, m_use_norm)
        self.const = nn.Parameter(torch.ones(1, c_init, resolution_init, resolution_init))
        self.bias = nn.Parameter(torch.ones(c_init))
        toggles = dict(use_attn=use_attn, use_noise=use_noise,
                       use_pixel_norm=use_pixel_norm, use_instance_norm=use_instance_norm)
        kw = dict(w_dim=w_dim, a_dim=a_dim, word_dim=word_dim, **toggles)
        self.adaIN1 = LayerEpilogue(c_init, resolution_init, **kw)
        self.conv = nn.Conv2d(c_init, c_init, 3, padding=1)
        self.adaIN2 = LayerEpilogue(c_init, resolution_init, **kw)
        self.rungs = list(range(log2_init + 1, log2 + 1))
        for i, rung in enumerate(self.rungs):
            setattr(self, f"block_{i}", Gen2GBlock(2 ** rung, fmap_base=fmap_base,
                                                   fmap_max=fmap_max, **kw))
        self.torgb = nn.Conv2d(nf(log2, fmap_base, fmap_max=fmap_max), 3, 1)

    def noise_sizes(self) -> List[int]:
        """The side of each epilogue's noise map, in the order of ``noise``."""
        sizes = [self.resolution_init] * 2
        for rung in self.rungs:
            sizes += [2 ** rung] * 2
        return sizes

    def draw(self, batch: int, generator: torch.Generator) -> Dict[str, object]:
        """z, the CA's epsilon and the noise maps (None without noise) of one
        call, drawn on the CPU from ``generator`` in that order."""
        z = torch.randn((batch, self.z_dim), generator=generator)
        eps = torch.randn((batch, self.c_dim), generator=generator)
        noise = ([torch.randn((batch, 1, s, s), generator=generator)
                  for s in self.noise_sizes()] if self.use_noise else None)
        return {"z": z, "eps": eps, "noise": noise}

    def forward(self, tokens: torch.Tensor, z: torch.Tensor, eps: torch.Tensor,
                noise: Optional[Sequence[torch.Tensor]] = None):
        if noise is None:
            if self.use_noise:
                raise ValueError("USE_NOISE needs a noise map per epilogue")
            noise = [None] * self.num_layers
        words, sent = self.bert_embedding(tokens)
        c_code, mu, logvar = self.ca_net(sent, eps)
        w = self.mapping(c_code, z)
        w = w[:, None, :].expand(w.shape[0], self.num_layers, w.shape[1])
        if self.use_truncation:
            coefs = torch.where(torch.arange(self.num_layers, device=w.device)
                                < self.truncation_cutoff, self.truncation_psi, 1.0)
            w = w * coefs[None, :, None].to(w.dtype)
        x = _leaky((self.const + self.bias[None, :, None, None]).expand(
            tokens.shape[0], -1, -1, -1))
        x = self.adaIN1(x, w[:, 0], words, noise[0])
        x = self.conv(x)
        x = self.adaIN2(x, w[:, 1], words, noise[1])
        for i in range(len(self.rungs)):
            lo = 2 * i + 2
            x = getattr(self, f"block_{i}")(x, w[:, lo:lo + 2], words, noise[lo:lo + 2])
        return self.torgb(x), words, sent, mu, logvar


class Gen2DBlock(nn.Module):
    def __init__(self, resolution: int, fmap_base: int = 4096, fmap_max: int = 256):
        super().__init__()
        log2 = int(math.log2(resolution))
        channels = nf(log2, fmap_base, fmap_max=fmap_max)
        down = nf(log2 - 1, fmap_base, fmap_max=fmap_max)
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.down_conv = None if down == channels else nn.Conv2d(channels, down, 2, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _leaky(self.conv(x))
        x = F.avg_pool2d(x, 2) if self.down_conv is None else self.down_conv(x)
        return _leaky(x)


class Gen2DOutput(nn.Module):
    """[concat(h, sentence) -> bias-free 1 x 1 -> leaky], mean over H, W,
    Linear -> one logit (the BCE losses take logits)."""

    def __init__(self, channels: int, e_dim: int, condition: bool = True):
        super().__init__()
        self.intermediate = (nn.Conv2d(channels + e_dim, channels, 1, bias=False)
                             if condition else None)
        self.fc = nn.Linear(channels, 1)

    def forward(self, h: torch.Tensor, c_code: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.intermediate is not None and c_code is not None:
            b, _, ih, iw = h.shape
            c = c_code[:, :, None, None].to(h.dtype).expand(b, -1, ih, iw)
            h = _leaky(self.intermediate(torch.cat([h, c], dim=1)))
        return self.fc(h.mean(dim=(2, 3)))


class Gen2Discriminator(nn.Module):
    """from-RGB 1 x 1 + leaky, then D blocks from ``resolution`` down to
    ``resolution_init``; returns the feature map (B, C, R0, R0)."""

    def __init__(self, resolution: int = 128, resolution_init: int = 4,
                 fmap_base: int = 4096, fmap_max: int = 256):
        super().__init__()
        log2, log2_init = int(math.log2(resolution)), int(math.log2(resolution_init))
        self.fromrgb = nn.Conv2d(3, nf(log2, fmap_base, fmap_max=fmap_max), 1)
        self.num_blocks = log2 - log2_init
        for i, rung in enumerate(range(log2, log2_init, -1)):
            setattr(self, f"block_{i}", Gen2DBlock(2 ** rung, fmap_base, fmap_max))
        self.channels = nf(log2_init, fmap_base, fmap_max=fmap_max)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = _leaky(self.fromrgb(img))
        for i in range(self.num_blocks):
            x = getattr(self, f"block_{i}")(x)
        return x


class Gen2ImageEncoder(InceptionV3):
    """The Inception-v3 trunk (always on its running statistics: eval mode
    whatever ``train()`` asks) and ``fc``: pooled 2048 -> e_dim.
    forward(images (B, 3, S, S)) -> (B, e_dim), resized to ``input_size``
    with the align-corners bilinear map where S differs."""

    def __init__(self, e_dim: int = 128, input_size: int = 299):
        super().__init__(input_size)
        self.fc = nn.Linear(2048, e_dim)
        self.train(False)

    def train(self, mode: bool = True) -> "Gen2ImageEncoder":
        return super().train(False)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.fc(self.taps(images.permute(0, 2, 3, 1))[1])


def gen2_trainable(name: str) -> bool:
    """Whether a :class:`Gen2Generator` parameter trains: all but the BERT
    tower (``bert_embedding.fc`` trains)."""
    return not name.startswith("bert_embedding.bert.")


def gen2_image_encoder_trainable(name: str) -> bool:
    """Only the image encoder's ``fc`` trains."""
    return name.startswith("fc.")
