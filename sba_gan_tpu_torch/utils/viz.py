"""Attention-map visualization (the port's copy of the JAX package's
``build_super_images`` and ``build_super_images2``).  ``build_super_images``:
per sample a [caption band / smoothed raw maps / overlays] block; columns
are the image, the max-over-words map, then one map per word.  Maps are
bilinearly upsampled and gaussian-smoothed (sigma 20, reflect padding) and
min/max-normalized within the sample.  ``build_super_images2`` (gen_example):
per word a threshold-masked, individually normalized map, the ``top_k``
most confident words as [caption band / overlays].  Pure numpy + PIL on the
host."""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Optional, Sequence

import numpy as np
from PIL import Image, ImageDraw, ImageFont

from sba_gan_tpu_torch.utils.image import to_uint8

# per-word caption band colors
COLOR_DIC = {
    0: [128, 64, 128], 1: [244, 35, 232], 2: [70, 70, 70],
    3: [102, 102, 156], 4: [190, 153, 153], 5: [153, 153, 153],
    6: [250, 170, 30], 7: [220, 220, 0], 8: [107, 142, 35],
    9: [152, 251, 152], 10: [70, 130, 180], 11: [220, 20, 60],
    12: [255, 0, 0], 13: [0, 0, 142], 14: [119, 11, 32],
    15: [0, 60, 100], 16: [0, 80, 100], 17: [0, 0, 230],
    18: [0, 0, 70], 19: [0, 0, 0],
}
FONT_MAX = 50  # caption band height
PAD = 2
SMOOTH_SIGMA = 20.0


def _font(size: int = 30):
    try:
        return ImageFont.load_default(size=size)
    except TypeError:  # older PIL: fixed-size default
        return ImageFont.load_default()


@lru_cache(maxsize=16)
def _blur_operator(n: int, sigma: float) -> np.ndarray:
    """(n, n) linear operator = reflect-pad + 1-D gaussian, as a dense
    matrix, so a separable blur is two BLAS matmuls (K @ a @ K.T)."""
    radius = max(1, int(3.0 * sigma))
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    m = n + 2 * radius
    conv = np.zeros((n, m), np.float32)
    for i in range(n):
        conv[i, i: i + 2 * radius + 1] = k
    if radius >= n:
        # several reflections: take np.pad's own indices
        idx = np.pad(np.arange(n), radius, mode="reflect")
    else:
        idx = np.concatenate([
            np.arange(radius, 0, -1), np.arange(n),
            np.arange(n - 2, n - 2 - radius, -1),
        ])
    pad = np.zeros((m, n), np.float32)
    pad[np.arange(m), np.clip(idx, 0, n - 1)] = 1.0
    return conv @ pad


def _gaussian_blur_2d(a: np.ndarray, sigma: float) -> np.ndarray:
    if sigma <= 0:
        return a
    h, w = a.shape
    out = _blur_operator(h, float(sigma)) @ a.astype(np.float32)
    return out @ _blur_operator(w, float(sigma)).T


def _smooth_upsample(attn: np.ndarray, size: int,
                     sigma: float = SMOOTH_SIGMA) -> np.ndarray:
    """Upsample an (h, w) map to (size, size) and gaussian-smooth it."""
    h = attn.shape[0]
    up = np.asarray(
        Image.fromarray(attn.astype(np.float32), mode="F").resize(
            (size, size), Image.BILINEAR
        ),
        np.float32,
    )
    if size // max(h, 1) > 1:
        up = _gaussian_blur_2d(up, sigma)
    return up


def _overlay(img_u8: np.ndarray, map_u8: np.ndarray, alpha: int) -> np.ndarray:
    """Paste the grayscale map over the image through a constant-alpha mask."""
    im = Image.fromarray(img_u8)
    att = Image.fromarray(np.repeat(map_u8[..., None], 3, axis=2))
    merged = Image.new("RGBA", im.size, (0, 0, 0, 0))
    mask = Image.new("L", im.size, alpha)
    merged.paste(im, (0, 0))
    merged.paste(att, (0, 0), mask)
    return np.array(merged)[:, :, :3]


def _caption_band(labels, width: int, cell_w: int, first_col: int,
                  colored: bool = True) -> np.ndarray:
    """One FONT_MAX-tall band with the labels: per-word colored cells, or
    (``colored`` false) a near-black band."""
    band = np.ones((FONT_MAX, width, 3), np.uint8)
    if colored:
        band[:] = 255
        for j in range(len(labels)):
            x0 = (first_col + j) * cell_w
            band[:, x0: x0 + cell_w] = COLOR_DIC[j % len(COLOR_DIC)]
    im = Image.fromarray(band)
    d = ImageDraw.Draw(im)
    font = _font(30)
    for j, label in enumerate(labels):
        d.text(((first_col + j) * cell_w + 2, 8), label,
               font=font, fill=(255, 255, 255))
    return np.asarray(im, np.uint8)


def _resize_img(img: np.ndarray, size: int) -> np.ndarray:
    if img.shape[0] == size:
        return to_uint8(img)
    return np.asarray(
        Image.fromarray(to_uint8(img)).resize((size, size), Image.BILINEAR)
    )


def build_super_images(
    images: np.ndarray,
    captions: np.ndarray,
    ixtoword: Dict[int, str],
    attn_maps: np.ndarray,
    att_size: Optional[int] = None,
    max_word_num: int = 18,
    max_vis: int = 8,
) -> np.ndarray:
    """Compose the attention-grid image (uint8).

    images:    (B, H, W, 3) in [-1, 1], at the attention stage's resolution.
    captions:  (B, T) int ids (0 = pad).
    attn_maps: (B, h, w, T) word-attention maps.
    """
    b = min(images.shape[0], max_vis)
    att_h = attn_maps.shape[1]
    vis_size = att_h * 16 if att_h == 17 else images.shape[1]
    t = captions.shape[1]
    n_words = min(t, max_word_num)
    cell_w = vis_size + PAD
    cols = n_words + 2  # image | max | words
    width = cols * cell_w

    blocks: List[np.ndarray] = []
    for i in range(b):
        img = _resize_img(np.asarray(images[i]), vis_size)
        attn = np.asarray(attn_maps[i], np.float32)  # (h, w, T)
        word_ids = [int(w) for w in captions[i][:n_words]]
        n_valid = next(
            (j for j, w in enumerate(word_ids) if w == 0), len(word_ids)
        )
        words = [ixtoword.get(w, "<?>") for w in word_ids[:n_valid]]

        # smoothed maps: index 0 = max over words
        maps = [_smooth_upsample(attn[:, :, :max(n_valid, 1)].max(-1),
                                 vis_size)]
        maps += [_smooth_upsample(attn[:, :, j], vis_size)
                 for j in range(n_valid)]
        lo = min(m.min() for m in maps)
        hi = max(m.max() for m in maps)
        span = (hi - lo) if hi > lo else 1.0
        maps_u8 = [
            np.clip((m - lo) / span * 255.0, 0, 255).astype(np.uint8)
            for m in maps
        ]

        raw_row = np.zeros((vis_size, width, 3), np.uint8)
        ovl_row = np.zeros((vis_size, width, 3), np.uint8)
        raw_row[:, :vis_size] = img
        ovl_row[:, :vis_size] = img
        for j, m in enumerate(maps_u8):
            x0 = (j + 1) * cell_w
            raw_row[:, x0: x0 + vis_size] = m[..., None]
            ovl_row[:, x0: x0 + vis_size] = _overlay(img, m, 210)

        labels = [f"{j}:{w[:6]}" for j, w in enumerate(words)]
        band = _caption_band(labels, width, cell_w, first_col=2)
        blocks.append(np.concatenate([band, raw_row, ovl_row], axis=0))
    return np.concatenate(blocks, axis=0)


def build_super_images2(
    images: Sequence[np.ndarray],
    captions: np.ndarray,
    cap_lens: np.ndarray,
    ixtoword: Dict[int, str],
    attn_maps: Sequence[np.ndarray],
    max_vis: int = 8,
    top_k: int = 5,
) -> np.ndarray:
    """The gen_example grid (uint8): per sample, each word's map masked below
    2 / num_words, upsampled, smoothed and normalized on its own; the
    ``top_k`` words of most mass above twice that threshold, as
    [caption band / overlay row], labels keeping each word's index."""
    b = min(len(captions), max_vis)
    imgs = np.asarray(images)
    if imgs.ndim == 3:
        imgs = imgs[None]
    vis_size = imgs.shape[1]
    cell_w = vis_size + PAD

    blocks: List[np.ndarray] = []
    for i in range(b):
        img = _resize_img(np.asarray(imgs[i]), vis_size)
        n = max(int(cap_lens[i]), 1)
        attn = np.asarray(attn_maps[i], np.float32)  # (h, w, T)
        words = [ixtoword.get(int(w), "<?>") for w in captions[i][:n]]
        thresh = 2.0 / float(n)

        maps, conf = [], []
        for j in range(n):
            m = attn[:, :, j]
            conf.append(float((m * (m > 2.0 * thresh)).sum()))
            m = m * (m > thresh)
            up = _smooth_upsample(m, vis_size)
            lo, hi = up.min(), up.max()
            maps.append((up - lo) / (hi - lo + 0.01))
        order = np.argsort(conf)[::-1][: min(top_k, n)]

        width = len(order) * cell_w
        ovl_row = np.zeros((vis_size, width, 3), np.uint8)
        labels = []
        for col, idx in enumerate(order):
            m_u8 = np.clip(maps[idx] * 255.0, 0, 255).astype(np.uint8)
            ovl_row[:, col * cell_w: col * cell_w + vis_size] = _overlay(img, m_u8, 180)
            labels.append(f"{int(idx)}:{words[idx][:6]}")
        band = _caption_band(labels, width, cell_w, first_col=0, colored=False)
        blocks.append(np.concatenate([band, ovl_row], axis=0))
    width = max(bl.shape[1] for bl in blocks)
    padded = [np.pad(bl, ((0, 0), (0, width - bl.shape[1]), (0, 0)), constant_values=255)
              for bl in blocks]
    return np.concatenate(padded, axis=0)
