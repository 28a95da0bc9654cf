"""Host-side image preprocessing of the CUB reader (the port's copy of the
JAX package's ``data/transforms.py``, with the same PIL calls, so that the
two packages read bit-identical items): bbox crop (1.5x box, centered),
resize of the short side to ``imsize * 76/64``, random crop to imsize,
random horizontal flip, per-branch bilinear downsizes, and [-1, 1]
normalization to (H, W, 3) float32.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
from PIL import Image


def bbox_crop(img: Image.Image, bbox: Sequence[int]) -> Image.Image:
    """1.5x bounding-box crop centered on the box (r = 0.75 * max(w, h) on
    each side), clipped to the image."""
    width, height = img.size
    r = int(np.maximum(bbox[2], bbox[3]) * 0.75)
    center_x = int((2 * bbox[0] + bbox[2]) / 2)
    center_y = int((2 * bbox[1] + bbox[3]) / 2)
    y1 = np.maximum(0, center_y - r)
    y2 = np.minimum(height, center_y + r)
    x1 = np.maximum(0, center_x - r)
    x2 = np.minimum(width, center_x + r)
    return img.crop((x1, y1, x2, y2))


def normalize_to_unit(img: Image.Image) -> np.ndarray:
    """uint8 RGB -> (H, W, 3) float32 in [-1, 1]."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return arr * 2.0 - 1.0


def _short_side_resize(img: Image.Image, imsize: int) -> Image.Image:
    """Scale the short side to ``int(imsize * 76 / 64)`` (bilinear)."""
    target = int(imsize * 76 / 64)
    w, h = img.size
    if w <= h:
        new_w, new_h = target, max(1, int(round(target * h / w)))
    else:
        new_w, new_h = max(1, int(round(target * w / h))), target
    return img.resize((new_w, new_h), Image.BILINEAR)


def train_transform(img: Image.Image, imsize: int, rng: np.random.Generator,
                    flip: bool = True) -> Image.Image:
    """Short-side resize, random crop to ``imsize``, random hflip; the crop's
    x, then y, then the flip are drawn from ``rng`` in that order."""
    img = _short_side_resize(img, imsize)
    new_w, new_h = img.size
    x = int(rng.integers(0, new_w - imsize + 1))
    y = int(rng.integers(0, new_h - imsize + 1))
    img = img.crop((x, y, x + imsize, y + imsize))
    if flip and rng.random() < 0.5:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    return img


def eval_transform(img: Image.Image, imsize: int) -> Image.Image:
    """Deterministic: short-side resize then center crop."""
    img = _short_side_resize(img, imsize)
    new_w, new_h = img.size
    x = (new_w - imsize) // 2
    y = (new_h - imsize) // 2
    return img.crop((x, y, x + imsize, y + imsize))


def multiscale_branches(img: Image.Image, imsizes: Sequence[int]) -> List[np.ndarray]:
    """Per-branch pyramid: a bilinear resize for all but the final branch,
    each normalized to [-1, 1]."""
    out = []
    for i, size in enumerate(imsizes):
        branch = img.resize((size, size), Image.BILINEAR) if i < len(imsizes) - 1 else img
        out.append(normalize_to_unit(branch))
    return out
