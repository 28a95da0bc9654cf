"""Image utilities: de-normalization to uint8, a fast PNG encoder, the
samplers' PNG writer and the gen-2 CLI's sample grid."""

from __future__ import annotations

import os

import numpy as np
from PIL import Image


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> uint8 as ``(im + 1) * 127.5``, clipped."""
    img = np.asarray(img, dtype=np.float32)
    img = (img + 1.0) * 127.5
    return np.clip(img, 0, 255).astype(np.uint8)


def save_image(img: np.ndarray, path: str) -> None:
    """One (H, W, 3) image in [-1, 1] as a PNG at ``path`` (its directory is
    made)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png_bytes(to_uint8(img)))


def png_bytes(a: np.ndarray, level: int = 1) -> bytes:
    """Minimal RGB8 PNG encoder: filter 0 + one zlib IDAT (2-3x faster than
    PIL's encoder at the same zlib level).  Anything but (H, W, 3) uint8
    goes through PIL."""
    import struct
    import zlib

    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] != 3:
        import io

        buf = io.BytesIO()
        Image.fromarray(a).save(buf, format="PNG", compress_level=level)
        return buf.getvalue()
    h, w, _ = a.shape
    raw = np.empty((h, w * 3 + 1), np.uint8)
    raw[:, 0] = 0  # per-row filter byte: None
    raw[:, 1:] = a.reshape(h, w * 3)
    comp = zlib.compress(raw.tobytes(), level)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", comp) + chunk(b"IEND", b""))


def make_grid(imgs, nrow: int = 8, pad: int = 2) -> np.ndarray:
    """(H, W, 3) images in [-1, 1] tiled ``nrow`` to a row with ``pad``
    black pixels around each -> uint8 (H', W', 3)."""
    imgs = [to_uint8(i) for i in imgs]
    n = len(imgs)
    h, w = imgs[0].shape[:2]
    ncol = min(nrow, n)
    nrows = (n + ncol - 1) // ncol
    grid = np.zeros((nrows * (h + pad) + pad, ncol * (w + pad) + pad, 3), np.uint8)
    for i, im in enumerate(imgs):
        r, c = divmod(i, ncol)
        y = r * (h + pad) + pad
        x = c * (w + pad) + pad
        grid[y:y + h, x:x + w] = im
    return grid
