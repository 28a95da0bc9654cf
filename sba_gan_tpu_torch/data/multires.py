"""Multi-resolution packed dataset (the JAX package's ``data/multires.py``),
the data of the gen-2 CLI.

* :class:`PackWriter` / :class:`PackReader`: a flat append-only pack,
  values concatenated in ``pack.bin``, their (offset, length) by key in
  the JSON table ``pack.idx``, read through ``mmap``;
* :func:`build_multires`: the resize pyramid (LANCZOS resize of the short
  side, center crop, JPEG quality 100) of a birds (class sub-directories)
  or coco (flat) image tree and its caption ``.txt`` files, over a pool of
  worker processes, keyed ``{size}-{idx:05d}``, ``txt-{k}-{idx:05d}`` and
  ``length``;
* :class:`MultiResolutionDataset`: (image NHWC float32 in [-1, 1], tokens)
  at one resolution, a random 1-of-6 caption with up to 3 retries and a
  random horizontal flip from a seeded ``random.Random``, the caption as
  ``[CLS] ... [SEP]`` tokenized and zero-padded to ``max_length``;
  :class:`TextOnlyDataset` the captions alone; :func:`batch_iterator` the
  epoch's batches in a seeded order;
* :func:`_default_tokenize`: the cached ``bert-base-uncased`` wordpieces
  (:func:`data.vocab.get_bert_tokenizer`, which maps the literal
  ``[CLS]``/``[SEP]`` to their ids as HuggingFace's tokenizer does), or,
  where no vocabulary is cached, crc32-hashed word ids in BERT's range.

The same tree gives the same pack bytes as the JAX package's
``build_multires``, and either package's reader gives the same items from
either pack for a seed.
"""

from __future__ import annotations

import io
import json
import multiprocessing
import mmap
import os
import random
from functools import partial
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

DEFAULT_SIZES = (4, 8, 16, 32, 64, 128, 256, 512)


# --------------------------------------------------------------------------
# pack container
# --------------------------------------------------------------------------
class PackWriter:
    """Append-only key/value pack: values concatenated in ``pack.bin``,
    offsets in ``pack.idx``."""

    def __init__(self, path: str):
        os.makedirs(path, exist_ok=True)
        self.path = path
        self._bin = open(os.path.join(path, "pack.bin"), "wb")
        self._index = {}
        self._offset = 0

    def put(self, key: str, value: bytes) -> None:
        self._bin.write(value)
        self._index[key] = [self._offset, len(value)]
        self._offset += len(value)

    def close(self) -> None:
        self._bin.close()
        with open(os.path.join(self.path, "pack.idx"), "w") as f:
            json.dump(self._index, f)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class PackReader:
    """mmap-backed random access over a :class:`PackWriter` pack."""

    def __init__(self, path: str):
        idx_path = os.path.join(path, "pack.idx")
        if not os.path.exists(idx_path):
            raise IOError(f"Cannot open pack dataset: {path}")
        with open(idx_path) as f:
            self._index = json.load(f)
        self._file = open(os.path.join(path, "pack.bin"), "rb")
        size = os.fstat(self._file.fileno()).st_size
        self._mm = (
            mmap.mmap(self._file.fileno(), size, access=mmap.ACCESS_READ)
            if size else b""
        )

    def get(self, key: str) -> Optional[bytes]:
        ent = self._index.get(key)
        if ent is None:
            return None
        off, length = ent
        return bytes(self._mm[off:off + length])

    def close(self) -> None:
        if hasattr(self._mm, "close"):
            self._mm.close()
        self._file.close()


# --------------------------------------------------------------------------
# the resize pyramid (prepare_data.py)
# --------------------------------------------------------------------------
def resize_and_convert(img: Image.Image, size: int, quality: int = 100) -> bytes:
    """LANCZOS resize (short side) + center crop + JPEG encode
    (prepare_data.py:15-23)."""
    w, h = img.size
    if w <= h:
        nw, nh = size, max(size, round(size * h / w))
    else:
        nw, nh = max(size, round(size * w / h)), size
    img = img.resize((nw, nh), Image.LANCZOS)
    left = (nw - size) // 2
    top = (nh - size) // 2
    img = img.crop((left, top, left + size, top + size))
    buf = io.BytesIO()
    img.save(buf, format="jpeg", quality=quality)
    return buf.getvalue()


def _resize_worker(item: Tuple[int, str], sizes: Sequence[int]):
    i, path = item
    img = Image.open(path).convert("RGB")
    return i, [resize_and_convert(img, s) for s in sizes]


def _list_pairs(img_path: str, txt_path: str, dataset: str):
    """Image/caption pairing rules of prepare_data.py:42-66: coco = flat
    dirs; birds = class-subdir trees, both sorted."""
    if dataset == "coco":
        imgs = sorted(
            os.path.join(img_path, f)
            for f in os.listdir(img_path) if f.endswith(".jpg"))
        txts = sorted(
            os.path.join(txt_path, f)
            for f in os.listdir(txt_path) if f.endswith(".txt"))
    else:
        imgs = sorted(
            os.path.join(root, f)
            for root, _, files in os.walk(img_path)
            for f in files if f.endswith(".jpg"))
        txts = sorted(
            os.path.join(root, f)
            for root, _, files in os.walk(txt_path)
            for f in files if f.endswith(".txt"))
    assert len(imgs) == len(txts), (
        "length doesn't match, please check the folders and suffix names")
    return list(enumerate(imgs)), txts


def build_multires(img_path: str, txt_path: str, out: str,
                   sizes: Sequence[int] = DEFAULT_SIZES,
                   n_worker: int = 4, dataset: str = "birds") -> int:
    """Build the multi-resolution pack (prepare_data.py ``prepare``).
    Returns the number of samples written."""
    img_files, txt_files = _list_pairs(img_path, txt_path, dataset)
    worker = partial(_resize_worker, sizes=sizes)
    with PackWriter(out) as pack:
        total = 0
        if n_worker > 1:
            ctx = multiprocessing.get_context("fork")
            with ctx.Pool(n_worker) as pool:
                results = pool.imap_unordered(worker, img_files)
                total = _write_samples(pack, results, txt_files, sizes)
        else:
            total = _write_samples(
                pack, map(worker, img_files), txt_files, sizes)
        pack.put("length", str(total).encode("utf-8"))
    return total


def _write_samples(pack, results, txt_files, sizes) -> int:
    total = 0
    for i, imgs in results:
        for size, data in zip(sizes, imgs):
            pack.put(f"{size}-{str(i).zfill(5)}", data)
        with open(txt_files[i], "r") as f:
            for k, cap in enumerate(f.read().split("\n")):
                if len(cap) == 0:
                    continue
                pack.put(f"txt-{k}-{str(i).zfill(5)}", cap.encode("utf-8"))
        total += 1
    return total


# --------------------------------------------------------------------------
# tokenization (dataset.py:31,55-59) — gated on a local BERT tokenizer
# --------------------------------------------------------------------------
def _default_tokenize(max_length: int) -> Callable[[str], np.ndarray]:
    try:
        from sba_gan_tpu_torch.data.vocab import get_bert_tokenizer

        tok = get_bert_tokenizer()

        def bert_ids(text: str) -> np.ndarray:
            ids = [tok.vocab[p] for p in tok.tokenize(text)]
            out = np.zeros(max_length, np.int32)
            n = min(len(ids), max_length)
            out[:n] = ids[:n]
            return out

        return bert_ids
    except RuntimeError:
        # no cached vocabulary: a deterministic hash vocabulary in BERT's id
        # range, with the same shapes and padding; crc32 (not built-in hash()) so the same word maps to the same id
        # across processes: checkpoint resume / sampling in a later process
        # must see the vocabulary training saw.
        import zlib

        def hashed_ids(text: str) -> np.ndarray:
            words = text.lower().split()
            out = np.zeros(max_length, np.int32)
            n = min(len(words), max_length)
            for j in range(n):
                out[j] = 1000 + (zlib.crc32(words[j].encode("utf-8")) % 29000)
            return out

        return hashed_ids


class MultiResolutionDataset:
    """Pack-backed (image, fixed-length BERT token) pairs at one resolution
    rung (Old_Code/dataset.py:11-60).  Emits NHWC float32 images in [-1,1]
    (the reference's ToTensor+Normalize(0.5,0.5) transform,
    Old_Code/train.py:398-404)."""

    def __init__(self, path: str, resolution: int = 4, max_length: int = 24,
                 tokenize_fn: Optional[Callable[[str], np.ndarray]] = None,
                 seed: Optional[int] = None, flip: bool = True):
        self.pack = PackReader(path)
        raw = self.pack.get("length")
        if raw is None:
            raise IOError(f"pack at {path} has no 'length' key")
        self.length = int(raw.decode("utf-8"))
        self.resolution = resolution
        self.max_length = max_length
        self.tokenize = tokenize_fn or _default_tokenize(max_length)
        self.random = random.Random(seed)
        self.flip = flip

    def __len__(self) -> int:
        return self.length

    def _caption_bytes(self, index: int) -> bytes:
        # random 1-of-6 caption, up to 3 retries (dataset.py:38-46)
        for _ in range(3):
            i = self.random.randint(0, 5)
            txt = self.pack.get(f"txt-{i}-{str(index).zfill(5)}")
            if txt is not None:
                return txt
        # empty caption: the caller adds the [CLS]/[SEP] wrapper
        return b""

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        data = self.pack.get(f"{self.resolution}-{str(index).zfill(5)}")
        if data is None:
            raise KeyError(
                f"resolution {self.resolution} missing for sample {index}")
        img = Image.open(io.BytesIO(data)).convert("RGB")
        if self.flip and self.random.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        arr = np.asarray(img, np.float32) / 127.5 - 1.0

        txt = self._caption_bytes(index).decode("utf-8")
        txt = "[CLS] " + txt.replace("��", " ") + " [SEP]"
        tokens = self.tokenize(txt).astype(np.int32)
        return arr, tokens


class TextOnlyDataset:
    """Caption-only pack reader (Old_Code/caltext.py)."""

    def __init__(self, path: str, max_length: int = 24,
                 tokenize_fn: Optional[Callable[[str], np.ndarray]] = None,
                 seed: Optional[int] = None):
        self.pack = PackReader(path)
        self.length = int(self.pack.get("length").decode("utf-8"))
        self.max_length = max_length
        self.tokenize = tokenize_fn or _default_tokenize(max_length)
        self.random = random.Random(seed)

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, index: int) -> np.ndarray:
        for _ in range(3):
            i = self.random.randint(0, 5)
            txt = self.pack.get(f"txt-{i}-{str(index).zfill(5)}")
            if txt is not None:
                break
        else:
            txt = b""  # caller adds the [CLS]/[SEP] wrapper
        text = ("[CLS] " + txt.decode("utf-8").replace("��", " ")
                + " [SEP]")
        return self.tokenize(text).astype(np.int32)


def batch_iterator(dataset: MultiResolutionDataset, batch_size: int,
                   shuffle: bool = True, seed: int = 0,
                   drop_last: bool = True):
    """Minimal epoch iterator over (images (B,R,R,3), tokens (B,T)) —
    the DataLoader role of Old_Code/train.py:99-115."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    n = len(order) - (len(order) % batch_size if drop_last else 0)
    for s in range(0, n, batch_size):
        idx = order[s:s + batch_size]
        if len(idx) < batch_size and drop_last:
            break
        imgs, toks = zip(*(dataset[int(i)] for i in idx))
        yield np.stack(imgs), np.stack(toks)
