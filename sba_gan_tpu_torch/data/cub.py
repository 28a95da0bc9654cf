"""Training and evaluation data: the CUB-200-2011 reader (and the COCO
layout) and the synthetic stand-in.

:class:`TextImageDataset` is the port's copy of the JAX package's reader of
the same name: the ``{split}/filenames.pickle`` and ``class_info.pickle``
files, CUB's bounding boxes (when ``birds`` is in the path; COCO's flat
``images/`` directory has none), the caption cache of :mod:`data.vocab`, a
random 1-of-N caption per item and the transforms of :mod:`data.transforms`.
Item ``index`` of epoch ``e`` draws every random number (crop, flip,
caption, caption subsample, in that order) from
``numpy.random.default_rng([seed, e, index])``, so items are the same
whatever the number of loader workers, and bit-identical to the JAX
package's.  ``vocab='bert'`` reads the captions as BERT wordpieces
(``captions_bert.pickle``, :func:`data.vocab.load_or_build_captions_bert`).
Its native JPEG loader is not ported and raises.

:class:`SyntheticDataset` is the port's copy of the JAX package's
``SyntheticDataset``: item ``index`` is drawn from
``numpy.random.default_rng(seed * 100003 + index)`` in the same order, so the
two packages see the same images, captions and classes from one seed.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from sba_gan_tpu_torch.data import transforms as T
from sba_gan_tpu_torch.data.vocab import (
    load_or_build_captions,
    load_or_build_captions_bert,
    pad_caption,
)


def load_filenames(data_dir: str, split: str) -> List[str]:
    """The item keys of ``{data_dir}/{split}/filenames.pickle`` (none when the
    file is absent)."""
    filepath = os.path.join(data_dir, split, "filenames.pickle")
    if os.path.isfile(filepath):
        with open(filepath, "rb") as f:
            return pickle.load(f)
    return []


def load_class_ids(split_dir: str, total_num: int) -> np.ndarray:
    """``class_info.pickle`` of the split, else ``arange(total_num)``."""
    path = os.path.join(split_dir, "class_info.pickle")
    if os.path.isfile(path):
        with open(path, "rb") as f:
            return np.asarray(pickle.load(f, encoding="latin1"))
    return np.arange(total_num)


def load_bboxes(data_dir: str) -> Optional[Dict[str, List[int]]]:
    """CUB's bounding boxes ``[x, y, w, h]`` keyed by image path without
    ``.jpg``; None when the files are absent."""
    base = os.path.join(data_dir, "CUB_200_2011", "CUB_200_2011")
    bbox_path = os.path.join(base, "bounding_boxes.txt")
    images_path = os.path.join(base, "images.txt")
    if not (os.path.isfile(bbox_path) and os.path.isfile(images_path)):
        return None
    out: Dict[str, List[int]] = {}
    with open(images_path) as f:
        names = [line.split()[1] for line in f if line.strip()]
    with open(bbox_path) as f:
        for line, name in zip(f, names):
            out[name[:-4]] = [int(float(v)) for v in line.split()[1:5]]
    return out


class TextImageDataset:
    """Map-style dataset of ``(imgs, caption, cap_len, class_id, key)``, as
    :class:`SyntheticDataset`; ``split`` 'train' takes random crops and
    flips, any other split the center crop."""

    def __init__(
        self,
        data_dir: str,
        split: str = "train",
        base_size: int = 64,
        branch_num: int = 3,
        words_num: int = 20,
        captions_per_image: int = 10,
        b_dcgan: bool = False,
        seed: int = 0,
        vocab: str = "word",
        loader: str = "pil",
    ):
        if vocab not in ("word", "bert"):
            raise ValueError(f"vocab must be 'word' or 'bert', got {vocab!r}")
        if loader != "pil":
            raise NotImplementedError(
                f"loader={loader!r} (MODEL.IMAGE_LOADER): the native JPEG loader "
                "is not ported (ROADMAP.md, queue 1, item 2); use 'pil'")
        self.data_dir = data_dir
        self.split = split
        self.branch_num = branch_num
        self.words_num = words_num
        self.embeddings_num = captions_per_image
        self.b_dcgan = b_dcgan
        self._seed = seed
        self._epoch = 0
        self.train_mode = split == "train"
        self.imsize = [base_size * (2 ** i) for i in range(branch_num)]

        self.bbox = load_bboxes(data_dir) if "birds" in data_dir else None
        train_names = load_filenames(data_dir, "train")
        test_names = load_filenames(data_dir, "test")
        load = load_or_build_captions_bert if vocab == "bert" else load_or_build_captions
        train_caps, test_caps, self.ixtoword, self.wordtoix = load(
            data_dir, train_names, test_names, captions_per_image)
        self.n_words = len(self.ixtoword)
        if split == "train":
            self.filenames, self.captions = train_names, train_caps
        else:
            self.filenames, self.captions = test_names, test_caps
        self.class_id = load_class_ids(os.path.join(data_dir, split), len(self.filenames))

    def __len__(self):
        return len(self.filenames)

    def set_epoch(self, epoch: int) -> None:
        """The epoch whose random numbers the next items draw."""
        self._epoch = int(epoch)

    def _image_path(self, key: str) -> str:
        if self.bbox is not None:
            return os.path.join(self.data_dir, "CUB_200_2011", "CUB_200_2011", "images",
                                key + ".jpg")
        return os.path.join(self.data_dir, "images", key + ".jpg")

    def __getitem__(self, index: int):
        key = self.filenames[index]
        rng = np.random.default_rng([self._seed, self._epoch, index])
        with Image.open(self._image_path(key)) as f:
            img = f.convert("RGB")
        if self.bbox is not None:
            img = T.bbox_crop(img, self.bbox[key])
        final_size = self.imsize[-1]
        if self.train_mode:
            img = T.train_transform(img, final_size, rng)
        else:
            img = T.eval_transform(img, final_size)
        if self.b_dcgan:
            imgs = [T.normalize_to_unit(img)]
        else:
            imgs = T.multiscale_branches(img, self.imsize)

        sent_ix = int(rng.integers(0, self.embeddings_num))
        caps, cap_len = pad_caption(self.captions[index * self.embeddings_num + sent_ix],
                                    self.words_num, rng)
        return imgs, caps, cap_len, int(self.class_id[index]), key


class SyntheticDataset:
    """Items ``(imgs, caption, cap_len, class_id, key)``: ``imgs`` a list of
    (S, S, 3) float32 images in [-1, 1], one per branch (only the largest
    when ``b_dcgan``); ``caption`` (words_num,) int64 ids, zero after
    ``cap_len`` (4 <= cap_len <= words_num)."""

    def __init__(
        self,
        num_examples: int = 64,
        base_size: int = 64,
        branch_num: int = 3,
        words_num: int = 20,
        n_words: int = 300,
        num_classes: int = 20,
        b_dcgan: bool = False,
        seed: int = 0,
    ):
        self.num_examples = num_examples
        self.branch_num = branch_num
        self.words_num = words_num
        self.n_words = n_words
        self.b_dcgan = b_dcgan
        self.imsize = [base_size * (2 ** i) for i in range(branch_num)]
        self.ixtoword = {i: f"w{i}" for i in range(n_words)}
        self.ixtoword[0] = "<end>"
        self.wordtoix = {v: k for k, v in self.ixtoword.items()}
        rng = np.random.default_rng(seed)
        self.class_id = rng.integers(0, num_classes, size=num_examples)
        self.filenames = [f"synthetic/{i:05d}" for i in range(num_examples)]
        self._seed = seed

    def __len__(self):
        return self.num_examples

    def __getitem__(self, index: int):
        rng = np.random.default_rng(self._seed * 100003 + index)
        sizes = self.imsize[-1:] if self.b_dcgan else self.imsize
        imgs = [
            rng.uniform(-1, 1, size=(s, s, 3)).astype(np.float32) for s in sizes
        ]
        cap_len = int(rng.integers(4, self.words_num + 1))
        caps = np.zeros((self.words_num,), dtype=np.int64)
        caps[:cap_len] = rng.integers(1, self.n_words, size=cap_len)
        return imgs, caps, cap_len, int(self.class_id[index]), self.filenames[index]
