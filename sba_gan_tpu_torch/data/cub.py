"""Training data: the synthetic stand-in for CUB.

:class:`SyntheticDataset` is the port's copy of the JAX package's
``SyntheticDataset``: item ``index`` is drawn from
``numpy.random.default_rng(seed * 100003 + index)`` in the same order, so the
two packages see the same images, captions and classes from one seed.  The
reader of the real CUB files comes when the data is in the repository.
"""

from __future__ import annotations

import numpy as np


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
