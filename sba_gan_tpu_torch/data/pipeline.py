"""Batches for training: collate, seeded shuffle, ``drop_last``, device.

The port's counterpart of the JAX package's ``data/pipeline.py``: batches
keep input order within the permutation and carry explicit lengths (no
sort by length), the permutation comes from
``numpy.random.default_rng(seed)`` and advances once per epoch exactly as
there, so both packages draw the same batches.  Captions and lengths stay
on the host as well, because the packed text encoder wants host lengths.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np
import torch


class Batch(NamedTuple):
    imgs: tuple  # per branch (B, S, S, 3) float32 in [-1, 1], on the device
    captions: torch.Tensor  # (B, T) int64, on the device
    cap_lens: torch.Tensor  # (B,) int64, on the CPU
    class_ids: torch.Tensor  # (B,) int64, on the device
    keys: tuple  # item names, host strings


def collate(samples, device="cpu") -> Batch:
    """Stack ``(imgs, caption, cap_len, class_id, key)`` items into a Batch
    whose tensors lie on ``device`` (``cap_lens`` always on the CPU)."""
    dev = torch.device(device)
    n_branches = len(samples[0][0])
    imgs = tuple(
        torch.from_numpy(np.stack([s[0][b] for s in samples])
                         .astype(np.float32, copy=False)).to(dev)
        for b in range(n_branches))
    captions = torch.from_numpy(
        np.stack([s[1] for s in samples]).astype(np.int64, copy=False)).to(dev)
    cap_lens = torch.tensor([int(s[2]) for s in samples], dtype=torch.long)
    class_ids = torch.tensor([int(s[3]) for s in samples], dtype=torch.long,
                             device=dev)
    return Batch(imgs, captions, cap_lens, class_ids, tuple(s[4] for s in samples))


class DataLoader:
    """Epoch iterator over a map-style dataset with a seeded shuffle and
    ``drop_last``; each batch is put on ``device``."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, device="cpu"):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.device = device
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Batch]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        for i in range(len(self)):
            idxs = order[i * self.batch_size: (i + 1) * self.batch_size]
            yield collate([self.dataset[int(k)] for k in idxs], self.device)


def build_dataset(cfg, synthetic: bool, split: str):
    """The training or evaluation set of ``cfg`` (``split``: 'train' or
    'test').  Only the synthetic set is ported: the same draws for both
    splits, sized ``max(4 * BATCH_SIZE, 32)``."""
    if not synthetic:
        raise NotImplementedError(
            "the CUB reader is not ported yet; pass synthetic=True (--synthetic)")
    from sba_gan_tpu_torch.data.cub import SyntheticDataset

    return SyntheticDataset(
        num_examples=max(4 * cfg.TRAIN.BATCH_SIZE, 32),
        base_size=cfg.TREE.BASE_SIZE,
        branch_num=cfg.TREE.BRANCH_NUM,
        words_num=cfg.TEXT.WORDS_NUM,
        b_dcgan=cfg.GAN.B_DCGAN,
        seed=cfg.JAX.SEED,
    )
