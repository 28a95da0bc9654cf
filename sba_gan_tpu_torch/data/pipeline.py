"""Batches for training and evaluation: collate, seeded shuffle,
``drop_last`` (or the ragged tail), worker threads, device.

The port's counterpart of the JAX package's ``data/pipeline.py``: batches
keep input order within the permutation and carry explicit lengths (no
sort by length), the permutation comes from
``numpy.random.default_rng(seed)`` and advances once per epoch exactly as
there, so both packages draw the same batches.  Each epoch starts with the
dataset's ``set_epoch``, if it has one.  With ``num_workers`` > 0 a thread
pool reads the items of up to ``prefetch`` + 1 batches ahead (PIL's decode
releases the interpreter lock); batches come out in order, an error raised
by an item is raised to the consumer, and the pool is shut down when the
iterator is dropped.  Items carry their own random numbers, so batches are
the same for any number of workers.  Lengths stay on the host, because the
packed text encoder wants host lengths.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
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
    """Epoch iterator over a map-style dataset with a seeded shuffle,
    ``drop_last`` and ``num_workers`` reader threads; each batch is put on
    ``device``."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, device="cpu",
                 num_workers: int = 0, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.device = device
        self.num_workers = max(0, num_workers)
        self.prefetch = max(1, prefetch)
        self._rng = np.random.default_rng(seed)
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        return [order[i * self.batch_size: (i + 1) * self.batch_size]
                for i in range(len(self))]

    def __iter__(self) -> Iterator[Batch]:
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self._epoch)
        self._epoch += 1
        batches = self._batch_indices()
        if self.num_workers == 0:
            for idxs in batches:
                yield collate([self.dataset[int(k)] for k in idxs], self.device)
            return
        with ThreadPoolExecutor(self.num_workers) as pool:
            window: deque = deque()
            try:
                for idxs in batches:
                    window.append([pool.submit(self.dataset.__getitem__, int(k))
                                   for k in idxs])
                    if len(window) > self.prefetch:
                        yield collate([f.result() for f in window.popleft()], self.device)
                while window:
                    yield collate([f.result() for f in window.popleft()], self.device)
            finally:  # a dropped iterator or an error: cancel what has not started
                for futures in window:
                    for f in futures:
                        f.cancel()


def build_dataset(cfg, synthetic: bool, split: str):
    """The training or evaluation set of ``cfg`` (``split``: 'train' or
    'test'): the CUB-layout tree under ``DATA_DIR``, or with ``synthetic``
    the synthetic set (the same draws for both splits, sized
    ``max(4 * BATCH_SIZE, 32)``)."""
    from sba_gan_tpu_torch.data.cub import SyntheticDataset, TextImageDataset

    if synthetic:
        return SyntheticDataset(
            num_examples=max(4 * cfg.TRAIN.BATCH_SIZE, 32),
            base_size=cfg.TREE.BASE_SIZE,
            branch_num=cfg.TREE.BRANCH_NUM,
            words_num=cfg.TEXT.WORDS_NUM,
            b_dcgan=cfg.GAN.B_DCGAN,
            seed=cfg.JAX.SEED,
        )
    return TextImageDataset(
        cfg.DATA_DIR,
        split=split,
        base_size=cfg.TREE.BASE_SIZE,
        branch_num=cfg.TREE.BRANCH_NUM,
        words_num=cfg.TEXT.WORDS_NUM,
        captions_per_image=cfg.TEXT.CAPTIONS_PER_IMAGE,
        b_dcgan=cfg.GAN.B_DCGAN,
        seed=cfg.JAX.SEED,
        vocab="bert" if cfg.MODEL.TEXT_ENCODER == "bert" else "word",
        loader=cfg.MODEL.IMAGE_LOADER,
    )
