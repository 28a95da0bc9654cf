"""The port's training data against the JAX package's: the synthetic set
draws the same items from one seed, and the loader (seeded shuffle,
drop_last) yields the same batches in the same order, epoch after epoch."""

import numpy as np
import pytest

from sba_gan_tpu.config import cfg_from_dict as jax_cfg_from_dict
from sba_gan_tpu.data.pipeline import DataLoader as JaxDataLoader
from sba_gan_tpu.main import build_dataset as jax_build_dataset
from sba_gan_tpu_torch.config import cfg_from_dict
from sba_gan_tpu_torch.data.pipeline import DataLoader, build_dataset

TINY = {"TREE": {"BRANCH_NUM": 1, "BASE_SIZE": 32}, "TRAIN": {"BATCH_SIZE": 5},
        "TEXT": {"WORDS_NUM": 7}, "JAX": {"SEED": 3}}


def test_synthetic_set_and_loader_match_jax():
    jds = jax_build_dataset(jax_cfg_from_dict(TINY), True, "train")
    ds = build_dataset(cfg_from_dict(TINY), True, "train")
    assert len(ds) == len(jds) == 32 and ds.n_words == jds.n_words
    for i in (0, 7, 31):
        (imgs_j, caps_j, len_j, cls_j, key_j), (imgs, caps, n, cls, key) = jds[i], ds[i]
        np.testing.assert_array_equal(imgs[0], imgs_j[0])
        np.testing.assert_array_equal(caps, caps_j)
        assert (n, cls, key) == (len_j, cls_j, key_j)

    jl = JaxDataLoader(jds, 5, shuffle=True, drop_last=True, seed=3, num_workers=0)
    pl = DataLoader(ds, 5, shuffle=True, drop_last=True, seed=3)
    assert len(pl) == len(jl) == 6
    for _ in range(2):  # the permutation advances each epoch on both sides
        for jb, b in zip(jl, pl):
            assert b.keys == jb.keys
            np.testing.assert_array_equal(b.imgs[0].numpy(), jb.imgs[0])
            np.testing.assert_array_equal(b.captions.numpy(), jb.captions)
            np.testing.assert_array_equal(b.cap_lens.numpy(), jb.cap_lens)
            np.testing.assert_array_equal(b.class_ids.numpy(), jb.class_ids)


def test_only_the_synthetic_set_is_ported(tmp_path, monkeypatch):
    """Of the real-data readers, the native JPEG loader is not ported and
    raises before reading anything, and the BERT vocabulary raises without
    its cached files (the CUB reader itself: tests/test_torch_cub_data.py;
    the BERT vocabulary: tests/test_torch_bert_vocab.py)."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_dataset(cfg_from_dict({**TINY, "MODEL": {"IMAGE_LOADER": "native"}}),
                      False, "train")
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "no_hub"))
    with pytest.raises(RuntimeError, match="tokenizer"):
        build_dataset(cfg_from_dict({**TINY, "DATA_DIR": str(tmp_path),
                                     "MODEL": {"TEXT_ENCODER": "bert"}}), False, "train")
