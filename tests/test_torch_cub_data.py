"""The port's CUB reader against the JAX package's on a mini CUB tree
written to disk (the layout of tests/test_cub_dataset.py, three classes,
a test split whose last batch is ragged, captions longer than WORDS_NUM so
that the subsample draws): items equal bit for bit (images, captions,
lengths, class ids, keys) for train at epochs 0 and 1 and for test, and for
the COCO layout without boxes; one caption cache read by both packages;
the loader with reader threads equal to the serial one, errors reaching the
consumer, the pool shut down when the iterator is dropped; what is not
ported raising."""

import os
import pickle
import shutil
import threading

import numpy as np
import pytest
from PIL import Image

from sba_gan_tpu.config import cfg_from_dict as jax_cfg_from_dict
from sba_gan_tpu.data.cub import TextImageDataset as JaxTextImageDataset
from sba_gan_tpu.main import build_dataset as jax_build_dataset
from sba_gan_tpu_torch.config import cfg_from_dict
from sba_gan_tpu_torch.data.cub import TextImageDataset
from sba_gan_tpu_torch.data.pipeline import DataLoader, build_dataset

WORDS = ("small bird with red wings and a short beak grey belly black crown "
         "white throat long tail yellow eyes perched on branch").split()
KW = dict(base_size=32, branch_num=2, words_num=6, seed=3)


def _write_tree(root, rng, n_train=5, n_test=7, classes=3, bbox=True):
    """A mini CUB (``bbox``) or COCO layout under ``root``; returns it."""
    img_base = (os.path.join(root, "CUB_200_2011", "CUB_200_2011", "images") if bbox
                else os.path.join(root, "images"))
    entries = {"train": [], "test": []}
    lines_img, lines_box = [], []
    for split, n in (("train", n_train), ("test", n_test)):
        for i in range(n):
            cls = i % classes + 1
            key = (f"{cls:03d}.Species/{split}_{i}" if bbox else f"COCO_{split}_{i:06d}")
            entries[split].append((key, cls))
            path = os.path.join(img_base, key + ".jpg")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            w, h = int(rng.integers(90, 140)), int(rng.integers(70, 120))
            Image.fromarray(rng.integers(0, 255, (h, w, 3)).astype(np.uint8)).save(path)
            lines_img.append(f"{len(lines_img) + 1} {key}.jpg")
            lines_box.append(f"{len(lines_box) + 1} {rng.integers(0, 30)}.0 "
                             f"{rng.integers(0, 20)}.0 {rng.integers(30, 60)}.0 "
                             f"{rng.integers(30, 50)}.0")
            text = os.path.join(root, "text", key + ".txt")
            os.makedirs(os.path.dirname(text), exist_ok=True)
            with open(text, "w") as f:
                for _ in range(10):
                    f.write(" ".join(rng.choice(WORDS, int(rng.integers(2, 12)))) + "\n")
    if bbox:
        base = os.path.dirname(img_base)
        with open(os.path.join(base, "images.txt"), "w") as f:
            f.write("\n".join(lines_img))
        with open(os.path.join(base, "bounding_boxes.txt"), "w") as f:
            f.write("\n".join(lines_box))
    for split, items in entries.items():
        os.makedirs(os.path.join(root, split))
        with open(os.path.join(root, split, "filenames.pickle"), "wb") as f:
            pickle.dump([k for k, _ in items], f)
        if bbox:
            with open(os.path.join(root, split, "class_info.pickle"), "wb") as f:
                pickle.dump([c for _, c in items], f)
    return str(root)


@pytest.fixture(scope="module")
def mini_cub(tmp_path_factory):
    return _write_tree(tmp_path_factory.mktemp("birds"), np.random.default_rng(0))


@pytest.fixture(scope="module")
def mini_coco(tmp_path_factory):
    return _write_tree(tmp_path_factory.mktemp("coco"), np.random.default_rng(1), bbox=False)


def _assert_items_equal(ds, jds, indices):
    for i in indices:
        (imgs, caps, n, cls, key), (imgs_j, caps_j, n_j, cls_j, key_j) = ds[i], jds[i]
        assert len(imgs) == len(imgs_j)
        for a, b in zip(imgs, imgs_j):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
        assert caps.dtype == caps_j.dtype
        np.testing.assert_array_equal(caps, caps_j)
        assert (n, cls, key) == (n_j, cls_j, key_j)


@pytest.mark.parametrize("split", ["train", "test"])
def test_items_equal_jax_bit_for_bit(mini_cub, split):
    ds = TextImageDataset(mini_cub, split=split, **KW)
    jds = JaxTextImageDataset(mini_cub, split=split, **KW)
    assert ds.bbox is not None and ds.bbox == jds.bbox
    assert len(ds) == len(jds) == (5 if split == "train" else 7)
    assert ds.n_words == jds.n_words and ds.ixtoword == jds.ixtoword
    assert sorted(set(ds.class_id.tolist())) == [1, 2, 3]
    assert max(len(c) for c in ds.captions) > KW["words_num"]  # the subsample draws
    for epoch in ((0, 1) if split == "train" else (0,)):
        ds.set_epoch(epoch)
        jds.set_epoch(epoch)
        _assert_items_equal(ds, jds, range(len(ds)))
    if split == "train":  # epochs draw other crops
        ds.set_epoch(0)
        a = ds[0][0][-1]
        ds.set_epoch(1)
        assert not np.array_equal(a, ds[0][0][-1])


def test_coco_layout_without_boxes_equals_jax(mini_coco):
    ds = TextImageDataset(mini_coco, split="train", captions_per_image=5, **KW)
    jds = JaxTextImageDataset(mini_coco, split="train", captions_per_image=5, **KW)
    assert ds.bbox is None and jds.bbox is None
    np.testing.assert_array_equal(ds.class_id, np.arange(5))
    _assert_items_equal(ds, jds, range(len(ds)))


def test_caption_cache_is_shared(mini_cub, tmp_path):
    """Each package writes the cache the other reads: the same bytes."""
    caches = {}
    for name, cls in (("port", TextImageDataset), ("jax", JaxTextImageDataset)):
        root = str(tmp_path / name / "birds")
        shutil.copytree(mini_cub, root, ignore=shutil.ignore_patterns("captions.pickle"))
        cls(root, split="train", **KW)
        with open(os.path.join(root, "captions.pickle"), "rb") as f:
            caches[name] = f.read()
        other = JaxTextImageDataset if cls is TextImageDataset else TextImageDataset
        a, b = cls(root, split="test", **KW), other(root, split="test", **KW)
        assert a.captions == b.captions and a.wordtoix == b.wordtoix
    assert caches["port"] == caches["jax"]
    train, test, ixtoword, wordtoix = pickle.loads(caches["port"])
    assert len(train) == 5 * 10 and len(test) == 7 * 10 and ixtoword[0] == "<end>"


def test_build_dataset_matches_jax(mini_cub):
    d = {"DATA_DIR": mini_cub, "TREE": {"BRANCH_NUM": 2, "BASE_SIZE": 32},
         "TEXT": {"WORDS_NUM": 6}, "JAX": {"SEED": 3}}
    ds = build_dataset(cfg_from_dict(d), False, "test")
    jds = jax_build_dataset(jax_cfg_from_dict(d), False, "test")
    assert isinstance(ds, TextImageDataset)
    _assert_items_equal(ds, jds, range(len(ds)))


def _epochs(ds, workers, epochs=2):
    loader = DataLoader(ds, 3, shuffle=True, drop_last=False, seed=5, num_workers=workers,
                        prefetch=2)
    return [b for _ in range(epochs) for b in loader]


def test_worker_loader_equals_serial(mini_cub):
    serial = _epochs(TextImageDataset(mini_cub, split="test", **KW), 0)
    pooled = _epochs(TextImageDataset(mini_cub, split="test", **KW), 3)
    assert [len(b.keys) for b in serial[:3]] == [3, 3, 1]  # the ragged tail
    assert len(serial) == len(pooled) == 6
    for a, b in zip(serial, pooled):
        assert a.keys == b.keys
        for x, y in zip(a.imgs + (a.captions, a.cap_lens, a.class_ids),
                        b.imgs + (b.captions, b.cap_lens, b.class_ids)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert serial[0].keys != serial[3].keys  # the permutation advances each epoch


def test_worker_errors_reach_the_consumer_and_the_pool_stops():
    class Items:
        def __len__(self):
            return 12

        def __getitem__(self, i):
            if i == 7:
                raise ValueError("item 7 is broken")
            return [np.zeros((2, 2, 3), np.float32)], np.zeros(4, np.int64), 1, 0, str(i)

    before = set(threading.enumerate())
    with pytest.raises(ValueError, match="item 7"):
        list(DataLoader(Items(), 2, shuffle=False, num_workers=3))
    it = iter(DataLoader(Items(), 2, shuffle=False, num_workers=3))
    assert next(it).keys == ("0", "1")
    it.close()  # a dropped iterator shuts its pool down
    left = [t for t in set(threading.enumerate()) - before if t.is_alive()]
    for t in left:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in left)


def test_native_loader_and_bert_vocab_are_refused(mini_cub, tmp_path, monkeypatch):
    """The native loader is not ported; the BERT vocabulary is refused
    without its cached files (with them: tests/test_torch_bert_vocab.py)."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TextImageDataset(mini_cub, loader="native", **KW)
    cfg = cfg_from_dict({"DATA_DIR": mini_cub, "MODEL": {"IMAGE_LOADER": "native"}})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_dataset(cfg, False, "train")
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "no_hub"))
    with pytest.raises(RuntimeError, match="tokenizer"):
        TextImageDataset(mini_cub, vocab="bert", **KW)
    cfg = cfg_from_dict({"DATA_DIR": mini_cub, "MODEL": {"TEXT_ENCODER": "bert"}})
    with pytest.raises(RuntimeError, match="tokenizer"):
        build_dataset(cfg, False, "train")
    assert not os.path.exists(os.path.join(mini_cub, "captions_bert.pickle"))
