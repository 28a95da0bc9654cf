"""The port's multi-resolution pack (``data/multires.py``,
``prepare_data.py``) and sample grid (``utils/image.make_grid``) against the
JAX package's:

* the pack the port builds from a birds-layout tree (class sub-directories,
  JPEGs of 40 x 56, 6 captions each) is byte-identical to JAX's, for one
  worker and for a pool of two (the pool's completion order can differ, so
  there the values by key are compared);
* each package reads the other's pack to the same items for a seed: images
  (NHWC float32 in [-1, 1], flips), tokens (the crc32 ids where no BERT
  vocabulary is cached: an empty hub cache), at two resolutions; the
  text-only reader; ``batch_iterator``'s batches;
* ``make_grid`` bit for bit;
* with a made-up ``vocab.txt`` as the cached ``bert-base-uncased``
  snapshot: the tokenizer maps the literal ``[CLS]`` and ``[SEP]`` of the
  caption wrapper to their ids as ``BertTokenizerFast`` does, and the
  items equal JAX's, whose reader tokenizes with ``BertTokenizerFast``.
"""

import os

import numpy as np
import pytest
from PIL import Image

from _torch_parity import import_transformers, write_bert_hub
from sba_gan_tpu.data import multires as jmr
from sba_gan_tpu.data import vocab as jax_vocab
from sba_gan_tpu.utils.image import make_grid as jax_make_grid
from sba_gan_tpu_torch import prepare_data
from sba_gan_tpu_torch.data import multires as pmr
from sba_gan_tpu_torch.data import vocab
from sba_gan_tpu_torch.utils.image import make_grid

SIZES = (4, 8, 16)


def _tree(root, n=6):
    rng = np.random.default_rng(0)
    for i in range(n):
        cls = f"{i % 2:03d}.class"
        (root / "images" / cls).mkdir(parents=True, exist_ok=True)
        (root / "text" / cls).mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 255, (40, 56, 3), np.uint8)).save(
            root / "images" / cls / f"img_{i}.jpg")
        caps = [f"a small bird number {i} with wings, caption {k}" for k in range(6)]
        if i == 1:
            caps = caps[:2]  # fewer captions: the reader's retries and empty caption
        (root / "text" / cls / f"img_{i}.txt").write_text("\n".join(caps) + "\n")
    return str(root / "images"), str(root / "text")


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
    root = tmp_path_factory.mktemp("multires")
    img, txt = _tree(root)
    out = {}
    out["jax"] = str(root / "jax_pack")
    assert jmr.build_multires(img, txt, out["jax"], sizes=SIZES, n_worker=1) == 6
    out["port"] = str(root / "port_pack")
    assert prepare_data.main(["--out", out["port"], "--img_path", img, "--txt_path", txt,
                              "--n_worker", "1", "--sizes", *map(str, SIZES)]) == 6
    out["port_pool"] = str(root / "port_pool_pack")
    assert pmr.build_multires(img, txt, out["port_pool"], sizes=SIZES, n_worker=2) == 6
    return out


@pytest.fixture
def no_bert_vocab(tmp_path, monkeypatch):
    """No cached BERT vocabulary for either package: the crc32 ids."""
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "empty"))

    def missing():
        raise RuntimeError("no cached vocabulary")
    monkeypatch.setattr(jax_vocab, "get_bert_tokenizer", missing)


def _files(path):
    return {n: open(os.path.join(path, n), "rb").read() for n in ("pack.bin", "pack.idx")}


def _values(path):
    r = pmr.PackReader(path)
    return {k: r.get(k) for k in r._index}


def test_pack_is_byte_identical_to_jax(packs):
    assert _files(packs["port"]) == _files(packs["jax"])
    assert _values(packs["port_pool"]) == _values(packs["jax"])


@pytest.mark.parametrize("reader,pack", [("port", "jax"), ("jax", "port")])
@pytest.mark.parametrize("res", [8, 16])
def test_each_package_reads_the_others_pack(packs, no_bert_vocab, reader, pack, res):
    kw = dict(resolution=res, max_length=12, seed=3)
    mine = (pmr if reader == "port" else jmr).MultiResolutionDataset(packs[pack], **kw)
    theirs = (jmr if reader == "port" else pmr).MultiResolutionDataset(packs[pack], **kw)
    assert len(mine) == len(theirs) == 6
    for i in [0, 1, 2, 3, 4, 5, 1, 0]:
        (a, ta), (b, tb) = mine[i], theirs[i]
        assert a.dtype == np.float32 and a.shape == (res, res, 3)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ta, tb)
        assert ta.dtype == np.int32 and np.all(ta[:2] > 0)


def test_text_only_dataset_and_batches(packs, no_bert_vocab):
    a = pmr.TextOnlyDataset(packs["jax"], max_length=9, seed=2)
    b = jmr.TextOnlyDataset(packs["port"], max_length=9, seed=2)
    for i in [0, 1, 5, 1]:
        np.testing.assert_array_equal(a[i], b[i])
    kw = dict(resolution=8, max_length=9, seed=4)
    got = list(pmr.batch_iterator(pmr.MultiResolutionDataset(packs["port"], **kw), 4, seed=7))
    want = list(jmr.batch_iterator(jmr.MultiResolutionDataset(packs["port"], **kw), 4, seed=7))
    assert len(got) == len(want) == 1  # 6 items, drop_last
    for (gi, gt), (wi, wt) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gt, wt)
    got = list(pmr.batch_iterator(pmr.MultiResolutionDataset(packs["port"], **kw), 4,
                                  shuffle=False, drop_last=False))
    assert [len(t) for _, t in got] == [4, 2]


def test_make_grid_matches_jax():
    imgs = list(np.random.default_rng(1).uniform(-1.2, 1.2, (7, 6, 5, 3)).astype(np.float32))
    for nrow in (4, 8):
        np.testing.assert_array_equal(make_grid(imgs, nrow=nrow), jax_make_grid(imgs, nrow=nrow))


transformers = import_transformers()
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "small", "bird", "number",
         "with", "wing", "##s", ",", "caption", "cls", "sep", "[", "]", "1", "2", "3"]


@pytest.fixture
def hub(tmp_path, monkeypatch):
    root = write_bert_hub(tmp_path / "hub", VOCAB)
    monkeypatch.setenv("HF_HUB_CACHE", str(root))
    monkeypatch.setattr(jax_vocab, "get_bert_tokenizer",
                        lambda: transformers.BertTokenizerFast.from_pretrained(
                            "bert-base-uncased", local_files_only=True, cache_dir=str(root)))
    return root


@pytest.mark.parametrize("text", [
    "[CLS] a small bird with wings [SEP]",
    "[CLS]  [SEP]",
    "a[CLS]bird [SEP][SEP] [cls] [Sep] [MASK][PAD] [UNK]x",
])
def test_special_tokens_as_bert_tokenizer_fast(hub, text):
    fast = jax_vocab.get_bert_tokenizer()
    tok = vocab.get_bert_tokenizer()
    assert tok.tokenize(text) == fast.tokenize(text)
    assert tok.encode(text) == fast(text)["input_ids"]


def test_items_with_bert_vocab_equal_jax(hub, packs):
    kw = dict(resolution=8, max_length=16, seed=5)
    mine = pmr.MultiResolutionDataset(packs["port"], **kw)
    theirs = jmr.MultiResolutionDataset(packs["port"], **kw)
    for i in [0, 1, 2, 1]:
        (a, ta), (b, tb) = mine[i], theirs[i]
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ta, tb)
        assert ta[0] == VOCAB.index("[CLS]") and VOCAB.index("[SEP]") in ta
