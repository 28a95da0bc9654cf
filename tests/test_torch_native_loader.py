"""The port's native JPEG pipeline (``MODEL.IMAGE_LOADER: native``) against
the JAX package's: the ctypes loader on generated JPEGs bit for bit (bbox
crop, pre-size, crop, flip, several sizes), a missing file raising
``IOError``, a library that cannot be built raising ``RuntimeError`` (no
fallback to PIL); the CUB reader's native path against the JAX reader's on
the mini CUB (boxes) and COCO trees of tests/test_torch_cub_data.py, bit
for bit, for train at epochs 0 and 1, test and ``b_dcgan``, and with
reader threads.  Both packages build their library from source here (g++
and libjpeg)."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from sba_gan_tpu.data.cub import TextImageDataset as JaxTextImageDataset
from sba_gan_tpu.data.native_loader import NativeImageLoader as JaxNativeImageLoader
from sba_gan_tpu_torch.config import cfg_from_dict
from sba_gan_tpu_torch.data import native_loader
from sba_gan_tpu_torch.data.cub import TextImageDataset
from sba_gan_tpu_torch.data.native_loader import NativeImageLoader
from sba_gan_tpu_torch.data.pipeline import DataLoader, build_dataset
from test_torch_cub_data import KW, _assert_items_equal, _write_tree


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs six
    test processes on the CPU, and small ops slow down by an order of
    magnitude when every process spins eight threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """A smooth 64 x 64 JPEG (as tests/test_native_loader.py's) and a noisy
    131 x 97 one."""
    tmp = tmp_path_factory.mktemp("jpegs")
    x = np.linspace(0, 255, 64, dtype=np.float32)
    img = np.stack(np.meshgrid(x, x), -1).sum(-1) / 2
    smooth = np.stack([img, img[::-1], img.T], -1).astype(np.uint8)
    noisy = np.random.default_rng(0).integers(0, 255, (97, 131, 3)).astype(np.uint8)
    paths = {}
    for name, arr in (("smooth", smooth), ("noisy", noisy)):
        paths[name] = str(tmp / f"{name}.jpg")
        Image.fromarray(arr).save(paths[name], quality=95)
    return paths


CASES = {
    "decode": dict(sizes=[64]),
    "sizes": dict(sizes=[16, 32, 64]),
    "bbox": dict(sizes=[16], bbox=(8, 8, 16, 16)),
    "pipeline": dict(sizes=[16, 32, 64], pre_size=76, crop2=(6, 6, 64, 64)),
    "flip": dict(sizes=[64], hflip=True),
    "all": dict(sizes=[8, 24, 48], bbox=(5, 3, 90, 80), pre_size=(71, 57),
                crop2=(11, 4, 48, 48), hflip=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("image", ["smooth", "noisy"])
def test_loader_matches_jax_bit_for_bit(jpegs, image, case):
    assert JaxNativeImageLoader.available()
    got = NativeImageLoader().load(jpegs[image], **CASES[case])
    want = JaxNativeImageLoader().load(jpegs[image], **CASES[case])
    assert [g.shape for g in got] == [(s, s, 3) for s in CASES[case]["sizes"]]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    assert all(-1.0 <= g.min() and g.max() <= 1.0 for g in got)


def test_flip_and_decode_against_pil(jpegs):
    """The flip mirrors the image; the decode is PIL's within JPEG's
    decoders' rounding (tests/test_native_loader.py's atol)."""
    loader = NativeImageLoader()
    (plain,) = loader.load(jpegs["smooth"], sizes=[64])
    (flipped,) = loader.load(jpegs["smooth"], sizes=[64], hflip=True)
    np.testing.assert_array_equal(flipped, plain[:, ::-1])
    ref = np.asarray(Image.open(jpegs["smooth"]), np.float32) / 127.5 - 1.0
    np.testing.assert_allclose(plain, ref, atol=0.02)


def test_missing_file_raises():
    with pytest.raises(IOError, match="native decode failed"):
        NativeImageLoader().load("/nonexistent/file.jpg", sizes=[8])


def test_library_that_cannot_be_built_raises(mini_cub, tmp_path, monkeypatch):
    """The build's linker error (here a library that does not exist, as
    libjpeg on a machine without it) raises with the compiler's message,
    from the loader, the reader and ``build_dataset``; nothing is read with
    PIL instead."""
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native_loader, "LIBS", ("-lsba_no_such_library",))
    opened = []
    monkeypatch.setattr(Image, "open", lambda *a, **k: opened.append(a))
    with pytest.raises(RuntimeError, match="sba_no_such_library"):
        NativeImageLoader()
    with pytest.raises(RuntimeError, match="needs g\\+\\+ and libjpeg"):
        TextImageDataset(mini_cub, loader="native", **KW)
    cfg = cfg_from_dict({"DATA_DIR": mini_cub, "MODEL": {"IMAGE_LOADER": "native"}})
    with pytest.raises(RuntimeError, match="sba_no_such_library"):
        build_dataset(cfg, False, "train")
    assert opened == [] and not list((tmp_path / "native").glob("*.so"))
    monkeypatch.setattr(native_loader, "CXX", "sba-no-such-compiler")
    with pytest.raises(RuntimeError, match="sba-no-such-compiler not found"):
        NativeImageLoader()


@pytest.fixture(scope="module")
def mini_cub(tmp_path_factory):
    return _write_tree(tmp_path_factory.mktemp("birds"), np.random.default_rng(0))


@pytest.fixture(scope="module")
def mini_coco(tmp_path_factory):
    return _write_tree(tmp_path_factory.mktemp("coco"), np.random.default_rng(1), bbox=False)


@pytest.mark.parametrize("b_dcgan", [False, True])
@pytest.mark.parametrize("split", ["train", "test"])
def test_reader_native_path_equals_jax(mini_cub, split, b_dcgan):
    kw = dict(KW, b_dcgan=b_dcgan, loader="native")
    ds, jds = TextImageDataset(mini_cub, split=split, **kw), JaxTextImageDataset(
        mini_cub, split=split, **kw)
    assert ds._native is not None and jds._native is not None and ds.bbox is not None
    for epoch in ((0, 1) if split == "train" else (0,)):
        ds.set_epoch(epoch)
        jds.set_epoch(epoch)
        _assert_items_equal(ds, jds, range(len(ds)))
        assert [im.shape[0] for im in ds[0][0]] == ([64] if b_dcgan else [32, 64])
    pil = TextImageDataset(mini_cub, split=split, **dict(kw, loader="pil"))
    assert not np.array_equal(ds[0][0][-1], pil[0][0][-1])  # another resampler


def test_reader_native_path_coco_and_threads(mini_coco):
    kw = dict(KW, captions_per_image=5, loader="native")
    ds = TextImageDataset(mini_coco, split="train", **kw)
    jds = JaxTextImageDataset(mini_coco, split="train", **kw)
    assert ds.bbox is None
    _assert_items_equal(ds, jds, range(len(ds)))

    def epochs(workers):
        loader = DataLoader(TextImageDataset(mini_coco, split="train", **kw), 2,
                            shuffle=True, drop_last=False, seed=5, num_workers=workers)
        return [b for _ in range(2) for b in loader]
    serial, pooled = epochs(0), epochs(3)
    assert len(serial) == len(pooled) == 6
    for a, b in zip(serial, pooled):
        assert a.keys == b.keys
        for x, y in zip(a.imgs, b.imgs):
            np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_library_that_cannot_be_loaded_raises(tmp_path, monkeypatch):
    """A library built on another machine whose libjpeg is missing here
    (dlopen fails) raises ``RuntimeError`` too."""
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path)
    native_loader.library_path().write_bytes(b"not a shared object")
    with pytest.raises(RuntimeError, match="cannot be loaded"):
        NativeImageLoader()


def test_library_is_keyed_by_source_and_command():
    path = native_loader.library_path()
    assert path.parent == native_loader.BUILD_DIR and path.name.startswith("libsba_loader-")
    assert os.path.exists(native_loader.build())
