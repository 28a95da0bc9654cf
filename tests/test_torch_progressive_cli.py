"""The port's gen-1 CLIs (``python -m sba_gan_tpu_torch.progressive_main`` and
``progressive_generate``) on the CPU at tiny widths (z 8, w 16, fmap_max 16,
rungs 4 x 4 to 16 x 16), and the resize of reals against
``jax.image.resize``:

* ``--synthetic --sched --batch_cap 4`` across every rung (a phase of 8
  samples), the grids at each rung's size, the scheduled learning rates (D
  at G's rate, as the JAX CLI), an Inception Score, the checkpoints and the
  ``used_samples.txt`` sidecar; a second call resumes from them (the step,
  the weights, the Adams, the pacing) and trains on;
* ``--pack`` through the port's ``prepare_data`` (each rung's images read at
  their size, no resize) with ``--conditional`` (the bi-LSTM over BERT's
  30,522 ids), and a CUB tree through ``--data_dir`` (reals shrunk to the
  rung);
* ``progressive_generate`` on the checkpoint: ``sample.png`` and the
  style-mixing grids' pixel layout (the blank tile, the sources, the
  targets);
* the default device is the card: without one both CLIs raise.

Tolerance of the resize: rtol 1e-5 and atol 1e-5.
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sba_gan_tpu_torch import prepare_data, progressive_generate, progressive_main
from sba_gan_tpu_torch.train.progressive import base_lr
from sba_gan_tpu_torch.utils.checkpoint import Checkpointer
from test_torch_cub_data import _write_tree
from test_torch_progressive import adam_count

# the module (the package exports its function of the same name)
inception_score = importlib.import_module("sba_gan_tpu_torch.evaluation.inception_score")

TINY = ["--z_dim", "8", "--w_dim", "16", "--fmap_max", "16", "--init_size", "4",
        "--max_size", "16", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("size", [128, 64, 32, 8, 4, 512])
def test_resize_matches_jax_image_resize(size):
    """256^2 reals to each rung (antialiased where it shrinks; 512 also
    without antialiasing, which the torch flag leaves alone when it grows)."""
    x = np.random.default_rng(size).uniform(-1, 1, (2, 256, 256, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, size, size, 3), "bilinear")
    got = progressive_main.resize_reals(torch.from_numpy(x), size)
    assert tuple(got.shape) == (2, size, size, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _grid_shape(n, nrow, side, pad=2):
    ncol = min(n, nrow)
    return ((n + ncol - 1) // ncol * (side + pad) + pad, ncol * (side + pad) + pad, 3)


def test_synthetic_across_rungs_resume_and_generate(tmp_path, capsys, monkeypatch):
    # the Inception Score's classifier at input 75 (its 299 costs tens of
    # seconds on one CPU thread)
    build = inception_score.build_classifier
    monkeypatch.setattr(inception_score, "build_classifier",
                        lambda size, weights=None: build(75, weights))
    out = str(tmp_path / "out")
    args = ["--synthetic", "--sched", "--batch_cap", "4", "--batch", "4", "--phase", "8",
            "--sample_every", "2", "--ckpt_every", "3", "--eval_is_every", "4",
            "--output_dir", out, *TINY]
    first = progressive_main.main(args + ["--steps", "5"])
    printed = capsys.readouterr().out
    # used 0, 4 at 4^2; 8, 12 at 8^2 (alpha 0, 0.5); 16 at 16^2
    assert "phase switch -> res 8, batch 4" in printed
    assert "phase switch -> res 16, batch 4" in printed
    assert "inception score" in printed and "nan" not in printed
    assert first.step == 5
    assert adam_count(first.d_opt, first.d_params) == adam_count(first.g_opt,
                                                                 first.g_params) == 5
    assert base_lr(first.g_opt) == base_lr(first.d_opt) == progressive_main.SCHED_LR[16]
    for step, side in ((2, 4), (4, 8)):
        grid = np.asarray(Image.open(os.path.join(out, "Image", f"sample_{step}.png")))
        assert grid.shape == _grid_shape(8, 4, side) and grid.std() > 0
    model = os.path.join(out, "Model")
    assert Checkpointer(model).steps() == [3, 5]
    assert open(os.path.join(model, "used_samples.txt")).read() == "20"
    saved = Checkpointer(model).restore()

    second = progressive_main.main(args + ["--steps", "7"])
    assert "resumed at step 5" in capsys.readouterr().out
    assert second.step == 7 and adam_count(second.d_opt, second.d_params) == 7
    assert open(os.path.join(model, "used_samples.txt")).read() == "28"
    assert Checkpointer(model).steps() == [3, 5, 6, 7]
    after = Checkpointer(model).restore()
    assert any(not torch.equal(after["generator"][k], v) for k, v in saved["generator"].items())

    samples = str(tmp_path / "samples")
    progressive_generate.main([model, "--size", "16", "--n_row", "2", "--n_col", "3",
                               "--n_mixing", "2", "--out_dir", samples, "--z_dim", "8",
                               "--w_dim", "16", "--fmap_max", "16", "--max_size", "16",
                               "--device", "cpu"])
    assert "loaded step 7" in capsys.readouterr().out
    grid = np.asarray(Image.open(os.path.join(samples, "sample.png")))
    assert grid.shape == _grid_shape(6, 3, 16)
    for j in range(2):
        mix = np.asarray(Image.open(os.path.join(samples, f"sample_mixing_{j}.png")))
        assert mix.shape == _grid_shape(12, 4, 16)  # (2 + 1) x (3 + 1) tiles
        tiles = [[mix[2 + r * 18:r * 18 + 18, 2 + c * 18:c * 18 + 18] for c in range(4)]
                 for r in range(3)]
        assert not tiles[0][0].any()  # the blank: -1 -> black
        assert all(tiles[r][c].std() > 0 for r in range(3) for c in range(4) if r or c)
    again = str(tmp_path / "again")
    progressive_generate.main([model, "--size", "16", "--n_row", "2", "--n_col", "3",
                               "--n_mixing", "1", "--out_dir", again, "--z_dim", "8",
                               "--w_dim", "16", "--fmap_max", "16", "--max_size", "16",
                               "--device", "cpu"])
    for name in ("sample.png", "sample_mixing_0.png"):
        assert np.array_equal(np.asarray(Image.open(os.path.join(samples, name))),
                              np.asarray(Image.open(os.path.join(again, name))))


def _birds(root):
    rng = np.random.default_rng(0)
    for i in range(6):
        (root / "images" / "c").mkdir(parents=True, exist_ok=True)
        (root / "text" / "c").mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 255, (24, 30, 3), np.uint8)).save(
            root / "images" / "c" / f"i{i}.jpg")
        (root / "text" / "c" / f"i{i}.txt").write_text(
            "\n".join(f"bird {i} caption {k}" for k in range(6)) + "\n")


def test_pack_conditional_through_prepare_data(tmp_path, capsys, monkeypatch):
    """Each rung reads its own images from the pack (4, 8, 16), so no real
    is resized; the sentence of the bi-LSTM over BERT's ids conditions G."""
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "empty"))  # the crc32 ids
    _birds(tmp_path)
    pack = str(tmp_path / "pack")
    prepare_data.main(["--out", pack, "--img_path", str(tmp_path / "images"),
                       "--txt_path", str(tmp_path / "text"), "--n_worker", "1",
                       "--sizes", "4", "8", "16"])
    shapes = []
    resize = progressive_main.resize_reals
    monkeypatch.setattr(progressive_main, "resize_reals",
                        lambda real, res: shapes.append(res) or resize(real, res))
    out = str(tmp_path / "out")
    trainer = progressive_main.main(["--pack", pack, "--conditional", "--embed_dim", "12",
                                     "--batch", "2", "--phase", "4", "--steps", "6",
                                     "--output_dir", out, *TINY])
    assert trainer.step == 6 and shapes == []
    assert trainer.generator.text_proj is not None
    assert open(os.path.join(out, "Model", "used_samples.txt")).read() == "12"
    assert "nan" not in capsys.readouterr().out


def test_cub_tree_shrinks_reals_to_the_rung(tmp_path, monkeypatch):
    root = _write_tree(tmp_path / "birds", np.random.default_rng(0), n_train=4, n_test=1)
    shapes = []
    resize = progressive_main.resize_reals
    monkeypatch.setattr(progressive_main, "resize_reals",
                        lambda real, res: shapes.append((real.shape[1], res)) or resize(real,
                                                                                         res))
    trainer = progressive_main.main(["--data_dir", root, "--conditional", "--embed_dim", "12",
                                     "--batch", "2", "--phase", "4", "--steps", "3",
                                     "--output_dir", str(tmp_path / "out"), *TINY])
    assert trainer.step == 3 and shapes == [(16, 4), (16, 4), (16, 8)]


def test_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        progressive_main.main(["--synthetic", "--output_dir", str(tmp_path / "a")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        progressive_generate.main([str(tmp_path / "b"), "--out_dir", str(tmp_path / "c")])
