"""The port's gen-2 CLI (``python -m sba_gan_tpu_torch.gen2_main``) on the
CPU at tiny widths (tests/test_gen2_cli.py's YAML, at 16 x 16 with the
attention style and noise on, so that every epilogue piece runs):

* ``--synthetic --device cpu`` for one epoch (8 D steps, 4 G steps at
  CRITIC_ITER 2), its grid and checkpoint, then a second call that resumes
  from the checkpoint (the step, the weights, the EMA and the RMSprop
  moments) and trains one more epoch;
* ``--data_dir`` on a pack the port's ``prepare_data`` builds from a
  birds-layout tree, the wordpiece ids folded into the tiny vocabulary;
* ``--bert_weights``: a made-up HuggingFace-layout ``BertModel`` state dict
  (``bert.``-prefixed keys, a ``cls.`` head and the position-id buffer,
  which are dropped) lands in the frozen tower of G and of its EMA and stays
  there through training;
* the default device is the card: without one the CLI raises.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from sba_gan_tpu_torch import gen2_main, prepare_data
from sba_gan_tpu_torch.config import cfg_from_file
from sba_gan_tpu_torch.models.text_bert import BertModel
from sba_gan_tpu_torch.train.gen2 import bert_cfg_of
from sba_gan_tpu_torch.utils.checkpoint import Checkpointer

TINY_YML = """
CONFIG_NAME: "gen2_tiny"
GEN2:
  E_DIM: 8
  C_DIM: 6
  Z_DIM: 5
  W_DIM: 12
  A_DIM: 10
  MAX_LENGTH: 6
  M_LAYERS: 2
  RESOLUTION: 16
  RESOLUTION_INIT: 4
  FMAP_BASE: 128
  FMAP_MAX: 16
  USE_ATTENTION: true
  USE_NOISE: true
  WGAN: true
  BERT_VOCAB: 60
  BERT_HIDDEN: 16
  BERT_LAYERS: 1
  BERT_HEADS: 2
  BERT_INTERMEDIATE: 32
TRAIN:
  BATCH_SIZE: 2
  MAX_EPOCH: 1
  CRITIC_ITER: 2
  SNAPSHOT_INTERVAL: 50
"""


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def yml(tmp_path):
    path = tmp_path / "tiny.yml"
    path.write_text(TINY_YML)
    return str(path)


def _run(yml, out, *extra):
    return gen2_main.main(["--cfg", yml, "--output_dir", out, "--device", "cpu", *extra])


def test_synthetic_train_and_resume(yml, tmp_path, capsys):
    out = str(tmp_path / "out")
    first = _run(yml, out, "--synthetic")
    printed = capsys.readouterr().out
    assert "Loss_D" in printed and "nan" not in printed
    assert first.step == 8
    ckpt = Checkpointer(os.path.join(out, "Model"))
    assert ckpt.steps() == [8]
    grid = np.asarray(Image.open(os.path.join(out, "Image", "epoch_0.png")))
    assert grid.shape == (2 + 18, 2 + 2 * 18, 3) and grid.std() > 0  # 2 images of 16, pad 2
    saved = ckpt.restore()

    second = _run(yml, out, "--synthetic")
    assert "resumed at step 8" in capsys.readouterr().out
    assert second.step == 16 and ckpt.steps() == [8, 16]
    # the resumed run started from the saved state: its first D step's
    # moments decay the saved ones
    assert any(float(n.abs().sum()) > 0 for n in saved["d_opt"])
    state = ckpt.restore(16)
    for k in ("generator", "g_ema", "dnet"):
        assert state[k].keys() == saved[k].keys()
    moved = [not torch.equal(state["generator"][n], saved["generator"][n])
             for n in saved["generator"] if not n.startswith("bert_embedding.bert.")]
    assert any(moved)


def _tree(root):
    rng = np.random.default_rng(0)
    for i in range(5):
        (root / "images" / "c").mkdir(parents=True, exist_ok=True)
        (root / "text" / "c").mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 255, (24, 30, 3), np.uint8)).save(
            root / "images" / "c" / f"i{i}.jpg")
        (root / "text" / "c" / f"i{i}.txt").write_text(
            "\n".join(f"bird {i} caption {k}" for k in range(6)) + "\n")


def test_data_dir_from_prepare_data(yml, tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "empty"))  # the crc32 ids
    _tree(tmp_path)
    pack = str(tmp_path / "pack")
    prepare_data.main(["--out", pack, "--img_path", str(tmp_path / "images"),
                       "--txt_path", str(tmp_path / "text"), "--n_worker", "1",
                       "--sizes", "8", "16"])
    trainer = _run(yml, str(tmp_path / "out"), "--data_dir", pack)
    printed = capsys.readouterr().out
    assert "Loss_D" in printed and "nan" not in printed
    assert trainer.step == 2  # 5 items at batch 2, drop_last
    assert os.path.exists(tmp_path / "out" / "Image" / "epoch_0.png")
    toks = gen2_main.fold_ids(np.array([[0, 1, 59, 60, 30000]]), 60)
    np.testing.assert_array_equal(toks, [[0, 1, 59, 1, 1 + 29999 % 59]])


def test_bert_weights(yml, tmp_path):
    cfg = cfg_from_file(yml)
    bert = BertModel(bert_cfg_of(cfg))
    gen = torch.Generator().manual_seed(3)
    sd = {f"bert.{k}": torch.randn(v.shape, generator=gen) for k, v in bert.state_dict().items()}
    sd["bert.embeddings.position_ids"] = torch.arange(512)[None]
    sd["cls.predictions.bias"] = torch.zeros(60)
    path = str(tmp_path / "bert.pth")
    torch.save(sd, path)
    trainer = _run(yml, str(tmp_path / "out"), "--synthetic", "--bert_weights", path)
    for k, v in trainer.generator.bert_embedding.bert.state_dict().items():
        assert torch.equal(v, sd[f"bert.{k}"]), k
    # the EMA folds the frozen tower into itself: float32 rounding alone
    for k, v in trainer.g_ema.bert_embedding.bert.state_dict().items():
        torch.testing.assert_close(v, sd[f"bert.{k}"], rtol=1e-6, atol=0, msg=k)


def test_default_device_is_the_card(yml, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gen2_main.main(["--cfg", yml, "--output_dir", str(tmp_path), "--synthetic"])
