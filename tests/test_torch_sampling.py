"""The port's evaluation samplers against the JAX package's trainer, from
the same reference-layout checkpoints, read by each package's own reader: a
``netG.pth`` (random weights and running statistics; the word projection as
the reference's 1 x 1 conv) whose every key and layout the helpers of
tests/test_g_net_port.py confirm, and a ``text_encoder.pth``.

The port's CLI (``main`` with ``TRAIN.FLAG`` false, on a mini CUB tree)
runs ``sampling`` (``B_VALIDATION``; the last batch ragged) and
``gen_example`` with the mixing sets (``TRAIN.MIXING``); the JAX package's
``GANTrainer.sampling`` / ``gen_example`` run on the same data.  The noise
cannot come from one generator (``jax.random`` against
``torch.Generator``), so the port's draws are replaced by JAX's draws from
the same seeds (``Sampler.draw_noise``, ``GANTrainer.mixing_noise``): both
sides must then write the same file names and the same images before PNG
quantization (atol/rtol 1e-4, as the sampler in tests/test_torch_serving.py).
"""

import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import sba_gan_tpu.train.loop as jax_loop
import sba_gan_tpu_torch.train.loop as port_loop
from _torch_parity import TINY
from sba_gan_tpu.config import cfg_from_dict as jax_cfg_from_dict
from sba_gan_tpu.main import build_dataset as jax_build_dataset
from sba_gan_tpu.main import load_example_captions as jax_load_example_captions
from sba_gan_tpu.models.text_rnn import RNNEncoder as JaxRNNEncoder
from sba_gan_tpu.train.gan import GANModels, make_sample_fn
from sba_gan_tpu.train.gan import noise_shape as jax_noise_shape
from sba_gan_tpu.utils.torch_port import load_torch_state_dict, port_g_net, port_rnn_encoder
from sba_gan_tpu_torch import main as gan_main
from sba_gan_tpu_torch.config import cfg_from_dict
from sba_gan_tpu_torch.data.cub import TextImageDataset
from sba_gan_tpu_torch.models.blocks import init_weights
from sba_gan_tpu_torch.models.generator import build_generator
from sba_gan_tpu_torch.models.text_rnn import init_weights as init_text_weights
from sba_gan_tpu_torch.train.sample import Sampler, build_text_encoder
from test_g_net_port import _flatten, _to_torch, _torch_name
from test_torch_cub_data import _write_tree

TOL = dict(rtol=1e-4, atol=1e-4)
SEED = 5
# one length for both files, so that JAX compiles its samplers once
EXAMPLES = {"first": ["a small bird with red wings", "grey belly and a short beak",
                      "yellow eyes"],
            "second": ["black crown white throat long tail", "perched on a branch",
                       "a bird unknownword"]}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs six
    test processes on the CPU, and the many small ops here slow down by an
    order of magnitude when every process spins eight threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_reference_files(cfg, root, seed, n_words):
    """(netG.pth, text_encoder.pth) in the reference layout: random weights
    of the port's models (cheaper than a Flax init), the word projection as
    a 1 x 1 conv; each Flax path that the JAX reader makes of the file is
    held to the reference key and layout that tests/test_g_net_port.py's
    ``_torch_name`` / ``_to_torch`` give it."""
    gen = torch.Generator().manual_seed(seed)
    g = build_generator(cfg)
    init_weights(g, gen)
    with torch.no_grad():
        for name, buf in g.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.5 * torch.randn(buf.shape, generator=gen))
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 2.0, generator=gen)
    sd = {k: v[:, :, None, None] if k.endswith("att.conv_context.weight") else v
          for k, v in g.state_dict().items()}
    params, stats = port_g_net({k: v.numpy() for k, v in sd.items()})
    for coll, tree in (("params", params), ("batch_stats", stats)):
        for path, val in _flatten(tree).items():
            name, kind = _torch_name(path)
            want = _to_torch(val, kind, path[-1]) if coll == "params" else val
            np.testing.assert_array_equal(sd[name].numpy(), want, err_msg=name)
    text = build_text_encoder(cfg, n_words)
    init_text_weights(text, gen)
    paths = (os.path.join(root, "netG.pth"), os.path.join(root, "text_encoder.pth"))
    torch.save(sd, paths[0])
    torch.save(text.state_dict(), paths[1])
    return paths


class _G(NamedTuple):
    params: dict
    batch_stats: dict


class _State(NamedTuple):  # the fields of a GANTrainState that sampling reads
    text: dict
    g_ema: dict
    g: _G


def _jax_trainer(jcfg, dataset, n_words, net_g, net_e, output_dir):
    """The JAX package's GANTrainer holding only what its samplers read:
    the checkpoints through its own reader (``port_g_net`` /
    ``port_rnn_encoder``), and its jitted sample functions."""
    params, stats = port_g_net(load_torch_state_dict(net_g))
    text_params = port_rnn_encoder(load_torch_state_dict(net_e))
    from sba_gan_tpu.models.generator import build_generator

    models = GANModels(text_encoder=JaxRNNEncoder(ntoken=n_words, nhidden=32),
                       image_encoder=None, generator=build_generator(jcfg), discriminators=())
    sample = make_sample_fn(jcfg, models)
    trainer = jax_loop.GANTrainer.__new__(jax_loop.GANTrainer)
    trainer.cfg, trainer.output_dir, trainer.dataset = jcfg, output_dir, dataset
    trainer.ixtoword = dataset.ixtoword
    trainer.state = _State(text={"params": text_params}, g_ema=params,
                           g=_G(params=params, batch_stats=stats))
    trainer.sample_fn = jax.jit(sample)
    trainer.sample_noise_fn = jax.jit(sample.with_noise)
    return trainer


def _jax_noise(cfg):
    """JAX's draws from ``PRNGKey(seed)`` in the port's ``draw_noise``
    signature: z as make_sample_fn splits it, eps from the CA key."""
    def draw(self, batch, seed):
        rng_z, rng_ca = jax.random.split(jax.random.PRNGKey(int(seed)))
        z = jax.random.normal(rng_z, jax_noise_shape(cfg, batch), jnp.float32)
        eps = jax.random.normal(rng_ca, (batch, cfg.GAN.CONDITION_DIM), jnp.float32)
        return torch.from_numpy(np.array(z)), torch.from_numpy(np.array(eps))
    return draw


def _capture(monkeypatch, module, root):
    """``save_image`` of ``module`` records each array under its path
    relative to ``root`` (and still writes the PNG)."""
    seen = {}
    write = module.save_image

    def save(img, path):
        seen[os.path.relpath(path, root)] = np.array(img, np.float32)
        write(img, path)
    monkeypatch.setattr(module, "save_image", save)
    return seen


def _run_both(tmp_path, monkeypatch, mixing, extra, coco=False):
    """Writes a mini CUB tree (or, with ``coco``, a mini COCO tree read at
    eval_coco.yml's structure: R_NUM 3, WORDS_NUM 20, 5 captions an image,
    GF_DIM 12) and the reference files, runs the port's ``main`` on the
    tree and returns (port images, JAX images to come, port summary, the
    JAX trainer, JAX config)."""
    root = _write_tree(tmp_path / ("coco" if coco else "birds"), np.random.default_rng(2),
                       n_train=2, n_test=10, bbox=not coco)
    d = {"TREE": {"BRANCH_NUM": 3 if mixing else 2}, "GAN": dict(TINY["GAN"]),
         "TEXT": dict(TINY["TEXT"]), "TRAIN": {"FLAG": False, "BATCH_SIZE": 4,
                                                "MIXING": mixing},
         "WORKERS": 2, "MODEL": {"INCEPTION_INPUT": 75}, "DATA_DIR": root, **extra}
    if coco:
        d["GAN"].update(GF_DIM=12, R_NUM=3)
        d["TEXT"].update(WORDS_NUM=20, CAPTIONS_PER_IMAGE=5)
        d.update(DATASET_NAME="coco")
    if mixing:
        d["GAN"].update(INIT_Z_CONCAT=False, M_NUM=8)
    cfg, jcfg = cfg_from_dict(d), jax_cfg_from_dict(d)
    jcfg.JAX.SEED = SEED
    # writes the caption cache
    n_words = TextImageDataset(root, split="test", captions_per_image=cfg.TEXT.CAPTIONS_PER_IMAGE
                               ).n_words
    net_g, net_e = _write_reference_files(cfg, str(tmp_path), 3, n_words)
    yml = tmp_path / "eval.yml"
    yml.write_text(yaml.safe_dump({**d, "TRAIN": {**d["TRAIN"], "NET_G": net_g,
                                                  "NET_E": net_e}}))
    port_out, jax_out = str(tmp_path / "port"), str(tmp_path / "jax")
    monkeypatch.setattr(Sampler, "draw_noise", _jax_noise(jcfg))

    def mixing_noise(self, batch):
        r0, r1, rca = jax.random.split(jax.random.PRNGKey(SEED), 3)
        draws = (jax.random.normal(r0, (batch, jcfg.GAN.Z_DIM)),
                 jax.random.normal(r1, (batch, jcfg.GAN.Z_DIM)),
                 jax.random.normal(rca, (batch, jcfg.GAN.CONDITION_DIM)))
        return tuple(torch.from_numpy(np.array(x)) for x in draws)
    monkeypatch.setattr(port_loop.GANTrainer, "mixing_noise", mixing_noise)

    port_seen = _capture(monkeypatch, port_loop, port_out)
    summary = gan_main.main(["--cfg", str(yml), "--device", "cpu", "--manualSeed", str(SEED),
                             "--output_dir", port_out])
    jax_seen = _capture(monkeypatch, jax_loop, jax_out)
    jt = _jax_trainer(jcfg, jax_build_dataset(jcfg, False, "test"), n_words, net_g, net_e,
                      jax_out)
    return port_seen, jax_seen, summary, jt, jcfg


def _assert_same_images(port_seen, jax_seen):
    assert sorted(port_seen) == sorted(jax_seen)
    for name, img in port_seen.items():
        np.testing.assert_allclose(img, jax_seen[name], err_msg=name, **TOL)


def test_sampling_from_reference_netg_matches_jax(tmp_path, monkeypatch):
    port_seen, jax_seen, summary, jt, _ = _run_both(tmp_path, monkeypatch, False,
                                                    {"B_VALIDATION": True})
    assert summary["mode"] == "sampling"
    assert not os.path.exists(tmp_path / "port" / "Model")  # evaluation: no checkpointer
    jt.sampling("valid")
    assert len(port_seen) == 10  # 2 batches of 4 and a ragged tail of 2
    assert sorted(os.listdir(summary["samples_dir"])) == sorted(
        os.path.basename(k) for k in jax_seen)
    assert "valid/single/001.Species_test_9_s-1.png" in port_seen
    _assert_same_images(port_seen, jax_seen)


def test_coco_sampling_from_reference_netg_matches_jax(tmp_path, monkeypatch):
    """eval_coco.yml's structure (R_NUM 3: the reference ``residual.{0,1,2}``
    keys of ``netG.pth``, each held to ``port_g_net``'s; WORDS_NUM 20; 5
    captions an image) on a mini COCO tree (no boxes, every image its own
    class); the tolerance above."""
    port_seen, jax_seen, summary, jt, jcfg = _run_both(
        tmp_path, monkeypatch, False, {"B_VALIDATION": True}, coco=True)
    assert summary["mode"] == "sampling" and jt.dataset.bbox is None
    assert (jcfg.GAN.R_NUM, jcfg.TEXT.WORDS_NUM) == (3, 20)
    assert "h_net2.residual.2.block.1.weight" in torch.load(
        tmp_path / "netG.pth", weights_only=True)
    jt.sampling("valid")
    assert len(port_seen) == 10 and "valid/single/COCO_test_000009_s-1.png" in port_seen
    _assert_same_images(port_seen, jax_seen)


def test_gen_example_and_mixing_sets_match_jax(tmp_path, monkeypatch):
    root = tmp_path / "birds"
    os.makedirs(root / "examples")
    for name, lines in EXAMPLES.items():
        (root / "examples" / f"{name}.txt").write_text("\n".join(lines) + "\n")
    (root / "example_filenames.txt").write_text("examples/first\nexamples/second\n")
    port_seen, jax_seen, summary, jt, jcfg = _run_both(tmp_path, monkeypatch, True,
                                                       {"B_VALIDATION": False})
    assert summary["mode"] == "gen_example"
    jt.gen_example(jax_load_example_captions(jcfg, jt.dataset.wordtoix))
    want = {f"gen_example/{key}/{j}_{tail}" for key, lines in EXAMPLES.items()
            for j in range(len(lines))
            for tail in ["s_g0.png", "s_g1.png", "s_g2.png"]
            + [f"mix_{t}.png" for t in ("AB", "BA", "A", "B")]}
    assert set(port_seen) == want
    _assert_same_images(port_seen, jax_seen)
    for key in EXAMPLES:
        for root in ("port", "jax"):
            assert (tmp_path / root / "gen_example" / key / "attention_maps.png").is_file()
    # the mixing sets really mix: AB differs from A and from B
    a, b, ab = (port_seen[f"gen_example/first/0_mix_{t}.png"] for t in ("A", "B", "AB"))
    assert np.abs(ab - a).max() > 1e-3 and np.abs(ab - b).max() > 1e-3


def test_missing_checkpoints_raise(tmp_path):
    """deviation from the JAX package, which skips a named path that does
    not exist."""
    for key in ("NET_G", "NET_E"):
        d = {"TREE": TINY["TREE"], "GAN": TINY["GAN"], "TEXT": TINY["TEXT"],
             "MODEL": {"INCEPTION_INPUT": 75},
             "TRAIN": {"FLAG": False, key: str(tmp_path / "missing.pth")}}
        yml = tmp_path / "eval.yml"
        yml.write_text(yaml.safe_dump(d))
        with pytest.raises(FileNotFoundError):
            gan_main.main(["--cfg", str(yml), "--synthetic", "--device", "cpu",
                           "--output_dir", str(tmp_path / "out")])
