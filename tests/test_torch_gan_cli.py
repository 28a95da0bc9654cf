"""The port's GAN CLI (sba_gan_tpu_torch.main) and trainer
(sba_gan_tpu_torch.train.loop) on the CPU at tiny widths: the DAMSM encoders
come from a checkpoint of the port's own pretraining CLI (``TRAIN.NET_E``),
one epoch saves the full GAN state, a second run resumes from it, and the
EMA sample and attention grid are rendered from the restored state.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from sba_gan_tpu_torch import main as gan_main
from sba_gan_tpu_torch import pretrain
from sba_gan_tpu_torch.config import CONFIG_DIR, cfg_from_file
from sba_gan_tpu_torch.data.pipeline import DataLoader, build_dataset
from sba_gan_tpu_torch.train.gan import log_keys
from sba_gan_tpu_torch.train.loop import GANTrainer
from sba_gan_tpu_torch.utils.checkpoint import Checkpointer

DAMSM_TINY = {"TREE": {"BRANCH_NUM": 1, "BASE_SIZE": 64}, "TRAIN": {"BATCH_SIZE": 8},
              "TEXT": {"EMBEDDING_DIM": 32, "WORDS_NUM": 6},
              "MODEL": {"INCEPTION_INPUT": 75}}
GAN_TINY = {"TREE": {"BRANCH_NUM": 2, "BASE_SIZE": 64},
            "GAN": {"GF_DIM": 8, "DF_DIM": 8, "Z_DIM": 8, "W_DIM": 16,
                    "CONDITION_DIM": 8, "R_NUM": 1},
            "TEXT": {"EMBEDDING_DIM": 32, "WORDS_NUM": 6},
            "MODEL": {"INCEPTION_INPUT": 75},
            "TRAIN": {"BATCH_SIZE": 8}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs six
    test processes on the CPU, and the many small ops here slow down by an
    order of magnitude when every process spins eight threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """A tiny DAMSM pretraining run of the port's CLI; its Model directory."""
    root = tmp_path_factory.mktemp("damsm")
    yml = root / "damsm.yml"
    yml.write_text(yaml.safe_dump(DAMSM_TINY))
    pretrain.main(["--cfg", str(yml), "--synthetic", "--max_epoch", "1", "--device", "cpu",
                   "--output_dir", str(root / "out")])
    return root / "out" / "Model"


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory, pretrained):
    """The CLI twice on one output directory: one epoch, then a second run
    to epoch 2, which resumes; the summaries, the directory and the YAML."""
    root = tmp_path_factory.mktemp("gan")
    cfg = {**GAN_TINY, "TRAIN": {**GAN_TINY["TRAIN"], "NET_E": str(pretrained)}}
    yml = root / "gan.yml"
    yml.write_text(yaml.safe_dump(cfg))
    out = root / "out"
    argv = ["--cfg", str(yml), "--synthetic", "--device", "cpu", "--output_dir", str(out)]
    first = gan_main.main(argv + ["--max_epoch", "1"])
    saved = Checkpointer(str(out / "Model")).restore(0)
    second = gan_main.main(argv + ["--max_epoch", "2"])
    return dict(first=first, second=second, saved=saved, out=out, yml=yml,
                pretrained=pretrained)


def test_cli_loads_net_e_saves_and_resumes(cli_run):
    first, saved = cli_run["first"], cli_run["saved"]
    assert first["resumed_from"] is None
    (epoch0,) = first["epochs"]
    assert epoch0["epoch"] == 0 and epoch0["steps"] == 4  # 32 synthetic items, batch 8
    assert sorted(epoch0["logs"]) == sorted(["errD0", "errD1", "g_loss0", "g_loss1",
                                             "w_loss", "s_loss", "kl_loss", "errG"])
    assert all(np.isfinite(v) for v in epoch0["logs"].values())
    assert saved["step"] == 4
    assert {"generator", "g_ema", "discriminators", "g_opt", "d_opts", "text_encoder",
            "image_encoder"} <= set(saved)
    assert len(saved["discriminators"]) == len(saved["d_opts"]) == 2
    # the encoders are the pretrained ones, unchanged by GAN training
    damsm = Checkpointer(str(cli_run["pretrained"])).restore()
    for key in ("text_encoder", "image_encoder"):
        for n, v in damsm[key].items():
            assert torch.equal(saved[key][n], v), (key, n)

    second = cli_run["second"]
    assert second["resumed_from"] == 0
    assert [e["epoch"] for e in second["epochs"]] == [1]
    ckpt = Checkpointer(str(cli_run["out"] / "Model"))
    assert ckpt.steps() == [0, 1] and ckpt.restore()["step"] == 8
    assert not torch.equal(ckpt.restore()["generator"]["h_net1.fc.0.weight"],
                           saved["generator"]["h_net1.fc.0.weight"])


def test_restored_trainer_renders_ema_sample_and_attention(cli_run):
    cfg = cfg_from_file(str(cli_run["yml"]))
    cfg.JAX.SEED = 100  # the CLI's --manualSeed default
    ds = build_dataset(cfg, True, "train")
    trainer = GANTrainer(cfg, str(cli_run["out"]), ds, ds.n_words, ds.ixtoword,
                         device="cpu")
    assert trainer.resume() and trainer.start_epoch == 2 and trainer.state.step == 8
    batch = next(iter(DataLoader(ds, 8, shuffle=False)))
    paths = trainer.save_img_results(batch, trainer.state.step)
    assert [os.path.basename(p) for p in paths] == ["G_avg_8_0.png", "attn_8.png"]
    assert all(open(p, "rb").read(8) == b"\x89PNG\r\n\x1a\n" for p in paths)
    # the EMA generator carries the EMA weights and G's statistics
    g = trainer.state.ema_generator()
    ema = trainer.state.g_ema
    assert all(torch.equal(p, ema[n]) for n, p in g.named_parameters())
    g_stats = trainer.state.generator.state_dict()
    assert all(torch.equal(b, g_stats[n]) for n, b in g.named_buffers())
    assert not g.training


def test_not_ported_modes_raise(tmp_path):
    """What the CLI still refuses, naming ROADMAP.md: the tensor-parallel
    model axis (``JAX.MESH_MODEL`` 2) and a reference BERT text encoder as
    ``TRAIN.NET_E`` (the native JPEG loader is ported:
    tests/test_torch_native_loader.py)."""
    ref = tmp_path / "text_encoder120.pth"
    torch.save({"bert.embeddings.word_embeddings.weight": torch.zeros(3, 2)}, ref)
    for key, value in (("JAX", {"MESH_MODEL": 2}), ("TRAIN", {"NET_E": str(ref)})):
        cfg = {**GAN_TINY, "DATA_DIR": str(tmp_path),
               key: {**GAN_TINY.get(key, {}), **value}}
        yml = tmp_path / "refused.yml"
        yml.write_text(yaml.safe_dump(cfg))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            gan_main.main(["--cfg", str(yml), "--device", "cpu",
                           "--output_dir", str(tmp_path / "out")])


def test_bench_cpu_smoke():
    """``bench --device cpu``: the tiny-width step, timed as one window of
    STEPS unfenced steps closed by one read of errG; no device metric."""
    from sba_gan_tpu_torch import bench

    line = bench.main(["--device", "cpu"])
    assert line["metric"] == "gan_train_step_images_per_sec_cpu_smoke"
    assert line["finite"] and line["steps"] == bench.STEPS and line["batch"] == 4
    assert line["value"] == pytest.approx(bench.STEPS * line["batch"] / line["window_s"])
    assert line["ms_per_step"] == pytest.approx(line["window_s"] * 1e3 / bench.STEPS)
    assert line["flops_per_step"] > line["flop_counter_flops"] > 0
    assert not {"mfu", "profile", "peak_memory_bytes", "step_ms"} & set(line)


def test_device_time_leaves_out_annotated_ranges():
    """The profiler puts each optimizer's ``Optimizer.step#Adam.step`` range
    on the device's timeline over the kernels it encloses; the bench and
    the pretrain profile sum kernels only."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from sba_gan_tpu_torch.bench import device_events

    kernel = SimpleNamespace(key="sm90_gemm", device_type=DeviceType.CUDA,
                             is_user_annotation=False)
    adam = SimpleNamespace(key="Optimizer.step#Adam.step", device_type=DeviceType.CUDA,
                           is_user_annotation=True)
    host = SimpleNamespace(key="aten::mm", device_type=DeviceType.CPU,
                           is_user_annotation=False)
    assert device_events([kernel, adam, host]) == ([kernel], [adam])


def _preset_yaml(name, path, **groups):
    """The port's preset ``name`` with the keys of ``groups`` merged in, as
    a YAML at ``path``."""
    with open(os.path.join(CONFIG_DIR, f"{name}.yml")) as f:
        raw = yaml.safe_load(f)
    for group, keys in groups.items():
        raw[group] = {**raw.get(group, {}), **keys} if isinstance(keys, dict) else keys
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def test_coco_presets_run_on_a_coco_tree(tmp_path):
    """The three user paths of the COCO presets through the CLIs, on the
    mini COCO tree of tests/test_torch_cub_data.py (no boxes, every image
    its own class): ``pretrain`` with DAMSM/coco.yml,
    ``main`` with coco_attn2.yml and that checkpoint as TRAIN.NET_E (an
    epoch, then a resume), its EMA G written as a reference-layout
    ``netG.pth``, and ``main`` with eval_coco.yml sampling the test split
    from it.  The presets' own keys, at tiny widths (GF/DF 12/24,
    EMBEDDING_DIM 32, Inception input 75, batch 4; R_NUM 3, WORDS_NUM
    15 / 12 / 20, 5 captions an image, lambda 50 as published)."""
    from test_torch_cub_data import _write_tree

    root = _write_tree(tmp_path / "coco", np.random.default_rng(4), n_train=8, n_test=6,
                       bbox=False)
    tiny = dict(GAN={"GF_DIM": 12, "DF_DIM": 24, "Z_DIM": 8, "W_DIM": 16,
                     "CONDITION_DIM": 8},
                MODEL={"INCEPTION_INPUT": 75}, DATA_DIR=root)
    text = {"EMBEDDING_DIM": 32}
    damsm = _preset_yaml("DAMSM/coco", tmp_path / "damsm.yml", TEXT=text,
                         TRAIN={"BATCH_SIZE": 4}, MODEL=tiny["MODEL"], DATA_DIR=root)
    pre = pretrain.main(["--cfg", damsm, "--max_epoch", "1", "--device", "cpu",
                         "--output_dir", str(tmp_path / "damsm")])
    assert len(pre["epochs"][0]["logs"]) == 2 and np.isfinite(pre["epochs"][0]["val"])
    model_dir = str(tmp_path / "damsm" / "Model")
    gan = _preset_yaml("coco_attn2", tmp_path / "gan.yml", TEXT=text,
                       TRAIN={"BATCH_SIZE": 4, "NET_E": model_dir}, **tiny)
    argv = ["--cfg", gan, "--device", "cpu", "--output_dir", str(tmp_path / "gan")]
    first = gan_main.main(argv + ["--max_epoch", "1"])
    second = gan_main.main(argv + ["--max_epoch", "2"])
    assert [first["resumed_from"], second["resumed_from"]] == [None, 0]
    assert [e["steps"] for e in first["epochs"] + second["epochs"]] == [2, 2]
    logs = second["epochs"][0]["logs"]
    assert sorted(logs) == sorted(log_keys(3)) and all(np.isfinite(list(logs.values())))
    saved = Checkpointer(str(tmp_path / "gan" / "Model")).restore()
    assert saved["step"] == 4 and "h_net3.residual.2.block.1.weight" in saved["g_ema"]

    net_g = {**saved["generator"], **saved["g_ema"]}
    net_g = {k: v[:, :, None, None] if k.endswith("att.conv_context.weight") else v
             for k, v in net_g.items()}
    torch.save(net_g, tmp_path / "netG.pth")
    torch.save(Checkpointer(model_dir).restore()["text_encoder"],
               tmp_path / "text_encoder.pth")
    ev = _preset_yaml("eval_coco", tmp_path / "eval.yml", TEXT=text, B_VALIDATION=True,
                      TRAIN={"BATCH_SIZE": 4, "NET_G": str(tmp_path / "netG.pth"),
                             "NET_E": str(tmp_path / "text_encoder.pth")}, **tiny)
    out = gan_main.main(["--cfg", ev, "--device", "cpu", "--manualSeed", "1",
                         "--output_dir", str(tmp_path / "eval")])
    assert out["mode"] == "sampling"
    assert sorted(os.listdir(out["samples_dir"])) == [
        f"COCO_test_{i:06d}_s-1.png" for i in range(6)]
