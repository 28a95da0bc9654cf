"""The port's DAMSM pretraining against the JAX package's ``DAMSMTrainer``:
one train step from the same weights, batch and dropout mask (losses,
gradients, BatchNorm running statistics, updated parameters), the eval
step, the frozen trunk, the learning-rate schedule and the optimizer reset;
then the port's epoch loop (logs and attention dumps) and its CLI on the
CPU, which writes a checkpoint and resumes from it.

Precision: the comparison runs the image and text encoders in float64 on
both sides (JAX under ``jax.enable_x64`` with ``JAX.DTYPE`` float64; both
losses stay float32, as the JAX package casts them).  In float32 the
train-mode BatchNorm of the tiny trunk (Mixed_7 maps of 1 x 1 at input 75:
batch statistics of 8 values) amplifies rounding to ~1e-2 in the global
code, which would hide a fault (tests/test_torch_inception.py).

Tolerances: logs rtol 2e-5; text gradients rtol 1e-4 / atol 1e-6, image
heads' gradients rtol 1e-4 / atol 1e-5 (JAX's average pool rounds through
float32 even in float64 mode, ~6e-6 in the regions); running statistics
atol 2e-5.  Updated parameters: Adam's first update is
lr * g / (|g| + 1e-8), about lr * sign(g), so it moves by at most
lr * 1e-3 where the two gradients agree to 1e-3 (over 99% of the entries,
checked), and by up to 2 lr where they do not (entries of a near-zero
gradient, whose sign is noise).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sba_gan_tpu.config import cfg_from_dict as jax_cfg_from_dict
from sba_gan_tpu.losses.damsm import sent_loss as jax_sent_loss
from sba_gan_tpu.losses.damsm import words_loss as jax_words_loss
from sba_gan_tpu.train.damsm import DAMSMTrainer as JaxTrainer
from sba_gan_tpu.train.damsm import build_damsm_models as jax_build
from sba_gan_tpu_torch import pretrain
from sba_gan_tpu_torch.config import cfg_from_dict
from sba_gan_tpu_torch.data.pipeline import DataLoader, build_dataset
from sba_gan_tpu_torch.train.damsm import (
    LOG_KEYS,
    DAMSMTrainer,
    build_damsm_models,
    epoch_lr,
    image_trainable_mask,
)
from sba_gan_tpu_torch.utils import weights as W
from sba_gan_tpu_torch.utils.checkpoint import Checkpointer

N_WORDS, B, T, SIZE, LR = 30, 8, 6, 75, 2e-3
TINY = {"TREE": {"BRANCH_NUM": 1}, "TEXT": {"EMBEDDING_DIM": 32, "WORDS_NUM": T},
        "MODEL": {"INCEPTION_INPUT": SIZE}, "TRAIN": {"ENCODER_LR": LR}}
GRAD = dict(rtol=1e-4, atol=1e-6)


def make_batch():
    rng = np.random.default_rng(11)
    img = rng.uniform(-1, 1, (B, SIZE, SIZE, 3))
    cap_lens = rng.integers(1, T + 1, (B,)).astype(np.int32)
    cap_lens[0], cap_lens[1] = 1, T
    captions = np.zeros((B, T), np.int32)
    for i, n in enumerate(cap_lens):
        captions[i, :n] = rng.integers(1, N_WORDS, (n,))
    class_ids = np.array([0, 1, 0, 2, 3, 1, 4, 5], np.int32)
    return img, captions, cap_lens, class_ids


@pytest.fixture(scope="module")
def jax_run():
    """The JAX trainer's state, its step, its gradients and eval logs, and
    the dropout mask of that step, all as numpy."""
    img, captions, cap_lens, class_ids = make_batch()
    key = jax.random.PRNGKey(1)
    with jax.enable_x64(True):
        cfg = jax_cfg_from_dict({**TINY, "JAX": {"DTYPE": "float64"}})
        models = jax_build(cfg, N_WORDS)
        trainer = JaxTrainer(cfg, models, N_WORDS)
        state = trainer.init_state(jax.random.PRNGKey(0))
        args = (jnp.asarray(img), jnp.asarray(captions), jnp.asarray(cap_lens),
                jnp.asarray(class_ids))
        eval_logs = trainer.eval_step(state, *args)
        new_state, logs = trainer.train_step(state, *args, key)

        rng = jax.random.fold_in(key, state.step)  # as the trainer draws it
        _, inter = models.text_encoder.apply(
            {"params": state.text_params}, args[1], args[2], train=True,
            rngs={"dropout": rng}, capture_intermediates=True)
        keep = np.asarray(inter["intermediates"]["Dropout_0"]["__call__"][0]) != 0
        trunk = {k: v for k, v in state.image_params.items() if k == "backbone"}
        heads = {k: v for k, v in state.image_params.items() if k != "backbone"}

        def total(text_params, head_params):
            (region, code), _ = models.image_encoder.apply(
                {"params": {**trunk, **head_params},
                 "batch_stats": state.image_batch_stats},
                args[0], True, mutable=["batch_stats"])
            words, sent = models.text_encoder.apply(
                {"params": text_params}, args[1], args[2], train=True,
                rngs={"dropout": rng})
            labels = jnp.arange(B)
            g = cfg.TRAIN.SMOOTH
            w0, w1 = jax_words_loss(region, words, labels, args[2], args[3],
                                    g.GAMMA1, g.GAMMA2, g.GAMMA3)
            s0, s1 = jax_sent_loss(code, sent, labels, args[3], g.GAMMA3)
            return w0 + w1 + s0 + s1

        text_grads, head_grads = jax.grad(total, argnums=(0, 1))(
            state.text_params, heads)
        out = jax.tree.map(np.asarray, dict(
            state=dict(text=state.text_params, image=state.image_params,
                       stats=state.image_batch_stats),
            new=dict(text=new_state.text_params, image=new_state.image_params,
                     stats=new_state.image_batch_stats),
            logs=logs, eval_logs=eval_logs, text_grads=text_grads,
            head_grads=head_grads))
    out["keep"] = keep
    return out


@pytest.fixture(scope="module")
def port_run(jax_run):
    """The port's trainer from the same weights, eval logs, then one step."""
    img, captions, cap_lens, class_ids = make_batch()
    cfg = cfg_from_dict(TINY)
    models = build_damsm_models(cfg, N_WORDS)
    s = jax_run["state"]
    models.text_encoder.load_state_dict(W.rnn_encoder_state_dict(s["text"]))
    models.image_encoder.load_state_dict(W.cnn_encoder_state_dict(s["image"], s["stats"]))
    models.text_encoder.double()
    models.image_encoder.double()
    trainer = DAMSMTrainer(cfg, models, device="cpu")
    before = {k: v.clone() for k, v in trainer.image_encoder.state_dict().items()}
    text_before = [p.detach().clone() for p in trainer.text_params]
    batch = (torch.from_numpy(img), torch.from_numpy(captions).long(),
             torch.from_numpy(cap_lens).long(), torch.from_numpy(class_ids).long())
    eval_logs = trainer.eval_step(*batch)
    logs = trainer.train_step(*batch, keep_mask=torch.from_numpy(jax_run["keep"]))
    return dict(trainer=trainer, logs=logs, eval_logs=eval_logs, before=before,
                text_before=text_before)


def _close_update(new, old, want_new, want_old, g_port, g_jax):
    """Updated parameter against JAX's, per the module docstring."""
    d_port = np.asarray(new, np.float64) - np.asarray(old, np.float64)
    d_jax = np.asarray(want_new, np.float64) - np.asarray(want_old, np.float64)
    g_port, g_jax = np.asarray(g_port, np.float64), np.asarray(g_jax, np.float64)
    agree = np.abs(g_port - g_jax) <= 1e-3 * np.abs(g_jax)
    diff = np.abs(d_port - d_jax)
    assert agree.mean() > 0.99
    assert diff[agree].max(initial=0.0) <= 1e-3 * LR
    assert diff[~agree].max(initial=0.0) <= 2 * LR + 1e-6


def test_logs_match(jax_run, port_run):
    for key in LOG_KEYS:
        np.testing.assert_allclose(float(port_run["logs"][key]),
                                   float(jax_run["logs"][key]), rtol=2e-5, err_msg=key)
        np.testing.assert_allclose(float(port_run["eval_logs"][key]),
                                   float(jax_run["eval_logs"][key]), rtol=2e-5,
                                   err_msg=f"eval {key}")


def test_gradients_match(jax_run, port_run):
    tr = port_run["trainer"]
    # the text side is clipped to global norm 0.25 with optax's formula
    want = W.rnn_encoder_state_dict(_scale_tree(jax_run["text_grads"],
                                                _clip_scale(jax_run["text_grads"])))
    for name, p in tr.text_encoder.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), err_msg=name, **GRAD)
    heads = W.cnn_encoder_state_dict(jax_run["head_grads"], {})
    for name, p in tr.image_encoder.named_parameters():
        if name in heads:
            np.testing.assert_allclose(p.grad.numpy(), heads[name].numpy(),
                                       err_msg=name, rtol=1e-4, atol=1e-5)
        else:
            assert p.grad is None and not p.requires_grad, name


def _clip_scale(tree, max_norm=0.25):
    """optax's clip_by_global_norm factor for the gradient tree."""
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                       for g in W.flatten_tree(tree).values()))
    return 1.0 if norm < max_norm else max_norm / norm


def _scale_tree(tree, scale):
    return {k: _scale_tree(v, scale) if isinstance(v, dict) else v * scale
            for k, v in tree.items()}


def test_running_stats_and_updated_params(jax_run, port_run):
    tr = port_run["trainer"]
    new, old = jax_run["new"], jax_run["state"]
    got = tr.image_encoder.state_dict()
    want = W.cnn_encoder_state_dict(new["image"], new["stats"])
    start = W.cnn_encoder_state_dict(old["image"], old["stats"])
    head_g = W.cnn_encoder_state_dict(jax_run["head_grads"], {})
    params = dict(tr.image_encoder.named_parameters())
    for name, value in want.items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[name].numpy(), value.numpy(), rtol=0,
                                       atol=2e-5, err_msg=name)
        elif name in head_g:
            _close_update(got[name], port_run["before"][name], value, start[name],
                          params[name].grad, head_g[name].numpy())
    text_want = W.rnn_encoder_state_dict(new["text"])
    text_old = W.rnn_encoder_state_dict(old["text"])
    text_g = W.rnn_encoder_state_dict(_scale_tree(jax_run["text_grads"],
                                                  _clip_scale(jax_run["text_grads"])))
    for (name, p), p0 in zip(tr.text_encoder.named_parameters(), port_run["text_before"]):
        _close_update(p.detach(), p0, text_want[name], text_old[name], p.grad,
                      text_g[name].numpy())


def test_trunk_frozen_heads_and_text_move(port_run):
    tr, before = port_run["trainer"], port_run["before"]
    after = tr.image_encoder.state_dict()
    mask = image_trainable_mask(tr.image_encoder)
    for name, trains in mask.items():
        assert torch.equal(after[name], before[name]) != trains, name
    assert any(not torch.equal(after[k], before[k])
               for k in after if k.endswith("running_mean"))
    assert all(not torch.equal(p, p0) for p, p0 in
               zip(tr.text_params, port_run["text_before"]))
    assert sorted({n.split(".")[0] for n, t in mask.items() if t}) == [
        "emb_cnn_code", "emb_features"]
    mixed7 = image_trainable_mask(tr.image_encoder, unfreeze_mixed7=True)
    assert mixed7["Mixed_7b.branch1x1.conv.weight"]
    assert not mixed7["Mixed_6e.branch1x1.conv.weight"]


def test_epoch_lr_and_reset_optimizer(port_run):
    assert epoch_lr(2e-4, 0) == 2e-4
    assert np.isclose(epoch_lr(2e-4, 1), 2e-4 * 0.98)
    assert epoch_lr(2e-4, 1000) >= 2e-4 / 10 * 0.98
    tr = port_run["trainer"]
    lr = tr.reset_optimizer(5)
    assert np.isclose(lr, epoch_lr(LR, 5))
    for opt in (tr.text_opt, tr.image_opt):
        assert all(np.isclose(g["lr"], lr) and g["betas"] == (0.5, 0.999)
                   and g["eps"] == 1e-8 for g in opt.param_groups)
        assert len(opt.state) == 0  # moments reset


@pytest.mark.parametrize("loss_dtype", ["bfloat16", "float16"])
def test_loss_dtype_sets_the_kernels_mm_dtype(loss_dtype):
    """``LOSS_DTYPE`` bfloat16 becomes K1-K3's ``mm_dtype``; float16, which no
    path of the port has, raises."""
    cfg = cfg_from_dict({**TINY, "JAX": {"LOSS_DTYPE": loss_dtype}})
    if loss_dtype == "float16":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            DAMSMTrainer(cfg, build_damsm_models(cfg, N_WORDS), device="cpu")
        return
    trainer = DAMSMTrainer(cfg, build_damsm_models(cfg, N_WORDS), device="cpu")
    assert trainer.mm_dtype == torch.bfloat16


def test_checkpointer_round_trip(tmp_path):
    ckpt = Checkpointer(str(tmp_path), max_to_keep=2)
    assert ckpt.latest_step() is None
    for step in range(3):
        ckpt.save(step, {"w": torch.full((2,), float(step)), "step": step})
    assert ckpt.steps() == [1, 2] and ckpt.latest_step() == 2
    assert torch.equal(ckpt.restore()["w"], torch.full((2,), 2.0))
    assert ckpt.restore(1)["step"] == 1


CLI_TINY = {"TREE": {"BRANCH_NUM": 1, "BASE_SIZE": 64}, "TRAIN": {"BATCH_SIZE": 8},
            "TEXT": {"EMBEDDING_DIM": 32, "WORDS_NUM": T},
            "MODEL": {"INCEPTION_INPUT": SIZE}}


def test_run_epoch_logs_and_dumps_attention(tmp_path):
    cfg = cfg_from_dict(CLI_TINY)
    ds = build_dataset(cfg, True, "train")
    trainer = DAMSMTrainer(cfg, build_damsm_models(cfg, ds.n_words), device="cpu")
    loader = DataLoader(ds, 8, shuffle=True, drop_last=True, seed=0)
    logs, step_ms = pretrain.run_epoch(trainer, loader, log_every=2,
                                       image_dir=str(tmp_path), ixtoword=ds.ixtoword,
                                       epoch=3)
    assert len(logs) == len(step_ms) == 4  # 32 synthetic items, batch 8
    assert all(sorted(l) == sorted(LOG_KEYS) for l in logs)
    assert sorted(os.listdir(tmp_path)) == ["attn_3_2.png", "attn_3_4.png"]


def test_cli_on_cpu_saves_and_resumes(tmp_path):
    yml = tmp_path / "damsm_tiny.yml"
    yml.write_text(yaml.safe_dump(CLI_TINY))
    out = tmp_path / "out"
    argv = ["--cfg", str(yml), "--synthetic", "--device", "cpu",
            "--output_dir", str(out)]
    first = pretrain.main(argv + ["--max_epoch", "1"])
    assert first["resumed_from"] is None and [e["epoch"] for e in first["epochs"]] == [0]
    epoch0 = first["epochs"][0]
    assert len(epoch0["logs"]) == 4  # 32 synthetic items, batch 8, drop_last
    assert all(np.isfinite(v) for logs in epoch0["logs"] for v in logs.values())
    assert np.isfinite(epoch0["val"])
    ckpt = Checkpointer(str(out / "Model"))
    assert ckpt.latest_step() == 0
    saved = ckpt.restore()
    assert saved["step"] == 4

    second = pretrain.main(argv + ["--max_epoch", "2"])
    assert second["resumed_from"] == 0
    assert [e["epoch"] for e in second["epochs"]] == [1]
    assert np.isclose(second["epochs"][0]["lr"], epoch_lr(2e-4, 1))
    assert ckpt.latest_step() == 1 and ckpt.restore()["step"] == 8
