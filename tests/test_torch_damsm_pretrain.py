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
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sba_gan_tpu.config import cfg_from_dict as jax_cfg_from_dict
from sba_gan_tpu.models import inception as jax_inception
from sba_gan_tpu.losses.damsm import sent_loss as jax_sent_loss
from sba_gan_tpu.losses.damsm import words_loss as jax_words_loss
from sba_gan_tpu.train.damsm import DAMSMTrainer as JaxTrainer
from sba_gan_tpu.train.damsm import build_damsm_models as jax_build
from sba_gan_tpu_torch import pretrain
from sba_gan_tpu_torch.config import cfg_from_dict
from sba_gan_tpu_torch.data.pipeline import DataLoader, build_dataset
from sba_gan_tpu_torch.parallel import dist
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
# DAMSM/coco.yml's structure at the tiny widths: WORDS_NUM 15, ENCODER_LR
# 0.002 (LR), CAPTIONS_PER_IMAGE 5 (the reader's)
COCO_T = 15
COCO = {**TINY, "TEXT": {**TINY["TEXT"], "WORDS_NUM": COCO_T, "CAPTIONS_PER_IMAGE": 5}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs six
    test processes on the CPU, and small ops slow down by an order of
    magnitude when every process spins eight threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_batch(coco=False):
    """One batch of B: CUB-like (six classes, captions of up to T words) or,
    with ``coco``, as DAMSM/coco.yml reads COCO (captions of up to COCO_T
    words, every image its own class)."""
    rng = np.random.default_rng(11)
    t = COCO_T if coco else T
    img = rng.uniform(-1, 1, (B, SIZE, SIZE, 3))
    cap_lens = rng.integers(1, t + 1, (B,)).astype(np.int32)
    cap_lens[0], cap_lens[1] = 1, t
    captions = np.zeros((B, t), np.int32)
    for i, n in enumerate(cap_lens):
        captions[i, :n] = rng.integers(1, N_WORDS, (n,))
    class_ids = (np.arange(B, dtype=np.int32) if coco
                 else np.array([0, 1, 0, 2, 3, 1, 4, 5], np.int32))
    return img, captions, cap_lens, class_ids


def _jax_step(models, trainer, state, args, key, chunks=1):
    """The JAX trainer's step from ``state`` as numpy, with the gradients of
    the same losses (the image encoder over ``chunks`` sequential
    sub-batches, its BatchNorm statistics threaded through them in order by
    a scan, as the trainer's) and the dropout mask of that step."""
    cfg = trainer.cfg
    new_state, logs = trainer.train_step(state, *args, key)
    rng = jax.random.fold_in(key, state.step)  # as the trainer draws it
    _, inter = models.text_encoder.apply(
        {"params": state.text_params}, args[1], args[2], train=True,
        rngs={"dropout": rng}, capture_intermediates=True)
    keep = np.asarray(inter["intermediates"]["Dropout_0"]["__call__"][0]) != 0
    trunk = {k: v for k, v in state.image_params.items() if k == "backbone"}
    heads = {k: v for k, v in state.image_params.items() if k != "backbone"}

    def image_features(head_params):
        variables = {"params": {**trunk, **head_params},
                     "batch_stats": state.image_batch_stats}
        if chunks == 1:
            (region, code), _ = models.image_encoder.apply(
                variables, args[0], True, mutable=["batch_stats"])
            return region, code

        def body(stats, part):
            (region, code), mut = models.image_encoder.apply(
                {**variables, "batch_stats": stats}, part, True, mutable=["batch_stats"])
            return mut["batch_stats"], (region, code)

        parts = args[0].reshape(chunks, B // chunks, *args[0].shape[1:])
        _, (region, code) = jax.lax.scan(body, state.image_batch_stats, parts)
        return region.reshape(B, *region.shape[2:]), code.reshape(B, -1)

    def total(text_params, head_params):
        region, code = image_features(head_params)
        words, sent = models.text_encoder.apply(
            {"params": text_params}, args[1], args[2], train=True,
            rngs={"dropout": rng})
        labels = jnp.arange(B)
        g = cfg.TRAIN.SMOOTH
        w0, w1 = jax_words_loss(region, words, labels, args[2], args[3],
                                g.GAMMA1, g.GAMMA2, g.GAMMA3)
        s0, s1 = jax_sent_loss(code, sent, labels, args[3], g.GAMMA3)
        return w0 + w1 + s0 + s1

    grad = jax.grad(total, argnums=(0, 1))
    text_grads, head_grads = (grad if chunks == 1 else jax.jit(grad))(
        state.text_params, heads)
    out = jax.tree.map(np.asarray, dict(
        state=dict(text=state.text_params, image=state.image_params,
                   stats=state.image_batch_stats),
        new=dict(text=new_state.text_params, image=new_state.image_params,
                 stats=new_state.image_batch_stats),
        logs=logs, text_grads=text_grads, head_grads=head_grads))
    out["keep"] = keep
    return out


@pytest.fixture(scope="module")
def jax_init():
    """The JAX models, trainer and initial state (float64 compute)."""
    with jax.enable_x64(True):
        cfg = jax_cfg_from_dict({**TINY, "JAX": {"DTYPE": "float64"}})
        models = jax_build(cfg, N_WORDS)
        trainer = JaxTrainer(cfg, models, N_WORDS)
        state = trainer.init_state(jax.random.PRNGKey(0))
    return models, trainer, state


def _jax_args(coco=False):
    return tuple(jnp.asarray(a) for a in make_batch(coco))


@pytest.fixture(scope="module")
def jax_run(jax_init):
    """The JAX trainer's state, its step, its gradients and eval logs, and
    the dropout mask of that step, all as numpy."""
    models, trainer, state = jax_init
    with jax.enable_x64(True):
        args = _jax_args()
        eval_logs = trainer.eval_step(state, *args)
        out = _jax_step(models, trainer, state, args, jax.random.PRNGKey(1))
        out["eval_logs"] = jax.tree.map(np.asarray, eval_logs)
    return out


def _port_trainer(run, chunks=1, raw=TINY):
    """The port's trainer (float64) of the config ``raw`` from the weights
    of a JAX run's state."""
    cfg = cfg_from_dict({**raw, "JAX": {"DAMSM_CHUNKS": chunks}})
    models = build_damsm_models(cfg, N_WORDS)
    s = run["state"]
    models.text_encoder.load_state_dict(W.rnn_encoder_state_dict(s["text"]))
    models.image_encoder.load_state_dict(W.cnn_encoder_state_dict(s["image"], s["stats"]))
    models.text_encoder.double()
    models.image_encoder.double()
    return DAMSMTrainer(cfg, models, device="cpu")


def _port_batch(coco=False):
    img, captions, cap_lens, class_ids = make_batch(coco)
    return (torch.from_numpy(img), torch.from_numpy(captions).long(),
            torch.from_numpy(cap_lens).long(), torch.from_numpy(class_ids).long())


def _port_step(trainer, run, coco=False):
    """One step of the port's trainer with the JAX run's dropout mask, and
    what it started from."""
    before = {k: v.clone() for k, v in trainer.image_encoder.state_dict().items()}
    text_before = [p.detach().clone() for p in trainer.text_params]
    logs = trainer.train_step(*_port_batch(coco), keep_mask=torch.from_numpy(run["keep"]))
    return dict(trainer=trainer, logs=logs, before=before, text_before=text_before)


@pytest.fixture(scope="module")
def port_run(jax_run):
    """The port's trainer from the same weights, eval logs, then one step."""
    trainer = _port_trainer(jax_run)
    eval_logs = trainer.eval_step(*_port_batch())
    return dict(_port_step(trainer, jax_run), eval_logs=eval_logs)


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
    _check_gradients(jax_run, port_run)


def _check_gradients(jax_run, port_run):
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
    _check_stats_and_params(jax_run, port_run)


def _check_stats_and_params(jax_run, port_run):
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


def _avg_pool_f64(x):
    """JAX's ``avg_pool_3x3_s1_pad1`` (torch's 3 x 3 average, stride 1,
    padding 1, divisor 9) without its round trip through float32."""
    s = jax.lax.reduce_window(x, 0.0, jax.lax.add, (1, 3, 3, 1), (1, 1, 1, 1),
                              ((0, 0), (1, 1), (1, 1), (0, 0)))
    return s / 9.0


@pytest.fixture(scope="module")
def coco_runs(jax_init):
    """The DAMSM/coco structure (COCO) from ``jax_init``'s weights, which
    no width of it changes: JAX's trainer and the port's, one step and the
    eval logs each, on the COCO batch.  JAX traces its average pool in
    float64 (as for the chunk cases): its float32 round trip moves the
    image heads' gradients by ~4e-7, which on this batch puts one of
    ``emb_cnn_code.bias``'s 32 entries (4.1e-4) past the 1e-3 agreement
    of Adam's first update."""
    models, _, state = jax_init
    with jax.enable_x64(True), mock.patch.object(jax_inception, "avg_pool_3x3_s1_pad1",
                                                 _avg_pool_f64):
        cfg = jax_cfg_from_dict({**COCO, "JAX": {"DTYPE": "float64"}})
        trainer = JaxTrainer(cfg, models, N_WORDS)
        args = _jax_args(coco=True)
        want = _jax_step(models, trainer, state, args, jax.random.PRNGKey(1))
        want["eval_logs"] = jax.tree.map(np.asarray, trainer.eval_step(state, *args))
    port = _port_trainer(want, raw=COCO)
    eval_logs = port.eval_step(*_port_batch(coco=True))
    return want, dict(_port_step(port, want, coco=True), eval_logs=eval_logs)


@pytest.mark.parametrize("check", ["logs", "gradients", "stats_and_params"])
def test_coco_step_matches_jax(coco_runs, check):
    """One DAMSM/coco step (T 15, every image its own class, so no pair is
    masked as the same class) against JAX at the bird step's tolerances:
    train and eval logs, gradients, running statistics and updated
    parameters."""
    want, got = coco_runs
    assert got["trainer"].cfg.TEXT.WORDS_NUM == COCO_T
    if check == "logs":
        for key in LOG_KEYS:
            for logs in ("logs", "eval_logs"):
                np.testing.assert_allclose(float(got[logs][key]), float(want[logs][key]),
                                           rtol=2e-5, err_msg=f"{logs} {key}")
    elif check == "gradients":
        _check_gradients(want, got)
    else:
        _check_stats_and_params(want, got)


CHUNKS = (2, 4)


@pytest.fixture(scope="module")
def chunked_jax_runs(jax_init):
    """For each ``JAX.DAMSM_CHUNKS`` c of CHUNKS, the JAX trainer's step (its
    scan over c sequential sub-batches of the Inception) from ``jax_init``'s
    state, the two compiled in threads.  The scan carries the running
    statistics in the dtype they come out in, so the initial ones go in as
    float64 (exactly).

    JAX's average pool rounds through float32 even under x64; with 4 or 2
    rows a sub-batch, Mixed_7's batch statistics (1 x 1 maps) amplify that
    rounding to ~1e-4 in the sentence losses (read at c 4: 1.25e-4
    relative; tests/test_torch_inception.py), so here the JAX modules trace
    the same pool in float64, and the step is held at the one-pass
    tolerances."""
    models, _, state = jax_init

    def run(chunks):
        with jax.enable_x64(True):
            cfg = jax_cfg_from_dict({**TINY, "JAX": {"DTYPE": "float64",
                                                     "DAMSM_CHUNKS": chunks}})
            trainer = JaxTrainer(cfg, models, N_WORDS)
            start = state.replace(image_batch_stats=jax.tree.map(
                lambda x: x.astype(jnp.float64), state.image_batch_stats))
            return _jax_step(models, trainer, start, _jax_args(), jax.random.PRNGKey(1),
                             chunks)

    with mock.patch.object(jax_inception, "avg_pool_3x3_s1_pad1", _avg_pool_f64), \
            ThreadPoolExecutor(len(CHUNKS)) as pool:
        return dict(zip(CHUNKS, pool.map(run, CHUNKS)))


@pytest.fixture(scope="module", params=CHUNKS)
def chunked_runs(request, chunked_jax_runs):
    """c, the JAX run of c and the port's step with c sub-batches from the
    same weights, batch and dropout mask."""
    chunks = request.param
    run = chunked_jax_runs[chunks]
    return chunks, run, _port_step(_port_trainer(run, chunks), run)


def test_chunked_step_matches_jax(chunked_runs, jax_run):
    """Sequential sub-batches of the train-mode Inception against the JAX
    trainer's: logs, gradients, running statistics and updated parameters
    at the tolerances of the one-pass step; the eval step stays one pass."""
    chunks, run, port = chunked_runs
    for key in LOG_KEYS:
        np.testing.assert_allclose(float(port["logs"][key]), float(run["logs"][key]),
                                   rtol=2e-5, err_msg=key)
    _check_gradients(run, port)
    _check_stats_and_params(run, port)
    fresh = _port_trainer(jax_run, chunks)
    eval_logs = fresh.eval_step(*_port_batch())
    for key in LOG_KEYS:
        np.testing.assert_allclose(float(eval_logs[key]), float(jax_run["eval_logs"][key]),
                                   rtol=2e-5, err_msg=f"eval {key}")


def test_chunks_change_the_step(chunked_runs, jax_run, port_run):
    """Per-sub-batch statistics are other values: the losses, the gradients
    and the running statistics differ from the one-pass step's, in JAX and
    in the port alike."""
    _, run, port = chunked_runs
    for got, want in ((port["logs"], port_run["logs"]), (run["logs"], jax_run["logs"])):
        assert abs(float(got["total"]) - float(want["total"])) > 1e-4 * abs(float(want["total"]))
    code_g = port["trainer"].image_encoder.emb_cnn_code.weight.grad
    assert not torch.allclose(code_g, port_run["trainer"].image_encoder.emb_cnn_code.weight.grad,
                              rtol=1e-3, atol=0)
    stats = port["trainer"].image_encoder.state_dict()
    one_pass = port_run["trainer"].image_encoder.state_dict()
    key = "Conv2d_1a_3x3.bn.running_mean"
    assert not torch.allclose(stats[key], one_pass[key], rtol=1e-3, atol=0)


def test_chunks_must_divide_the_batch():
    cfg = cfg_from_dict({**TINY, "JAX": {"DAMSM_CHUNKS": 3}})
    trainer = DAMSMTrainer(cfg, build_damsm_models(cfg, N_WORDS, seed=0), device="cpu")
    img, captions, cap_lens, class_ids = _port_batch()
    with pytest.raises(ValueError, match="DAMSM_CHUNKS=3 does not divide the batch 8"):
        trainer.train_step(img.float(), captions, cap_lens, class_ids)


@pytest.mark.parametrize("chunks", [1, 2])
def test_chunks_across_ranks(monkeypatch, chunks):
    """Across ranks the sub-batches (blocks of the global batch) do not line
    up with the ranks' rows: chunks above 1 raise, naming ROADMAP.md; 1
    builds."""
    monkeypatch.setattr(dist, "world_size", lambda: 2)
    cfg = cfg_from_dict({**TINY, "JAX": {"DAMSM_CHUNKS": chunks}})
    models = build_damsm_models(cfg, N_WORDS)
    if chunks > 1:
        with pytest.raises(NotImplementedError, match="DAMSM_CHUNKS=2 across 2 ranks.*ROADMAP"):
            DAMSMTrainer(cfg, models, device="cpu")
    else:
        assert DAMSMTrainer(cfg, models, device="cpu").chunks == 1


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
