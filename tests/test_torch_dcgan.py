"""``GAN.B_DCGAN`` in the port (the attnDCGAN2 path: GDCGAN, its one
discriminator at the final scale without an unconditional head) against the
JAX package, at tiny widths: GF/DF 8, Z 8, W 16, CONDITION 8, EMBEDDING 32,
WORDS 6, Inception input 75, batch 4, BRANCH_NUM 3 (one 256 image, K4's
path in both refinement stages), R_NUM 0 as ``bird_attnDCGAN2.yml``,
lambda 1.  The JAX side gets the port's seeded weights
(``_torch_parity.jax_gan_state``, no Flax init); torch runs on one
intra-op thread.

* GDCGAN's forward (eval mode, random running statistics; the JAX side's
  word attention the Pallas kernel in interpret mode) at R_NUM 0 and 1:
  the image, both maps, ``mu`` and ``logvar``, rtol 1e-5 / atol 1e-5 in
  float32 (measured: 6.3e-6 at most, on an image whose entries reach 1; an
  rtol alone cannot hold at entries near 0, which float32 rounding moves by
  more than 1e-5 of themselves);
* one GAN step against ``make_gan_train_step`` in float64, the tolerances
  of tests/test_torch_grad_accum.py: logs rtol 2e-5; the D's gradients
  atol 2e-5 of each tensor's largest entry; G's per network (the whole of
  G, and each of its top-level modules) within GRAD_REL of JAX's norm with
  a cosine of at least GRAD_COS, every tensor within 2 GRAD_REL, and the
  mapping net's gradient nonzero on both sides (its w code styles both
  refinement stages through AdaIN, at R_NUM 0 too); running statistics
  atol 5e-6 of each tensor's largest entry; the EMA to its own formula
  (1e-12) and to JAX's (1e-3 of 2 lr plus 2e-7);
* the step's generator forward in bfloat16 (``JAX.DTYPE`` bfloat16, train
  mode; the JAX side's K4 in interpret mode, as
  tests/test_torch_bf16_paths.py runs it) against JAX's: the image, the
  maps and the running statistics, within that file's bounds (the rest of
  the bfloat16 step runs the modules that file holds);
* the GDCGAN weight map, Flax -> port -> Flax, exactly; the layout read
  from the config or from the tree;
* the CLI: train, save, resume and render with one image, and two steps on
  CUB-layout JPEGs through the ``b_dcgan`` reader; a reference ``NET_G``
  refused;
* the ``Sampler`` and the WSGI service from an ``.npz`` of the JAX trees
  against JAX's ``make_sample_fn`` with the same noise; ``gen_example``
  writes one stage per caption.

Two ranks over gloo with one D: tests/test_torch_distributed.py ('dcgan').
"""

import copy
import io
import json
import os
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from _torch_parity import flax_tree_from_port, jax_gan_state, rnn_encoder_key
from sba_gan_tpu.config import cfg_from_dict as jax_cfg_from_dict
from sba_gan_tpu.models.generator import build_generator as jax_build_generator
from sba_gan_tpu.train.gan import build_models as jax_build_models
from sba_gan_tpu.train.gan import make_gan_train_step, make_sample_fn
from sba_gan_tpu.train.gan import noise_shape as jax_noise_shape
from sba_gan_tpu_torch import main as gan_main
from sba_gan_tpu_torch.config import cfg_from_dict, preset
from sba_gan_tpu_torch.models.blocks import init_weights
from sba_gan_tpu_torch.models.discriminator import DNet256
from sba_gan_tpu_torch.models.generator import GDCGAN, build_generator
from sba_gan_tpu_torch.train.gan import GANStep, build_models, init_gan_state, log_keys
from sba_gan_tpu_torch.train.loop import GANTrainer
from sba_gan_tpu_torch.train.sample import Sampler
from sba_gan_tpu_torch.utils import torch_port
from sba_gan_tpu_torch.utils import weights as W
from sba_gan_tpu_torch.utils.checkpoint import Checkpointer
from test_torch_cub_data import _write_tree

N_WORDS, B, T, LR = 30, 4, 6, 2e-4
GRAD_REL, GRAD_COS = 2e-2, 0.9999  # as tests/test_torch_grad_accum.py
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
SAMPLER_TOL = dict(rtol=1e-4, atol=1e-5)  # as tests/test_torch_bert_paths.py's sampler
# tests/test_torch_bf16_paths.py's TOL: sampler_images, gan_logs, gan_stats_G
BF16_TOL = {"images": 0.15, "logs": 3e-2, "stats_G": 5e-5}
TINY = {"TREE": {"BRANCH_NUM": 3, "BASE_SIZE": 64},
        "GAN": {"GF_DIM": 8, "DF_DIM": 8, "Z_DIM": 8, "W_DIM": 16, "CONDITION_DIM": 8,
                "R_NUM": 0, "B_DCGAN": True},
        "TEXT": {"EMBEDDING_DIM": 32, "WORDS_NUM": T},
        "MODEL": {"INCEPTION_INPUT": 75},
        "TRAIN": {"BATCH_SIZE": B, "GENERATOR_LR": LR, "DISCRIMINATOR_LR": LR,
                  "SMOOTH": {"GAMMA1": 4.0, "GAMMA2": 5.0, "GAMMA3": 10.0, "LAMBDA": 1.0}}}
BF16 = {"DTYPE": "bfloat16", "LOSS_DTYPE": "bfloat16"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as tests/test_torch_bert_paths.py: the suite runs
    six test processes on the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny(**over) -> dict:
    d = copy.deepcopy(TINY)
    for group, keys in over.items():
        d.setdefault(group, {}).update(keys)
    return d


def _captions(rng, lens):
    captions = np.zeros((len(lens), T), np.int32)
    for i, n in enumerate(lens):
        captions[i, :n] = rng.integers(1, N_WORDS, n)
    return captions


def make_batch():
    rng = np.random.default_rng(5)
    imgs = [rng.uniform(-1, 1, (B, s, s, 3)) for s in (64, 128, 256)]
    cap_lens = np.array([T, 3, 1, 5], np.int32)
    return imgs, _captions(rng, cap_lens), cap_lens, np.array([0, 1, 0, 2], np.int32)


def random_stats(module, seed):
    gen = torch.Generator().manual_seed(seed)
    for n, b in module.named_buffers():
        if n.endswith("running_mean"):
            b.normal_(0.0, 0.5, generator=gen)
        elif n.endswith("running_var"):
            b.uniform_(0.5, 2.0, generator=gen)


def dcgan_key(path):
    return W.g_net_key(path, dcgan=True)


# ------------------------------------------------------------------ forward


@pytest.mark.parametrize("r_num", [0, 1])
def test_gdcgan_forward_matches_jax(r_num):
    raw = tiny(GAN={"R_NUM": r_num})
    net = build_generator(cfg_from_dict(raw))
    assert isinstance(net, GDCGAN)
    init_weights(net, torch.Generator().manual_seed(0))
    random_stats(net, 1)
    rng = np.random.default_rng(2)
    z = rng.standard_normal((2, 8)).astype(np.float32)
    sent = rng.standard_normal((2, 32)).astype(np.float32)
    words = rng.standard_normal((2, T, 32)).astype(np.float32)
    pad = np.arange(T)[None, :] >= np.array([T, 3])[:, None]
    rng_ca = jax.random.PRNGKey(5)
    eps = np.array(jax.random.normal(rng_ca, (2, 8), jnp.float32))
    args = (jnp.asarray(z), jnp.asarray(sent), jnp.asarray(words), jnp.asarray(pad), rng_ca)

    g = jax_build_generator(jax_cfg_from_dict(raw)).clone(attn_impl="interpret")
    abstract = jax.eval_shape(lambda: g.init(jax.random.PRNGKey(0), *args, True))
    variables = {c: flax_tree_from_port(abstract[c], net.state_dict(), dcgan_key)
                 for c in ("params", "batch_stats")}
    fakes_j, atts_j, mu_j, logvar_j = jax.jit(lambda v, *a: g.apply(v, *a, False))(
        variables, *args)
    net.eval()
    with torch.no_grad():
        fakes, atts, mu, logvar = net(*(torch.from_numpy(a) for a in (z, sent, words, pad,
                                                                      eps)))
    assert [f.shape for f in fakes] == [(2, 256, 256, 3)]
    assert [a.shape for a in atts] == [(2, s, s, T) for s in (64, 128)]
    for got, want in zip(fakes + atts + [mu, logvar],
                         list(fakes_j) + list(atts_j) + [mu_j, logvar_j]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


# --------------------------------------------------------------- the steps


def _jax_tree(state) -> dict:
    return {"g": {"params": state.g.params, "batch_stats": state.g.batch_stats},
            "g_ema": state.g_ema,
            "ds": [{"params": d.params, "batch_stats": d.batch_stats} for d in state.ds],
            "text": state.text, "image": state.image}


def _lower(raw, models, batch):
    """JAX's step of ``raw`` in float64 (call under ``jax.enable_x64``)
    lowered on the port's weights and ``batch``; the noise it draws in its
    first step."""
    imgs, captions, cap_lens, class_ids = batch
    jcfg = jax_cfg_from_dict({**raw, "JAX": {"DTYPE": "float64"}})
    jmodels = jax_build_models(jcfg, N_WORDS)
    state = jax_gan_state(jcfg, jmodels, models, rnn_encoder_key)
    key = jax.random.PRNGKey(3)
    r_z, r_ca = jax.random.split(jax.random.fold_in(key, 0))  # the step's own draws
    noise = (np.asarray(jax.random.normal(r_z, jax_noise_shape(jcfg, B), jnp.float32)),
             np.asarray(jax.random.normal(r_ca, (B, 8), jnp.float32)))
    args = (state, tuple(jnp.asarray(i) for i in imgs), jnp.asarray(captions),
            jnp.asarray(cap_lens), jnp.asarray(class_ids), key)
    return jax.jit(make_gan_train_step(jcfg, jmodels)).lower(*args), args, noise


def _port_step(raw, models, batch, noise):
    """One port step of ``raw`` in float64 from ``models``: logs, gradients,
    state dicts before and after."""
    cfg = cfg_from_dict(raw)
    for m in (models.text_encoder, models.image_encoder, models.generator,
              *models.discriminators):
        m.double()
    state = init_gan_state(cfg, models, device="cpu")
    before = copy.deepcopy(state.state_dict())
    imgs, captions, cap_lens, class_ids = batch
    z, eps = (torch.from_numpy(a.copy()).double() for a in noise)
    logs = GANStep(cfg, state)([torch.from_numpy(i) for i in imgs],
                               torch.from_numpy(captions).long(),
                               torch.from_numpy(cap_lens).long(),
                               torch.from_numpy(class_ids).long(), z=z, eps=eps)
    nets = {"G": state.generator, "D0": state.discriminators[0]}
    return {"logs": {k: float(v) for k, v in logs.items()},
            "grads": {n: {k: p.grad.double().numpy() for k, p in m.named_parameters()}
                      for n, m in nets.items()},
            "before": before, "after": copy.deepcopy(state.state_dict()),
            "n_ds": len(state.discriminators),
            "uncond": [d.UNCOND_DNET for d in state.discriminators]}


def _jax_result(step, args) -> dict:
    new, logs = step(*args)
    new = jax.tree.map(np.asarray, new)
    return {"logs": {k: float(v) for k, v in logs.items()},
            "grads": {"G": {k: 2 * v.double().numpy() for k, v in
                            W.g_net_state_dict(new.g.opt_state[0].mu, {}, True).items()},
                      "D0": {k: 2 * v.double().numpy() for k, v in
                             W.d_net_state_dict(new.ds[0].opt_state[0].mu, {}).items()}},
            "after": W.gan_state_from_jax(_jax_tree(new))}


def _cli_runs(root) -> dict:
    """``main`` twice on one output directory at batch 8 (one epoch of 4
    steps, then a resume to epoch 2), then a trainer that resumes from its
    checkpoint and renders one batch, and ``main`` on a mini CUB tree: the
    summaries, the directory, the reader's images of one item, the
    trainer's step and the rendered files."""
    from sba_gan_tpu_torch.config import cfg_from_file
    from sba_gan_tpu_torch.data.pipeline import DataLoader, build_dataset

    yml = root / "dcgan.yml"
    yml.write_text(yaml.safe_dump(tiny(TRAIN={"BATCH_SIZE": 8})))
    out = root / "out"
    argv = ["--cfg", str(yml), "--synthetic", "--device", "cpu", "--output_dir", str(out)]
    first = gan_main.main(argv + ["--max_epoch", "1"])
    second = gan_main.main(argv + ["--max_epoch", "2"])
    cfg = cfg_from_file(str(yml))
    cfg.JAX.SEED = 100  # the CLI's --manualSeed default
    ds = build_dataset(cfg, True, "train")
    trainer = GANTrainer(cfg, str(out), ds, ds.n_words, ds.ixtoword, device="cpu")
    resumed = trainer.resume()
    paths = trainer.save_img_results(next(iter(DataLoader(ds, 8, shuffle=False))),
                                     trainer.state.step)
    # the b_dcgan reader on a mini CUB tree, through the trainer: one epoch
    # of one step at batch 4
    tree = _write_tree(root / "birds", np.random.default_rng(0))
    cub_yml = root / "dcgan_cub.yml"
    cub_yml.write_text(yaml.safe_dump(tiny(TRAIN={"MAX_EPOCH": 1})))
    cub = gan_main.main(["--cfg", str(cub_yml), "--data_dir", tree, "--device", "cpu",
                         "--output_dir", str(root / "cub_out")])
    return dict(out=out, first=first, second=second, item_shapes=[i.shape for i in ds[0][0]],
                resumed=resumed, step=trainer.state.step, paths=paths, cub=cub)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """JAX's float64 and bfloat16 steps and the port's, from the port's
    seeded weights, one batch and JAX's noise; and the CLI runs.  XLA
    compiles each JAX step in a thread (it releases the GIL there) while
    the next is traced and the port's steps run, and the CLI runs in a
    third thread beside them all."""
    batch = make_batch()
    models = build_models(cfg_from_dict(TINY), N_WORDS, seed=0)
    with ThreadPoolExecutor(2) as pool:
        cli = pool.submit(_cli_runs, tmp_path_factory.mktemp("dcgan"))
        with jax.enable_x64(True):
            lowered, args, noise = _lower(TINY, models, batch)
            compiling = pool.submit(lowered.compile)
            port = _port_step(TINY, models, batch, noise)
            want = _jax_result(compiling.result(), args)
        return {"port": port, "jax": want, "cli": cli.result()}


def test_one_discriminator_at_the_final_scale(steps):
    run = steps["port"]
    assert run["n_ds"] == 1 and run["uncond"] == [None]
    assert sorted(run["logs"]) == sorted(steps["jax"]["logs"]) == sorted(log_keys(1))
    assert sorted(run["after"]["discriminators"][0]) == sorted(
        DNet256(8, 32, b_jcu=False).state_dict())


def test_step_logs_match_jax(steps):
    want, got = steps["jax"]["logs"], steps["port"]["logs"]
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=2e-5, err_msg=k)


def test_step_d_gradients_match_jax(steps):
    want, got = steps["jax"]["grads"]["D0"], steps["port"]["grads"]["D0"]
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=2e-5 * np.abs(w).max(),
                                   err_msg=name)


def _flat(d: dict, names) -> np.ndarray:
    return np.concatenate([d[n].ravel() for n in names])


@pytest.mark.parametrize("network", ["G", "ca_net", "mapping_net", "h_net1", "h_net2",
                                     "h_net3", "img_net"])
def test_step_g_gradients_match_jax(steps, network):
    """Per network, by norm and cosine (a D LeakyReLU's kink moves G's
    gradient a little; tests/test_torch_bert_paths.py)."""
    want, got = steps["jax"]["grads"]["G"], steps["port"]["grads"]["G"]
    assert sorted(got) == sorted(want)
    names = sorted(n for n in want if network == "G" or n.split(".")[0] == network)
    assert names
    a, b = _flat(got, names), _flat(want, names)
    assert np.linalg.norm(b) > 0 and np.linalg.norm(a) > 0
    assert np.linalg.norm(a - b) <= GRAD_REL * np.linalg.norm(b)
    assert a @ b >= GRAD_COS * np.linalg.norm(a) * np.linalg.norm(b)
    for name in names:
        assert np.linalg.norm(got[name] - want[name]) <= 2 * GRAD_REL * np.linalg.norm(
            want[name]), name


def test_step_running_stats_match_jax(steps):
    want, got = steps["jax"]["after"], steps["port"]["after"]
    checked = 0
    for net in ("generator", "discriminators"):
        w_sd = want[net][0] if net == "discriminators" else want[net]
        g_sd = got[net][0] if net == "discriminators" else got[net]
        for name, w in w_sd.items():
            if name.endswith(("running_mean", "running_var")):
                w = w.double().numpy()
                np.testing.assert_allclose(g_sd[name].double().numpy(), w, rtol=0,
                                           atol=5e-6 * np.abs(w).max(), err_msg=name)
                checked += 1
    assert checked > 20


def test_step_ema_matches_its_formula_and_jax(steps):
    run, want = steps["port"], steps["jax"]["after"]["g_ema"]
    before, after = run["before"], run["after"]
    assert sorted(after["g_ema"]) == sorted(want)
    for n, w in want.items():
        own = 0.999 * before["g_ema"][n] + 0.001 * after["generator"][n]
        torch.testing.assert_close(after["g_ema"][n], own, rtol=0, atol=1e-12)
        diff = np.abs(after["g_ema"][n].double().numpy() - w.double().numpy()).max()
        assert diff <= 1e-3 * 2 * LR + 2e-7, n


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_bf16_generator_forward_matches_jax_bf16():
    """The step's generator forward in bfloat16 (``JAX.DTYPE`` bfloat16, train
    mode: batch statistics, running statistics moved) against JAX's
    bfloat16 GDCGAN (its K4 the Pallas kernel in interpret mode) from the
    same weights, noise and words, by norm, in the bounds of
    tests/test_torch_bf16_paths.py: the image within its sampler's images
    bound, the maps within its step's logs bound, G's running statistics
    within its step's G statistics bound (measured 1.6e-2; 7.9e-3 and
    9.0e-3; 9.8e-6).  The port's float32 forward from the same weights is
    as far from JAX's bfloat16 images and maps (1.5e-2; 7.1e-3, 8.3e-3):
    JAX's own bfloat16 rounding; not from its statistics (3.6e-5), which
    the bfloat16 path must match closer."""
    raw = tiny(JAX=BF16)
    net = build_generator(cfg_from_dict(raw))
    init_weights(net, torch.Generator().manual_seed(3))
    random_stats(net, 9)
    net32 = build_generator(cfg_from_dict(tiny()))
    net32.load_state_dict(net.state_dict())
    rng = np.random.default_rng(4)
    z = rng.standard_normal((B, 8)).astype(np.float32)
    sent = rng.standard_normal((B, 32)).astype(np.float32)
    words = rng.standard_normal((B, T, 32)).astype(np.float32)
    pad = np.arange(T)[None, :] >= np.array([T, 3, 1, 5])[:, None]
    rng_ca = jax.random.PRNGKey(6)
    eps = np.array(jax.random.normal(rng_ca, (B, 8), jnp.float32))
    args = (jnp.asarray(z), jnp.asarray(sent), jnp.asarray(words), jnp.asarray(pad), rng_ca)
    g = jax_build_generator(jax_cfg_from_dict(raw)).clone(attn_impl="interpret")
    abstract = jax.eval_shape(lambda: g.init(jax.random.PRNGKey(0), *args, True))
    variables = {c: flax_tree_from_port(abstract[c], net.state_dict(), dcgan_key)
                 for c in ("params", "batch_stats")}
    (fakes_j, atts_j, _, _), mut = jax.jit(
        lambda v, *a: g.apply(v, *a, True, mutable=["batch_stats"]))(variables, *args)
    want = [np.asarray(a, np.float32) for a in list(fakes_j) + list(atts_j)]
    want_stats = _stats(W.g_net_state_dict({}, mut["batch_stats"], dcgan=True))
    torch_args = [torch.from_numpy(a) for a in (z, sent, words, pad, eps)]
    errs = {}
    for name, m in (("bf16", net), ("f32", net32)):
        with torch.no_grad():
            fakes, atts, _, _ = m.train()(*torch_args)
        got = [f.float().numpy() for f in fakes + atts]
        errs[name] = ([_rel(x, w) for x, w in zip(got, want)],
                      _rel(_stats(m.state_dict()), want_stats))
    (img, *maps), stats = errs["bf16"]
    assert img <= BF16_TOL["images"] and stats <= BF16_TOL["stats_G"], errs
    assert all(e <= BF16_TOL["logs"] for e in maps), errs
    assert stats < errs["f32"][1], errs


def _stats(sd) -> np.ndarray:
    return np.concatenate([sd[n].double().numpy().ravel() for n in sorted(sd)
                           if n.endswith(("running_mean", "running_var"))])


# ------------------------------------------------------------- weights map


def test_weight_map_round_trip():
    """A GDCGAN's Flax variables -> the port's state dict -> Flax, exactly;
    the layout is told from the tree, and GNet's and GDCGAN's keys differ
    only in the RGB heads."""
    raw = tiny()
    g = jax_build_generator(jax_cfg_from_dict(raw))
    args = (jnp.zeros((2, 8)), jnp.zeros((2, 32)), jnp.zeros((2, T, 32)),
            jnp.zeros((2, T), bool), jax.random.PRNGKey(1))
    abstract = jax.eval_shape(lambda: g.init(jax.random.PRNGKey(0), *args, True))
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                        abstract)
    tree = {c: dict(tree[c]) for c in ("params", "batch_stats")}
    assert W.is_dcgan_tree(tree["params"])
    sd = W.g_net_state_dict(tree["params"], tree["batch_stats"])  # layout from the tree
    net = build_generator(cfg_from_dict(raw))
    net.load_state_dict(sd)  # strict: every key of the port's GDCGAN, and only those
    assert torch.equal(sd["img_net.img.0.weight"], W.flax_leaf_to_torch(
        ("kernel",), tree["params"]["GetImageG_0"]["Conv3x3_0"]["Conv_0"]["kernel"]))
    back = {c: flax_tree_from_port(abstract[c], sd, dcgan_key) for c in tree}
    flat, flat_back = W.flatten_tree(tree), W.flatten_tree(back)
    assert flat.keys() == flat_back.keys()
    for k, v in flat.items():
        assert np.array_equal(flat_back[k], v), k
    for dcgan, want in ((True, "img_net.img.0.weight"), (False, "img_net1.img.0.weight")):
        assert W.g_net_key(("GetImageG_0", "Conv3x3_0", "Conv_0", "kernel"), dcgan) == want
    with pytest.raises(KeyError, match="GDCGAN"):
        W.g_net_key(("GetImageG_1", "Conv3x3_0", "Conv_0", "kernel"), dcgan=True)
    state = {"g": tree, "g_ema": tree["params"], "ds": [], "text": {"params": {}},
             "image": {"params": {}, "batch_stats": {}}}
    assert "img_net.img.0.weight" in W.gan_state_from_jax(state)["g_ema"]


# ------------------------------------------------------------- the CLI


@pytest.fixture(scope="module")
def cli_run(steps):
    """The CLI's runs (:func:`_cli_runs`, made beside the steps)."""
    return steps["cli"]


def test_cli_trains_saves_resumes_and_renders_one_stage(cli_run):
    (epoch0,) = cli_run["first"]["epochs"]
    assert cli_run["first"]["resumed_from"] is None and epoch0["steps"] == 4
    assert sorted(epoch0["logs"]) == sorted(log_keys(1))
    assert all(np.isfinite(v) for v in epoch0["logs"].values())
    assert cli_run["second"]["resumed_from"] == 0
    ckpt = Checkpointer(str(cli_run["out"] / "Model"))
    saved = ckpt.restore()
    assert ckpt.steps() == [0, 1] and saved["step"] == 8
    assert len(saved["discriminators"]) == len(saved["d_opts"]) == 1
    assert "img_net.img.0.weight" in saved["g_ema"]
    assert cli_run["item_shapes"] == [(256, 256, 3)]  # the b_dcgan reader
    assert cli_run["resumed"] and cli_run["step"] == 8
    paths = cli_run["paths"]
    assert [os.path.basename(p) for p in paths] == ["G_avg_8_0.png", "attn_8.png"]
    assert Image.open(paths[0]).size == (256, 256)


def test_cli_trains_on_cub_jpegs(cli_run):
    """The ``b_dcgan`` reader on CUB-layout JPEGs through the trainer."""
    (epoch,) = cli_run["cub"]["epochs"]
    assert epoch["steps"] == 1 and all(np.isfinite(v) for v in epoch["logs"].values())


def test_reference_net_g_is_refused(tmp_path):
    """Neither package imports a reference G_DCGAN: ``TRAIN.NET_G`` under
    B_DCGAN raises, before the path is looked up, and so does
    ``load_g_net`` on a GDCGAN."""
    cfg = preset("eval_bird_attnDCGAN2")
    assert cfg.GAN.B_DCGAN and cfg.TRAIN.NET_G
    yml = tmp_path / "eval.yml"
    yml.write_text(yaml.safe_dump(tiny(TRAIN={"FLAG": False, "NET_G": "netG.pth"})))
    with pytest.raises(NotImplementedError, match="G_DCGAN.*ROADMAP"):
        gan_main.main(["--cfg", str(yml), "--synthetic", "--device", "cpu",
                       "--output_dir", str(tmp_path / "out")])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        torch_port.load_g_net(build_generator(cfg_from_dict(tiny())), "netG.pth")


# ------------------------------------------------- sampler, serving, examples


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """The port's seeded GDCGAN (random running statistics) and text encoder
    as JAX trees, an ``.npz`` of them, and JAX's sampler's images and maps
    of a batch of three captions with its noise."""
    raw = tiny()
    models = build_models(cfg_from_dict(raw), N_WORDS, seed=7)
    random_stats(models.generator, 8)
    jcfg = jax_cfg_from_dict(raw)
    jmodels = jax_build_models(jcfg, N_WORDS)
    rng = np.random.default_rng(6)
    lens = np.array([6, 2, 1], np.int32)
    captions = _captions(rng, lens)
    z = rng.standard_normal((3, 8)).astype(np.float32)
    rng_ca = jax.random.PRNGKey(11)
    eps = np.array(jax.random.normal(rng_ca, (3, 8), jnp.float32))
    key = jax.random.PRNGKey(0)
    words = jnp.zeros((3, T, 32))
    g_abstract = jax.eval_shape(lambda: jmodels.generator.init(
        key, jnp.asarray(z), words[:, 0], words, jnp.asarray(captions == 0), rng_ca, True))
    text_abstract = jax.eval_shape(lambda: jmodels.text_encoder.init(
        {"params": key, "dropout": key}, jnp.asarray(captions), jnp.asarray(lens),
        train=False))
    g = {c: flax_tree_from_port(g_abstract[c], models.generator.state_dict(), dcgan_key)
         for c in ("params", "batch_stats")}
    text = flax_tree_from_port(text_abstract["params"], models.text_encoder.state_dict(),
                               rnn_encoder_key)
    npz = tmp_path_factory.mktemp("weights") / "weights.npz"
    np.savez(npz, **{f"g_ema/{k}": v for k, v in W.flatten_tree(g["params"]).items()},
             **{f"g/batch_stats/{k}": v for k, v in W.flatten_tree(g["batch_stats"]).items()},
             **{f"text/params/{k}": v for k, v in W.flatten_tree(text).items()})
    with_noise = make_sample_fn(jcfg, jmodels).with_noise

    def sample(g, text):
        state = SimpleNamespace(text={"params": text}, g_ema=g["params"],
                                g=SimpleNamespace(batch_stats=g["batch_stats"]))
        return with_noise(state, jnp.asarray(captions), jnp.asarray(lens), jnp.asarray(z),
                          rng_ca)
    fakes, atts = jax.jit(sample)(g, text)
    return dict(cfg=cfg_from_dict(raw), npz=str(npz), captions=captions, lens=lens, z=z,
                eps=eps, fakes=[np.asarray(f) for f in fakes],
                atts=[np.asarray(a) for a in atts])


def test_sampler_from_npz_matches_jax(carried):
    sampler = Sampler.from_config(carried["cfg"], N_WORDS, weights=carried["npz"],
                                  device="cpu")
    assert isinstance(sampler.generator, GDCGAN)
    fakes, atts = sampler.with_noise(carried["captions"], carried["lens"], carried["z"],
                                     carried["eps"])
    assert [f.shape for f in fakes] == [(3, 256, 256, 3)] and len(atts) == 2
    for got, want in zip(fakes + atts, carried["fakes"] + carried["atts"]):
        np.testing.assert_allclose(got, want, **SAMPLER_TOL)


def test_service_serves_one_stage(carried, tmp_path, monkeypatch):
    """``POST /api/v1.0/bird`` with the JAX noise put into the sampler: one
    stage, labelled ``small`` as in the JAX service, its PNG the JAX image
    (within one step of uint8 rounding), and both attention maps."""
    from sba_gan_tpu_torch.serving.app import build_service, make_wsgi_app
    from sba_gan_tpu_torch.utils.image import to_uint8

    words = [f"w{i}" for i in range(N_WORDS)]
    wordtoix = {w: i for i, w in enumerate(words)}
    caption = " ".join(words[i] for i in carried["captions"][0][: carried["lens"][0]])
    sampler = Sampler.from_config(carried["cfg"], N_WORDS, weights=carried["npz"],
                                  device="cpu")
    monkeypatch.setattr(sampler, "draw_noise", lambda b, seed: (
        torch.from_numpy(carried["z"][:b]), torch.from_numpy(carried["eps"][:b])))
    service = build_service(carried["cfg"], sampler, wordtoix, dict(enumerate(words)),
                            str(tmp_path), telemetry=lambda event: None)
    app = make_wsgi_app(service)
    body = json.dumps({"caption": caption}).encode()
    status = {}
    out = app({"PATH_INFO": "/api/v1.0/bird", "REQUEST_METHOD": "POST",
               "CONTENT_LENGTH": str(len(body)), "wsgi.input": io.BytesIO(body)},
              lambda s, h, e=None: status.setdefault("s", s))
    assert status["s"].startswith("201")
    bird = json.loads(b"".join(out))["bird"]
    assert sorted(k for k in bird if k not in ("caption", "elapsed")) == [
        "map1", "map2", "small"]
    png = np.asarray(Image.open(io.BytesIO(service.store.get(
        bird["small"][len("/images/"):]))))
    want = to_uint8(carried["fakes"][0][0])
    assert png.shape == want.shape == (256, 256, 3)
    assert np.abs(png.astype(int) - want.astype(int)).max() <= 1


def test_gen_example_writes_one_stage(carried, tmp_path, monkeypatch):
    """``gen_example`` on a trainer whose sampler holds the carried weights,
    with the JAX noise put in: one stage per caption (``{j}_s_g0.png``, the
    JAX images within one step of uint8 rounding) and the attention maps."""
    from sba_gan_tpu_torch.utils.image import to_uint8

    cfg = copy.deepcopy(carried["cfg"])
    cfg.TRAIN.FLAG = False
    trainer = GANTrainer(cfg, str(tmp_path), SimpleNamespace(), N_WORDS,
                         {i: f"w{i}" for i in range(N_WORDS)}, device="cpu")
    sampler = Sampler.from_config(cfg, N_WORDS, weights=carried["npz"], device="cpu")
    monkeypatch.setattr(sampler, "draw_noise", lambda b, seed: (
        torch.from_numpy(carried["z"][:b]), torch.from_numpy(carried["eps"][:b])))
    monkeypatch.setattr(trainer, "sampler", lambda: sampler)
    root = trainer.gen_example({"birds": (carried["captions"], carried["lens"], None)})
    assert sorted(os.listdir(os.path.join(root, "birds"))) == [
        "0_s_g0.png", "1_s_g0.png", "2_s_g0.png", "attention_maps.png"]
    for j, want in enumerate(carried["fakes"][0]):
        png = np.asarray(Image.open(os.path.join(root, "birds", f"{j}_s_g0.png")))
        assert np.abs(png.astype(int) - to_uint8(want).astype(int)).max() <= 1, j
