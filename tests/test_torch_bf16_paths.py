"""The port's three paths under ``JAX.DTYPE`` and ``JAX.LOSS_DTYPE``
bfloat16 against the JAX package's under the same config, from the same
weights, batch and noise:

* one GAN train step (``make_gan_train_step``; BRANCH_NUM 2, batch 4, GF/DF
  8, EMBEDDING 32, WORDS 6, Inception input 75), its generator built with
  ``attn_impl="interpret"`` (the Pallas word attention and its ``_bwd``,
  the functions the port's K4 path holds to) and ``DAMSM_SIM_IMPL:
  interpret`` with ``DAMSM_SIM_TILE`` 4, which divides the batch (else the
  JAX words loss takes its dense XLA path).  The Ds' learning rate is 0, so
  that G's loss meets the same Ds on both sides (Adam's sign-like first
  update turns D gradients that are rounding noise into D weights 2 lr
  apart).  Compared: every log, the D and G gradients (JAX's from its Adam
  first moments, g = 2 mu), the running statistics of G and the Ds;
* one DAMSM pretrain step (``DAMSMTrainer.train_step``, batch 8, the same
  dropout mask), the path of K3: the logs, the text encoder's and the
  image heads' gradients (the text side clipped), the running statistics;
* one sampler call (``make_sample_fn(...).with_noise``, three branches):
  the images and the attention maps.

The JAX side's weights are drawn by the port and carried into Flax (a Flax
init of these models takes a minute on the CPU).

Tolerances.  In bfloat16 these tiny train-mode models amplify rounding
far more than in float32 (which is why tests/test_torch_gan_step.py and
tests/test_torch_damsm_pretrain.py compare in float64): G's and the
pretrain step's gradients change by 40-50% between JAX's own bfloat16 and
float32 steps, while the forward values (logs, running statistics, images)
change by 1e-5 to 5e-2.  And XLA on the CPU keeps bfloat16 elementwise
chains in float32 inside a fusion where PyTorch rounds each operation, so
the two sides' bfloat16 roundings are not the same ones (the rounding
points themselves are held exactly in tests/test_torch_bf16_kernels.py
and tests/test_torch_bf16_models.py).  So each quantity is held within
``TOL``, about twice its measured distance to JAX (the largest relative
difference of the logs; |port - jax| / |jax| over all the gradients of a
network, over all its running statistics, over each image), and the
gradients' cosine to JAX's above ``COSINE``; the docstring of each test
gives the measurements, beside the distance of the port's float32 path
from the same weights to JAX's bfloat16 result, the scale of JAX's own
bfloat16 rounding.  The port's bfloat16 path must also differ from its
float32 one (it rounds).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cnn_encoder_key, flax_tree_from_port, rnn_encoder_key, tiny_cfgs
from sba_gan_tpu.config import cfg_from_dict as jax_cfg_from_dict
from sba_gan_tpu.train.damsm import DAMSMTrainer as JaxDAMSMTrainer
from sba_gan_tpu.train.damsm import build_damsm_models as jax_build_damsm
from sba_gan_tpu.train.gan import build_models as jax_build_models
from sba_gan_tpu.train.gan import init_gan_state as jax_init_gan_state
from sba_gan_tpu.train.gan import make_gan_train_step, make_sample_fn
from sba_gan_tpu.train.gan import noise_shape as jax_noise_shape
from sba_gan_tpu.train.state import GANTrainState, NetState, gan_optimizers
from sba_gan_tpu_torch.config import cfg_from_dict
from sba_gan_tpu_torch.ops import damsm_sim as dsim
from sba_gan_tpu_torch.ops import word_attention as wa
from sba_gan_tpu_torch.train.damsm import LOG_KEYS, DAMSMTrainer, build_damsm_models
from sba_gan_tpu_torch.train.gan import GANStep, build_models, init_gan_state, log_keys
from sba_gan_tpu_torch.train.sample import Sampler
from sba_gan_tpu_torch.utils import weights as W

TOL = {  # measured in brackets, the port's float32 path after the slash
    "gan_logs": 3e-2,  # [1.37e-2 / 3.3e-3]
    "gan_grads_G": 0.8, "gan_grads_D0": 0.16, "gan_grads_D1": 0.25,  # [0.41, 0.080, 0.12
    #                                                 / 0.48, 0.082, 0.12]
    "gan_stats_G": 5e-5, "gan_stats_D0": 5e-4, "gan_stats_D1": 1e-3,  # [1.7e-5, 2.3e-4,
    #                                                          3.9e-4 / 4.7e-5, 2.2e-4, 3.6e-4]
    "pretrain_logs": 0.5, "pretrain_grads_text": 0.8, "pretrain_grads_heads": 0.9,  # [0.26,
    #                                                  0.40, 0.50 / 0.18, 0.36, 0.41]
    "pretrain_stats": 2e-2,  # [8.2e-3 / 7.0e-3]
    "sampler_images": 0.15, "sampler_maps": 5e-3,  # [9.7e-3, 6.2e-2, 7.2e-2; 9.0e-4,
    #                                                1.7e-3 / 9.8e-3, 4.7e-2, 5.5e-2; ...]
}
COSINE = {"gan_grads_G": 0.8, "gan_grads_D0": 0.99, "gan_grads_D1": 0.98,  # [0.917, 0.997,
          "pretrain_grads_text": 0.8, "pretrain_grads_heads": 0.75}  # 0.993; 0.921, 0.876]
N_WORDS, B, T = 30, 4, 6
BF16 = {"DTYPE": "bfloat16", "LOSS_DTYPE": "bfloat16", "DAMSM_SIM_IMPL": "interpret",
        "DAMSM_SIM_TILE": 4}
F32 = {"DTYPE": "float32", "LOSS_DTYPE": "float32"}
GAN = {"TREE": {"BRANCH_NUM": 2, "BASE_SIZE": 64},
       "GAN": {"GF_DIM": 8, "DF_DIM": 8, "Z_DIM": 8, "W_DIM": 16, "CONDITION_DIM": 8,
               "R_NUM": 1},
       "TEXT": {"EMBEDDING_DIM": 32, "WORDS_NUM": T},
       "MODEL": {"INCEPTION_INPUT": 75},
       "TRAIN": {"BATCH_SIZE": B, "GENERATOR_LR": 2e-4, "DISCRIMINATOR_LR": 0.0,
                 "SMOOTH": {"GAMMA1": 4.0, "GAMMA2": 5.0, "GAMMA3": 10.0, "LAMBDA": 5.0}}}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _flat(tensors: dict) -> np.ndarray:
    return np.concatenate([np.asarray(tensors[k], np.float64).ravel()
                           for k in sorted(tensors)])


def _cos(a, b) -> float:
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _log_err(got: dict, want: dict) -> float:
    return max(abs(got[k] - want[k]) / abs(want[k]) for k in want)


def _within(name, err):
    assert err <= TOL[name], (name, err, TOL[name])


def _captions(rng, lens, t=T):
    captions = np.zeros((len(lens), t), np.int32)
    for i, n in enumerate(lens):
        captions[i, :n] = rng.integers(1, N_WORDS, n)
    return captions


def _jax_gan_state(jcfg, jmodels, models) -> GANTrainState:
    """The JAX train state holding the port models' weights."""
    abstract = jax.eval_shape(lambda: jax_init_gan_state(jcfg, jmodels,
                                                         jax.random.PRNGKey(0)))
    g_tx, d_tx = gan_optimizers(jcfg)
    g_sd = models.generator.state_dict()
    g = {c: flax_tree_from_port(getattr(abstract.g, c), g_sd, W.g_net_key)
         for c in ("params", "batch_stats")}
    ds = []
    for ab, d in zip(abstract.ds, models.discriminators):
        v = {c: flax_tree_from_port(getattr(ab, c), d.state_dict(), W.d_net_key)
             for c in ("params", "batch_stats")}
        ds.append(NetState(v["params"], v["batch_stats"], d_tx.init(v["params"])))
    image_sd = models.image_encoder.state_dict()
    return GANTrainState(
        step=jnp.zeros((), jnp.int32),
        g=NetState(g["params"], g["batch_stats"], g_tx.init(g["params"])),
        g_ema=g["params"], ds=tuple(ds),
        text={"params": flax_tree_from_port(abstract.text["params"],
                                            models.text_encoder.state_dict(),
                                            rnn_encoder_key)},
        image={c: flax_tree_from_port(abstract.image[c], image_sd, cnn_encoder_key)
               for c in ("params", "batch_stats")})


@pytest.fixture(scope="module")
def gan_runs():
    """One GAN step of JAX in bfloat16 and of the port in bfloat16 and float32,
    from the same weights: logs, gradients and running statistics per
    network (port keys, numpy), and the port's kernel counts."""
    rng = np.random.default_rng(5)
    imgs = [rng.uniform(-1, 1, (B, s, s, 3)).astype(np.float32) for s in (64, 128)]
    cap_lens = rng.integers(1, T + 1, (B,)).astype(np.int32)
    cap_lens[0], cap_lens[1] = T, 1
    captions = _captions(rng, cap_lens)
    class_ids = rng.integers(0, B // 2, (B,)).astype(np.int32)
    cfgs = {k: cfg_from_dict({**GAN, "JAX": jax_}) for k, jax_ in (("bf16", BF16),
                                                                 ("f32", F32))}
    models = build_models(cfgs["bf16"], N_WORDS, seed=0)

    jcfg = jax_cfg_from_dict({**GAN, "JAX": BF16})
    jmodels = jax_build_models(jcfg, N_WORDS)
    jmodels = jmodels._replace(generator=jmodels.generator.clone(attn_impl="interpret"))
    state = _jax_gan_state(jcfg, jmodels, models)
    key = jax.random.PRNGKey(3)
    r_z, r_ca = jax.random.split(jax.random.fold_in(key, 0))  # the step's own draws
    z = np.array(jax.random.normal(r_z, jax_noise_shape(jcfg, B), jnp.float32))
    eps = np.array(jax.random.normal(r_ca, (B, 8), jnp.float32))
    new, logs = jax.jit(make_gan_train_step(jcfg, jmodels))(
        state, tuple(jnp.asarray(i) for i in imgs), jnp.asarray(captions),
        jnp.asarray(cap_lens), jnp.asarray(class_ids), key)
    new = jax.tree.map(np.asarray, new)
    runs = {"jax": {
        "logs": {k: float(v) for k, v in logs.items()},
        "grads": {"G": {k: 2 * v.numpy() for k, v in
                        W.g_net_state_dict(new.g.opt_state[0].mu, {}).items()},
                  **{f"D{i}": {k: 2 * v.numpy() for k, v in
                               W.d_net_state_dict(d.opt_state[0].mu, {}).items()}
                     for i, d in enumerate(new.ds)}},
        "stats": {"G": W.g_net_state_dict(new.g.params, new.g.batch_stats),
                  **{f"D{i}": W.d_net_state_dict(d.params, d.batch_stats)
                     for i, d in enumerate(new.ds)}}}}

    batch = ([torch.from_numpy(i) for i in imgs], torch.from_numpy(captions).long(),
             torch.from_numpy(cap_lens).long(), torch.from_numpy(class_ids).long())
    for name, cfg in cfgs.items():
        mine = build_models(cfg, N_WORDS)
        for dst, src in zip((*mine[:3], *mine.discriminators),
                            (*models[:3], *models.discriminators)):
            dst.load_state_dict(src.state_dict())
        st = init_gan_state(cfg, mine, device="cpu")
        wa.word_attention.launches = dsim.damsm_sim_fwd.launches = 0
        logs = GANStep(cfg, st)(*batch, z=torch.from_numpy(z), eps=torch.from_numpy(eps))
        nets = {"G": st.generator, **{f"D{i}": d for i, d in enumerate(st.discriminators)}}
        runs[name] = {
            "logs": {k: float(v) for k, v in logs.items()},
            "grads": {n: {k: p.grad.numpy() for k, p in m.named_parameters()}
                      for n, m in nets.items()},
            "stats": {n: m.state_dict() for n, m in nets.items()},
            "launches": (wa.word_attention.launches, dsim.damsm_sim_fwd.launches)}
    return runs


def test_gan_step_logs_match_jax_bf16(gan_runs):
    want = gan_runs["jax"]["logs"]
    assert sorted(want) == sorted(gan_runs["bf16"]["logs"]) == sorted(log_keys(2))
    _within("gan_logs", _log_err(gan_runs["bf16"]["logs"], want))
    assert gan_runs["bf16"]["logs"] != gan_runs["f32"]["logs"]
    assert gan_runs["bf16"]["launches"] == (0, 0)  # the CPU runs the plain versions


@pytest.mark.parametrize("net", ["G", "D0", "D1"])
def test_gan_step_gradients_match_jax_bf16(gan_runs, net):
    want = _flat(gan_runs["jax"]["grads"][net])
    got, got32 = (_flat(gan_runs[k]["grads"][net]) for k in ("bf16", "f32"))
    assert got.shape == want.shape
    _within(f"gan_grads_{net}", _rel(got, want))
    assert _cos(got, want) >= COSINE[f"gan_grads_{net}"]
    assert _rel(got, got32) > 0


@pytest.mark.parametrize("net", ["G", "D0", "D1"])
def test_gan_step_running_stats_match_jax_bf16(gan_runs, net):
    def stats(run):
        return _flat({k: v for k, v in run["stats"][net].items()
                      if k.endswith(("running_mean", "running_var"))})
    _within(f"gan_stats_{net}", _rel(stats(gan_runs["bf16"]), stats(gan_runs["jax"])))
    assert _rel(stats(gan_runs["bf16"]), stats(gan_runs["f32"])) > 0


SIZE = 75
PRETRAIN = {"TREE": {"BRANCH_NUM": 1}, "TEXT": {"EMBEDDING_DIM": 32, "WORDS_NUM": T},
            "MODEL": {"INCEPTION_INPUT": SIZE}, "TRAIN": {"ENCODER_LR": 2e-3}}


def _adam_mu(opt_state):
    """The first moment of the one Adam in an optax state."""
    found = []
    jax.tree.map(lambda s: found.append(s.mu) if hasattr(s, "nu") else None, opt_state,
                 is_leaf=lambda s: hasattr(s, "mu") and hasattr(s, "nu"))
    (mu,) = found
    return mu


@pytest.fixture(scope="module")
def pretrain_runs():
    """One DAMSM train step of JAX in bfloat16 and of the port in bfloat16 and
    float32 from the same weights and dropout mask: logs, gradients (text
    clipped, image heads), running statistics."""
    rng = np.random.default_rng(11)
    b = 8
    img = rng.uniform(-1, 1, (b, SIZE, SIZE, 3)).astype(np.float32)
    cap_lens = rng.integers(1, T + 1, (b,)).astype(np.int32)
    cap_lens[0], cap_lens[1] = 1, T
    captions = _captions(rng, cap_lens)
    class_ids = np.array([0, 1, 0, 2, 3, 1, 4, 5], np.int32)
    models = build_damsm_models(cfg_from_dict({**PRETRAIN, "JAX": BF16}), N_WORDS, seed=0)

    jcfg = jax_cfg_from_dict({**PRETRAIN, "JAX": BF16})
    jmodels = jax_build_damsm(jcfg, N_WORDS)
    trainer = JaxDAMSMTrainer(jcfg, jmodels, N_WORDS)
    abstract = jax.eval_shape(trainer.init_state, jax.random.PRNGKey(0))
    image_sd = models.image_encoder.state_dict()
    state = trainer.reset_optimizer(abstract.replace(
        step=jnp.zeros((), jnp.int32),
        text_params=flax_tree_from_port(abstract.text_params,
                                        models.text_encoder.state_dict(), rnn_encoder_key),
        image_params=flax_tree_from_port(abstract.image_params, image_sd, cnn_encoder_key),
        image_batch_stats=flax_tree_from_port(abstract.image_batch_stats, image_sd,
                                              cnn_encoder_key)), 0)
    key = jax.random.PRNGKey(1)
    args = tuple(jnp.asarray(a) for a in (img, captions, cap_lens, class_ids))
    new, logs = trainer.train_step(state, *args, key)
    _, inter = jmodels.text_encoder.apply(  # the step's dropout mask
        {"params": state.text_params}, args[1], args[2], train=True,
        rngs={"dropout": jax.random.fold_in(key, 0)}, capture_intermediates=True)
    keep = np.asarray(inter["intermediates"]["Dropout_0"]["__call__"][0]) != 0
    new = jax.tree.map(np.asarray, new)
    text_mu, image_mu = (_adam_mu(s) for s in new.opt_state)
    runs = {"jax": {
        "logs": {k: float(v) for k, v in logs.items()},
        "text": {k: 2 * v.numpy() for k, v in W.rnn_encoder_state_dict(text_mu).items()},
        "heads": {k: 2 * v.numpy() for k, v in W.cnn_encoder_state_dict(image_mu, {}).items()
                  if k.startswith("emb_")},
        "stats": W.cnn_encoder_state_dict(new.image_params, new.image_batch_stats)}}
    batch = (torch.from_numpy(img), torch.from_numpy(captions).long(),
             torch.from_numpy(cap_lens).long(), torch.from_numpy(class_ids).long())
    for name, jax_ in (("bf16", BF16), ("f32", F32)):
        cfg = cfg_from_dict({**PRETRAIN, "JAX": jax_})
        mine = build_damsm_models(cfg, N_WORDS)
        mine.text_encoder.load_state_dict(models.text_encoder.state_dict())
        mine.image_encoder.load_state_dict(models.image_encoder.state_dict())
        tr = DAMSMTrainer(cfg, mine, device="cpu")
        dsim.damsm_sim_dwords.launches = 0
        logs = tr.train_step(*batch, keep_mask=torch.from_numpy(keep))
        runs[name] = {
            "logs": {k: float(v) for k, v in logs.items()},
            "text": {k: p.grad.numpy() for k, p in tr.text_encoder.named_parameters()},
            "heads": {k: p.grad.numpy() for k, p in tr.image_encoder.named_parameters()
                      if k.startswith("emb_")},
            "stats": tr.image_encoder.state_dict()}
    return runs


def test_pretrain_step_matches_jax_bf16(pretrain_runs):
    jx, got, got32 = (pretrain_runs[k] for k in ("jax", "bf16", "f32"))
    assert sorted(got["logs"]) == sorted(jx["logs"]) == sorted(LOG_KEYS)
    _within("pretrain_logs", _log_err(got["logs"], jx["logs"]))
    for part in ("text", "heads"):
        want = _flat(jx[part])
        _within(f"pretrain_grads_{part}", _rel(_flat(got[part]), want))
        assert _cos(_flat(got[part]), want) >= COSINE[f"pretrain_grads_{part}"]
        assert _rel(_flat(got[part]), _flat(got32[part])) > 0

    def stats(run):
        return _flat({k: v for k, v in run["stats"].items()
                      if k.endswith(("running_mean", "running_var"))})
    _within("pretrain_stats", _rel(stats(got), stats(jx)))


def test_sampler_matches_jax_bf16():
    """One ``with_noise`` call of the port's Sampler (bfloat16, from its own
    random weights with random running statistics) against JAX's."""
    rng = np.random.default_rng(6)
    jcfg, cfg = tiny_cfgs()
    lens = np.array([6, 2, 1], np.int32)
    captions = _captions(rng, lens)
    z = rng.standard_normal((3, 8)).astype(np.float32)
    rng_ca = jax.random.PRNGKey(11)
    eps = np.array(jax.random.normal(rng_ca, (3, 8), jnp.float32))
    samplers = {}
    for dtype in ("float32", "bfloat16"):
        cfg.JAX.DTYPE = dtype
        samplers[dtype] = Sampler.from_config(cfg, N_WORDS, seed=0, device="cpu")
    ref = samplers["float32"]
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in ref.generator.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.copy_(0.5 * torch.randn(m.running_mean.shape, generator=gen))
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    g_sd, text_sd = ref.generator.state_dict(), ref.text_encoder.state_dict()
    samplers["bfloat16"].generator.load_state_dict(g_sd)
    samplers["bfloat16"].text_encoder.load_state_dict(text_sd)

    jcfg.JAX.DTYPE = "bfloat16"
    jmodels = jax_build_models(jcfg, N_WORDS)
    abstract = jax.eval_shape(lambda: jax_init_gan_state(jcfg, jmodels,
                                                         jax.random.PRNGKey(0)))
    g = {c: flax_tree_from_port(getattr(abstract.g, c), g_sd, W.g_net_key)
         for c in ("params", "batch_stats")}
    text = {"params": flax_tree_from_port(abstract.text["params"], text_sd,
                                          rnn_encoder_key)}
    with_noise = make_sample_fn(jcfg, jmodels).with_noise

    def sample(g, text):
        state = SimpleNamespace(text=text, g_ema=g["params"],
                                g=SimpleNamespace(batch_stats=g["batch_stats"]))
        return with_noise(state, jnp.asarray(captions), jnp.asarray(lens),
                          jnp.asarray(z), rng_ca)
    fakes_j, atts_j = jax.jit(sample)(g, text)
    out = {k: s.with_noise(captions, lens, z, eps) for k, s in samplers.items()}
    (fakes, atts), (fakes32, atts32) = out["bfloat16"], out["float32"]
    assert [a.dtype for a in atts] == [np.float32] * 2  # bfloat16 maps widened
    for k, (got, got32, want) in enumerate(zip(fakes + atts, fakes32 + atts32,
                                               list(fakes_j) + list(atts_j))):
        want = np.asarray(jnp.asarray(want).astype(jnp.float32))
        _within("sampler_images" if k < len(fakes) else "sampler_maps", _rel(got, want))
        assert _rel(got, got32) > 0
