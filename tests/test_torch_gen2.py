"""The port's gen-2 conditional StyleGAN (``models/gen2.py``,
``losses/gen2.py``, ``train/gen2.py``) against the JAX package's, at tiny
widths: E 8, C 6, Z 5, W 12, A 10, 7 tokens, 2 mapping layers, 16 x 16
images from a 4 x 4 constant, FMAP_BASE 128 and FMAP_MAX 16 (so that G
doubles once through the bilinear resize and once through the transposed
convolution, and D goes down once through its 2 x 2 convolution and once
through the average pool), a BERT tower of 1 layer and width 16, batch 4,
Inception at 75.  Weights are the JAX package's, carried by
``utils.weights.gen2_state_from_jax``; the random draws are JAX's, made in
the test from the steps' own key arithmetic and injected; torch runs on one
intra-op thread.

* the ``nf`` ladder; G's forward under each toggle set of
  tests/test_gen2.py (none, attention with noise, noise alone, pixel norm,
  truncation, no instance norm), with random noise gains; D's features and
  heads; the image encoder (eval-mode Inception, random running
  statistics); every loss's value and input gradients, the feature
  gradient penalty's also to D's parameters (a double backward);
* one WGAN D step and one G step against the JAX trainer's jitted pair:
  the JAX steps run with an optimizer that keeps the gradient as its state
  (so that they give their gradients) and optax's RMSprop is applied to
  them; the losses, the gradients, D's parameters after the update, G's
  and the EMA after the G update;
* the BCE D step against JAX's; the BCE G step against JAX's pieces (its
  own G step raises: ROADMAP.md, section 3, reference fault 3, shown by
  ``test_jax_bce_g_step_raises``), with the image encoder's ``batch_stats``
  passed as the port applies them;
* freezing (BERT unchanged, ``bert_embedding.fc`` and the image encoder's
  ``fc`` moved), the critic schedule, ``sample`` from the EMA.

Tolerance: rtol 1e-5 and atol 1e-5, for gradients atol 1e-5 of each
tensor's largest entry; in float32, but G's forward and the BCE G step in
float64 (the JAX modules built with ``dtype`` float64 under
``jax.enable_x64``), where float32 rounding through the instance norm's
eps of 1e-8 and Inception's backward reaches 1e-5 at a few entries.
"""

import copy

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import random_bn_stats
from sba_gan_tpu.config import cfg_from_dict as jax_cfg_from_dict
from sba_gan_tpu.losses import gen2 as jl
from sba_gan_tpu.models import gen2 as jm
from sba_gan_tpu.train.gen2 import Gen2DNet as JaxGen2DNet
from sba_gan_tpu.train.gen2 import Gen2Trainer as JaxGen2Trainer
from sba_gan_tpu_torch.config import cfg_from_dict
from sba_gan_tpu_torch.losses import gen2 as pl
from sba_gan_tpu_torch.models import gen2 as pm
from sba_gan_tpu_torch.train.gen2 import EMA_DECAY, Gen2DNet, Gen2Trainer, RMSprop
from sba_gan_tpu_torch.utils import weights as W

TOL = dict(rtol=1e-5, atol=1e-5)
G2 = dict(E_DIM=8, C_DIM=6, Z_DIM=5, W_DIM=12, A_DIM=10, MAX_LENGTH=7, M_LAYERS=2,
          RESOLUTION=16, RESOLUTION_INIT=4, FMAP_BASE=128, FMAP_MAX=16,
          BERT_VOCAB=50, BERT_HIDDEN=16, BERT_LAYERS=1, BERT_HEADS=2, BERT_INTERMEDIATE=32)
B, T = 4, 7
LR = 2e-4


def cfgs(**over):
    d = {"GEN2": {**G2, **over}, "TRAIN": {"BATCH_SIZE": B, "CRITIC_ITER": 2},
         "MODEL": {"INCEPTION_INPUT": 75}}
    return jax_cfg_from_dict(d), cfg_from_dict(d)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs six test processes on the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def batch(seed=0):
    rng = np.random.default_rng(seed)
    real = rng.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32)
    lens = [7, 5, 3, 6]
    tokens = np.zeros((B, T), np.int32)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(1, G2["BERT_VOCAB"], n)
    return real, tokens


def noise_sizes(res=16, res_init=4):
    sizes, r = [res_init] * 2, res_init * 2
    while r <= res:
        sizes += [r] * 2
        r *= 2
    return sizes


def jax_gen_draws(r_gen, batch_size, use_noise, sizes, noise_dtype=jnp.float32):
    """The CA epsilon and the epilogues' noise maps (NCHW, drawn in the
    generator's dtype) that ``Gen2Generator.apply(..., rng=r_gen)`` draws."""
    r, ca = jax.random.split(r_gen)
    eps = np.asarray(jax.random.normal(ca, (batch_size, G2["C_DIM"]), jnp.float32))
    r, r1, r2 = jax.random.split(r, 3)
    keys = [r1, r2]
    for _ in range((len(sizes) - 2) // 2):
        r, block = jax.random.split(r)
        keys += list(jax.random.split(block))
    noise = [np.asarray(jax.random.normal(k, (batch_size, s, s, 1), noise_dtype)
                        ).transpose(0, 3, 1, 2) for k, s in zip(keys, sizes)]
    return eps, (noise if use_noise else None)


def jax_step_draws(key, n, batch_size, d_step, penalty=False, use_noise=False):
    """The draws of JAX's step: ``fold_in(key, n)`` split into z, the
    generator's key and (D step, used with ``penalty``) the penalty's."""
    rng = jax.random.fold_in(key, n)
    keys = jax.random.split(rng, 3 if d_step else 2)
    z = np.asarray(jax.random.normal(keys[0], (batch_size, G2["Z_DIM"]), jnp.float32))
    eps, noise = jax_gen_draws(keys[1], batch_size, use_noise, noise_sizes())
    out = {"z": z, "eps": eps, "noise": noise}
    if penalty:
        out["gp_eps"] = np.asarray(jax.random.uniform(keys[2], (batch_size, 1, 1, 1),
                                                      jnp.float32))
    return out


def randomize(tree, rng, names=("weight",)):
    """``tree`` with the leaves named ``names`` (the zero-init noise gains)
    drawn at random."""
    return {k: (randomize(v, rng, names) if isinstance(v, dict) else
                (rng.normal(0, 0.5, np.shape(v)).astype(np.float32) if k in names else v))
            for k, v in tree.items()}


def assert_grads(got, want, name=""):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5 * scale,
                               err_msg=name)


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------
def test_nf_ladder():
    for base, cap in ((4096, 256), (128, 16), (64, 16)):
        for r in range(1, 10):
            assert pm.nf(r, base, fmap_max=cap) == jm.nf(r, base, fmap_max=cap)
    assert [pm.nf(r) for r in (2, 5, 6, 7)] == [256, 128, 64, 32]


def _gen_kw():
    return dict(resolution=16, resolution_init=4, e_dim=8, c_dim=6, w_dim=12, a_dim=10,
                m_layers=2, fmap_base=128, fmap_max=16,
                bert_cfg=dict(vocab_size=50, hidden_size=16, num_layers=1, num_heads=2,
                              intermediate_size=32, max_position=24, type_vocab_size=2,
                              layer_norm_eps=1e-12))


@pytest.mark.parametrize("toggles", [
    dict(),
    dict(use_attn=True, use_noise=True),
    dict(use_noise=True),
    dict(use_pixel_norm=True),
    dict(use_truncation=True, truncation_psi=0.2),
    dict(use_instance_norm=False, use_pixel_norm=True),
], ids=["none", "attention", "noise", "pixel_norm", "truncation", "no_instance_norm"])
def test_generator_matches_jax(toggles):
    """In float64 (the JAX modules with ``dtype`` float64 under
    ``jax.enable_x64``; their explicit float32 casts stay): the instance
    norm's eps of 1e-8 lifts float32 rounding past 1e-5 at an entry or two
    of the image.  Random noise gains and constant."""
    _, tokens = batch()
    z = np.random.default_rng(1).standard_normal((B, 5))
    rng = jax.random.PRNGKey(3)
    with jax.enable_x64(True):
        jg = jm.Gen2Generator(**_gen_kw(), **toggles, dtype=jnp.float64)
        params = np_tree(jg.init(rng, jnp.asarray(tokens), jnp.asarray(z), rng)["params"])
        params = randomize(params, np.random.default_rng(2), ("weight", "const"))
        want = jg.apply({"params": params}, jnp.asarray(tokens), jnp.asarray(z), rng)
        eps, noise = jax_gen_draws(rng, B, toggles.get("use_noise", False), noise_sizes(),
                                   jnp.float64)
    pg = pm.Gen2Generator(z_dim=5, **_gen_kw(), **toggles).double()
    pg.load_state_dict(W.gen2_state_dict(params))
    with torch.no_grad():
        got = pg(torch.from_numpy(tokens).long(), torch.from_numpy(z), torch.from_numpy(eps),
                 None if noise is None else [torch.from_numpy(n) for n in noise])
    np.testing.assert_allclose(got[0].permute(0, 2, 3, 1).numpy(), np.asarray(want[0]), **TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_weight_map_names_every_port_parameter():
    """Every port parameter of G and D gets a value from the Flax tree and
    every Flax leaf a port key; the transposed convolution is the flipped
    kernel (a plain transpose is far off)."""
    jg = jm.Gen2Generator(**_gen_kw(), use_attn=True, use_noise=True)
    _, tokens = batch()
    rng = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(jg.init, rng, jnp.asarray(tokens), jnp.zeros((B, 5)), rng)
    gen = np.random.default_rng(0)
    params = jax.tree.map(lambda a: gen.standard_normal(a.shape).astype(np.float32),
                          shapes["params"])
    sd = W.gen2_state_dict(params)
    pg = pm.Gen2Generator(z_dim=5, **_gen_kw(), use_attn=True, use_noise=True)
    assert sorted(sd) == sorted(pg.state_dict())
    k = params["block_1"]["up_conv"]["kernel"]
    np.testing.assert_array_equal(sd["block_1.up_conv.weight"].numpy(),
                                  k[::-1, ::-1].transpose(2, 3, 0, 1))
    x = jnp.asarray(np.random.default_rng(0).standard_normal((2, 8, 8, 16)), jnp.float32)
    conv = flax.linen.ConvTranspose(8, (4, 4), strides=(2, 2), padding="SAME")
    want = np.asarray(conv.apply({"params": {"kernel": k, "bias": np.zeros(8, np.float32)}}, x))
    got = torch.nn.functional.conv_transpose2d(
        torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2), sd["block_1.up_conv.weight"],
        stride=2, padding=1).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    unflipped = torch.from_numpy(np.ascontiguousarray(k.transpose(2, 3, 0, 1)))
    off = torch.nn.functional.conv_transpose2d(
        torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2), unflipped, stride=2, padding=1)
    assert np.abs(off.permute(0, 2, 3, 1).numpy() - want).max() > 1e-2


@pytest.fixture(scope="module")
def dnets():
    jd = JaxGen2DNet(resolution=16, resolution_init=4, e_dim=8, fmap_base=128, fmap_max=16)
    real, _ = batch()
    sent = np.random.default_rng(5).standard_normal((B, 8)).astype(np.float32)
    params = np_tree(jax.jit(jd.init)(jax.random.PRNGKey(1), jnp.asarray(real),
                                      jnp.asarray(sent))["params"])
    pd = Gen2DNet(16, 4, 8, fmap_base=128, fmap_max=16)
    pd.load_state_dict(W.gen2_state_dict(params))
    return jd, params, pd, real, sent


def test_discriminator_matches_jax(dnets):
    jd, params, pd, real, sent = dnets
    want_f = jd.apply({"params": params}, jnp.asarray(real), method=JaxGen2DNet.features)
    want = jd.apply({"params": params}, jnp.asarray(real), jnp.asarray(sent))
    x = torch.from_numpy(real).permute(0, 3, 1, 2)
    with torch.no_grad():
        feats = pd.features(x)
        got = pd(x, torch.from_numpy(sent))
    assert tuple(feats.shape) == (B, 16, 4, 4)
    np.testing.assert_allclose(feats.permute(0, 2, 3, 1).numpy(), np.asarray(want_f), **TOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_image_encoder_matches_jax(bce_runs):
    """The BCE trainer's encoder (its init) at Inception input 75, eval mode
    on random running statistics."""
    enc = bce_runs["jt"].image_encoder
    x = np.random.default_rng(6).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    params, stats = np_tree(bce_runs["s0"].enc_params), bce_runs["stats"]
    want = jax.jit(enc.apply)({"params": params, "batch_stats": stats}, jnp.asarray(x))
    pe = pm.Gen2ImageEncoder(8, 75)
    pe.load_state_dict(W.gen2_state_from_jax({}, {}, params, stats)["image_encoder"])
    pe.train()  # stays on its running statistics
    assert not pe.training and not pe.Mixed_7c.branch1x1.bn.training
    with torch.no_grad():
        got = pe(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------
def _logits(rng, n=B):
    return rng.standard_normal((n, 1)).astype(np.float32)


def _loss_case(name, rng):
    """(JAX function, port function, inputs) of one loss."""
    lg = [_logits(rng) for _ in range(4)] + [_logits(rng, B - 1)]
    sent, code = (rng.standard_normal((B, 8)).astype(np.float32) for _ in range(2))
    if name == "sent":
        return (lambda s, c: sum(jl.gen2_sent_loss(s, c, 10.0)),
                lambda s, c: sum(pl.gen2_sent_loss(s, c, 10.0)), [sent, code])
    if name == "d_bce":
        return jl.gen2_d_loss_bce, pl.gen2_d_loss_bce, lg
    if name == "g_bce":
        return (lambda a, b, s, c: jl.gen2_g_loss_bce(a, b, s, c, 5.0, 10.0),
                lambda a, b, s, c: pl.gen2_g_loss_bce(a, b, s, c, 5.0, 10.0),
                lg[:2] + [sent, code])
    if name == "d_wgan":
        gp = np.float32(0.7)
        return (lambda *a: jl.gen2_d_loss_wgan(*a, gp),
                lambda *a: pl.gen2_d_loss_wgan(*a, torch.tensor(gp)), lg)
    return jl.gen2_g_loss_wgan, pl.gen2_g_loss_wgan, lg[:2]


@pytest.mark.parametrize("name", ["sent", "d_bce", "g_bce", "d_wgan", "g_wgan"])
def test_loss_matches_jax(name):
    jf, pf, xs = _loss_case(name, np.random.default_rng(11))
    argnums = tuple(range(len(xs)))
    want, want_g = jax.value_and_grad(jf, argnums)(*map(jnp.asarray, xs))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    got = pf(*ts)
    got_g = torch.autograd.grad(got, ts)
    np.testing.assert_allclose(float(got), float(want), **TOL)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_feature_gradient_penalty_matches_jax(dnets):
    """The penalty through D's features: its value, and its gradients to the
    real and fake images and to D's parameters (a double backward)."""
    jd, params, pd, real, _ = dnets
    fake = np.random.default_rng(12).uniform(-1, 1, real.shape).astype(np.float32)
    key = jax.random.PRNGKey(9)
    eps = np.asarray(jax.random.uniform(key, (B, 1, 1, 1), jnp.float32))

    def jax_gp(p, r, f):
        feat = lambda x: jd.apply({"params": p}, x, method=JaxGen2DNet.features)  # noqa: E731
        return jl.gen2_feature_gradient_penalty(feat, r, f, key, 10.0)
    want, (gp_p, gp_r, gp_f) = jax.jit(jax.value_and_grad(jax_gp, (0, 1, 2)))(
        params, jnp.asarray(real), jnp.asarray(fake))
    r, f = (torch.from_numpy(a).permute(0, 3, 1, 2).requires_grad_(True) for a in (real, fake))
    got = pl.gen2_feature_gradient_penalty(pd.features, r, f, torch.from_numpy(eps), 10.0)
    names = [f"backbone.{n}" for n, _ in pd.backbone.named_parameters()]
    grads = torch.autograd.grad(got, [r, f] + list(pd.backbone.parameters()))
    np.testing.assert_allclose(float(got), float(want), **TOL)
    assert_grads(grads[0].permute(0, 2, 3, 1).numpy(), gp_r, "real")
    assert_grads(grads[1].permute(0, 2, 3, 1).numpy(), gp_f, "fake")
    want_p = W.gen2_state_dict(np_tree(gp_p))
    for n, g in zip(names, grads[2:]):
        assert_grads(g.numpy(), want_p[n].numpy(), n)
    assert float(torch.stack([g.abs().max() for g in grads[2:]]).max()) > 0


# --------------------------------------------------------------------------
# the steps
# --------------------------------------------------------------------------
def keep_grads():
    """An optax transformation whose state is the last gradient and whose
    update is 0: a JAX step through it returns its gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def init_state(jt, key):
    """``jt.init_state`` at batch 2, jitted (its masks and optimizers are set
    while it traces)."""
    return jax.jit(lambda k: jt.init_state(k, batch=2, max_length=T))(key)


def with_random_const(state):
    """``state`` with G's learned constant (and its EMA) drawn at random: the
    init's constant of ones is flat in space, so the instance norm that
    follows it gives 0 and the constant's gradient is rounding alone."""
    g = np_tree(state.g_params)
    g["const"] = np.random.default_rng(8).normal(0, 1, g["const"].shape).astype(np.float32)
    return state.replace(g_params=g, g_ema=copy.deepcopy(g))


def rmsprop_update(params, grads, lr=LR):
    tx = optax.rmsprop(lr)
    upd, _ = tx.update(grads, tx.init(params), params)
    return np_tree(optax.apply_updates(params, upd))


def port_trainer(pcfg, state, enc_stats=None, dtype=torch.float32):
    t = Gen2Trainer(pcfg, device="cpu", seed=0, dtype=dtype)
    sd = W.gen2_state_from_jax(np_tree(state.g_params), np_tree(state.d_params),
                               None if state.enc_params is None else np_tree(state.enc_params),
                               enc_stats, np_tree(state.g_ema))
    t.generator.load_state_dict(sd["generator"])
    t.g_ema.load_state_dict(sd["g_ema"])
    t.dnet.load_state_dict(sd["dnet"])
    if t.image_encoder is not None:
        t.image_encoder.load_state_dict(sd["image_encoder"])
    return t


@pytest.fixture(scope="module")
def wgan_runs():
    """JAX's WGAN D step, then its G step from the D after optax's RMSprop,
    each giving its gradients."""
    jcfg, pcfg = cfgs(WGAN=True)
    jt = JaxGen2Trainer(jcfg)
    key = jax.random.PRNGKey(0)
    s0 = with_random_const(init_state(jt, key))
    s0 = s0.replace(d_params=randomize(np_tree(s0.d_params), np.random.default_rng(3),
                                       ("bias",)))
    jt._d_tx = jt._g_tx = keep_grads()
    d_step, g_step = jt.steps()
    real, tokens = batch()
    s1, d_loss = d_step(s0, jnp.asarray(real), jnp.asarray(tokens), key)
    d_after = rmsprop_update(np_tree(s0.d_params), np_tree(s1.d_opt))
    s2, g_loss = g_step(s1.replace(d_params=d_after), jnp.asarray(real),
                        jnp.asarray(tokens), key)
    g_grads = np_tree(s2.g_opt)
    g_after = rmsprop_update(np_tree(s0.g_params), g_grads)
    return dict(pcfg=pcfg, s0=s0, real=real, tokens=tokens, key=key,
                d_loss=float(d_loss), d_grads=np_tree(s1.d_opt), d_after=d_after,
                g_loss=float(g_loss), g_grads=g_grads, g_after=g_after)


def test_wgan_d_step_matches_jax(wgan_runs):
    r = wgan_runs
    t = port_trainer(r["pcfg"], r["s0"])
    draws = jax_step_draws(r["key"], 0, B, d_step=True, penalty=True)
    loss, grads = t.d_grads(r["real"], r["tokens"], draws)
    np.testing.assert_allclose(float(loss), r["d_loss"], **TOL)
    want = W.gen2_state_dict(r["d_grads"])
    for n, g in zip(t.d_names, grads):
        assert_grads(g.numpy(), want[n].numpy(), n)
    t.d_step(r["real"], r["tokens"], draws)
    assert t.step == 1
    after = W.gen2_state_dict(r["d_after"])
    for n, p in t.dnet.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), after[n].numpy(), **TOL, err_msg=n)


def test_wgan_g_step_matches_jax(wgan_runs):
    """From JAX's D after its update: the G loss, G's gradients (the BERT
    tower's none; JAX's masked to 0), G and its EMA after the update."""
    r = wgan_runs
    t = port_trainer(r["pcfg"], r["s0"])
    t.dnet.load_state_dict(W.gen2_state_dict(r["d_after"]))
    t.step = 1
    draws = jax_step_draws(r["key"], 3, B, d_step=False)
    loss, grads, enc = t.g_grads(r["tokens"], draws)
    assert enc == []
    np.testing.assert_allclose(float(loss), r["g_loss"], **TOL)
    want = W.gen2_state_dict(r["g_grads"])
    assert all(not np.any(want[n].numpy()) for n in want if n.startswith("bert_embedding.bert."))
    for n, g in zip(t.g_names, grads):
        assert_grads(g.numpy(), want[n].numpy(), n)
    ema0 = {n: p.clone() for n, p in t.g_ema.named_parameters()}
    t.g_step(r["tokens"], draws)
    after = W.gen2_state_dict(r["g_after"])
    for n, p in t.generator.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), after[n].numpy(), **TOL, err_msg=n)
        np.testing.assert_allclose(dict(t.g_ema.named_parameters())[n].numpy(),
                                   (ema0[n] * EMA_DECAY + p.detach() * (1 - EMA_DECAY)).numpy(),
                                   rtol=0, atol=1e-7, err_msg=n)


@pytest.fixture(scope="module")
def bce_runs():
    """JAX's BCE D step (its gradients), and its G loss and gradients from
    its pieces: G, D, the image encoder with its ``batch_stats``, and
    ``gen2_g_loss_bce``."""
    jcfg, pcfg = cfgs(WGAN=False)
    jt = JaxGen2Trainer(jcfg)
    key = jax.random.PRNGKey(1)
    s0 = with_random_const(init_state(jt, key))
    shape = jax.eval_shape(lambda: jt.image_encoder.init(
        key, jnp.zeros((2, 16, 16, 3))))["batch_stats"]
    stats = random_bn_stats(shape, np.random.default_rng(4))
    jt._d_tx = keep_grads()
    d_step, _ = jt.steps()
    real, tokens = batch(1)
    s1, d_loss = d_step(s0, jnp.asarray(real), jnp.asarray(tokens), key)

    draws = jax_step_draws(key, 3, B, d_step=False)
    r_z, r_gen = jax.random.split(jax.random.fold_in(key, 3))
    d_params = s1.d_params

    def g_loss(g_params, enc_params):
        z = jax.random.normal(r_z, (B, G2["Z_DIM"]), jnp.float32)
        fake, _, sent, _, _ = gen.apply({"params": g_params}, jnp.asarray(tokens), z, r_gen)
        sent = jax.lax.stop_gradient(sent)
        fu, fc = dnet.apply({"params": d_params}, fake, sent)
        code = enc.apply({"params": enc_params, "batch_stats": stats}, fake)
        return jl.gen2_g_loss_bce(fu, fc, sent, code, jt.lam, jt.gamma3)
    with jax.enable_x64(True):  # float64: Inception's backward lifts float32 rounding
        gen, dnet, enc = (m.clone(dtype=jnp.float64)
                          for m in (jt.generator, jt.dnet, jt.image_encoder))
        loss, (gg, eg) = jax.jit(jax.value_and_grad(g_loss, (0, 1)))(s0.g_params,
                                                                       s0.enc_params)
        loss, gg, eg = float(loss), np_tree(gg), np_tree(eg)
    return dict(pcfg=pcfg, s0=s0, stats=stats, real=real, tokens=tokens, key=key,
                jt=jt, d_loss=float(d_loss), d_grads=np_tree(s1.d_opt), g_draws=draws,
                g_loss=loss, g_grads=gg, e_grads=eg)


def test_bce_d_step_matches_jax(bce_runs):
    r = bce_runs
    t = port_trainer(r["pcfg"], r["s0"], r["stats"])
    draws = jax_step_draws(r["key"], 0, B, d_step=True)
    loss, grads = t.d_grads(r["real"], r["tokens"], draws)
    np.testing.assert_allclose(float(loss), r["d_loss"], **TOL)
    want = W.gen2_state_dict(r["d_grads"])
    for n, g in zip(t.d_names, grads):
        assert_grads(g.numpy(), want[n].numpy(), n)


def test_bce_g_step_matches_jax_pieces(bce_runs):
    """The port's BCE G step (Inception on its running statistics) against
    JAX's G, D, image encoder and loss with ``batch_stats`` passed, both in
    float64; then only the encoder's ``fc`` and G move, by optax's
    RMSprop."""
    r = bce_runs
    t = port_trainer(r["pcfg"], r["s0"], r["stats"], torch.float64)
    loss, grads, enc = t.g_grads(r["tokens"], r["g_draws"])
    np.testing.assert_allclose(float(loss), r["g_loss"], **TOL)
    want = W.gen2_state_dict(r["g_grads"])
    for n, g in zip(t.g_names, grads):
        assert_grads(g.numpy(), want[n].numpy(), n)
    assert t.e_names == ["fc.weight", "fc.bias"]
    want_e = W.flatten_tree(r["e_grads"])
    assert_grads(enc[0].numpy(), want_e["fc/kernel"].T, "fc.weight")
    assert_grads(enc[1].numpy(), want_e["fc/bias"], "fc.bias")
    trunk = copy.deepcopy({n: p for n, p in t.image_encoder.named_parameters()
                           if not n.startswith("fc.")})
    t.g_step(r["tokens"], r["g_draws"])
    e_after = W.flatten_tree(rmsprop_update(np_tree(r["s0"].enc_params["fc"]),
                                            r["e_grads"]["fc"]))
    np.testing.assert_allclose(t.image_encoder.fc.weight.detach().numpy(),
                               e_after["kernel"].T, **TOL)
    for n, p in t.image_encoder.named_parameters():
        if n in trunk:
            assert torch.equal(p, trunk[n]), n


def test_jax_bce_g_step_raises(bce_runs):
    """Reference fault 3: the JAX trainer keeps the image encoder's params
    alone (train/gen2.py:162-163) and applies it without ``batch_stats`` in
    its BCE G step (:251), which raises."""
    r = bce_runs
    _, g_step = r["jt"].steps()  # its G step keeps optax's RMSprop
    with pytest.raises(flax.errors.ScopeCollectionNotFound):
        g_step(r["s0"], jnp.asarray(r["real"]), jnp.asarray(r["tokens"]), r["key"])


# --------------------------------------------------------------------------
# the trainer
# --------------------------------------------------------------------------
def test_trainable_parameters_match_jax_masks(wgan_runs):
    """The port trains what the JAX masks train: G but the BERT tower
    (``bert_embedding.fc`` trains), the image encoder's ``fc`` alone."""
    r = wgan_runs
    mask = W.flatten_tree(jm.gen2_trainable_mask(r["s0"].g_params))
    want = sorted(W.gen2_key(tuple(k.split("/"))) for k, v in mask.items() if v)
    t = Gen2Trainer(r["pcfg"], device="cpu", seed=0)
    assert sorted(t.g_names) == want
    assert "bert_embedding.fc.weight" in t.g_names
    assert not any(n.startswith("bert_embedding.bert.") for n in t.g_names)
    enc = jm.Gen2ImageEncoder(e_dim=8, input_size=75)
    shape = jax.eval_shape(lambda: enc.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 16, 16, 3))))["params"]
    emask = W.flatten_tree(jm.gen2_image_encoder_trainable_mask(shape))
    assert sorted(k for k, v in emask.items() if v) == ["fc/bias", "fc/kernel"]
    assert [n for n, _ in pm.Gen2ImageEncoder(8, 75).named_parameters()
            if pm.gen2_image_encoder_trainable(n)] == ["fc.weight", "fc.bias"]


def test_freezing_keeps_bert_and_moves_fc(wgan_runs):
    r = wgan_runs
    t = port_trainer(r["pcfg"], r["s0"])
    bert = copy.deepcopy(t.generator.bert_embedding.bert.state_dict())
    fc = t.generator.bert_embedding.fc.weight.detach().clone()
    for _ in range(2):
        t.d_step(r["real"], r["tokens"])
        t.g_step(r["tokens"])
    for n, v in t.generator.bert_embedding.bert.state_dict().items():
        assert torch.equal(v, bert[n]), n
    assert not torch.equal(t.generator.bert_embedding.fc.weight, fc)
    assert all(not p.requires_grad for p in t.generator.bert_embedding.bert.parameters())


def test_critic_schedule(wgan_runs):
    """4 batches at CRITIC_ITER 2: 4 D updates, 2 G updates (after the 2nd
    and 4th); the draws follow the step counter."""
    r = wgan_runs
    t = Gen2Trainer(r["pcfg"], device="cpu", seed=5)
    calls = []
    g_step = t.g_step
    t.g_step = lambda tokens, draws=None: calls.append(t.step) or g_step(tokens, draws)
    d, g = t.train_epoch([batch(i) for i in range(4)])
    assert t.step == 4 and calls == [2, 4]
    assert np.isfinite(d) and np.isfinite(g)
    a, b = t.draw(0, 2, True), t.draw(0, 2, True)
    assert torch.equal(a["z"], b["z"]) and not torch.equal(a["z"], t.draw(2, 2, True)["z"])


def test_sample_uses_the_ema(wgan_runs):
    """``sample`` against JAX's ``Gen2Trainer.sample`` of the same EMA
    weights and key (its z and CA epsilon reproduced), and the live G's
    image differs once G moved."""
    r = wgan_runs
    jcfg, _ = cfgs(WGAN=True)
    jt = JaxGen2Trainer(jcfg)
    s0 = r["s0"]
    ema = jax.tree.map(lambda p: p + 0.01, s0.g_ema)
    state = s0.replace(g_ema=ema)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jt.sample(state, jnp.asarray(r["tokens"]), key))
    t = port_trainer(r["pcfg"], state)
    r_z, r_gen = jax.random.split(key)
    eps, _ = jax_gen_draws(r_gen, B, False, noise_sizes())
    draws = {"z": np.asarray(jax.random.normal(r_z, (B, G2["Z_DIM"]), jnp.float32)),
             "eps": eps, "noise": None}
    got = t.sample(r["tokens"], seed=0, draws=draws)
    assert got.shape == (B, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    live = t.sample(r["tokens"], seed=0, use_ema=False, draws=draws)
    assert np.abs(live.numpy() - want).max() > 1e-3


def test_rmsprop_is_optax():
    rng = np.random.default_rng(0)
    p = rng.standard_normal((3, 4)).astype(np.float32)
    grads = [rng.standard_normal((3, 4)).astype(np.float32) * s for s in (1.0, 1e-4, 3.0)]
    tx = optax.rmsprop(1e-2)
    jp, st = jnp.asarray(p), tx.init(jnp.asarray(p))
    tp = torch.from_numpy(p.copy())
    opt = RMSprop([tp], 1e-2)
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.from_numpy(g)])
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(opt.nu[0].numpy(), np.asarray(st[0].nu), rtol=1e-6)
