"""The port's gen-1 progressive StyleGAN (``models/progressive.py``, the gen-1
losses of ``losses/gan.py``, ``train/progressive.py`` and the sampling
functions of ``progressive_generate.py``) against the JAX package's, at the
tiny widths of tests/test_progressive.py: z 8, w 16, 8 mapping layers,
``max_resolution`` 16 (rungs 0-2), ``fmap_max`` 16, a sentence embedding of
12, batch 4.  The weights are one JAX state (jitted init, the noise gains
drawn at random so that the noise maps matter), carried by
``utils.weights.progressive_state_from_jax``; the random draws are JAX's,
made in the test from the steps' own key arithmetic and injected; torch
runs on one intra-op thread.

* G at rungs 0-2 at alpha 0, 0.5 and 1, mixed (a crossover) and unmixed;
  truncated; ``return_w``; D's scores at rungs 0-2;
* the four losses: the WGAN terms' values and input gradients, the two
  penalties' values and gradients to D's parameters (a double backward);
* one D step and one G step in each mode against JAX's jitted steps (the
  R1 G step is the WGAN trainer's: the G step does not depend on the
  mode): the loss and the gradients (with beta1 0, optax's first moment
  after one update is the gradient itself); then the trainer's Adam
  (``torch.optim.Adam``) fed JAX's gradients, held to JAX's updated
  parameters, moments and count, and the EMA;
* a run across a rung (D and G at rung 1, then at rung 2): the blocks new at
  rung 2 move by optax's update with its global count, which they take
  because the trainer gives every parameter a gradient, zeros where the rung
  does not run it (a parameter whose gradient is None keeps PyTorch's
  per-parameter count behind);
* ``with_lr``, ``sample``, the mean style and the style-mixing grid;
  ``make_adam`` against optax's chain with the 0.01 mask.

Tolerance: rtol 1e-5 and atol 1e-5 forward and for the updated
parameters, moments and EMA (the same gradients fed to both optimizers);
gradients rtol 1e-5 and atol 1e-5 of each tensor's largest entry, as
tests/test_torch_gen2.py holds gen-2, but for D's biases under a penalty
(the penalty alone, and the D steps of both modes), which take atol 1e-5 of
the largest entry of D's whole gradient where that is larger: a bias's
gradient sums the map's over B, H and W, terms of both signs, and the
head's R1 gradient is a difference of two means of sigmoids near 0.5, so
float32 rounding of the terms, not the small result, sets its error
(measured: up to 2.2e-5 of the tensor's own largest entry through the
penalty's double backward, 5.5e-5 for R1's head bias, a 1-ulp cancellation
at 0.5; every other tensor of D and G within 1e-5 of its own).  Float32
throughout: the JAX modules cast to float32 inside (their equalized layers
take no ``dtype``), so there is no float64 JAX step to hold them to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sba_gan_tpu import progressive_generate as jgen
from sba_gan_tpu.losses import gan as jl
from sba_gan_tpu.models import progressive as jm
from sba_gan_tpu.train.progressive import ProgressiveTrainer as JaxTrainer
from sba_gan_tpu_torch import progressive_generate as pgen
from sba_gan_tpu_torch.losses import gan as pl
from sba_gan_tpu_torch.models import progressive as pm
from sba_gan_tpu_torch.train.progressive import (
    EMA_DECAY,
    ProgressiveTrainer,
    base_lr,
    make_adam,
)
from sba_gan_tpu_torch.utils import weights as W

TOL = dict(rtol=1e-5, atol=1e-5)
DIMS = dict(z_dim=8, w_dim=16, max_resolution=16, fmap_max=16)
E, B, LR = 12, 4, 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs six test processes on the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def randomize(tree, rng, under=False):
    """``tree`` with the leaves under ``noise1``/``noise2`` (the zero-init
    noise gains) drawn at random."""
    return {k: (randomize(v, rng, under or k in ("noise1", "noise2")) if isinstance(v, dict)
                else rng.normal(0, 0.5, np.shape(v)).astype(np.float32) if under else v)
            for k, v in tree.items()}


def nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().permute(0, 2, 3, 1).numpy()


def assert_grads(got, want, name="", net_scale=0.0):
    """atol 1e-5 of the tensor's largest entry; a bias of D under a penalty
    (``net_scale`` given) takes 1e-5 of the largest entry of D's whole
    gradient if that is larger (see the module's docstring)."""
    want = np.asarray(want)
    scale = float(np.abs(want).max()) or 1.0
    if name.endswith("bias"):
        scale = max(scale, net_scale)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5 * scale,
                               err_msg=name)


def reals(res, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (B, res, res, 3)).astype(np.float32)


# --------------------------------------------------------------------------
# JAX's draws
# --------------------------------------------------------------------------
def jax_noise(r_noise, batch, step):
    """The noise maps (NCHW) ``StyledGenerator.apply(..., rng=r_noise)``
    draws at rung ``step``: split into step + 1 block keys, each split in
    two."""
    out = []
    for i, k in enumerate(jax.random.split(r_noise, step + 1)):
        s = 4 * 2 ** i
        for kk in jax.random.split(k):
            out.append(np.array(jax.random.normal(kk, (batch, s, s, 1), jnp.float32))
                       .transpose(0, 3, 1, 2))
    return out


def jax_z(r_z, batch, mixing_prob=0.9):
    r_mix, r = jax.random.split(r_z)
    z = np.asarray(jax.random.normal(r, (2, batch, DIMS["z_dim"]), jnp.float32))
    if not bool(jax.random.uniform(r_mix) < mixing_prob):
        z = np.stack([z[0], z[0]])
    return z


def jax_step_draws(key, n, batch, step, d_step):
    """The draws of the JAX step that folds ``n`` into ``key``: z, the noise
    and (D step) the penalty's epsilon."""
    keys = jax.random.split(jax.random.fold_in(key, n), 3 if d_step else 2)
    out = {"z": jax_z(keys[0], batch), "noise": jax_noise(keys[1], batch, step)}
    if d_step:
        out["gp_eps"] = np.asarray(jax.random.uniform(keys[2], (batch, 1, 1, 1), jnp.float32))
    return out


# --------------------------------------------------------------------------
# one JAX state for the module
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_state():
    jt = JaxTrainer(**DIMS, loss_mode="wgan-gp", embed_dim=E)
    s0 = jax.jit(lambda k: jt.init_state(k))(jax.random.PRNGKey(0))
    g = randomize(np_tree(s0.g_params), np.random.default_rng(1))
    s0 = s0.replace(g_params=g, g_ema=jax.tree.map(np.copy, g), d_params=np_tree(s0.d_params))
    sent = np.random.default_rng(2).standard_normal((B, E)).astype(np.float32)
    return jt, s0, sent


def port_trainer(state, loss_mode="wgan-gp", g_params=None, d_params=None):
    t = ProgressiveTrainer(**DIMS, loss_mode=loss_mode, embed_dim=E, device="cpu", seed=0)
    sd = W.progressive_state_from_jax(np_tree(g_params or state.g_params),
                                      np_tree(d_params or state.d_params),
                                      np_tree(state.g_ema))
    t.generator.load_state_dict(sd["generator"])
    t.g_ema.load_state_dict(sd["g_ema"])
    t.discriminator.load_state_dict(sd["discriminator"])
    return t


def adam_state(opt_state):
    """(count, mu, nu) of a JAX state's Adam (G's chain or D's)."""
    inner = (opt_state if hasattr(opt_state, "inner_state") else opt_state[0]).inner_state[0]
    return int(inner.count), np_tree(inner.mu), np_tree(inner.nu)


def adam_count(opt, params):
    """The one step count of a torch Adam whose every parameter in
    ``params`` has stepped as often as every other."""
    counts = {int(opt.state[p]["step"]) for p in params if p in opt.state}
    assert len(counts) == 1 and all(p in opt.state for p in params), counts
    return counts.pop()


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------
def test_channels_ladder():
    for i in range(9):
        for cap in (512, 16):
            assert pm._channels(i, fmap_max=cap) == jm._channels(i, fmap_max=cap)
    assert [pm._channels(i) for i in range(7)] == [512, 512, 512, 512, 256, 128, 64]


def test_weight_map_names_every_port_parameter(jax_state):
    """Every port parameter gets a value from the Flax trees and every Flax
    leaf a port key; at the CLI's full width G has 25.9 M parameters and D
    23.1 M, as the JAX init."""
    _, s0, _ = jax_state
    sd = W.progressive_state_from_jax(np_tree(s0.g_params), np_tree(s0.d_params))
    t = ProgressiveTrainer(**DIMS, embed_dim=E, device="cpu")
    assert sorted(sd["generator"]) == sorted(t.generator.state_dict())
    assert sorted(sd["discriminator"]) == sorted(t.discriminator.state_dict())
    full = ProgressiveTrainer(device="cpu", init=False)
    g = sum(p.numel() for p in full.generator.parameters())
    d = sum(p.numel() for p in full.discriminator.parameters())
    shapes = jax.eval_shape(lambda k: JaxTrainer().init_state(k), jax.random.PRNGKey(0))
    count = lambda tree: sum(int(np.prod(a.shape)) for a in jax.tree.leaves(tree))  # noqa: E731
    assert (g, d) == (count(shapes.g_params), count(shapes.d_params))
    assert round(g / 1e6, 1) == 25.9 and round(d / 1e6, 1) == 23.1


@pytest.mark.parametrize("mixed", [False, True], ids=["unmixed", "mixed"])
@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("step", [0, 1, 2])
def test_generator_matches_jax(jax_state, step, alpha, mixed):
    jt, s0, sent = jax_state
    rng = jax.random.PRNGKey(10 + step)
    z = np.random.default_rng(step).standard_normal((2, B, 8) if mixed else (B, 8)
                                                     ).astype(np.float32)
    cross = 1 if mixed else None
    want = jt.generator.apply({"params": s0.g_params}, jnp.asarray(z), jnp.asarray(sent), step,
                              jnp.float32(alpha), rng, cross)
    t = port_trainer(s0)
    with torch.no_grad():
        got = t.generator(torch.from_numpy(z), torch.from_numpy(sent), step, alpha,
                          [torch.from_numpy(n) for n in jax_noise(rng, B, step)], crossover=cross)
    assert tuple(got.shape) == (B, 3, 4 * 2 ** step, 4 * 2 ** step)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)


def test_truncation_and_return_w_match_jax(jax_state):
    jt, s0, sent = jax_state
    rng = jax.random.PRNGKey(4)
    z = np.random.default_rng(4).standard_normal((B, 8)).astype(np.float32)
    args = (jnp.asarray(z), jnp.asarray(sent))
    w = jt.generator.apply({"params": s0.g_params}, *args, 0, jnp.float32(1.0), rng,
                           return_w=True)
    w_mean = np.asarray(w).mean(axis=0, keepdims=True)
    want = jt.generator.apply({"params": s0.g_params}, *args, 2, jnp.float32(0.5), rng,
                              w_mean=jnp.asarray(w_mean), style_weight=0.3)
    t = port_trainer(s0)
    zt, st = torch.from_numpy(z), torch.from_numpy(sent)
    with torch.no_grad():
        got_w = t.generator(zt, st, 0, 1.0, None, return_w=True)
        got = t.generator(zt, st, 2, 0.5, [torch.from_numpy(n) for n in jax_noise(rng, B, 2)],
                          w_mean=torch.from_numpy(w_mean), style_weight=0.3)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(w), **TOL)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("step", [0, 1, 2])
def test_discriminator_matches_jax(jax_state, step):
    jt, s0, _ = jax_state
    img = reals(4 * 2 ** step, seed=step)
    want = jt.discriminator.apply({"params": s0.d_params}, jnp.asarray(img), step,
                                  jnp.float32(0.3))
    t = port_trainer(s0)
    with torch.no_grad():
        got = t.discriminator(torch.from_numpy(img).permute(0, 3, 1, 2), step, 0.3)
    assert got.shape == (B,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["wgan_d", "wgan_g"])
def test_wgan_loss_matches_jax(name):
    rng = np.random.default_rng(11)
    xs = [rng.standard_normal(B).astype(np.float32) for _ in range(2 if name == "wgan_d" else 1)]
    jf, pf = (jl.wgan_d_loss, pl.wgan_d_loss) if name == "wgan_d" else (jl.wgan_g_loss,
                                                                      pl.wgan_g_loss)
    want, want_g = jax.value_and_grad(jf, tuple(range(len(xs))))(*map(jnp.asarray, xs))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    got = pf(*ts)
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    for g, w in zip(torch.autograd.grad(got, ts), want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("penalty", ["wgan_gp", "r1"])
def test_penalty_matches_jax(jax_state, penalty):
    """The penalty (R1: its whole loss) at rung 2, alpha 0.7: its value and
    its gradients to D's parameters, through D's input gradient (a double
    backward through the blur, the pools, the minibatch statistic and the
    fade)."""
    jt, s0, _ = jax_state
    real, fake = reals(16, 1), reals(16, 2)
    key = jax.random.PRNGKey(9)
    fake_scores = np.random.default_rng(3).standard_normal(B).astype(np.float32)
    disc = jt.discriminator

    def jax_loss(p):
        def d_fn(x):
            return disc.apply({"params": p}, x, 2, jnp.float32(0.7))
        if penalty == "r1":
            return jl.r1_d_loss(d_fn, jnp.asarray(real), jnp.asarray(fake_scores))
        return jl.wgan_gradient_penalty(d_fn, jnp.asarray(real), jnp.asarray(fake), key)
    want, want_g = jax.jit(jax.value_and_grad(jax_loss))(s0.d_params)
    t = port_trainer(s0)

    def d_fn(x):
        return t.discriminator(x, 2, 0.7)
    r, f = (torch.from_numpy(a).permute(0, 3, 1, 2) for a in (real, fake))
    if penalty == "r1":
        got = pl.r1_d_loss(d_fn, r, torch.from_numpy(fake_scores))
    else:
        eps = torch.from_numpy(np.asarray(jax.random.uniform(key, (B, 1, 1, 1), jnp.float32)))
        got = pl.wgan_gradient_penalty(d_fn, r, f, eps)
    grads = torch.autograd.grad(got, t.d_params, allow_unused=True)
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    want_sd = W.progressive_state_dict(np_tree(want_g))
    net_scale = max(float(v.abs().max()) for v in want_sd.values())
    for n, g in zip(t.d_names, grads):
        if g is None:  # a head rung 2 does not run: JAX's gradient is 0
            assert not want_sd[n].any(), n
            continue
        assert_grads(g.numpy(), want_sd[n].numpy(), n, net_scale)
    assert sum(g is not None and bool(g.any()) for g in grads) >= 10


# --------------------------------------------------------------------------
# the steps
# --------------------------------------------------------------------------
def _check_step(t, net, loss, grads, want_loss, after, what):
    """The port's loss and gradients against JAX's; then the port's Adam fed
    JAX's gradients, against JAX's updated parameters, moments and count
    (torch's ``step``, ``exp_avg`` and ``exp_avg_sq``)."""
    count, mu, nu = adam_state(after.g_opt if net == "G" else after.d_opt)
    names = t.g_names if net == "G" else t.d_names
    want_g = W.progressive_state_dict(mu)  # beta1 0: mu is the last gradient
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL, err_msg=what)
    net_scale = max(float(v.abs().max()) for v in want_g.values()) if net == "D" else 0.0
    for n, g in zip(names, grads):
        assert_grads(g.numpy(), want_g[n].numpy(), f"{what} {n}", net_scale)
    opt = t.g_opt if net == "G" else t.d_opt
    jax_grads = [want_g[n] for n in names]
    if net == "G":
        ema0 = {n: p.clone() for n, p in t.g_ema.named_parameters()}
        t.apply_g(jax_grads)
    else:
        t.apply_d(jax_grads)
    module = t.generator if net == "G" else t.discriminator
    want_p = W.progressive_state_dict(np_tree(after.g_params if net == "G" else after.d_params))
    want_nu = W.progressive_state_dict(nu)
    assert adam_count(opt, list(module.parameters())) == count
    for n, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_p[n].numpy(), **TOL,
                                   err_msg=f"{what} {n}")
        np.testing.assert_allclose(opt.state[p]["exp_avg_sq"].numpy(), want_nu[n].numpy(),
                                   rtol=1e-5, atol=1e-12, err_msg=f"{what} nu {n}")
        np.testing.assert_array_equal(opt.state[p]["exp_avg"].numpy(), want_g[n].numpy())
    if net == "G":
        want_ema = W.progressive_state_dict(np_tree(after.g_ema))
        for n, e in t.g_ema.named_parameters():
            np.testing.assert_allclose(e.numpy(), want_ema[n].numpy(), **TOL, err_msg=n)
            np.testing.assert_allclose(
                e.numpy(), (ema0[n] * EMA_DECAY + dict(module.named_parameters())[n].detach()
                            * (1 - EMA_DECAY)).numpy(), rtol=3e-7, atol=1e-7, err_msg=n)


@pytest.fixture(scope="module")
def step_runs(jax_state):
    """JAX's D and G steps at rung 2 (alpha 0.5) in both modes from one
    state, and the run across a rung: D, G at rung 1, then D, G at rung 2."""
    jt, s0, sent = jax_state
    key = jax.random.PRNGKey(5)
    real1, real2 = reals(8, 3), reals(16, 4)
    a = jnp.float32(0.5)
    d2, g2 = jt.steps_for(2)
    jr = JaxTrainer(**DIMS, loss_mode="r1", embed_dim=E)
    r1_d2, _ = jr.steps_for(2)
    out = {}
    for mode, d_step in (("wgan-gp", d2), ("r1", r1_d2)):
        s1, dl = d_step(s0, jnp.asarray(real2), jnp.asarray(sent), a, key)
        s2, gl = g2(s1, jnp.asarray(sent), a, key, jnp.asarray(real2))
        out[mode] = [(s1, float(dl)), (s2, float(gl))]
    d1, g1 = jt.steps_for(1)
    s1, l1 = d1(s0, jnp.asarray(real1), jnp.asarray(sent), a, key)
    s2, l2 = g1(s1, jnp.asarray(sent), a, key, jnp.asarray(real1))
    s3, l3 = d2(s2, jnp.asarray(real2), jnp.asarray(sent), a, key)
    s4, l4 = g2(s3, jnp.asarray(sent), a, key, jnp.asarray(real2))
    out["across"] = [(s1, float(l1)), (s2, float(l2)), (s3, float(l3)), (s4, float(l4))]
    return dict(key=key, real1=real1, real2=real2, runs=out)


@pytest.mark.parametrize("mode", ["wgan-gp", "r1"])
def test_d_and_g_steps_match_jax(jax_state, step_runs, mode):
    _, s0, sent = jax_state
    r = step_runs
    (s1, d_loss), (s2, g_loss) = r["runs"][mode]
    t = port_trainer(s0, mode)
    draws = jax_step_draws(r["key"], 0, B, 2, d_step=True)
    if mode == "r1":
        del draws["gp_eps"]
    loss, grads = t.d_grads(r["real2"], sent, 0.5, 2, draws)
    _check_step(t, "D", loss, grads, d_loss, s1, f"{mode} D")
    assert t.step == 1
    t.discriminator.load_state_dict(W.progressive_state_dict(np_tree(s1.d_params)))
    loss, grads = t.g_grads(B, sent, 0.5, 2, jax_step_draws(r["key"], 3, B, 2, d_step=False))
    _check_step(t, "G", loss, grads, g_loss, s2, f"{mode} G")


def test_adam_count_across_a_rung(jax_state, step_runs):
    """D and G at rung 1, then at rung 2: the gradients at each step are
    JAX's, and the blocks new at rung 2 (D's from_rgb_2, conv_2, down_2;
    G's block_2, to_rgb_2) take optax's update of count 2, whose bias
    correction makes it about sqrt(2) lr an entry, where a count of 1 for
    them (PyTorch's per-parameter count, had they taken no gradient at rung
    1) would move them by lr."""
    _, s0, sent = jax_state
    r = step_runs
    t = port_trainer(s0)
    for k, (net, res, real) in enumerate((("D", 1, r["real1"]), ("G", 1, None),
                                          ("D", 2, r["real2"]), ("G", 2, None))):
        after, want_loss = r["runs"]["across"][k]
        # JAX folds 2 step (D) and 2 step + 1 (G) into its key, step the D count
        draws = jax_step_draws(r["key"], (0, 3, 2, 5)[k], B, res, d_step=(net == "D"))
        before = {n: p.detach().clone() for n, p in
                  (t.discriminator if net == "D" else t.generator).named_parameters()}
        if net == "D":
            loss, grads = t.d_grads(real, sent, 0.5, res, draws)
        else:
            loss, grads = t.g_grads(B, sent, 0.5, res, draws)
        if res == 1:  # the parts rung 1 does not run: a zero gradient, as JAX's
            names = t.d_names if net == "D" else t.g_names
            for n, g in zip(names, grads):
                if n.startswith(("block_2.", "to_rgb_2.", "from_rgb_2.", "conv_2.", "down_2.")):
                    assert not g.any(), n
        _check_step(t, net, loss, grads, want_loss, after, f"across {k}")
        if res == 2:
            lr = base_lr(t.d_opt if net == "D" else t.g_opt)
            new = "from_rgb_2.weight" if net == "D" else "block_2.conv2.weight"
            p = dict((t.discriminator if net == "D" else t.generator).named_parameters())[new]
            step = (p.detach() - before[new]).abs()
            g = dict(zip(t.d_names if net == "D" else t.g_names, grads))[new]
            big = g.abs() > 1e-3 * g.abs().max()
            ratio = (step[big] / lr).mean().item()
            assert ratio == pytest.approx(1 / np.sqrt(0.01 / (1 - 0.99 ** 2)), rel=1e-3)
            assert abs(ratio - 1.0) > 0.3  # a count of 1: lr sign(g)
    assert t.step == 2
    assert adam_count(t.d_opt, t.d_params) == adam_count(t.g_opt, t.g_params) == 2


def test_with_lr_and_state_round_trip(jax_state):
    """D trains at 4x G's rate by default; ``with_lr`` retunes both (what
    JAX's ``with_lr`` sets in its injected hyperparameters); a state dict
    restores step, weights, EMA, moments, counts and rates."""
    jt, s0, sent = jax_state
    t = port_trainer(s0)
    assert base_lr(t.d_opt) == pytest.approx(4 * base_lr(t.g_opt)) and base_lr(t.g_opt) == LR
    js = jt.with_lr(s0, 5e-4, 2e-3)
    t.with_lr(5e-4, 2e-3)
    assert base_lr(t.g_opt) == pytest.approx(float(js.g_opt[0].hyperparams["learning_rate"]))
    assert base_lr(t.d_opt) == pytest.approx(float(js.d_opt.hyperparams["learning_rate"]))
    mlp = {id(p) for n, p in t.generator.named_parameters() if n.startswith("mlp_")}
    for group in t.g_opt.param_groups:  # the style MLP at 0.01 x, text_proj with the rest
        scale = 0.01 if all(id(p) in mlp for p in group["params"]) else 1.0
        assert group["lr"] == pytest.approx(5e-4 * scale)
        assert all((id(p) in mlp) == (scale == 0.01) for p in group["params"])
    t.d_step(reals(8), sent, 0.5, 1)
    t.g_step(B, sent, 0.5, 1)
    u = ProgressiveTrainer(**DIMS, embed_dim=E, device="cpu", seed=0, init=False)
    u.load_state_dict(t.state_dict())
    assert (u.step, adam_count(u.g_opt, u.g_params), base_lr(u.d_opt)) == (1, 1, 2e-3)
    nu = lambda tr: [tr.d_opt.state[p]["exp_avg_sq"] for p in tr.d_params] + [  # noqa: E731
        tr.g_opt.state[p]["exp_avg_sq"] for p in tr.g_params]
    for a, b in zip(list(t.g_ema.parameters()) + nu(t), list(u.g_ema.parameters()) + nu(u),
                    strict=True):
        assert torch.equal(a, b)
    assert torch.equal(t.draw(4, 2, 1, True)["z"], u.draw(4, 2, 1, True)["z"])


def test_adam_is_optax_with_the_mlp_mask():
    """``make_adam`` (the trainer's ``torch.optim.Adam``, the style MLP's
    group at 0.01 x the rate) against optax's inject_hyperparams(adam)
    chained with masked(scale(0.01)), over steps with a zero gradient
    between, as the trainer gives a part the rung does not run."""
    rng = np.random.default_rng(0)
    params = {"mlp_0": rng.standard_normal((3, 4)).astype(np.float32),
              "text_proj": rng.standard_normal(5).astype(np.float32)}
    mask = {"mlp_0": True, "text_proj": False}
    tx = optax.chain(optax.inject_hyperparams(optax.adam)(learning_rate=1e-2, b1=0.0,
                                                           b2=0.99),
                     optax.masked(optax.scale(0.01), mask))
    jp, st = params, tx.init(params)
    tp = [torch.from_numpy(params[k].copy()) for k in ("mlp_0", "text_proj")]
    opt = make_adam([([tp[1]], 1.0), ([tp[0]], 0.01)], 1e-2)
    for i in range(4):
        g = {k: (rng.standard_normal(v.shape).astype(np.float32) * 10 ** -i
                 if not (i == 1 and k == "text_proj") else np.zeros_like(v))
             for k, v in params.items()}
        upd, st = tx.update(g, st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in zip(("mlp_0", "text_proj"), tp):
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in zip(("mlp_0", "text_proj"), tp):
            np.testing.assert_allclose(p.numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
    assert adam_count(opt, tp) == int(st[0].inner_state[0].count) == 4


# --------------------------------------------------------------------------
# sampling
# --------------------------------------------------------------------------
def test_sample_matches_jax(jax_state):
    """``sample`` against JAX's ``ProgressiveTrainer.sample`` of the same EMA
    and key (its z and noise rebuilt), at rung 2, alpha 0.6."""
    jt, s0, sent = jax_state
    ema = jax.tree.map(lambda p: p + 0.01, s0.g_ema)
    state = s0.replace(g_ema=ema)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jt.sample(state, key, B, 2, sent_emb=jnp.asarray(sent), alpha=0.6))
    t = port_trainer(state)
    r_z, r_noise = jax.random.split(key)
    draws = {"z": np.asarray(jax.random.normal(r_z, (B, 8), jnp.float32)),
             "noise": jax_noise(r_noise, B, 2)}
    got = t.sample(B, 2, sent, alpha=0.6, draws=draws)
    assert got.shape == (B, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    live = t.sample(B, 2, sent, alpha=0.6, use_ema=False, draws=draws)
    assert np.abs(live.numpy() - want).max() > 1e-3


class JittedApply:
    """A Flax module whose ``apply`` is jitted (the rung, the crossover and
    the style weight static), for the JAX sampler's functions."""

    def __init__(self, module):
        self.apply = jax.jit(module.apply, static_argnums=(3,),
                             static_argnames=("crossover", "style_weight", "return_w"))


def test_mean_style_and_mixing_grid_match_jax(jax_state):
    """The sampler's functions with JAX's draws: the mean style (2 draws of
    16 here) and the style-mixing grid, (n_target + 1) x (n_source + 1)
    tiles: a blank, the sources, then each target and its mixes (the target
    style on blocks 0-1)."""
    jt, s0, sent = jax_state
    gen, params = JittedApply(jt.generator), s0.g_ema
    key = jax.random.PRNGKey(3)
    se = jnp.asarray(sent[:1])
    want_w = jgen.mean_style(gen, params, 8, key, se, n_draws=2, draw=16)
    t = port_trainer(s0)
    zs = [np.asarray(jax.random.normal(jax.random.fold_in(key, i), (16, 8))) for i in range(2)]
    got_w = pgen.mean_style(t.g_ema, zs, torch.from_numpy(sent[:1]))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), **TOL)

    n_source, n_target, step = 2, 2, 2
    want = jgen.style_mixing_grid(gen, params, 8, step, want_w, 0.7, key, n_source, n_target,
                                  se)
    r_s, r_t, r_n = jax.random.split(key, 3)
    source = np.asarray(jax.random.normal(r_s, (n_source, 8)))
    target = np.asarray(jax.random.normal(r_t, (n_target, 8)))
    got = pgen.style_mixing_grid(
        t.g_ema, step, got_w, 0.7, torch.from_numpy(source), torch.from_numpy(target),
        lambda b: [torch.from_numpy(n) for n in jax_noise(r_n, b, step)],
        torch.from_numpy(sent[:1]))
    assert got.shape == ((n_target + 1) * (n_source + 1), 16, 16, 3)
    np.testing.assert_allclose(got, want, **TOL)
    assert (got[0] == -1.0).all()

