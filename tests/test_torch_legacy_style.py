"""The port's legacy StyleGAN ops (``sba_gan_tpu_torch/models/legacy_style.py``)
against the JAX package's (``sba_gan_tpu/models/legacy_style.py``): the
same weights (Flax's layouts carried by the port's weight map) and inputs,
made from a seed with numpy; each op's value and its gradients to its
input and its parameters (the blur's also a second derivative, which the
gen-1 penalties take); the schedules and the truncation helpers; the
4-tap blur's zero padding; AdaIN of the progressive G.

Tolerance: rtol 1e-5 and atol 1e-5 forward; gradients atol 1e-5 of each
tensor's largest entry (and rtol 1e-5).  Float32 throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sba_gan_tpu.models import legacy_style as jl
from sba_gan_tpu.models.progressive import StyleAdaIN as JaxStyleAdaIN
from sba_gan_tpu_torch.models import legacy_style as pl
from sba_gan_tpu_torch.models.progressive import StyleAdaIN
from sba_gan_tpu_torch.utils import weights as W

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs six test processes on the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().permute(0, 2, 3, 1).numpy()


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a.transpose(0, 3, 1, 2)))


def assert_grads(got, want, name=""):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5 * scale,
                               err_msg=name)


def randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def module_case(name, rng):
    """(Flax module, its params, its input NHWC or (B, F), the port module
    holding the same weights, the port's input)."""
    if name == "dense":
        m = jl.EqualizedDense(7)
        x = randn(rng, 3, 10)
        p = {"weight": randn(rng, 10, 7), "bias": randn(rng, 7)}
        pm = pl.EqualizedDense(10, 7)
        return m, p, x, pm, torch.from_numpy(x)
    k = 3 if name == "conv3" else 1
    m = jl.EqualizedConv(6, (k, k))
    x = randn(rng, 2, 8, 8, 5)
    p = {"weight": randn(rng, k, k, 5, 6), "bias": randn(rng, 6)}
    pm = pl.EqualizedConv(5, 6, kernel=k)
    return m, p, x, pm, nchw(x)


@pytest.mark.parametrize("name", ["dense", "conv3", "conv1"])
def test_equalized_layer_matches_jax(name):
    """The He constant at every call: the output, the input's gradient and
    the stored weight's and bias's gradients are JAX's."""
    rng = np.random.default_rng(0)
    m, p, x, pm, xt = module_case(name, rng)
    pm.load_state_dict(W.progressive_state_dict(p))
    ct = randn(rng, *np.shape(m.apply({"params": p}, x)))

    def f(params, inp):
        return jnp.sum(m.apply({"params": params}, inp) * ct)
    want_y = m.apply({"params": p}, x)
    gp, gx = jax.grad(f, (0, 1))(p, jnp.asarray(x))
    xt.requires_grad_(True)
    y = pm(xt)
    ct_t = torch.from_numpy(ct) if y.dim() == 2 else nchw(ct)
    got_gx, got_w, got_b = torch.autograd.grad((y * ct_t).sum(), [xt, pm.weight, pm.bias])
    if y.dim() == 2:
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), **TOL)
        assert_grads(got_gx.numpy(), gx, "x")
    else:
        np.testing.assert_allclose(nhwc(y), np.asarray(want_y), **TOL)
        assert_grads(nhwc(got_gx), gx, "x")
    want = W.progressive_state_dict(jax.tree.map(np.asarray, gp))
    assert_grads(got_w.numpy(), want["weight"].numpy(), "weight")
    assert_grads(got_b.numpy(), want["bias"].numpy(), "bias")


def test_equalized_init_and_scale():
    """Weights N(0, 1), biases 0, and the scale sqrt(2) / sqrt(fan_in)."""
    gen = torch.Generator().manual_seed(0)
    conv, dense = pl.EqualizedConv(64, 32), pl.EqualizedDense(512, 256)
    conv.reset_parameters(gen)
    dense.reset_parameters(gen)
    for m, fan in ((conv, 64 * 9), (dense, 512)):
        assert m.scale == pytest.approx(jl.equalized_lr_scale(fan))
        w = m.weight.detach()
        assert abs(float(w.std()) - 1.0) < 0.02 and abs(float(w.mean())) < 0.02
        assert not m.bias.any()


def test_noise_injection_matches_jax():
    """With a nonzero gain: x + gain * noise, JAX's noise injected; the
    gradients to x and the gain; the zero-init gain gives x back, and a
    drawn noise comes from the generator given."""
    rng = np.random.default_rng(1)
    x = randn(rng, 2, 4, 4, 3)
    key = jax.random.PRNGKey(3)
    gain = randn(rng, 3)
    m = jl.NoiseInjection()
    ct = randn(rng, 2, 4, 4, 3)

    def f(g, inp):
        return jnp.sum(m.apply({"params": {"weight": g}}, inp, key) * ct)
    want_y = m.apply({"params": {"weight": gain}}, jnp.asarray(x), key)
    gg, gx = jax.grad(f, (0, 1))(jnp.asarray(gain), jnp.asarray(x))
    noise = np.asarray(jax.random.normal(key, (2, 4, 4, 1), jnp.float32))
    pm = pl.NoiseInjection(3)
    with torch.no_grad():
        pm.weight.copy_(torch.from_numpy(gain))
    xt = nchw(x).requires_grad_(True)
    y = pm(xt, nchw(noise))
    got_gx, got_gg = torch.autograd.grad((y * nchw(ct)).sum(), [xt, pm.weight])
    np.testing.assert_allclose(nhwc(y), np.asarray(want_y), **TOL)
    assert_grads(nhwc(got_gx), gx, "x")
    assert_grads(got_gg.numpy(), gg, "gain")
    fresh = pl.NoiseInjection(3)
    assert torch.equal(fresh(nchw(x), generator=torch.Generator()), nchw(x))
    a = pm(nchw(x), generator=torch.Generator().manual_seed(5))
    b = pm(nchw(x), torch.randn((2, 1, 4, 4), generator=torch.Generator().manual_seed(5)))
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        pm(nchw(x))


def test_constant_input_matches_jax():
    rng = np.random.default_rng(2)
    const = randn(rng, 1, 4, 4, 6)
    want = jl.ConstantInput(6).apply({"params": {"input": const}}, 3)
    pm = pl.ConstantInput(6)
    pm.load_state_dict({"input": W.progressive_state_dict(
        {"const": {"input": const}})["const.input"]})
    np.testing.assert_array_equal(nhwc(pm(3)), np.asarray(want))


def test_blur_matches_jax_to_the_second_derivative():
    """The blur's value, its input gradient, and the gradient of a function
    of that gradient (the penalties' double backward); zero padding at the
    border."""
    rng = np.random.default_rng(3)
    x = randn(rng, 2, 6, 6, 4)
    ct = randn(rng, 2, 6, 6, 4)

    def inner(inp):
        return jnp.sum(jl.blur_4tap(inp) ** 2 * ct)

    def outer(inp):
        g = jax.grad(inner)(inp)
        return jnp.sum(g ** 2)
    want_y = jl.blur_4tap(jnp.asarray(x))
    want_g1 = jax.grad(inner)(jnp.asarray(x))
    want_g2 = jax.grad(outer)(jnp.asarray(x))
    xt = nchw(x).requires_grad_(True)
    y = pl.blur_4tap(xt)
    (g1,) = torch.autograd.grad((y ** 2 * nchw(ct)).sum(), xt, create_graph=True)
    (g2,) = torch.autograd.grad((g1 ** 2).sum(), xt)
    np.testing.assert_allclose(nhwc(y), np.asarray(want_y), **TOL)
    assert_grads(nhwc(g1), want_g1, "first")
    assert_grads(nhwc(g2), want_g2, "second")
    ones = pl.Blur4Tap()(torch.ones(1, 1, 4, 4))
    assert float(ones[0, 0, 0, 0]) == pytest.approx(9 / 16)  # a corner: 4 + 2 + 2 + 1 of 16
    assert float(ones[0, 0, 1, 1]) == pytest.approx(1.0)


def test_minibatch_stddev_matches_jax():
    rng = np.random.default_rng(4)
    x = randn(rng, 4, 4, 4, 5, scale=2.0)
    ct = randn(rng, 4, 4, 4, 6)
    want_y = jl.minibatch_stddev(jnp.asarray(x))
    want_g = jax.grad(lambda v: jnp.sum(jl.minibatch_stddev(v) * ct))(jnp.asarray(x))
    xt = nchw(x).requires_grad_(True)
    y = pl.minibatch_stddev(xt)
    (g,) = torch.autograd.grad((y * nchw(ct)).sum(), xt)
    assert tuple(y.shape) == (4, 6, 4, 4)
    np.testing.assert_allclose(nhwc(y), np.asarray(want_y), **TOL)
    assert_grads(nhwc(g), want_g, "x")


def test_style_adain_matches_jax():
    """(gamma + 1) instance_norm(h) + beta, with (gamma, beta) an equalized
    dense of w."""
    rng = np.random.default_rng(5)
    h, w = randn(rng, 2, 4, 4, 6, scale=3.0), randn(rng, 2, 8)
    p = {"style": {"weight": randn(rng, 8, 12), "bias": randn(rng, 12)}}
    ct = randn(rng, 2, 4, 4, 6)
    m = JaxStyleAdaIN(6)

    def f(params, hh, ww):
        return jnp.sum(m.apply({"params": params}, hh, ww) * ct)
    want_y = m.apply({"params": p}, jnp.asarray(h), jnp.asarray(w))
    gp, gh, gw = jax.grad(f, (0, 1, 2))(p, jnp.asarray(h), jnp.asarray(w))
    pm = StyleAdaIN(6, 8)
    pm.load_state_dict(W.progressive_state_dict(p))
    ht, wt = nchw(h).requires_grad_(True), torch.from_numpy(w).requires_grad_(True)
    y = pm(ht, wt)
    got = torch.autograd.grad((y * nchw(ct)).sum(), [ht, wt, pm.style.weight])
    np.testing.assert_allclose(nhwc(y), np.asarray(want_y), **TOL)
    assert_grads(nhwc(got[0]), gh, "h")
    assert_grads(got[1].numpy(), gw, "w")
    assert_grads(got[2].numpy(), np.asarray(gp["style"]["weight"]).T, "style.weight")


def test_pixel_norm_matches_jax():
    rng = np.random.default_rng(6)
    x = randn(rng, 4, 9, scale=5.0)
    want = jl.PixelNorm().apply({}, jnp.asarray(x))
    np.testing.assert_allclose(pl.PixelNorm()(torch.from_numpy(x)).numpy(), np.asarray(want),
                               **TOL)


def test_truncation_and_mean_style_match_jax():
    rng = np.random.default_rng(7)
    w, w_mean = randn(rng, 5, 6), randn(rng, 1, 6)
    np.testing.assert_allclose(pl.mean_style(torch.from_numpy(w)).numpy(),
                               np.asarray(jl.mean_style(jnp.asarray(w))), **TOL)
    for psi in (0.0, 0.7, 1.0):
        np.testing.assert_allclose(
            pl.truncate_w(torch.from_numpy(w), torch.from_numpy(w_mean), psi).numpy(),
            np.asarray(jl.truncate_w(jnp.asarray(w), jnp.asarray(w_mean), psi)), **TOL)


@pytest.mark.parametrize("sizes", [(8, 64), (8, 256), (4, 16)])
def test_schedules_match_jax(sizes):
    init, top = sizes
    for phase in (16, 600):
        for used in list(range(0, 8 * phase, max(1, phase // 8))) + [10 ** 7]:
            assert pl.progressive_schedule_samples(used, phase, init, top) == \
                jl.progressive_schedule_samples(used, phase, init, top)
        for step, batch in ((0, 16), (7, 32), (50, 16), (123, 8)):
            assert pl.progressive_schedule(step, phase, batch, init, top) == \
                jl.progressive_schedule(step, phase, batch, init, top)


def test_noise_sizes():
    assert pl.noise_sizes(0) == [4, 4]
    assert pl.noise_sizes(3) == [4, 4, 8, 8, 16, 16, 32, 32]
