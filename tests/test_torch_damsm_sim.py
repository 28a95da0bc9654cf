"""The port's DAMSM similarity (ops/damsm_sim.py) against the JAX package's
Pallas ``damsm_sim`` in interpret mode (float32 products, tile 4) and its
custom VJP, on the same numpy inputs; the autograd Function's routing of
the backward to K2 and K3; a float64 ``gradcheck``; and a batch that no
tile divides against the JAX dense-grid ``words_loss``.

Tolerances as in tests/test_damsm_sim_kernel.py: rtol 1e-5 forward, rtol
1e-4 / atol 1e-6 for the gradients (float32, sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sba_gan_tpu.losses.damsm import words_loss as jax_words_loss
from sba_gan_tpu.ops.damsm_sim import damsm_sim as jax_damsm_sim
from sba_gan_tpu_torch.losses.damsm import words_loss
from sba_gan_tpu_torch.ops import damsm_sim as ds

B, T, R, D = 8, 6, 9, 16
G1, G2 = 4.0, 5.0
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)


def make_inputs(seed, b=B, t=T, r=R, d=D):
    rng = np.random.default_rng(seed)
    words = rng.standard_normal((b, t, d)).astype(np.float32)
    img = rng.standard_normal((b, r, d)).astype(np.float32)
    lens = rng.integers(1, t + 1, (b,)).astype(np.int32)
    lens[0], lens[-1] = 1, t
    g = rng.standard_normal((b, b)).astype(np.float32)
    return words, img, lens, g


@pytest.fixture(scope="module")
def reference():
    """Inputs, and JAX's sim and (d_words, d_img) for the cotangent g."""
    words, img, lens, g = make_inputs(0)

    def f(w, x):
        return jax_damsm_sim(w, x, jnp.asarray(lens), G1, G2, tile_i=4,
                             mm_dtype=jnp.float32, interpret=True)

    sim, vjp = jax.vjp(f, jnp.asarray(words), jnp.asarray(img))
    d_words, d_img = vjp(jnp.asarray(g))
    return (words, img, lens, g), tuple(np.asarray(a) for a in (sim, d_words, d_img))


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("fn", ["plain", "wrapper", "function"])
def test_forward_matches_jax(reference, fn):
    (words, img, lens, _), (sim, _, _) = reference
    w, x, n = _t(words), _t(img), _t(lens)
    got = {"plain": ds.damsm_sim_plain, "wrapper": ds.damsm_sim_fwd,
           "function": ds.damsm_sim}[fn](w, x, n, G1, G2)
    assert got.shape == (B, B)
    np.testing.assert_allclose(got.numpy(), sim, **FWD)


@pytest.mark.parametrize("which", ["dimg", "dwords"])
def test_plain_gradients_match_jax(reference, which):
    (words, img, lens, g), (_, d_words, d_img) = reference
    args = (_t(words), _t(img), _t(lens), _t(g), G1, G2)
    if which == "dimg":
        np.testing.assert_allclose(ds.damsm_sim_dimg_plain(*args).numpy(), d_img, **GRAD)
        np.testing.assert_allclose(ds.damsm_sim_dimg(*args).numpy(), d_img, **GRAD)
    else:
        got = ds.damsm_sim_dwords_plain(*args).numpy()
        np.testing.assert_allclose(got, d_words, **GRAD)
        np.testing.assert_allclose(ds.damsm_sim_dwords(*args).numpy(), d_words, **GRAD)
        pad = np.arange(T)[None, :] >= lens[:, None]
        assert np.all(got[pad] == 0.0)


def test_function_backward_matches_jax(reference):
    (words, img, lens, g), (_, d_words, d_img) = reference
    w = _t(words).requires_grad_()
    x = _t(img).requires_grad_()
    ds.damsm_sim(w, x, _t(lens), G1, G2).backward(_t(g))
    np.testing.assert_allclose(w.grad.numpy(), d_words, **GRAD)
    np.testing.assert_allclose(x.grad.numpy(), d_img, **GRAD)


@pytest.mark.parametrize("need_words,need_img", [(True, True), (False, True),
                                                 (True, False)])
def test_backward_runs_only_the_gradients_asked_for(monkeypatch, need_words,
                                                    need_img):
    calls = []
    for name in ("damsm_sim_dimg", "damsm_sim_dwords"):
        real = getattr(ds, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(ds, name, spy)
    words, img, lens, g = make_inputs(1, b=3, t=4, r=5, d=8)
    w = _t(words).requires_grad_(need_words)
    x = _t(img).requires_grad_(need_img)
    ds.damsm_sim(w, x, _t(lens)).backward(_t(g))
    assert calls == (["damsm_sim_dwords"] if need_words else []) + (
        ["damsm_sim_dimg"] if need_img else [])
    assert (w.grad is not None) == need_words and (x.grad is not None) == need_img


def test_gradcheck_float64():
    words, img, lens, _ = make_inputs(2, b=3, t=4, r=5, d=4)
    w = _t(words).double().requires_grad_()
    x = _t(img).double().requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, b: ds.damsm_sim(a, b, _t(lens), G1, G2), (w, x))


def test_words_loss_any_batch_matches_dense_grid():
    """B 6: no tile of 4 divides it, the port takes it all the same."""
    words, img, lens, _ = make_inputs(3, b=6)
    cls = np.array([0, 1, 0, 2, 1, 3], np.int32)
    labels = np.arange(6, dtype=np.int32)

    def jloss(x, w):
        l0, l1 = jax_words_loss(x, w, jnp.asarray(labels), jnp.asarray(lens),
                                jnp.asarray(cls), G1, G2, 10.0, impl="xla")
        return l0 + 2.0 * l1, (l0, l1)

    (_, (l0, l1)), (gx, gw) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(img), jnp.asarray(words))
    w = _t(words).requires_grad_()
    x = _t(img).requires_grad_()
    p0, p1 = words_loss(x, w, torch.arange(6), _t(lens), _t(cls).long(), G1, G2, 10.0)
    (p0 + 2.0 * p1).backward()
    np.testing.assert_allclose([p0.item(), p1.item()], [float(l0), float(l1)], rtol=2e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx), **GRAD)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(gw), **GRAD)


def test_wrapper_refuses_bad_lengths():
    words, img, lens, _ = make_inputs(4, b=2, t=3, r=4, d=4)
    for bad in ([0, 2], [1, 4]):
        with pytest.raises(ValueError):
            ds.damsm_sim_fwd(_t(words), _t(img), torch.tensor(bad))


@pytest.mark.parametrize("b,bj,texts", [(32, 32, 2), (32, 32, 1), (128, 128, 2),
                                        (30, 30, 2), (1, 1, 1), (300, 7, 2)])
@pytest.mark.parametrize("sms", [132, 78])
def test_dwords_grid_covers_every_image_once_in_one_wave(b, bj, texts, sms):
    chunk, splits = ds.dwords_grid(b, bj, texts, sms)
    assert splits == -(-bj // chunk)  # no empty range of images
    assert (splits - 1) * chunk < bj <= splits * chunk
    groups = -(-b // texts)
    assert groups * splits <= max(sms, groups)  # one block per SM, one wave


def test_kernel_builds_are_named_by_source_and_headers(tmp_path, monkeypatch):
    from sba_gan_tpu_torch.ops import _build

    assert all((_build.CSRC / src).is_file() for src in _build.SOURCES.values())
    assert (_build.CSRC / "damsm_common.cuh").is_file()
    names = {name: _build.library_path(name) for name in _build.SOURCES}
    assert len(set(names.values())) == len(names)
    # a change to a shared header renames every library built from csrc/
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in _build.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert _build.library_path("damsm_dwords") == names["damsm_dwords"]
    (csrc / "damsm_common.cuh").write_text("// changed\n")
    assert _build.library_path("damsm_dwords") != names["damsm_dwords"]
