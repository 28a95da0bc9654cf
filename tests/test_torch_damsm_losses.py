"""The port's DAMSM losses (losses/damsm.py) against the JAX package's, on
the same numpy inputs: ``sent_loss`` and ``words_loss`` (the JAX dense grid,
``impl='xla'``) in value and gradient, with repeated class ids so that the
class mask is live, and ``own_image_attention`` against the attention that
``words_loss(return_attn=True)`` returns.

Tolerance rtol 2e-5 on the losses, rtol 1e-4 / atol 1e-6 on the gradients
and 1e-6 on the attention (float32, sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sba_gan_tpu.losses import damsm as J
from sba_gan_tpu_torch.losses import damsm as P

B, T, R, D = 8, 6, 9, 16
CLASS_IDS = np.array([3, 1, 3, 0, 1, 2, 3, 5], np.int32)
GRAD = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    return dict(
        cnn=rng.standard_normal((B, D)).astype(np.float32),
        rnn=rng.standard_normal((B, D)).astype(np.float32),
        words=rng.standard_normal((B, T, D)).astype(np.float32),
        img=rng.standard_normal((B, R, D)).astype(np.float32),
        lens=np.array([1, 6, 3, 4, 2, 6, 5, 1], np.int32),
        labels=np.arange(B, dtype=np.int32))


@pytest.mark.parametrize("with_classes", [True, False])
def test_sent_loss(inputs, with_classes):
    cls = CLASS_IDS if with_classes else None

    def jloss(c, r):
        l0, l1 = J.sent_loss(c, r, jnp.asarray(inputs["labels"]),
                             None if cls is None else jnp.asarray(cls), 10.0)
        return l0 + 3.0 * l1, (l0, l1)

    (_, (l0, l1)), (gc, gr) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(inputs["cnn"]), jnp.asarray(inputs["rnn"]))
    c = torch.from_numpy(inputs["cnn"]).requires_grad_()
    r = torch.from_numpy(inputs["rnn"]).requires_grad_()
    p0, p1 = P.sent_loss(c, r, torch.arange(B),
                         None if cls is None else torch.from_numpy(cls).long(), 10.0)
    (p0 + 3.0 * p1).backward()
    np.testing.assert_allclose([p0.item(), p1.item()], [float(l0), float(l1)], rtol=2e-5)
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(gc), **GRAD)
    np.testing.assert_allclose(r.grad.numpy(), np.asarray(gr), **GRAD)


def test_words_loss_repeated_classes(inputs):
    lens, labels = inputs["lens"], inputs["labels"]

    def jloss(x, w):
        l0, l1 = J.words_loss(x, w, jnp.asarray(labels), jnp.asarray(lens),
                              jnp.asarray(CLASS_IDS), 4.0, 5.0, 10.0, impl="xla")
        return 2.0 * l0 + l1, (l0, l1)

    (_, (l0, l1)), (gx, gw) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(inputs["img"]), jnp.asarray(inputs["words"]))
    x = torch.from_numpy(inputs["img"]).requires_grad_()
    w = torch.from_numpy(inputs["words"]).requires_grad_()
    p0, p1 = P.words_loss(x, w, torch.arange(B), torch.from_numpy(lens),
                          torch.from_numpy(CLASS_IDS).long(), 4.0, 5.0, 10.0)
    (2.0 * p0 + p1).backward()
    np.testing.assert_allclose([p0.item(), p1.item()], [float(l0), float(l1)], rtol=2e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx), **GRAD)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(gw), **GRAD)


def test_own_image_attention(inputs):
    *_, attn = J.words_loss(jnp.asarray(inputs["img"]), jnp.asarray(inputs["words"]),
                            jnp.asarray(inputs["labels"]), jnp.asarray(inputs["lens"]),
                            None, 4.0, 5.0, 10.0, return_attn=True)
    got = P.own_image_attention(torch.from_numpy(inputs["img"]),
                                torch.from_numpy(inputs["words"]),
                                torch.from_numpy(inputs["lens"]), 4.0)
    assert got.shape == (B, T, R)
    np.testing.assert_allclose(got.numpy(), np.asarray(attn), atol=1e-6)


def test_class_mask():
    mask = P.class_mask(torch.from_numpy(CLASS_IDS))
    np.testing.assert_array_equal(mask.numpy(),
                                  np.asarray(J._class_mask(jnp.asarray(CLASS_IDS))))
