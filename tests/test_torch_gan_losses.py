"""The port's GAN losses (sba_gan_tpu_torch.losses.gan) against the JAX
package's (``sba_gan_tpu/losses/gan.py``): ``bce_logits`` at both targets
(with large logits, where the softplus form matters), ``kl_loss``, and the
D loss on fixed logits, with and without the unconditional head, through
small stand-in discriminators whose heads return given logits.

Tolerance: float32 on both sides: rtol 1e-6 / atol 1e-7 for the scalar
losses, and the same for the gradients of the logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sba_gan_tpu.losses.gan import bce_logits as jax_bce
from sba_gan_tpu.losses.gan import discriminator_loss as jax_d_loss
from sba_gan_tpu.losses.gan import kl_loss as jax_kl
from sba_gan_tpu_torch.losses.gan import (
    bce_logits,
    discriminator_loss,
    generator_adv_loss,
    kl_loss,
)

TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("target", [0.0, 1.0])
def test_bce_logits_and_gradient(target):
    rng = np.random.default_rng(int(target))
    logits = np.concatenate([rng.standard_normal(16) * 3.0,
                             [40.0, -40.0, 0.0]]).astype(np.float32)
    want, grad_j = jax.value_and_grad(lambda l: jax_bce(l, target))(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_(True)
    got = bce_logits(lt, target)
    got.backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(grad_j), **TOL)
    # float64 logits are taken in float32, as the JAX package casts them
    assert bce_logits(torch.from_numpy(logits).double(), target).dtype == torch.float32


def test_kl_loss_and_gradients():
    rng = np.random.default_rng(3)
    mu = rng.standard_normal((5, 7)).astype(np.float32)
    logvar = (rng.standard_normal((5, 7)) * 0.5).astype(np.float32)
    want, (g_mu, g_lv) = jax.value_and_grad(jax_kl, argnums=(0, 1))(
        jnp.asarray(mu), jnp.asarray(logvar))
    mt = torch.from_numpy(mu).requires_grad_(True)
    lt = torch.from_numpy(logvar).requires_grad_(True)
    got = kl_loss(mt, lt)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(mt.grad.numpy(), np.asarray(g_mu), **TOL)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(g_lv), **TOL)


class _LogitD(torch.nn.Module):
    """A stand-in discriminator: the 'backbone' passes the images through,
    the heads read fixed per-image logits, shifted by the sentence for the
    conditional one, so that the wrong pairs score differently."""

    def __init__(self, uncond: bool):
        super().__init__()
        self.UNCOND_DNET = torch.nn.Identity() if uncond else None

    def forward(self, x):
        return x

    def cond_logits(self, h, c):
        return h[:, 0] + c[:, 0]

    def uncond_logits(self, h):
        return h[:, 1]


@pytest.mark.parametrize("uncond", [True, False])
def test_discriminator_loss(uncond):
    rng = np.random.default_rng(5 + uncond)
    b = 6
    real = (rng.standard_normal((b, 2)) * 2).astype(np.float32)
    fake = (rng.standard_normal((b, 2)) * 2).astype(np.float32)
    sent = rng.standard_normal((b, 1)).astype(np.float32)
    want = jax_d_loss(lambda x: x, lambda h, c: h[:, 0] + c[:, 0],
                      (lambda h: h[:, 1]) if uncond else None,
                      jnp.asarray(real), jnp.asarray(fake), jnp.asarray(sent))
    d = _LogitD(uncond)
    got = discriminator_loss(d, torch.from_numpy(real), torch.from_numpy(fake),
                             torch.from_numpy(sent))
    np.testing.assert_allclose(float(got), float(want), **TOL)
    # the G term: bce(cond, 1) (+ bce(uncond, 1))
    want_g = jax_bce(jnp.asarray(fake[:, 0] + sent[:, 0]), 1.0)
    if uncond:
        want_g = want_g + jax_bce(jnp.asarray(fake[:, 1]), 1.0)
    got_g = generator_adv_loss(d, torch.from_numpy(fake), torch.from_numpy(sent))
    np.testing.assert_allclose(float(got_g), float(want_g), **TOL)
