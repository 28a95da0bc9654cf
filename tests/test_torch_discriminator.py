"""The port's discriminators (sba_gan_tpu_torch.models.discriminator) against
the JAX package's DNet64/128/256, at DF_DIM 8, EMBEDDING_DIM 16, batch 3,
with the Flax variables carried over by ``utils.weights.d_net_state_dict``
(random BatchNorm running statistics):

* eval mode: the backbone's 4 x 4 code, the conditional and the
  unconditional logits;
* the D loss of the JAX train step (``sba_gan_tpu/train/gan.py``, its
  ``inner``) in train mode against :func:`losses.gan.discriminator_loss`:
  the loss, every parameter's gradient, and the running statistics after
  the passes in JAX's order (backbone on reals and fakes, conditional head
  on reals, fakes and the B-1 wrong pairs, unconditional head).

Tolerance: float32 on both sides, sums in another order through up to
seven convolutions and train-mode BatchNorms over small batches: features
and logits rtol 1e-4 / atol 1e-5; loss rtol 1e-5; gradients atol 1e-4 times
each tensor's largest entry; running statistics rtol 1e-4 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import nchw, random_bn_stats
from sba_gan_tpu.config import cfg_from_dict as jax_cfg_from_dict
from sba_gan_tpu.losses.gan import bce_logits as jax_bce
from sba_gan_tpu.models.discriminator import build_discriminators as jax_build
from sba_gan_tpu_torch.config import cfg_from_dict
from sba_gan_tpu_torch.losses.gan import discriminator_loss
from sba_gan_tpu_torch.models.discriminator import build_discriminators
from sba_gan_tpu_torch.utils import weights as W

B, NDF, NEF = 3, 8, 16
DIMS = {"TREE": {"BRANCH_NUM": 3}, "GAN": {"DF_DIM": NDF}, "TEXT": {"EMBEDDING_DIM": NEF}}
FEAT = dict(rtol=1e-4, atol=1e-5)


def _pair(index, seed):
    """The JAX DNet of branch ``index``, its variables, and the port's DNet
    carrying them."""
    size = 64 * 2 ** index
    jd = jax_build(jax_cfg_from_dict(DIMS))[index]
    v = jd.init(jax.random.PRNGKey(seed), jnp.zeros((B, size, size, 3)),
                jnp.zeros((B, NEF)), True, method="init_all")
    rng = np.random.default_rng(seed)
    variables = {"params": v["params"], "batch_stats": random_bn_stats(v["batch_stats"], rng)}
    pd = build_discriminators(cfg_from_dict(DIMS))[index]
    pd.load_state_dict(W.d_net_state_dict(variables["params"], variables["batch_stats"]))
    return jd, variables, pd, size


def _inputs(size, seed):
    rng = np.random.default_rng(seed)
    real = rng.uniform(-1, 1, (B, size, size, 3)).astype(np.float32)
    fake = rng.uniform(-1, 1, (B, size, size, 3)).astype(np.float32)
    sent = rng.standard_normal((B, NEF)).astype(np.float32)
    return real, fake, sent


@pytest.mark.parametrize("index", [0, 1, 2])
def test_eval_mode_codes_and_logits(index):
    jd, variables, pd, size = _pair(index, seed=index)
    real, _, sent = _inputs(size, seed=10 + index)
    h_j, cond_j, uncond_j = jd.apply(variables, jnp.asarray(real), jnp.asarray(sent),
                                     False, method="init_all")
    pd.eval()
    with torch.no_grad():
        h_t = pd(nchw(real))
        cond_t = pd.cond_logits(h_t, torch.from_numpy(sent))
        uncond_t = pd.uncond_logits(h_t)
    assert h_t.shape == (B, 8 * NDF, 4, 4) and cond_t.shape == (B,)
    assert cond_t.dtype == torch.float32
    np.testing.assert_allclose(h_t.permute(0, 2, 3, 1).numpy(), np.asarray(h_j), **FEAT)
    np.testing.assert_allclose(cond_t.numpy(), np.asarray(cond_j), **FEAT)
    np.testing.assert_allclose(uncond_t.numpy(), np.asarray(uncond_j), **FEAT)


def _jax_d_loss(jd, variables, real, fake, sent):
    """The D loss of the JAX step's ``inner`` (train/gan.py), with its
    parameter gradients and the running statistics it leaves."""

    def loss_fn(params):
        def inner(mod):
            real_f = mod(real, True)
            fake_f = mod(fake, True)
            cond_real = jax_bce(mod.cond_logits(real_f, sent, True), 1.0)
            cond_fake = jax_bce(mod.cond_logits(fake_f, sent, True), 0.0)
            cond_wrong = jax_bce(mod.cond_logits(real_f[: B - 1], sent[1:], True), 0.0)
            real_u = jax_bce(mod.uncond_logits(real_f, True), 1.0)
            fake_u = jax_bce(mod.uncond_logits(fake_f, True), 0.0)
            return (real_u + cond_real) / 2.0 + (fake_u + cond_fake + cond_wrong) / 3.0

        loss, mut = jd.apply({"params": params, "batch_stats": variables["batch_stats"]},
                             method=inner, mutable=["batch_stats"])
        return loss, mut["batch_stats"]

    (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    return float(loss), grads, stats


@pytest.mark.parametrize("index", [0, 1, 2])
def test_d_loss_gradients_and_running_stats(index):
    jd, variables, pd, size = _pair(index, seed=20 + index)
    real, fake, sent = _inputs(size, seed=30 + index)
    loss_j, grads_j, stats_j = _jax_d_loss(jd, variables, jnp.asarray(real),
                                           jnp.asarray(fake), jnp.asarray(sent))
    pd.train()
    loss_t = discriminator_loss(pd, nchw(real), nchw(fake), torch.from_numpy(sent))
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), loss_j, rtol=1e-5)

    want_grads = W.d_net_state_dict(grads_j, {})
    params = dict(pd.named_parameters())
    assert sorted(want_grads) == sorted(params)
    for name, want in want_grads.items():
        want = want.numpy()
        np.testing.assert_allclose(params[name].grad.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=name)

    want_stats = W.d_net_state_dict({}, stats_j)
    got = pd.state_dict()
    moved = 0
    for name, want in want_stats.items():
        if name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[name].numpy(), want.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
        moved += name.endswith("running_mean")
    assert moved == sum(1 for m in pd.modules() if hasattr(m, "update_stats"))
    # backbone BNs saw two passes, the conditional head's three (the last
    # one of B - 1 wrong pairs)
    assert int(got["img_code_s16.3.num_batches_tracked"]) == 2
    assert int(got["COND_DNET.jointConv.1.num_batches_tracked"]) == 3


def test_weight_map_keys_and_dcgan_refusal():
    assert W.d_net_key(("backbone", "Conv_0", "kernel")) == "img_code_s16.0.weight"
    assert W.d_net_key(("backbone", "DownBlock_2", "BatchNorm_0", "BatchNorm_0",
                        "var")) == "img_code_s16.9.running_var"
    assert W.d_net_key(("block64_2", "Conv3x3_0", "Conv_0", "kernel")) == (
        "img_code_s64_2.0.weight")
    assert W.d_net_key(("cond_head", "Block3x3LeakRelu_0", "BatchNorm_0", "BatchNorm_0",
                        "scale")) == "COND_DNET.jointConv.1.weight"
    assert W.d_net_key(("uncond_head", "Conv_0", "bias")) == "UNCOND_DNET.outlogits.0.bias"
    with pytest.raises(KeyError):
        W.d_net_key(("uncond_head", "Block3x3LeakRelu_0", "Conv3x3_0", "Conv_0", "kernel"))
    # GAN.B_DCGAN: one D, at the final scale, without the unconditional head
    (d,) = build_discriminators(cfg_from_dict({**DIMS, "GAN": {"DF_DIM": NDF,
                                                               "B_DCGAN": True}}))
    assert type(d).__name__ == "DNet256" and d.UNCOND_DNET is None
    assert not any(k.startswith("UNCOND_DNET") for k in d.state_dict())
    with pytest.raises(ValueError, match="no unconditional head"):
        d.uncond_logits(torch.zeros(1))
