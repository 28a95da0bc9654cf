"""The whole generator: the port's GNet against the JAX package's
``GNet.apply(..., train=False)``, all three images and both attention maps.

Tiny widths (GF_DIM 8, Z_DIM 8, W_DIM 16, CONDITION_DIM 8, R_NUM 1,
EMBEDDING_DIM 32, WORDS_NUM 6, three branches); the spatial sizes are the
real ones (64, 128, 256).  Weights come from Flax with random BatchNorm
running statistics and are carried over with the port's weight map; the
CA-net noise is the one JAX draws, ``jax.random.normal(rng_ca, (B, C))``.
Tolerance atol 1e-4, rtol 1e-4: float32 through some twenty convolutions
and norms whose sums run in another order on each side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_generator_and_vars, tiny_cfgs
from sba_gan_tpu_torch.models.generator import build_generator
from sba_gan_tpu_torch.utils import weights as W

TOL = dict(rtol=1e-4, atol=1e-4)
B, T, NEF = 2, 6, 32


@pytest.mark.parametrize("case", ["xla", "interpret", "style_mixing"])
def test_gnet_matches_jax(case):
    rng = np.random.default_rng(2)
    jcfg, cfg = tiny_cfgs(style_mixing=case == "style_mixing")
    zshape = (2, B, 8) if case == "style_mixing" else (B, 8)
    z = rng.standard_normal(zshape).astype(np.float32)
    sent = rng.standard_normal((B, NEF)).astype(np.float32)
    words = rng.standard_normal((B, T, NEF)).astype(np.float32)
    pad = np.arange(T)[None, :] >= np.array([6, 3])[:, None]
    rng_ca = jax.random.PRNGKey(5)
    eps = np.array(jax.random.normal(rng_ca, (B, 8), jnp.float32))

    g, variables = jax_generator_and_vars(jcfg, rng, z, sent, words, pad, rng_ca)
    if case == "interpret":
        g = g.clone(attn_impl="interpret")  # the Pallas kernel, interpreted
    fakes_j, atts_j, mu_j, _ = g.apply(
        variables, jnp.asarray(z), jnp.asarray(sent), jnp.asarray(words),
        jnp.asarray(pad), rng_ca, False)

    net = build_generator(cfg)
    net.load_state_dict(W.g_net_state_dict(variables["params"],
                                           variables["batch_stats"]))
    net.eval()
    with torch.no_grad():
        fakes, atts, mu, _ = net(torch.from_numpy(z), torch.from_numpy(sent),
                                 torch.from_numpy(words), torch.from_numpy(pad),
                                 torch.from_numpy(eps))

    assert [f.shape for f in fakes] == [(B, s, s, 3) for s in (64, 128, 256)]
    assert [a.shape for a in atts] == [(B, s, s, T) for s in (64, 128)]
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), **TOL)
    for got, want in zip(fakes + atts, list(fakes_j) + list(atts_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_weight_map_rejects_unknown_and_missing_keys():
    rng = np.random.default_rng(0)
    jcfg, cfg = tiny_cfgs()
    z = np.zeros((B, 8), np.float32)
    sent = np.zeros((B, NEF), np.float32)
    words = np.zeros((B, T, NEF), np.float32)
    pad = np.zeros((B, T), bool)
    _, v = jax_generator_and_vars(jcfg, rng, z, sent, words, pad,
                                  jax.random.PRNGKey(1))
    params = jax.tree.map(np.asarray, v["params"])
    sd = W.g_net_state_dict(params, v["batch_stats"])
    net = build_generator(cfg)
    net.load_state_dict(sd)  # the full map loads strictly

    missing = dict(sd)
    del missing["h_net2.att.conv_context.weight"]
    with pytest.raises(RuntimeError, match="Missing key"):
        net.load_state_dict(missing)
    with pytest.raises(KeyError):
        W.g_net_state_dict({**params, "Extra_0": {"kernel": np.zeros(1)}}, {})
