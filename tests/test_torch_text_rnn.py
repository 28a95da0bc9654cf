"""The port's RNNEncoder (packed torch LSTM/GRU) against the JAX package's
masked-scan RNNEncoder, eval mode, with ragged lengths.

Weights are initialized by Flax and carried over with the port's weight
map.  Tolerance atol 2e-5 (that of tests/test_text_rnn.py): float32
recurrences, summed in another order, over a few steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sba_gan_tpu.models.text_rnn import RNNEncoder as JaxRNNEncoder
from sba_gan_tpu_torch.models.text_rnn import RNNEncoder
from sba_gan_tpu_torch.utils import weights as W

NTOKEN, NINPUT, NHIDDEN, T = 40, 24, 32, 6


@pytest.mark.parametrize("rnn_type", ["LSTM", "GRU"])
def test_matches_jax(rnn_type):
    rng = np.random.default_rng(1)
    lens = np.array([6, 1, 4, 3], np.int64)
    captions = np.zeros((len(lens), T), np.int64)
    for i, n in enumerate(lens):
        captions[i, :n] = rng.integers(1, NTOKEN, n)

    jenc = JaxRNNEncoder(ntoken=NTOKEN, ninput=NINPUT, nhidden=NHIDDEN,
                         rnn_type=rnn_type)
    key = jax.random.PRNGKey(3)
    variables = jenc.init({"params": key, "dropout": key},
                          jnp.asarray(captions, jnp.int32),
                          jnp.asarray(lens, jnp.int32), train=False)
    words_j, sent_j = jenc.apply(variables, jnp.asarray(captions, jnp.int32),
                                 jnp.asarray(lens, jnp.int32), train=False)

    enc = RNNEncoder(NTOKEN, ninput=NINPUT, nhidden=NHIDDEN, rnn_type=rnn_type)
    enc.load_state_dict(W.rnn_encoder_state_dict(variables["params"]))
    enc.eval()
    with torch.no_grad():
        words_t, sent_t = enc(torch.from_numpy(captions), torch.from_numpy(lens))

    assert words_t.shape == (len(lens), T, NHIDDEN)
    np.testing.assert_allclose(words_t.numpy(), np.asarray(words_j), atol=2e-5)
    np.testing.assert_allclose(sent_t.numpy(), np.asarray(sent_j), atol=2e-5)
    # outputs are zero at padded steps
    assert np.all(words_t.numpy()[1, 1:] == 0)


def test_unknown_flax_path_raises():
    with pytest.raises(KeyError):
        W.rnn_encoder_state_dict({"embedding": np.zeros((3, 2)),
                                  "extra": {"w_ih": np.zeros(1)}})


@pytest.mark.parametrize("rnn_type", ["LSTM", "GRU"])
def test_train_mode_dropout_matches_jax(rnn_type):
    """Train mode: flax's embedding dropout, its mask recovered from the JAX
    side (the Dropout_0 output is zero exactly where a unit was dropped)
    and handed to the port."""
    rng = np.random.default_rng(2)
    lens = np.array([6, 1, 4, 3], np.int64)
    captions = np.zeros((len(lens), T), np.int64)
    for i, n in enumerate(lens):
        captions[i, :n] = rng.integers(1, NTOKEN, n)
    jenc = JaxRNNEncoder(ntoken=NTOKEN, ninput=NINPUT, nhidden=NHIDDEN,
                         rnn_type=rnn_type)
    key = jax.random.PRNGKey(5)
    args = (jnp.asarray(captions, jnp.int32), jnp.asarray(lens, jnp.int32))
    variables = jenc.init({"params": key, "dropout": key}, *args, train=False)
    (words_j, sent_j), inter = jenc.apply(
        variables, *args, train=True, rngs={"dropout": jax.random.PRNGKey(6)},
        capture_intermediates=True)
    keep = np.asarray(inter["intermediates"]["Dropout_0"]["__call__"][0]) != 0

    enc = RNNEncoder(NTOKEN, ninput=NINPUT, nhidden=NHIDDEN, rnn_type=rnn_type)
    enc.load_state_dict(W.rnn_encoder_state_dict(variables["params"]))
    enc.train()
    with torch.no_grad():
        words_t, sent_t = enc(torch.from_numpy(captions), torch.from_numpy(lens),
                              keep_mask=torch.from_numpy(keep))
    np.testing.assert_allclose(words_t.numpy(), np.asarray(words_j), atol=2e-5)
    np.testing.assert_allclose(sent_t.numpy(), np.asarray(sent_j), atol=2e-5)
    # a mask drawn from a generator: about half kept, the same for one seed
    a = enc.dropout_mask(torch.from_numpy(captions), torch.Generator().manual_seed(1))
    b = enc.dropout_mask(torch.from_numpy(captions), torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and 0.4 < a.float().mean().item() < 0.6
    with pytest.raises(ValueError):
        enc(torch.from_numpy(captions), torch.from_numpy(lens))
