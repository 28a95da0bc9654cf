"""The port's Inception-v3 CNNEncoder against the JAX package's, with Flax
weights carried over by ``weights.cnn_encoder_state_dict``: eval mode (random
running statistics), train mode (outputs and the updated running
statistics, flax's momentum and biased variance), and a 64 x 64 input that
both resize to the 75 x 75 the tiny configuration uses.

Tolerance in eval mode atol 1e-4 / rtol 1e-4: float32 through some ninety
convolutions and norms, summed in another order; train mode is compared in
float64 (see its test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import random_bn_stats
from sba_gan_tpu.models.inception import CNNEncoder as JaxCNNEncoder
from sba_gan_tpu.models.inception import resize_bilinear_align_corners as jax_resize
from sba_gan_tpu_torch.models.inception import (CNNEncoder, _resize_weights,
                                                 resize_bilinear_align_corners)
from sba_gan_tpu_torch.utils import weights as W

NEF, SIZE, B = 32, 75, 4
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def encoders():
    """(JAX module, Flax variables with random running stats, port encoder)."""
    jenc = JaxCNNEncoder(nef=NEF, input_size=SIZE)
    v = jenc.init(jax.random.PRNGKey(0), jnp.zeros((2, SIZE, SIZE, 3)), True)
    variables = {"params": v["params"],
                 "batch_stats": random_bn_stats(v["batch_stats"],
                                                np.random.default_rng(1))}
    enc = CNNEncoder(nef=NEF, input_size=SIZE)
    enc.load_state_dict(W.cnn_encoder_state_dict(variables["params"],
                                                 variables["batch_stats"]))
    return jenc, variables, enc


def _images(seed, size):
    return np.random.default_rng(seed).uniform(-1, 1, (B, size, size, 3)).astype(
        np.float32)


@pytest.mark.parametrize("size", [SIZE, 64])
def test_eval_mode(encoders, size):
    jenc, variables, enc = encoders
    img = _images(2, size)
    region_j, code_j = jenc.apply(variables, jnp.asarray(img), False)
    enc.eval()
    with torch.no_grad():
        region, code = enc(torch.from_numpy(img))
    assert region.shape == (B, 9, NEF) and code.shape == (B, NEF)
    np.testing.assert_allclose(region.numpy(), np.asarray(region_j), **TOL)
    np.testing.assert_allclose(code.numpy(), np.asarray(code_j), **TOL)


def test_train_mode_and_running_stats(encoders):
    """Train mode in float64 on both sides (the JAX module with dtype float64
    under ``jax.enable_x64``): at B 4 the Mixed_7 maps are 1 x 1, so batch
    statistics come from 4 values and float32 rounding is amplified far
    beyond what a comparison can tell from a fault.  JAX's average pool
    still rounds through float32 (``avg_pool_3x3_s1_pad1``), which leaves
    ~1e-6 in the regions and the statistics and ~2e-4 in the global code:
    atol 2e-5 on regions and statistics, 1e-3 on the code.  A fault of the
    running-statistics update (torch's unbiased variance, torch's momentum)
    moves them by 1e-2 and more."""
    _, variables, _ = encoders
    enc = CNNEncoder(nef=NEF, input_size=SIZE)
    enc.load_state_dict(W.cnn_encoder_state_dict(variables["params"],
                                                 variables["batch_stats"]))
    enc.double().train()
    img = _images(3, SIZE).astype(np.float64)
    with jax.enable_x64(True):
        jenc = JaxCNNEncoder(nef=NEF, input_size=SIZE, dtype=jnp.float64)
        v64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)), variables)
        (region_j, code_j), mut = jenc.apply(v64, jnp.asarray(img), True,
                                             mutable=["batch_stats"])
        region_j, code_j = np.asarray(region_j), np.asarray(code_j)
        stats_j = jax.tree.map(np.asarray, mut["batch_stats"])
    with torch.no_grad():
        region, code = enc(torch.from_numpy(img))
    np.testing.assert_allclose(region.numpy(), region_j, rtol=0, atol=2e-5)
    np.testing.assert_allclose(code.numpy(), code_j, rtol=0, atol=1e-3)
    start = W.cnn_encoder_state_dict(variables["params"], variables["batch_stats"])
    want = W.cnn_encoder_state_dict(variables["params"], stats_j)
    got = enc.state_dict()
    moved = 0
    for name, value in want.items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[name].numpy(), value.numpy(),
                                       rtol=0, atol=2e-5, err_msg=name)
            moved += int(not torch.allclose(value, start[name]))
    assert moved > 0


def test_resize_matches_jax():
    img = _images(4, 64)
    got = resize_bilinear_align_corners(torch.from_numpy(img), (75, 75))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_resize(jnp.asarray(img),
                                                                   (75, 75))),
                               atol=1e-6)


def test_resize_first_made_in_inference_mode_still_backpropagates():
    """The resize's cached weights made by an evaluation under inference
    mode serve a later training step's backward at the same sizes."""
    _resize_weights.cache_clear()
    img = torch.from_numpy(_images(2, 128))
    with torch.inference_mode():
        first = resize_bilinear_align_corners(img, (75, 75))
    x = img.clone().requires_grad_(True)
    out = resize_bilinear_align_corners(x, (75, 75))
    out.square().sum().backward()
    torch.testing.assert_close(out.detach(), first, rtol=0, atol=0)
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert x.grad.abs().sum() > 0


def test_unknown_flax_path_raises():
    with pytest.raises(KeyError):
        W.cnn_encoder_state_dict({"backbone": {"Mixed_5b": {"odd": {"kernel": 0}}}}, {})


def test_state_dict_keys_are_the_reference_ones(encoders):
    """The port's state dict, read back by the JAX package's own importer of
    reference checkpoints (``port_cnn_encoder``), gives the Flax variables it
    came from: the port's module names are the torchvision keys."""
    from sba_gan_tpu.utils.torch_port import port_cnn_encoder

    _, variables, enc = encoders
    sd = {k: v.numpy() for k, v in enc.state_dict().items()}
    params, stats = port_cnn_encoder(sd)
    for want, got in ((variables["params"], params), (variables["batch_stats"], stats)):
        want, got = W.flatten_tree(want), W.flatten_tree(got)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
