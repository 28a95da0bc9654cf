"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: random BatchNorm statistics, and Flax variables of one block
carried into the port's block with the port's own weight map."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sba_gan_tpu.config import cfg_from_dict as jax_cfg_from_dict
from sba_gan_tpu.models.generator import build_generator as jax_build_generator
from sba_gan_tpu_torch.config import cfg_from_dict
from sba_gan_tpu_torch.utils import weights as W

# tiny widths; the spatial sizes (64, 128, 256) stay the real ones
TINY = {"GAN": {"GF_DIM": 8, "Z_DIM": 8, "W_DIM": 16, "CONDITION_DIM": 8,
                "R_NUM": 1},
        "TEXT": {"EMBEDDING_DIM": 32, "WORDS_NUM": 6},
        "TREE": {"BRANCH_NUM": 3}}


def tiny_cfgs(style_mixing=False):
    """The same tiny configuration for the JAX package and for the port."""
    d = {k: dict(v) for k, v in TINY.items()}
    if style_mixing:
        d["TRAIN"] = {"MIXING": True}
        d["GAN"].update(INIT_Z_CONCAT=False, M_NUM=8)
    return jax_cfg_from_dict(d), cfg_from_dict(d)


def jax_generator_and_vars(jcfg, rng, z, sent, words, pad, rng_ca):
    """The JAX GNet of ``jcfg`` and its Flax variables, with random
    BatchNorm running statistics."""
    g = jax_build_generator(jcfg)
    v = g.init(jax.random.PRNGKey(0), jnp.asarray(z), jnp.asarray(sent),
               jnp.asarray(words), jnp.asarray(pad), rng_ca, True)
    return g, {"params": v["params"],
               "batch_stats": random_bn_stats(v["batch_stats"], rng)}


def random_bn_stats(batch_stats, rng):
    """The same tree with random running means and positive variances, so
    that eval-mode BatchNorm really normalizes."""
    out = {}
    for k, v in batch_stats.items():
        if isinstance(v, dict):
            out[k] = random_bn_stats(v, rng)
        elif k == "mean":
            out[k] = rng.normal(0.0, 0.5, np.shape(v)).astype(np.float32)
        else:
            out[k] = rng.uniform(0.5, 2.0, np.shape(v)).astype(np.float32)
    return out


def block_state_dict(variables, gnet_prefix, strip):
    """State dict of one port block from the Flax variables of its JAX
    counterpart: each path is placed under ``gnet_prefix`` inside a GNet,
    mapped with ``weights.g_net_key``, and the key prefix ``strip`` is cut."""
    sd = {}
    for coll in ("params", "batch_stats"):
        for key, value in W.flatten_tree(variables.get(coll, {})).items():
            path = tuple(gnet_prefix) + tuple(key.split("/"))
            name = W.g_net_key(path)
            assert name.startswith(strip), (name, strip)
            sd[name[len(strip):]] = W.flax_leaf_to_torch(path, value)
            if name.endswith("running_mean"):
                sd[name[len(strip):-len("running_mean")] + "num_batches_tracked"] = (
                    torch.zeros((), dtype=torch.long))
    return sd


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()
