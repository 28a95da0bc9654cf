"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: random BatchNorm statistics, and Flax variables of one block
carried into the port's block with the port's own weight map."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sba_gan_tpu.config import cfg_from_dict as jax_cfg_from_dict
from sba_gan_tpu.models.generator import build_generator as jax_build_generator
from sba_gan_tpu.train.gan import init_gan_state as jax_init_gan_state
from sba_gan_tpu.train.state import GANTrainState, NetState, gan_optimizers
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


def _flax_leaf(path, tensor):
    """One port tensor as the Flax leaf at ``path``: a conv kernel OIHW ->
    HWIO, a dense kernel (out, in) -> (in, out), anything else as it is."""
    v = tensor.detach().cpu().numpy()
    if path[-1] == "kernel":
        v = np.transpose(v, (2, 3, 1, 0)) if v.ndim == 4 else v.T
    return np.ascontiguousarray(v)


def flax_tree_from_port(abstract, state_dict, key_fn, path=()):
    """The Flax tree shaped as ``abstract`` (e.g. from ``jax.eval_shape`` of
    an init) filled from a port ``state_dict``: each leaf from the tensor
    ``key_fn(path)`` names.  The inverse of the port's weight maps, so that
    a test can skip a slow Flax init."""
    if isinstance(abstract, dict) or hasattr(abstract, "items"):
        return {k: flax_tree_from_port(v, state_dict, key_fn, path + (k,))
                for k, v in abstract.items()}
    leaf = _flax_leaf(path, state_dict[key_fn(path)])
    assert leaf.shape == tuple(abstract.shape), (path, leaf.shape, abstract.shape)
    return leaf


def jax_gan_state(jcfg, jmodels, models, text_key) -> GANTrainState:
    """The JAX GAN train state of ``jcfg`` holding the weights of the
    port's ``models`` (its text encoder's paths mapped by ``text_key``),
    with fresh optimizer states: a Flax init of these models takes a
    minute on the CPU."""
    abstract = jax.eval_shape(lambda: jax_init_gan_state(jcfg, jmodels,
                                                         jax.random.PRNGKey(0)))
    g_tx, d_tx = gan_optimizers(jcfg)
    g_sd = models.generator.state_dict()
    g = {c: flax_tree_from_port(getattr(abstract.g, c), g_sd, W.g_net_key)
         for c in ("params", "batch_stats")}
    ds = []
    for ab, d in zip(abstract.ds, models.discriminators):
        v = {c: flax_tree_from_port(getattr(ab, c), d.state_dict(), W.d_net_key)
             for c in ("params", "batch_stats")}
        ds.append(NetState(v["params"], v["batch_stats"], d_tx.init(v["params"])))
    image_sd = models.image_encoder.state_dict()
    return GANTrainState(
        step=jnp.zeros((), jnp.int32),
        g=NetState(g["params"], g["batch_stats"], g_tx.init(g["params"])),
        g_ema=g["params"], ds=tuple(ds),
        text={"params": flax_tree_from_port(abstract.text["params"],
                                            models.text_encoder.state_dict(), text_key)},
        image={c: flax_tree_from_port(abstract.image[c], image_sd, cnn_encoder_key)
               for c in ("params", "batch_stats")})


_RNN_KEYS = {"w_ih": "weight_ih", "w_hh": "weight_hh", "b_ih": "bias_ih",
             "b_hh": "bias_hh"}
_BN_KEYS = {"scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}


def rnn_encoder_key(path):
    """Port key of a Flax RNNEncoder path."""
    if path == ("embedding",):
        return "encoder.weight"
    return f"rnn.{_RNN_KEYS[path[1]]}_{'l0' if path[0] == 'fwd' else 'l0_reverse'}"


def cnn_encoder_key(path):
    """Port key of a Flax CNNEncoder path."""
    if path[0] in ("emb_features", "emb_cnn_code"):
        return f"{path[0]}.{'weight' if path[1] == 'kernel' else 'bias'}"
    leaf = "weight" if path[-1] == "kernel" else _BN_KEYS[path[-1]]
    return ".".join(path[1:-1]) + "." + leaf


def write_bert_hub(root, tokens):
    """A HuggingFace hub cache under ``root`` whose ``bert-base-uncased``
    snapshot holds a ``vocab.txt`` of ``tokens`` (ids in order), found
    through ``refs/main``; returns ``root``."""
    repo = root / "models--bert-base-uncased"
    (repo / "snapshots" / "0123abc").mkdir(parents=True)
    (repo / "refs").mkdir()
    (repo / "refs" / "main").write_text("0123abc")
    (repo / "snapshots" / "0123abc" / "vocab.txt").write_text("\n".join(tokens) + "\n")
    return root


def import_transformers():
    """``transformers`` (skipping where it is absent), imported without its
    TensorFlow import, which these tests do not use and which costs seconds;
    the setting counts only where this is the process's first import."""
    import pytest

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("USE_TF", "0")
        return pytest.importorskip("transformers")
