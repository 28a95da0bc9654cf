"""The port's modules under a bfloat16 compute dtype against the JAX
package's built with ``dtype=jnp.bfloat16``, with Flax weights carried over
by the port's weight maps (parameters float32 on both sides):

* BatchNorm (flax ``nn.BatchNorm(dtype=bfloat16)``): train-mode output and
  running statistics, and eval mode;
* a G-side block (``ResBlock``, train mode) and a D-side block
  (``DownBlock``, train mode);
* ``GNet`` (three branches, eval mode, the XLA attention path, whose
  forward rounds P as the kernel does), ``DNet64`` (train mode: code and
  both logits), ``CNNEncoder`` (eval mode) and ``RNNEncoder`` (LSTM and
  GRU, eval mode).

Each output must have JAX's dtype.  BatchNorm rounds once, after float32
math on both sides, and agrees exactly.  Elsewhere XLA on the CPU keeps
bfloat16 elementwise chains in float32 inside a fusion
(``xla_allow_excess_precision``) where PyTorch rounds each operation, so
the two sides differ by about one bfloat16 rounding (2^-9 relative) at many
entries, which the deeper modules amplify as they amplify any rounding.
So each output's distance to JAX's, |port - jax| / |jax| over the tensor,
is bounded by ``FACTOR`` (2) times the distance of the port's float32
output to JAX's bfloat16 one (which tests/test_torch_{blocks,generator,
discriminator,inception,text_rnn}.py hold to JAX's float32 output within
1e-4): the port's bfloat16 result is no further from JAX's than JAX's
bfloat16 result is from float32.  Measured ratios: DownBlock 0.14,
ResBlock 0.75, DNet64 0.36-0.74, RNNEncoder 0.81-0.87, GNet 0.82-1.15 (its
256 x 256 image differs by 8.8e-2 in eval mode, its 64 x 64 one by
4.4e-3).  That the port rounds at all is checked against its own float32
result: every output differs from it by at least 1e-4 of its norm (2^-9 is
one rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    block_state_dict,
    cnn_encoder_key,
    flax_tree_from_port,
    nchw,
    nhwc,
    random_bn_stats,
    tiny_cfgs,
)
from sba_gan_tpu.config import cfg_from_dict as jax_cfg_from_dict
from sba_gan_tpu.models import blocks as jb
from sba_gan_tpu.models.discriminator import build_discriminators as jax_build_ds
from sba_gan_tpu.models.generator import build_generator as jax_build_generator
from sba_gan_tpu.models.inception import CNNEncoder as JaxCNNEncoder
from sba_gan_tpu.models.text_rnn import RNNEncoder as JaxRNNEncoder
from sba_gan_tpu_torch.config import cfg_from_dict
from sba_gan_tpu_torch.models import blocks as tb
from sba_gan_tpu_torch.models.blocks import init_weights
from sba_gan_tpu_torch.models.discriminator import build_discriminators
from sba_gan_tpu_torch.models.generator import build_generator
from sba_gan_tpu_torch.models.inception import CNNEncoder
from sba_gan_tpu_torch.models.inception import init_weights as init_image_weights
from sba_gan_tpu_torch.models.layers import set_compute_dtype
from sba_gan_tpu_torch.models.text_rnn import RNNEncoder
from sba_gan_tpu_torch.utils import weights as W

BF16 = torch.bfloat16
BF16_JAX = {"JAX": {"DTYPE": "bfloat16"}}
ROUNDS = 1e-4  # least |port_bf16 - port_f32| / |port_f32| of an output
FACTOR = 2.0


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _np(x):
    """A JAX or torch array as a float32 numpy array (bfloat16 widened)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _check(name, got_bf16, got_f32, want):
    """Dtype as JAX's; within FACTOR times the port's float32 distance to
    JAX's bfloat16 output; and rounded (not the port's float32 result)."""
    assert str(got_bf16.dtype).split(".")[-1] == str(want.dtype), (name, got_bf16.dtype,
                                                                 want.dtype)
    err, gap = _rel(_np(got_bf16), _np(want)), _rel(_np(got_f32), _np(want))
    assert err <= FACTOR * gap, (name, err, gap)
    assert _rel(_np(got_bf16), _np(got_f32)) >= ROUNDS, name


def _random_stats(module, seed):
    """Random running statistics in every BatchNorm of a port module."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.copy_(0.5 * torch.randn(m.running_mean.shape, generator=gen))
                m.running_var.uniform_(0.5, 2.0, generator=gen)


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_matches_flax(train):
    rng = np.random.default_rng(0)
    x = 3.0 * _x(rng, 4, 8, 8, 16) + 1.0
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    jm = jb.BatchNorm(dtype=jnp.bfloat16)
    v = dict(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), True))
    v["batch_stats"] = random_bn_stats(v["batch_stats"], rng)
    want, mut = jm.apply(v, xb, train, mutable=["batch_stats"])
    bn = tb.batch_norm(16)
    bn.load_state_dict(block_state_dict(v, ("InitStageG_0", "UpBlock_0", "BatchNorm_0"),
                                        "h_net1.upsample1.2."))
    bn.train(train)
    got = bn(nchw(x).to(BF16))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(nhwc(got.float()), _np(want))
    stats = mut["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]),
                               rtol=1e-6, atol=1e-7)
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32


def _block_case(name, rng):
    if name == "res_block":
        x = _x(rng, 2, 8, 8, 16)
        return (jb.ResBlock(16, dtype=jnp.bfloat16), tb.ResBlock(16), x,
                ("NextStageG_0", "ResBlock_0"), "h_net2.residual.0.")
    x = _x(rng, 3, 16, 16, 8)
    return (jb.DownBlock(16, dtype=jnp.bfloat16), tb.down_block(8, 16), x,
            ("D", "DownBlock_0"), "")


@pytest.mark.parametrize("name", ["res_block", "down_block"])
def test_block_matches_jax_bf16(name):
    rng = np.random.default_rng(1)
    jmod, tmod, x, prefix, strip = _block_case(name, rng)
    v = dict(jax.jit(lambda k: jmod.init(k, jnp.asarray(x), False))(jax.random.PRNGKey(0)))
    v["batch_stats"] = random_bn_stats(v["batch_stats"], rng)
    want, mut = jax.jit(lambda v: jmod.apply(v, jnp.asarray(x), True,
                                             mutable=["batch_stats"]))(v)
    if name == "res_block":
        sd = block_state_dict(v, prefix, strip)
    else:  # the D map: the down block as DNet128's img_code_s32
        sd = {k[len("img_code_s32."):]: t for k, t in W.d_net_state_dict(
            {"down32": v["params"]}, {"down32": v["batch_stats"]}).items()}
    tmod.load_state_dict(sd)
    ref = {n: t.clone() for n, t in tmod.state_dict().items()}
    got_f32 = tmod.train()(nchw(x))
    tmod.load_state_dict(ref)
    got = set_compute_dtype(tmod, BF16)(nchw(x))
    _check(name, got.permute(0, 2, 3, 1), got_f32.permute(0, 2, 3, 1), want)


def test_gnet_matches_jax_bf16():
    """Weights drawn by the port (random running statistics) and carried into
    Flax, which spares a slow Flax init."""
    rng = np.random.default_rng(2)
    jcfg, cfg = tiny_cfgs()
    b, t, nef = 2, 6, 32
    z, sent, words = _x(rng, b, 8), _x(rng, b, nef), _x(rng, b, t, nef)
    pad = np.arange(t)[None, :] >= np.array([6, 3])[:, None]
    rng_ca = jax.random.PRNGKey(5)
    eps = np.array(jax.random.normal(rng_ca, (b, 8), jnp.float32))
    nets = {}
    for dtype in ("float32", "bfloat16"):
        cfg.JAX.DTYPE = dtype
        nets[dtype] = build_generator(cfg).eval()
    init_weights(nets["float32"], torch.Generator().manual_seed(0))
    _random_stats(nets["float32"], 1)
    sd = nets["float32"].state_dict()
    nets["bfloat16"].load_state_dict(sd)
    jcfg.JAX.DTYPE = "bfloat16"
    jg = jax_build_generator(jcfg)
    args = (jnp.asarray(z), jnp.asarray(sent), jnp.asarray(words), jnp.asarray(pad), rng_ca)
    abstract = jax.eval_shape(lambda: jg.init(jax.random.PRNGKey(0), *args, True))
    v = {c: flax_tree_from_port(abstract[c], sd, W.g_net_key)
         for c in ("params", "batch_stats")}
    fakes_j, atts_j, mu_j, _ = jax.jit(lambda v: jg.apply(v, *args, False))(v)
    outs = {}
    for dtype, net in nets.items():
        with torch.no_grad():
            outs[dtype] = net(*(torch.from_numpy(a) for a in (z, sent, words, pad, eps)))
    (fakes, atts, mu, _), (fakes32, atts32, mu32, _) = outs["bfloat16"], outs["float32"]
    _check("mu", mu, mu32, mu_j)
    for k, (f, f32, want) in enumerate(zip(fakes + atts, fakes32 + atts32,
                                           list(fakes_j) + list(atts_j))):
        _check(f"gnet output {k}", f, f32, want)


def test_dnet_matches_jax_bf16():
    rng = np.random.default_rng(3)
    dims = {"TREE": {"BRANCH_NUM": 1}, "GAN": {"DF_DIM": 8}, "TEXT": {"EMBEDDING_DIM": 16}}
    b = 3
    img, sent = rng.uniform(-1, 1, (b, 64, 64, 3)).astype(np.float32), _x(rng, b, 16)
    ds = {dtype: build_discriminators(cfg_from_dict({**dims, "JAX": {"DTYPE": dtype}}))[0]
          for dtype in ("float32", "bfloat16")}
    init_weights(ds["float32"], torch.Generator().manual_seed(0))
    _random_stats(ds["float32"], 1)
    sd = ds["float32"].state_dict()
    ds["bfloat16"].load_state_dict(sd)
    jd = jax_build_ds(jax_cfg_from_dict({**dims, **BF16_JAX}))[0]
    abstract = jax.eval_shape(lambda: jd.init(jax.random.PRNGKey(0), jnp.zeros((b, 64, 64, 3)),
                                              jnp.zeros((b, 16)), True, method="init_all"))
    v = {c: flax_tree_from_port(abstract[c], sd, W.d_net_key)
         for c in ("params", "batch_stats")}

    def heads(mod, x, c):
        h = mod(x, True)
        return h, mod.cond_logits(h, c, True), mod.uncond_logits(h, True)
    want, _ = jax.jit(lambda v: jd.apply(v, jnp.asarray(img), jnp.asarray(sent),
                                         method=heads, mutable=["batch_stats"]))(v)
    outs = {}
    for dtype, d in ds.items():
        h = d.train()(nchw(img))
        outs[dtype] = (h.permute(0, 2, 3, 1), d.cond_logits(h, torch.from_numpy(sent)),
                       d.uncond_logits(h))
    for name, got, got32, w in zip(("code", "cond", "uncond"), outs["bfloat16"],
                                   outs["float32"], want):
        _check(name, got, got32, w)


def test_cnn_encoder_matches_jax_bf16():
    """As the GNet's; regions and code come out float32 on both sides."""
    rng = np.random.default_rng(4)
    nef, size, b = 32, 75, 4
    img = rng.uniform(-1, 1, (b, 64, 64, 3)).astype(np.float32)  # resized to 75
    encs = {dt: CNNEncoder(nef=nef, input_size=size, dtype=dt).eval()
            for dt in (torch.float32, BF16)}
    init_image_weights(encs[torch.float32], torch.Generator().manual_seed(0))
    _random_stats(encs[torch.float32], 1)
    sd = encs[torch.float32].state_dict()
    encs[BF16].load_state_dict(sd)
    jenc = JaxCNNEncoder(nef=nef, input_size=size, dtype=jnp.bfloat16)
    abstract = jax.eval_shape(lambda: jenc.init(jax.random.PRNGKey(0),
                                                jnp.zeros((2, size, size, 3)), False))
    v = {c: flax_tree_from_port(abstract[c], sd, cnn_encoder_key)
         for c in ("params", "batch_stats")}
    want = jax.jit(lambda v: jenc.apply(v, jnp.asarray(img), False))(v)
    with torch.no_grad():
        outs = {dt: enc(torch.from_numpy(img)) for dt, enc in encs.items()}
    for name, got, got32, w in zip(("region", "code"), outs[BF16], outs[torch.float32],
                                   want):
        _check(name, got, got32, w)


@pytest.mark.parametrize("rnn_type", ["LSTM", "GRU"])
def test_rnn_encoder_matches_jax_bf16(rnn_type):
    rng = np.random.default_rng(5)
    ntoken, ninput, nhidden, t = 40, 24, 32, 6
    lens = np.array([6, 1, 4, 3], np.int64)
    captions = np.zeros((len(lens), t), np.int64)
    for i, n in enumerate(lens):
        captions[i, :n] = rng.integers(1, ntoken, n)
    jenc = JaxRNNEncoder(ntoken=ntoken, ninput=ninput, nhidden=nhidden, rnn_type=rnn_type,
                         dtype=jnp.bfloat16)
    key = jax.random.PRNGKey(3)
    v = jenc.init({"params": key, "dropout": key}, jnp.asarray(captions, jnp.int32),
                  jnp.asarray(lens, jnp.int32), train=False)
    want = jenc.apply(v, jnp.asarray(captions, jnp.int32), jnp.asarray(lens, jnp.int32),
                      train=False)
    outs = {}
    for dtype in (torch.float32, BF16):
        enc = RNNEncoder(ntoken, ninput=ninput, nhidden=nhidden, rnn_type=rnn_type,
                         dtype=dtype)
        enc.load_state_dict(W.rnn_encoder_state_dict(v["params"]))
        with torch.no_grad():
            outs[dtype] = enc.eval()(torch.from_numpy(captions), torch.from_numpy(lens))
    for name, got, got32, w in zip(("words", "sent"), outs[BF16], outs[torch.float32],
                                   want):
        _check(name, got, got32, w)
    assert np.all(outs[BF16][0].float().numpy()[1, 1:] == 0)  # zero at padded steps
