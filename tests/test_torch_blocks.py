"""The port's generator blocks against the JAX package's, eval mode.

Flax initializes each block, its BatchNorm running statistics are replaced
by random ones, and the variables are carried into the port's block with
the port's weight map.  The same numpy inputs (NHWC for JAX, NCHW for the
port) then go through both.  Tolerance atol 1e-5, rtol 1e-5: float32 on
both sides, sums in a different order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import block_state_dict, nchw, nhwc, random_bn_stats
from sba_gan_tpu.models import attention as jatt
from sba_gan_tpu.models import blocks as jb
from sba_gan_tpu.models import generator as jgen
from sba_gan_tpu_torch.models import attention as tatt
from sba_gan_tpu_torch.models import blocks as tb
from sba_gan_tpu_torch.models import generator as tgen

TOL = dict(rtol=1e-5, atol=1e-5)
B, HW, C = 2, 8, 16


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _case_up_block(rng):
    x = _x(rng, B, HW, HW, C)
    return (jb.UpBlock(8), (jnp.asarray(x), False),
            tb.up_block(C, 8), (nchw(x),),
            ("InitStageG_0", "UpBlock_0"), "h_net1.upsample1.", ("nchw",))


def _case_res_block(rng):
    x = _x(rng, B, HW, HW, C)
    return (jb.ResBlock(C), (jnp.asarray(x), False),
            tb.ResBlock(C), (nchw(x),),
            ("NextStageG_0", "ResBlock_0"), "h_net2.residual.0.", ("nchw",))


def _case_adain(rng):
    h, w = _x(rng, B, HW, HW, C), _x(rng, B, 12)
    return (jb.AdaINNorm(C), (jnp.asarray(h), jnp.asarray(w)),
            tb.AdaINNorm(12, C), (nchw(h), torch.from_numpy(w)),
            ("NextStageG_0", "AdaINNorm_0"), "h_net2.adain.", ("nchw",))


def _case_canet(rng):
    sent = _x(rng, B, 32)
    key = jax.random.PRNGKey(7)
    eps = np.array(jax.random.normal(key, (B, 8), jnp.float32))  # CANet's draw
    return (jb.CANet(8), (jnp.asarray(sent), key),
            tb.CANet(32, 8), (torch.from_numpy(sent), torch.from_numpy(eps)),
            ("CANet_0",), "ca_net.", ("same",) * 3)


def _case_mapping(rng):
    z = _x(rng, B, 8)
    return (jb.MappingNet(16, num_layers=3), (jnp.asarray(z),),
            tb.MappingNet(8, 16, 3), (torch.from_numpy(z),),
            ("MappingNet_0",), "mapping_net.", ("same",))


def _case_bn_eval(rng):
    x = _x(rng, B, HW, HW, C)
    return (jb.BatchNorm(), (jnp.asarray(x), False),
            tb.batch_norm(C), (nchw(x),),
            ("InitStageG_0", "UpBlock_0", "BatchNorm_0"), "h_net1.upsample1.2.",
            ("nchw",))


def _case_get_image(rng):
    x = _x(rng, B, HW, HW, C)
    return (jgen.GetImageG(), (jnp.asarray(x),),
            tgen.GetImageG(C), (nchw(x),),
            ("GetImageG_0",), "img_net1.", ("nchw",))


def _case_word_attention(rng):
    h, words = _x(rng, B, HW, HW, C), _x(rng, B, 5, 24)
    pad = np.array([[0, 0, 0, 1, 1], [1, 1, 1, 1, 1]], bool)
    return (jatt.WordAttention(C, impl="xla"),
            (jnp.asarray(h), jnp.asarray(words), jnp.asarray(pad)),
            tatt.WordAttention(C, 24),
            (nchw(h), torch.from_numpy(words), torch.from_numpy(pad)),
            ("NextStageG_0", "WordAttention_0"), "h_net2.att.",
            ("nchw", "same"))


CASES = {
    "up_block": _case_up_block,
    "res_block": _case_res_block,
    "adain": _case_adain,
    "canet": _case_canet,
    "mapping_net": _case_mapping,
    "bn_eval": _case_bn_eval,
    "get_image": _case_get_image,
    "word_attention": _case_word_attention,
}


def _as_numpy(out, layouts):
    """Port outputs in the JAX layout: NCHW feature maps back to NHWC."""
    outs = out if isinstance(out, tuple) else (out,)
    assert len(outs) == len(layouts)
    return [nhwc(o) if lay == "nchw" else o.numpy()
            for o, lay in zip(outs, layouts)]


@pytest.mark.parametrize("name", list(CASES) + ["glu"])
def test_block_matches_jax(name):
    rng = np.random.default_rng(0)
    if name == "glu":
        x = _x(rng, B, HW, HW, C)
        want = [np.asarray(jb.glu(jnp.asarray(x)))]
        got = [nhwc(tb.glu(nchw(x)))]
    else:
        jmod, jargs, tmod, targs, prefix, strip, layouts = CASES[name](rng)
        variables = dict(jmod.init(jax.random.PRNGKey(0), *jargs))
        if "batch_stats" in variables:
            variables["batch_stats"] = random_bn_stats(variables["batch_stats"], rng)
        want = jmod.apply(variables, *jargs)
        want = [np.asarray(w) for w in (want if isinstance(want, tuple) else (want,))]
        tmod.load_state_dict(block_state_dict(variables, prefix, strip), strict=True)
        tmod.eval()
        with torch.no_grad():
            got = _as_numpy(tmod(*targs), layouts)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)
