"""The bfloat16 paths of the port's kernels' plain versions against the JAX
package's Pallas kernels in interpret mode, on the same numpy inputs:

* K1-K3 (``ops/damsm_sim.py``) with ``mm_dtype`` bfloat16 against
  ``damsm_sim(..., mm_dtype=jnp.bfloat16, interpret=True)`` and its custom
  VJP: sim, d_words and d_img, through the plain versions, the wrappers and
  the autograd Function (batch 8, a multiple of the tile 4);
* K4 (``ops/word_attention.py``) on bfloat16 query and source against
  ``_word_attention(..., interpret=True)`` and ``_bwd``: the context, P, dQ
  and dS.

Each comparison also shows that the port rounds where the JAX package
rounds and not in float32: its largest distance to JAX's bfloat16 result is
at least ``FOLLOWS`` (10) times smaller than the largest distance between
JAX's bfloat16 and float32 results (measured: K1-K3 1.2e4 to 1.1e5 times;
K4 forward 4e4 to 1e5 times, dQ 73 times, dS exactly equal).

Tolerances.  K1-K3: the rounding points are the same, the products of
bfloat16 operands are exact in float32 and only the order of the float32
sums differs (measured: sim 4.8e-7, gradients 3.2e-7 of entries up to
1.8), so the float32 tolerances of tests/test_torch_damsm_sim.py hold: rtol
1e-5 / atol 1e-6 forward, rtol 1e-4 / atol 1e-6 gradients.  An
intermediate (A2, dC, dS) computed in another order can round to the
neighbouring bfloat16 value; none does at these inputs.  K4 forward as
tests/test_torch_word_attention.py (rtol 1e-5, atol 1e-5; measured 4.8e-7);
dQ and dS come out bfloat16 on both sides and may differ by one bfloat16
rounding of the float32 result, whose sums run in another order: rtol 2^-7,
atol 1e-5 (measured: dQ 3.9e-3 at one entry of 0.8 and 1.9e-6 at one of
7e-5, dS equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sba_gan_tpu.ops.damsm_sim import damsm_sim as jax_damsm_sim
from sba_gan_tpu.ops.word_attention import _bwd as jax_attn_bwd
from sba_gan_tpu.ops.word_attention import _word_attention as jax_word_attention
from sba_gan_tpu_torch.ops import damsm_sim as ds
from sba_gan_tpu_torch.ops import word_attention as wa

FOLLOWS = 10.0
B, T, R, D = 8, 6, 9, 16
G1, G2 = 4.0, 5.0
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
ATTN = dict(rtol=1e-5, atol=1e-5)
ATTN_GRAD = dict(rtol=2.0 ** -7, atol=1e-5)
BF16 = torch.bfloat16


def _gap(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _follows(got, want_bf16, want_f32):
    """``got`` is at least FOLLOWS times closer to JAX's bfloat16 result than
    that is to JAX's float32 one."""
    assert _gap(got, want_bf16) * FOLLOWS <= _gap(want_bf16, want_f32)


@pytest.fixture(scope="module")
def damsm_reference():
    """Inputs, and JAX's (sim, d_words, d_img) with bfloat16 and with float32
    products."""
    rng = np.random.default_rng(0)
    words = rng.standard_normal((B, T, D)).astype(np.float32)
    img = rng.standard_normal((B, R, D)).astype(np.float32)
    lens = rng.integers(1, T + 1, (B,)).astype(np.int32)
    lens[0], lens[-1] = 1, T
    g = rng.standard_normal((B, B)).astype(np.float32)
    out = {}
    for name, mm in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
        def f(w, x, mm=mm):
            return jax_damsm_sim(w, x, jnp.asarray(lens), G1, G2, tile_i=4,
                                 mm_dtype=mm, interpret=True)
        sim, vjp = jax.vjp(f, jnp.asarray(words), jnp.asarray(img))
        out[name] = [np.asarray(a) for a in (sim, *vjp(jnp.asarray(g)))]
    return (words, img, lens, g), out


@pytest.mark.parametrize("fn", ["plain", "wrapper", "function"])
def test_damsm_forward_follows_jax_bf16(damsm_reference, fn):
    (words, img, lens, _), ref = damsm_reference
    args = (torch.from_numpy(words), torch.from_numpy(img), torch.from_numpy(lens), G1, G2)
    got = {"plain": ds.damsm_sim_plain, "wrapper": ds.damsm_sim_fwd,
           "function": ds.damsm_sim}[fn](*args, mm_dtype=BF16)
    assert got.dtype == torch.float32 and got.shape == (B, B)
    np.testing.assert_allclose(got.numpy(), ref["bf16"][0], **FWD)
    _follows(got.numpy(), ref["bf16"][0], ref["f32"][0])


@pytest.mark.parametrize("fn", ["plain", "wrapper", "function"])
@pytest.mark.parametrize("which", ["dwords", "dimg"])
def test_damsm_gradients_follow_jax_bf16(damsm_reference, which, fn):
    (words, img, lens, g), ref = damsm_reference
    k = 1 if which == "dwords" else 2
    w, x, n, gt = (torch.from_numpy(a) for a in (words, img, lens, g))
    if fn == "function":
        w.requires_grad_(which == "dwords")
        x.requires_grad_(which == "dimg")
        ds.damsm_sim(w, x, n, G1, G2, BF16).backward(gt)
        got = (w if which == "dwords" else x).grad
    else:
        table = {("plain", "dwords"): ds.damsm_sim_dwords_plain,
                 ("plain", "dimg"): ds.damsm_sim_dimg_plain,
                 ("wrapper", "dwords"): ds.damsm_sim_dwords,
                 ("wrapper", "dimg"): ds.damsm_sim_dimg}
        got = table[fn, which](w, x, n, gt, G1, G2, mm_dtype=BF16)
    np.testing.assert_allclose(got.numpy(), ref["bf16"][k], **GRAD)
    _follows(got.numpy(), ref["bf16"][k], ref["f32"][k])
    if which == "dwords":
        pad = np.arange(T)[None, :] >= lens[:, None]
        assert np.all(got.numpy()[pad] == 0.0)


def test_damsm_rejects_other_mm_dtypes():
    w, x = torch.zeros((2, 3, 4)), torch.zeros((2, 5, 4))
    with pytest.raises(ValueError, match="mm_dtype"):
        ds.damsm_sim_plain(w, x, torch.tensor([1, 3]), mm_dtype=torch.float16)


ATTN_CASES = {  # B, QL, T, D, lengths (None = no mask)
    "ragged": (3, 512, 7, 16, [7, 3, 5]),
    "all_padding_row": (2, 512, 6, 8, [4, 0]),
    "no_mask": (2, 512, 5, 32, None),
    "coco_width": (2, 512, 12, 48, [12, 3]),  # D 48, WORDS_NUM 12: COCO's
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_word_attention_follows_jax_bf16(case):
    b, ql, t, d, lens = ATTN_CASES[case]
    rng = np.random.default_rng(len(case))
    q = rng.standard_normal((b, ql, d)).astype(np.float32)
    s = rng.standard_normal((b, t, d)).astype(np.float32)
    d_ctx = rng.standard_normal((b, ql, d)).astype(np.float32)
    pad = None if lens is None else np.arange(t)[None, :] >= np.asarray(lens)[:, None]
    bias = (np.zeros((b, t), np.float32) if pad is None
            else np.where(pad, np.float32(wa.NEG_INF), np.float32(0.0)))

    ref = {}
    for name, dt in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
        qj, sj = jnp.asarray(q).astype(dt), jnp.asarray(s).astype(dt)
        ctx, p = jax_word_attention(qj, sj, jnp.asarray(bias), 512, True)
        dq, dsrc, _ = jax_attn_bwd(512, True, (qj, sj, p), (jnp.asarray(d_ctx), None))
        assert dq.dtype == dt and dsrc.dtype == dt
        ref[name] = [np.asarray(a.astype(jnp.float32)) for a in (ctx, p, dq, dsrc)]

    qt = torch.from_numpy(q).to(BF16).requires_grad_(True)
    st = torch.from_numpy(s).to(BF16).requires_grad_(True)
    ctx, p = wa.word_attention(qt, st, None if pad is None else torch.from_numpy(pad))
    assert ctx.dtype == p.dtype == torch.float32
    ctx.backward(torch.from_numpy(d_ctx))
    assert qt.grad.dtype == st.grad.dtype == BF16
    got = [ctx.detach(), p.detach(), qt.grad.float(), st.grad.float()]
    for k, (name, tol) in enumerate((("ctx", ATTN), ("P", ATTN), ("dQ", ATTN_GRAD),
                                     ("dS", ATTN_GRAD))):
        np.testing.assert_allclose(got[k].numpy(), ref["bf16"][k], err_msg=name, **tol)
        _follows(got[k].numpy(), ref["bf16"][k], ref["f32"][k])


def test_word_attention_plain_rounds_p_for_the_context_only():
    """P comes out unrounded; the context is P rounded to bfloat16 times S."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 64, 8)).astype(np.float32)).to(BF16)
    s = torch.from_numpy(rng.standard_normal((2, 5, 8)).astype(np.float32)).to(BF16)
    bias = torch.zeros((2, 5))
    ctx, p = wa.word_attention_plain(q, s, bias)
    want_p = torch.softmax(torch.einsum("bqd,btd->bqt", q.float(), s.float()), dim=2)
    torch.testing.assert_close(p, want_p, rtol=0, atol=0)
    want = torch.einsum("bqt,btd->bqd", p.to(BF16).float(), s.float())
    torch.testing.assert_close(ctx, want, rtol=0, atol=0)
    assert not torch.equal(ctx, torch.einsum("bqt,btd->bqd", p, s.float()))
